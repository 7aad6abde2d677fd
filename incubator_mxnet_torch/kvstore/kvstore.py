"""KVStore: gradient aggregation and parameter synchronization.

Counterpart of the JAX package's ``kvstore/kvstore.py``, over
``torch.distributed`` with one process a card:

* ``'local'``/``'device'``/``'nccl'`` (:class:`KVStoreLocal`): aggregation
  within the process: a list pushed for one key is summed, and one worker
  has nothing else to reduce.
* ``'dist_sync'``/``'dist_sync_device'``/``'dist_device_sync'``
  (:class:`KVStoreDist`): the same, then a sum over the process group, an
  all-reduce of the tensor where it lives (NCCL on the card, gloo on the
  CPU or between ranks that share a card).  ``rank`` and ``num_workers``
  come from the group; with ``DMLC_NUM_WORKER`` above 1 and no group yet,
  the store starts one (``parallel.init_distributed``).  There is no
  server tier: ``set_optimizer`` runs the optimizer on each worker's
  identical copy, as the JAX package's store does.

Values are tensors or NDArrays; the store keeps tensors, an updater
(``set_optimizer`` or ``_set_updater``) is called with tensors
``(key, grad, weight)``, and ``pull`` writes into the tensors or NDArrays
it is given.

Bucketed all-reduce (``plan_buckets``, ``execute_bucket``,
``bucketed_pushpull``): same-dtype gradients flattened into size-capped
flat buckets (``MXNET_KVSTORE_BUCKET_BYTES``, default 4 MiB), one
all-reduce a bucket, in a plan that is deterministic (input order, split
by dtype and device), so every rank formats the same buckets.  A bucket's
all-reduce can be launched asynchronously (``launch_bucket``) and
finished later (``finish_bucket``), which ``Trainer.backward`` overlaps
with the backward.  The ``kvstore.push``, ``kvstore.pull``,
``kvstore.pushpull`` and ``kvstore.bucketed_pushpull`` spans are in the
profiler's ``comms`` category; the first three bill its ``comms`` bucket,
a bucket's wire wait among them (a ``kvstore.pushpull`` inside its
``kvstore.bucketed_pushpull``, which does not bill, as in the JAX
package).

Not in this slice, each raising and naming its ROADMAP §1 item:
``'dist_async'`` (the parameter server, item 9), gradient compression
(``set_gradient_compression``, ``_quantize_2bit``, a ``compression=``
policy: item 6b).
"""
from __future__ import annotations

import os as _os
import zlib
from time import perf_counter as _perf

import torch

from .. import profiler as _profiler
from ..base import dtype_name
from ..ndarray.ndarray import NDArray

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDist", "bucket_bytes", "bucketed_pushpull",
           "plan_buckets", "execute_bucket", "launch_bucket", "finish_bucket", "create"]

_COMPRESSION_QUEUED = ("gradient compression waits in ROADMAP §1 item 6b "
                       "(comm/compression.py and comm/ring.py)")


def bucket_bytes():
    """Per-bucket byte cap for bucketed gradient all-reduce
    (``MXNET_KVSTORE_BUCKET_BYTES``, default 4 MiB; 0 disables bucketing)."""
    try:
        return int(_os.environ.get("MXNET_KVSTORE_BUCKET_BYTES", str(4 << 20)))
    except ValueError:
        return 4 << 20


def _tensor(v):
    return v._data if isinstance(v, NDArray) else v


def _write(out, value):
    """Copy ``value`` into ``out`` (a tensor or an NDArray), unless it is
    that very tensor."""
    t = _tensor(out)
    if t is not value:
        with torch.no_grad():
            t.copy_(value)
    if isinstance(out, NDArray):
        out._version += 1


def _flatten(raws):
    return torch.cat([r.reshape(-1) for r in raws])


def _unflatten(flat, shapes):
    pieces, off = [], 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        pieces.append(flat[off:off + n].view(s))
        off += n
    return pieces


def plan_buckets(items, names=None, cap_bytes=None, compression=None, epoch=0):
    """THE deterministic bucket-assignment rule (input order, split per
    (dtype, device), size-capped), shared by :func:`bucketed_pushpull` and
    ``Trainer.backward``'s overlap: both must format identical buckets, or
    the ranks' collectives split.  ``items`` are ``(key, grad)``; only
    dtype, shape and device are read, so the plan can be drawn before the
    backward runs.  Returns ``(policy, buckets)``, the policy None (no
    compression in this slice), each bucket a dict of its wire ``key``,
    ``codec`` (None: exact), ``cid``, the ``positions`` of its members in
    ``items`` and its ``nbytes``."""
    if compression is not None:
        raise NotImplementedError(f"plan_buckets(compression={compression!r}): "
                                  + _COMPRESSION_QUEUED)
    cap = bucket_bytes() if cap_bytes is None else cap_bytes
    cid = "fp32"
    by_group = {}  # (dtype, device, codec id) -> positions
    for i, (_, g) in enumerate(items):
        t = _tensor(g)
        by_group.setdefault((dtype_name(t.dtype), str(t.device), cid), []).append(i)
    buckets = []
    bucket_id = 0
    for (dt, _dev, cid), members in by_group.items():
        itemsize = _tensor(items[members[0]][1]).element_size()
        start = 0
        while start < len(members):
            end, nbytes = start, 0
            while end < len(members):
                sz = _tensor(items[members[end]][1]).numel() * itemsize
                if end > start and nbytes + sz > cap:
                    break
                nbytes += sz
                end += 1
            buckets.append({"key": f"__grad_bucket__:{epoch}:{cid}:{dt}:{bucket_id}",
                            "codec": None, "cid": cid,
                            "positions": tuple(members[start:end]), "nbytes": nbytes})
            bucket_id += 1
            start = end
    return None, buckets


def launch_bucket(kv, bucket, items):
    """Start ONE planned bucket's all-reduce: the agreement check, the
    flatten, and ``kv.wire_allreduce(flat, async_op=True)``.  Returns the
    handle :func:`finish_bucket` takes; nothing is written yet."""
    t0 = _perf()
    grads = [_tensor(items[i][1]) for i in bucket["positions"]]
    if hasattr(kv, "check_wire_agreement"):
        kv.check_wire_agreement(bucket["key"])
    with torch.no_grad():
        flat = _flatten(grads)
    work = kv.wire_allreduce(flat, async_op=True)
    return {"bucket": bucket, "items": items, "flat": flat, "work": work, "t0": t0}


def finish_bucket(handle):
    """Wait for a launched bucket and scatter the reduced values back into
    its members' gradient buffers in place.  A failure on the wire raises
    out of the wait, before the scatter: the members keep their values."""
    bucket, items, flat = handle["bucket"], handle["items"], handle["flat"]
    tw = _perf()
    if handle["work"] is not None:
        handle["work"].wait()
    if _profiler._active:
        # the wire time this thread waited for: the leaf that bills "comms"
        # (the bucketed_pushpull parent does not, as in the JAX package)
        _profiler.record_span("kvstore.pushpull", "comms", tw, args={"key": bucket["key"]})
    members = [items[i][1] for i in bucket["positions"]]
    grads = [_tensor(g) for g in members]
    with torch.no_grad():
        for g, piece in zip(grads, _unflatten(flat, [g.shape for g in grads])):
            g.copy_(piece)
    for g in members:
        if isinstance(g, NDArray):
            g._version += 1
    _profiler.incr("allreduce_bucket")
    _profiler.incr("allreduce_bucket_params", len(grads))
    if _profiler._active:
        _profiler.record_span("kvstore.bucketed_pushpull", "comms", handle["t0"],
                              args={"params": len(grads), "bytes": bucket["nbytes"],
                                    "bytes_raw": bucket["nbytes"],
                                    "bytes_wire": bucket["nbytes"], "codec": bucket["cid"]})


def execute_bucket(kv, bucket, items, policy, feedback):
    """All-reduce ONE planned bucket through ``kv`` and scatter the reduced
    values back into its members' gradient buffers in place; raises,
    never half-writes, when the wire fails."""
    if policy is not None or feedback is not None:
        raise NotImplementedError("execute_bucket with a compression policy: "
                                  + _COMPRESSION_QUEUED)
    finish_bucket(launch_bucket(kv, bucket, items))


def bucketed_pushpull(kv, items, cap_bytes=None, names=None, compression=None, feedback=None):
    """All-reduce ``items`` (``(key, grad)``) through ``kv`` as size-capped
    flat buckets, writing the reduced values back into each gradient in
    place.  The plan is :func:`plan_buckets`'; ``compression`` and
    ``feedback`` wait in ROADMAP §1 item 6b."""
    if feedback is not None:
        raise NotImplementedError("bucketed_pushpull(feedback=): " + _COMPRESSION_QUEUED)
    epoch = kv.membership_epoch() if hasattr(kv, "membership_epoch") else 0
    _, buckets = plan_buckets(items, names=names, cap_bytes=cap_bytes, compression=compression,
                              epoch=epoch)
    for bucket in buckets:
        execute_bucket(kv, bucket, items, None, None)


def create(name="local"):
    """Parity: ``mx.kv.create``."""
    name = name.lower()
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device", "device", "nccl"):
        return KVStoreLocal(name)
    if name == "dist_async":
        raise NotImplementedError(
            "kvstore 'dist_async': the asynchronous parameter server (the JAX package's "
            "kvstore/async_ps.py) waits in ROADMAP §1 item 9")
    if name in ("dist_sync", "dist_sync_device", "dist_device_sync", "dist"):
        return KVStoreDist(name)
    if name in ("horovod", "byteps"):
        # plugin all-reduce backends in the reference: the dist store is one
        return KVStoreDist("dist_sync")
    raise ValueError(f"unknown kvstore type {name!r}")


class KVStore:
    """Base key-value store (parity: ``mx.kvstore.KVStore``)."""

    def __init__(self, name):
        self._type = name
        self._store = {}
        self._updater = None
        self._optimizer = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- core ops --------------------------------------------------------
    def init(self, key, value):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        self._store[key] = _tensor(value).detach().clone()

    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        t0 = _perf() if _profiler._active else None
        agg = self._reduce_across_workers(self._aggregate(value))
        if self._updater is not None:
            self._updater(key, agg, self._store[key])
        else:
            self._store[key] = agg
        if t0 is not None:
            _profiler.record_span("kvstore.push", "comms", t0)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        t0 = _perf() if _profiler._active else None
        value = self._store[key]
        for o in (out if isinstance(out, (list, tuple)) else [out]):
            _write(o, value)
        if t0 is not None:
            _profiler.record_span("kvstore.pull", "comms", t0)

    def pushpull(self, key, value, out=None, priority=0):
        """Fused push and pull (parity: the 1.7 ``pushpull``)."""
        if isinstance(key, (list, tuple)):
            for i, k in enumerate(key):
                self.pushpull(k, value[i], out[i] if out is not None else None, priority)
            return
        t0 = _perf() if _profiler._active else None
        agg = self._reduce_across_workers(self._aggregate(value))
        if self._updater is not None:
            if key not in self._store:
                self.init(key, agg)
            self._updater(key, agg, self._store[key])
            result = self._store[key]
        else:
            result = self._store[key] = agg
        if out is not None:
            for o in (out if isinstance(out, (list, tuple)) else [out]):
                _write(o, result)
        if t0 is not None:
            _profiler.record_span("kvstore.pushpull", "comms", t0)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        # dense storage only: a pull (the JAX package's documented divergence)
        self.pull(key, out, priority)

    def supports_grad_bucketing(self):
        """Whether ``bucketed_pushpull`` is sound against this store: only a
        pure all-reduce tier qualifies; a store applying an optimizer per
        key keeps one key a parameter, and a local store has no wire."""
        return False

    def membership_epoch(self):
        """Epoch of the contributing worker set: fixed at bootstrap here."""
        return 0

    # -- helpers ---------------------------------------------------------
    def _aggregate(self, value):
        if isinstance(value, (list, tuple)):
            acc = _tensor(value[0]).detach().clone()
            for v in value[1:]:
                acc += _tensor(v)
            return acc
        return _tensor(value)

    def _reduce_across_workers(self, value):
        return value

    def wire_allreduce(self, arr, op="sum", async_op=False):
        """Cross-worker sum of ``arr`` in place (the transport a bucket
        rides); one worker: nothing to do.  With ``async_op`` returns the
        work to wait on, or None."""
        return None if async_op else arr

    def _quantize_2bit(self, key, grad):
        raise NotImplementedError("2-bit gradient compression: " + _COMPRESSION_QUEUED)

    # -- optimizer plumbing ---------------------------------------------
    def set_optimizer(self, optimizer):
        """Parity: run the optimizer "on the kvstore": here the updater runs
        on each worker's identical copy (same math, no server)."""
        from ..optimizer import get_updater

        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError(
            f"set_gradient_compression({compression_params!r}): " + _COMPRESSION_QUEUED)

    # -- persistence / barrier -------------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise ValueError("Cannot save states for distributed training without "
                             "initializing the optimizer")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise ValueError("Cannot load states without an optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        pass


class KVStoreLocal(KVStore):
    """'local'/'device'/'nccl': single-process aggregation."""


class KVStoreDist(KVStore):
    """'dist_*': a sum over the process group (``torch.distributed``).

    The reference launcher's ``DMLC_*`` environment starts the group
    (``tools/launch_local.py``): ``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT``
    the rendezvous, ``DMLC_NUM_WORKER`` the world size, ``DMLC_WORKER_ID``
    the rank.  ``group`` is the process group (default: the world)."""

    def __init__(self, name, group=None):
        super().__init__(name)
        self._group = group
        self._ensure_dist()

    def supports_grad_bucketing(self):
        return self._updater is None and self._optimizer is None

    @staticmethod
    def _ensure_dist():
        import torch.distributed as dist

        if int(_os.environ.get("DMLC_NUM_WORKER", "1")) > 1 and not dist.is_initialized():
            from ..parallel.mesh import init_distributed

            init_distributed()

    @staticmethod
    def _dist():
        import torch.distributed as dist

        return dist if dist.is_available() and dist.is_initialized() else None

    @property
    def rank(self):
        d = self._dist()
        return 0 if d is None else d.get_rank(self._group)

    @property
    def num_workers(self):
        d = self._dist()
        return 1 if d is None else d.get_world_size(self._group)

    # -- collectives ---------------------------------------------------
    def _allreduce(self, arr, op="sum", async_op=False):
        """Reduce ``arr`` in place over the group where it lives ('sum',
        'max' or 'min')."""
        import torch.distributed as dist

        from ..parallel.mesh import collective

        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
        return collective("all_reduce", arr, group=self._group, async_op=async_op, op=ops[op])

    def wire_allreduce(self, arr, op="sum", async_op=False):
        if self.num_workers == 1:
            return None if async_op else arr
        work = self._allreduce(arr, op, async_op=async_op)
        return work if async_op else arr

    def check_wire_agreement(self, key):
        """Fail loudly if a peer formats this bucket differently: one
        (2,)-int all-reduce of the key's hash a bucket, the first
        collective each rank issues for it, so a rank that planned other
        buckets raises on every side instead of summing mismatched data."""
        if self.num_workers == 1:
            return
        import torch.distributed as dist

        h = zlib.crc32(key.encode()) & 0x3FFFFFFF
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(self._group) == "nccl" else torch.device("cpu"))
        pair = torch.tensor([h, -h], dtype=torch.int64, device=device)
        self._allreduce(pair, "max")
        hi, neg_lo = pair.tolist()
        if hi != h or -neg_lo != h:
            raise RuntimeError(
                f"gradient-bucket wire-format mismatch: this worker formats {key!r} but a "
                "peer disagrees; every worker must plan the same buckets (the same "
                "parameters, dtypes, devices and MXNET_KVSTORE_BUCKET_BYTES)")

    def _reduce_across_workers(self, value):
        if self.num_workers == 1:
            return value
        out = value.detach().clone()
        self._allreduce(out)
        return out

    def barrier(self):
        if self.num_workers > 1:
            from ..parallel.mesh import collective

            collective("barrier", None, group=self._group)
