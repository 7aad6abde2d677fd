"""``mx.io``: the legacy data-iterator API.

Counterpart of the JAX package's ``io/io.py`` (parity target: MXNet's
``python/mxnet/io/io.py``: DataIter/DataBatch/DataDesc, NDArrayIter,
ResizeIter, PrefetchingIter, CSVIter).  The record-file iterator is
:mod:`.record_iter` over the port's native decode pool, the
device-resident infeed :mod:`.pipeline`.  Batches are NDArrays on the CPU
context, as a reference-MXNet iterator gives them; moving them to the card
is the consumer's (or ``DataPipeline``'s) work.
"""
from __future__ import annotations

import threading
import queue as _queue
from time import perf_counter as _perf

import numpy as _np
import torch

from .. import profiler as _profiler
from ..context import cpu as _cpu
from ..ndarray.ndarray import NDArray, _canonical, _wrap

__all__ = [
    "DataDesc",
    "DataBatch",
    "DataIter",
    "NDArrayIter",
    "ResizeIter",
    "PrefetchingIter",
    "CSVIter",
]


def host_array(arr):
    """A numpy array as an NDArray on the CPU context, sharing its memory
    where it can (a read-only array is copied): numpy's 64-bit dtypes become
    32-bit, as ``nd.array`` makes them."""
    arr, cast = _canonical(_np.asarray(arr))
    arr = _np.ascontiguousarray(arr)
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if cast is not None:
        t = t.to(cast)
    return _wrap(t, _cpu())


class DataDesc:
    """Shape/dtype descriptor of one input (parity: ``DataDesc`` — a
    namedtuple in the reference; kept a small class for layout attrs)."""

    __slots__ = ("name", "shape", "dtype", "layout")

    def __init__(self, name, shape, dtype=_np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = _np.dtype(dtype)
        self.layout = layout

    def __iter__(self):  # tuple-unpacking compat: name, shape
        return iter((self.name, self.shape))

    def __getitem__(self, i):
        return (self.name, self.shape, self.dtype, self.layout)[i]

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One minibatch: lists of data/label NDArrays + padding bookkeeping."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return f"DataBatch: data shapes {shapes} pad {self.pad}"


class DataIter:
    """Iterator contract (parity: ``mx.io.DataIter``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """Normalize data argument to list of (name, ndarray) (parity:
    ``_init_data`` in the reference)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (NDArray, _np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("data cannot be empty")
        data = {(default_name if i == 0 and len(data) == 1 else f"_{i}_{default_name}"): d
                for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("data must be NDArray, numpy array, list or dict")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """In-memory iterator (parity: ``mx.io.NDArrayIter``), incl.
    ``last_batch_handle`` = 'pad' | 'discard' | 'roll_over' and shuffle.

    ``num_parts``/``part_index`` (the upstream record-iterator sharding
    kwargs, shared with :class:`ImageRecordIter`) restrict the iterator to
    one host's shard: the FULL index space is permuted with a seed every
    host agrees on (``seed``; the RNG stream advances per epoch, so the
    permutation is epoch-aware yet identical across hosts) and each part
    takes a disjoint contiguous slice of it.  Uneven totals are an error
    unless ``allow_pad=True``, which wraps the tail so every part sees
    the same number of samples (SPMD hosts must agree on batch counts).
    This is the single sharding surface ``io.DataPipeline`` plumbs
    through."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0,
                 allow_pad=False, seed=0):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        if self.num_parts < 1 or not 0 <= self.part_index < self.num_parts:
            raise ValueError(
                f"part_index {part_index} out of range for num_parts "
                f"{num_parts}")
        total = self.data[0][1].shape[0]
        self._total = total
        if self.num_parts > 1:
            if total % self.num_parts != 0 and not allow_pad:
                raise ValueError(
                    f"{total} samples do not divide evenly over "
                    f"{self.num_parts} parts ({total % self.num_parts} "
                    "left over); pass allow_pad=True to wrap the tail so "
                    "every host sees the same number of samples")
            self._part_n = -(-total // self.num_parts)  # ceil
        else:
            self._part_n = total
        self.num_data = self._part_n
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._carry = _np.array([], dtype=_np.int64)  # roll_over leftovers
        self._consumed = 0  # index into _order just past the last returned batch
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self._rng = _np.random.RandomState(seed)
        self._order = self._epoch_order()

    def _epoch_order(self):
        """One epoch's index order for THIS part: permute the full index
        space (advancing the shared RNG stream exactly once per epoch on
        every host), then slice this part's window, wrapping modulo the
        total when ``allow_pad`` made the parts oversized."""
        base = _np.arange(self._total)
        if self.shuffle:
            self._rng.shuffle(base)
        if self.num_parts == 1:
            return base
        pos = _np.arange(self.part_index * self._part_n,
                         (self.part_index + 1) * self._part_n) % self._total
        return base[pos]

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over":
            # unconsumed tail rolls into the next epoch's first batch
            # (parity: the reference defers the partial batch, it does NOT
            # pad it — padding would double-count samples in metrics).
            # ``_consumed`` tracks the position just past the last batch
            # actually returned, which neither the mid-epoch cursor (start
            # of the last batch) nor the post-exhaustion cursor can both
            # provide; a reset before any batch carries nothing.
            if 0 < self._consumed < len(self._order):
                self._carry = self._order[self._consumed:]
            else:
                self._carry = _np.array([], dtype=_np.int64)
        self.cursor = -self.batch_size
        self._consumed = 0
        base = self._epoch_order()
        self._order = _np.concatenate([self._carry, base]) if len(self._carry) else base

    def state_dict(self):
        """Everything needed to resume THIS iterator mid-epoch with the
        exact remaining batch sequence (the elastic run snapshots of
        ROADMAP §1 item 9 read it): the cursor pair, the
        roll_over carry, the epoch's materialized index order, and the
        shared RNG stream so every FUTURE epoch re-permutes identically
        on every host."""
        return {
            "kind": "NDArrayIter",
            "cursor": int(self.cursor),
            "consumed": int(self._consumed),
            "carry": self._carry.copy(),
            "order": self._order.copy(),
            "rng": self._rng.get_state(),
            "num_parts": self.num_parts,
            "part_index": self.part_index,
        }

    def load_state_dict(self, state):
        """Restore :meth:`state_dict` output.  The iterator must be built
        over the same data with the same batch_size/sharding — the saved
        order indexes the ORIGINAL arrays; a part-layout mismatch raises
        (an elastic resize must restart the epoch instead)."""
        if state.get("kind") not in (None, "NDArrayIter"):
            raise ValueError(
                f"not an NDArrayIter state: {state.get('kind')!r}")
        if (int(state.get("num_parts", self.num_parts)) != self.num_parts
                or int(state.get("part_index", self.part_index))
                != self.part_index):
            raise ValueError(
                "sharding layout changed: saved part "
                f"{state.get('part_index')}/{state.get('num_parts')}, this "
                f"iterator is part {self.part_index}/{self.num_parts}")
        self.cursor = int(state["cursor"])
        self._consumed = int(state["consumed"])
        self._carry = _np.asarray(state["carry"], dtype=_np.int64)
        self._order = _np.asarray(state["order"])
        self._rng.set_state(state["rng"])

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle in ("discard", "roll_over"):
            ok = self.cursor + self.batch_size <= len(self._order)
        else:
            ok = self.cursor < self.num_data
        if ok:
            self._consumed = min(self.cursor + self.batch_size, len(self._order))
        return ok

    def _slice(self, arrays):
        out = []
        total = len(self._order)
        for _, arr in arrays:
            lo = self.cursor
            hi = self.cursor + self.batch_size
            if hi <= total:
                idx = self._order[lo:hi]
            else:  # pad by wrapping (parity: 'pad' repeats head samples)
                idx = _np.concatenate([self._order[lo:],
                                       self._order[: hi - total]])
            out.append(host_array(arr[idx]))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        hi = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and hi > self.num_data:
            return hi - self.num_data
        return 0

    def getindex(self):
        hi = min(self.cursor + self.batch_size, self.num_data)
        return self._order[self.cursor:hi]


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch (parity:
    ``mx.io.ResizeIter``; loops the underlying iter if needed)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double-buffer prefetch on a worker thread (parity:
    ``mx.io.PrefetchingIter`` / the C++ ThreadedIter — [U:src/io/
    iter_prefetcher.h]).  Overlaps host batch prep with device compute.

    Lifecycle: :meth:`close` (also the context-manager exit and
    ``__del__``) stops and joins the worker — an iterator abandoned
    mid-epoch no longer leaks its daemon thread and queued batches.
    ``depth`` defaults from ``MXNET_IO_PREFETCH_DEPTH`` (2).  For a
    device-resident infeed use :class:`~incubator_mxnet_torch.io.pipeline.
    DataPipeline` instead."""

    def __init__(self, iters, rename_data=None, rename_label=None, depth=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        if len(iters) != 1:
            raise NotImplementedError("composite prefetch not supported; pass one iter")
        if depth is None:
            depth = _profiler._env_int("MXNET_IO_PREFETCH_DEPTH", 2)
        self.data_iter = iters[0]
        self._depth = max(1, depth)
        self._queue = None
        self._stop = None
        self._thread = None
        self.current_batch = None
        self._start()

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def _worker(self, q, stop):
        # q/stop are THIS generation's, captured at thread start: a worker
        # that outlives a timed-out close() (stuck in data_iter.next())
        # keeps talking to its orphaned queue and set stop flag, never to
        # a restarted iterator's
        while not stop.is_set():
            err = None
            try:
                t0 = _perf() if _profiler._active else None
                batch = self.data_iter.next()
                if t0 is not None:
                    _profiler.record_span("io.prefetch", "io", t0)
                _profiler.incr("io_prefetch_batches")
            except StopIteration:
                batch = None
            except BaseException as e:  # noqa: BLE001 — any failure must
                # still enqueue a sentinel, or the consumer's blocking
                # queue.get() hangs forever; re-raised in iter_next()
                batch, err = None, e
            # bounded put that notices reset(): never blocks forever with a
            # stale pre-reset batch (that race duplicated epoch tails)
            item = (batch, err)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    break
                except _queue.Full:
                    continue
            if batch is None:
                return

    def _start(self):
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._stop), daemon=True)
        self._thread.start()

    def close(self, timeout=10.0):
        """Stop the worker and drain its queue (no pre-close batch
        survives).  Idempotent; safe after partial consumption — the
        worker may be blocked on a full queue and is drained out.

        BOUNDED: this also runs from ``__del__`` (possibly on the GC's
        thread), so a worker stuck inside ``data_iter.next()`` — which
        has no cancellation point — must not hang the caller forever.
        Past ``timeout`` the daemon worker is abandoned with its stop
        flag set and its (orphaned, per-generation) queue; it exits on
        its own the moment the blocked ``next()`` returns."""
        if self._thread is None:
            return
        self._stop.set()
        # drain until the worker exits so no stale batch survives
        deadline = _perf() + timeout
        while self._thread.is_alive() and _perf() < deadline:
            try:
                self._queue.get(timeout=0.05)
            except _queue.Empty:
                pass
        self._thread.join(timeout=max(0.0, deadline - _perf()))
        self._thread = None
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.data_iter.reset()
        self._start()  # fresh queue + stop event per generation

    def iter_next(self):
        if self._thread is None:
            # closed: the worker is joined and its queue drained — a
            # blocking get() here would hang forever, never error
            raise RuntimeError(
                "PrefetchingIter is closed; call reset() to restart")
        batch, err = self._queue.get()
        if err is not None:
            raise err
        if batch is None:
            return False
        self.current_batch = batch
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class CSVIter(DataIter):
    """CSV reader (parity: [U:src/io/iter_csv.cc] exposed as mx.io.CSVIter).
    Loads into memory then delegates to NDArrayIter semantics."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        self._iter = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            data_name="data", label_name="label")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()

    def iter_next(self):
        return self._iter.iter_next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getpad(self):
        return self._iter.getpad()

    def getindex(self):
        return self._iter.getindex()
