"""``DataPipeline``: the threaded input pipeline that hands device-resident
batches to the card, with autotuned prefetch depth.

Counterpart of the JAX package's ``io/pipeline.py``.  ``PrefetchingIter``
(io.py) overlaps host batch prep with compute on one thread but hands back
host arrays, so every step then pays a host-to-device copy on the
consumer's stream.  ``DataPipeline`` moves that work off the consumer:

1. **Multi-worker host-side prep**: a pool of threads runs ``prep_fn``
   (decode/augment) off the consumer thread; a reader thread sequences the
   source, and an order-restoring transfer thread delivers in exactly
   source order, whichever worker finishes first.
2. **Per-host data sharding**: ``num_parts``/``part_index`` (defaulting to
   the ``torch.distributed`` world and rank) ride the same kwargs
   ``NDArrayIter``/``ImageRecordIter`` take, so each rank reads only its
   shard; sources that do not speak the contract are batch-strided.
3. **Asynchronous host-to-card staging**: the transfer thread copies each
   batch into a ring of pinned host buffers (a buffer is written again
   only after the copy that last read it has completed) and from there to
   the card with ``copy_(non_blocking=True)`` on a CUDA stream of the
   pipeline's own, then records an event.  ``next()`` makes the
   consumer's current stream wait on that event and marks every delivered
   tensor with ``record_stream`` of the consumer's stream, so the caching
   allocator never hands the block back to the copy stream while the
   consumer still reads it.  ``SPMDTrainer.shard_batch`` passes a tensor
   already on the rank's device straight through (no ``spmd.shard_batch``
   span), and the step fold's static-buffer copies read it on the
   consumer's stream.  Placement is pure data parallelism, the rank's
   device: ``sp_axis`` (and tp/fsdp/sp meshes, which ``make_mesh``
   refuses) wait in ROADMAP §1 item 6b.
4. **Autotuned prefetch depth**: a feedback loop reads the rolling
   host/device split from ``profiler.step_stats()`` and the pipeline's own
   consumer-stall counter: while steps are host-bound the depth rises (up
   to ``max_depth``); it backs off when the estimated buffer footprint
   would exceed ``memory_budget_mb`` or the card reports memory pressure
   (``profiler.memory_budget()``).

Observability: ``io.prep`` / ``io.transfer`` / ``io.wait`` spans (the
``data_wait`` goodput bucket reads ``io.wait``), the declared
``io_pipeline_*`` counters, and a metrics provider (buffer occupancy and
bytes, depth, consumer-stall p50/p99).

Threading contract: ``__next__``/``reset``/``close`` are consumer-thread
calls; every host-to-card copy happens on the single transfer thread.
Worker threads touch only host memory.
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as _np
import torch

from .. import profiler as _profiler
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, _canonical, _wrap
from .io import DataBatch

__all__ = ["DataPipeline"]

_perf = time.perf_counter

_env_float = _profiler._env_float
_env_int = _profiler._env_int

# pinned host buffers the transfer thread cycles through: one is filled
# while the copy out of the other runs
_STAGING_SLOTS = 2


class _EOS:
    """End-of-epoch sentinel carried through the stages in sequence order."""

    __slots__ = ()


_EOS = _EOS()

_name_lock = threading.Lock()
_name_seq = 0


def _default_name():
    """Unique per-process default provider key: a second default-named
    pipeline must not silently replace the first's gauges on the metrics
    surface (and closing one must not unregister the survivor's).  The
    first pipeline keeps the stable name ``io_pipeline`` — the common
    one-pipeline deployment gets stable Prometheus gauge names."""
    global _name_seq
    with _name_lock:
        _name_seq += 1
        n = _name_seq
    return "io_pipeline" if n == 1 else f"io_pipeline{n}"


def _host(a):
    """One leaf as a tensor: NDArrays and tensors give theirs, anything
    else goes through numpy (64-bit dtypes to 32-bit, as ``nd.array``)."""
    if isinstance(a, NDArray):
        return a._data.detach()
    if isinstance(a, torch.Tensor):
        return a.detach()
    arr, cast = _canonical(_np.asarray(a))
    t = torch.from_numpy(_np.ascontiguousarray(arr))
    return t.to(cast) if cast is not None else t


def _leaves(batch):
    """Flatten one source item into (leaves, rebuild) where ``leaves`` is a
    list of tensors (on the host, unless the source made them elsewhere)
    and ``rebuild(new_leaves)`` reassembles the item with the leaves
    replaced by their placed counterparts.  Type affinity is kept: numpy
    and tensors in give tensors out, NDArray / DataBatch in give NDArrays
    out."""
    if isinstance(batch, DataBatch):
        n_data = len(batch.data or [])
        arrs = list(batch.data or []) + list(batch.label or [])
        leaves = [_host(a) for a in arrs]

        def rebuild(new):
            wrapped = [_wrap(a) for a in new]
            return DataBatch(wrapped[:n_data], wrapped[n_data:] or None,
                             pad=batch.pad, index=batch.index,
                             bucket_key=batch.bucket_key,
                             provide_data=batch.provide_data,
                             provide_label=batch.provide_label)

        return leaves, rebuild
    if isinstance(batch, dict):
        keys = list(batch)
        leaves = [_host(batch[k]) for k in keys]
        wrap = [isinstance(batch[k], NDArray) for k in keys]

        def rebuild(new):
            return {k: (_wrap(a) if w else a)
                    for k, a, w in zip(keys, new, wrap)}

        return leaves, rebuild
    if isinstance(batch, (list, tuple)):
        leaves = [_host(a) for a in batch]
        wrap = [isinstance(a, NDArray) for a in batch]
        cls = type(batch)

        def rebuild(new):
            return cls(_wrap(a) if w else a for a, w in zip(new, wrap))

        return leaves, rebuild
    if isinstance(batch, NDArray):
        return [_host(batch)], lambda new: _wrap(new[0])
    return [_host(batch)], lambda new: new[0]


def _rows_compatible(a, b):
    """Whether two batches' leaf lists np.stack into one window."""
    return (len(a) == len(b)
            and all(x.shape == y.shape and x.dtype == y.dtype
                    for x, y in zip(a, b)))


class _StagingSlot:
    """Pinned host buffers for one batch's leaves (flat bytes, grown to the
    largest leaf seen at each position) and the event of the copy that last
    read them."""

    __slots__ = ("buffers", "event")

    def __init__(self):
        self.buffers = []
        self.event = None

    def fill(self, leaves):
        """Copy host leaves into the pinned buffers, once the last copy out
        of them has completed; returns a pinned view a leaf (None for a
        leaf that is not on the host)."""
        if self.event is not None:
            self.event.synchronize()
        out = []
        for i, t in enumerate(leaves):
            if t.device.type != "cpu":
                out.append(None)
                continue
            n = t.numel() * t.element_size()
            if i == len(self.buffers):
                self.buffers.append(None)
            buf = self.buffers[i]
            if buf is None or buf.numel() < n:
                buf = self.buffers[i] = torch.empty(max(n, 1), dtype=torch.uint8,
                                                    pin_memory=True)
            view = buf[:n].view(t.dtype).view(t.shape)
            view.copy_(t)
            out.append(view)
        return out


class _Engine:
    """The threaded core of :class:`DataPipeline`.  Separated from the
    user-facing facade because the stage threads hold bound-method
    references to their owner: were the stages methods of the public
    object, an abandoned pipeline could never be garbage-collected and
    ``__del__``-based cleanup would be dead code.  Threads reference the
    engine; only the user references the facade — dropping the facade
    fires its ``__del__``, which closes the engine and joins the threads.

    Parameters
    ----------
    source : DataIter, iterable, or callable returning an iterator
        Batches may be ``DataBatch``, (tuples/lists/dicts of) numpy
        arrays or NDArrays, or single arrays.  A ``DataIter`` is
        ``reset()`` per epoch; a callable is invoked per epoch (the
        re-iterable contract for generators); a plain iterable must be
        re-iterable for multi-epoch use.
    prep_fn : callable(batch) -> batch, optional
        Host-side decode/augment, run on the worker pool (host memory
        only: the transfer thread owns the device).
    mesh : parallel.Mesh, optional
        Target mesh.  Defaults to the ambient ``mesh_scope`` mesh; batches
        land on its device, this rank's (pure dp: each rank holds its own
        rows).  With no mesh they land on ``device``: a ``Context``, a
        ``torch.device`` or its name, default the current context (the
        card, which raises on a machine without one).
    sp_axis : int, optional
        Sequence-parallel placement: waits in ROADMAP §1 item 6b (raises
        unless None).
    num_workers : int
        Prep worker threads (env ``MXNET_IO_NUM_WORKERS``, default 2).
    depth : int
        Initial device-buffer depth (env ``MXNET_IO_PREFETCH_DEPTH``,
        default 2 — double buffering).
    max_depth : int
        Autotune ceiling (env ``MXNET_IO_MAX_DEPTH``, default 8).
    autotune : bool
        Enable the depth feedback loop (env ``MXNET_IO_AUTOTUNE``,
        default on).  When off, ``depth`` is fixed.
    memory_budget_mb : float, optional
        Cap on the estimated device-buffer footprint
        (``depth × batch_bytes``); the autotuner never raises past it
        and backs off when a depth no longer fits (env
        ``MXNET_IO_MEM_BUDGET_MB``; unset = uncapped).
    num_parts, part_index : int, optional
        Per-host sharding.  Default the ``torch.distributed`` world size
        and rank (1 and 0 without a process group).  A source that already carries matching
        ``num_parts``/``part_index`` attributes (NDArrayIter,
        ImageRecordIter) reads only its shard and the pipeline passes
        every batch through; mismatched source sharding is an error;
        sources without the contract are batch-strided
        (``part_index::num_parts``).
    name : str
        Metrics-provider key (Prometheus gauges ``mxnet_<name>_*``).
        Default: ``io_pipeline``, auto-suffixed per process so concurrent
        default-named pipelines never clobber each other's gauges.
    """

    def __init__(self, source, *, prep_fn=None, mesh=None, sp_axis=None,
                 num_workers=None, depth=None, max_depth=None, autotune=None,
                 memory_budget_mb=None, num_parts=None, part_index=None,
                 device=None, name=None, autostart=True,
                 _step_stats_fn=None, _device_pressure_fn=None):
        from ..parallel.mesh import _world, current_mesh

        if sp_axis is not None:
            raise NotImplementedError(
                f"DataPipeline(sp_axis={sp_axis}): sequence placement of batches waits in "
                "ROADMAP §1 item 6b (the port's mesh is pure data parallel)")
        self._source = source
        self._prep_fn = prep_fn
        self._mesh = mesh if mesh is not None else current_mesh()
        self._sp_axis = sp_axis
        if self._mesh is not None:
            wide = {a: n for a, n in self._mesh.shape.items() if a != "dp" and n > 1}
            if wide:
                raise NotImplementedError(
                    f"DataPipeline on a mesh with {wide}: only the data-parallel axis is "
                    "ported; tp/fsdp/sp placement of batches waits in ROADMAP §1 item 6b")
            self._device = self._mesh.device
        elif device is None:
            self._device = current_context().device
        elif isinstance(device, Context):
            self._device = device.device
        else:
            self._device = torch.device(device)
        self._stream = None          # the copy stream (CUDA targets), made by
        self._slots = []             # the transfer thread with its pinned ring
        self._slot_pos = 0
        self.name = str(name) if name is not None else _default_name()

        self._num_workers = max(1, int(
            num_workers if num_workers is not None
            else _env_int("MXNET_IO_NUM_WORKERS", 2)))
        self._min_depth = 2          # double buffering is the floor
        self._depth = max(self._min_depth, int(
            depth if depth is not None
            else _env_int("MXNET_IO_PREFETCH_DEPTH", 2)))
        self._max_depth = max(self._depth, int(
            max_depth if max_depth is not None
            else _env_int("MXNET_IO_MAX_DEPTH", 8)))
        self._autotune = bool(
            autotune if autotune is not None
            else _env_int("MXNET_IO_AUTOTUNE", 1))
        budget = (memory_budget_mb if memory_budget_mb is not None
                  else _env_float("MXNET_IO_MEM_BUDGET_MB", 0.0))
        self._budget_bytes = float(budget) * (1 << 20) if budget else None
        self._hbm_frac = _env_float("MXNET_IO_HBM_FRAC", 0.9)
        self._tune_interval = max(1, _env_int("MXNET_IO_TUNE_INTERVAL", 4))
        self._host_bound_frac = _env_float("MXNET_IO_HOST_BOUND_FRAC", 0.5)
        self._step_stats_fn = _step_stats_fn or _profiler.step_stats
        self._device_pressure_fn = (_device_pressure_fn
                                    or self._default_device_pressure)

        # -- per-host sharding ----------------------------------------
        world, rank = _world()
        if num_parts is None:
            num_parts = world
        if part_index is None:
            # also the default for an EXPLICIT num_parts: defaulting to 0
            # here would silently hand every host shard 0 (4x-duplicated
            # data, no error) the moment a caller passes num_parts alone
            part_index = rank
        part_index = int(part_index)
        num_parts = int(num_parts)
        if not 0 <= part_index < num_parts:
            raise ValueError(
                f"part_index {part_index} out of range for num_parts "
                f"{num_parts}")
        self.num_parts = num_parts
        self.part_index = part_index
        src_parts = getattr(source, "num_parts", None)
        if src_parts is not None and int(src_parts) > 1:
            # the source already reads only its shard — never re-stride
            src_idx = int(getattr(source, "part_index", 0))
            if (int(src_parts), src_idx) != (num_parts, part_index):
                raise ValueError(
                    f"source is sharded {src_idx}/{src_parts} but the "
                    f"pipeline wants {part_index}/{num_parts}; pass "
                    "matching num_parts/part_index to exactly one of them")
            self._stride = False
        else:
            self._stride = num_parts > 1

        # -- stage state -----------------------------------------------
        self._lock = threading.Lock()
        self._buf_cond = threading.Condition(self._lock)
        self._ready_cond = threading.Condition(self._lock)
        self._buf = []               # device-resident items, delivery order
        self._ready = {}             # seq -> (prepped_batch, exc)
        self._prep_q = None          # (seq, raw_batch) feed to the workers
        self._threads = []
        self._stop = threading.Event()
        self._started = False
        self._closed = False
        self._finished = False       # epoch exhausted; reset() rearms
        self._epoch = 0
        self._resume_skip = 0        # one-shot: post-stride batches the
                                     # next epoch's reader drops (cursor
                                     # resume — load_state_dict)
        self._resume_resets = 0      # one-shot: extra source resets that
                                     # replay the shuffle stream up to the
                                     # snapshot epoch
        self._gen = 0                # bumped per start(): a zombie stage
                                     # thread that outlived close()'s join
                                     # timeout (prep_fn stuck) can never
                                     # publish into a newer epoch's tables
        self._window = 1             # K-step fold window: the transfer
                                     # thread stacks this many source
                                     # batches into ONE [K, ...] device
                                     # item (stage_window / set_window)

        self._zombies = []

        # -- telemetry -------------------------------------------------
        self._n_batches = 0          # delivered device-resident
        self._n_stalls = 0           # __next__ arrivals finding buf empty
        self._warm_stalls = 0        # stalls AFTER the epoch's buffer had
                                     # filled once — the only ones the
                                     # autotuner feeds on (the consumer's
                                     # unavoidable arrival at a refilling
                                     # epoch-start buffer would otherwise
                                     # ratchet depth to max over epochs)
        self._epoch_batches = 0      # delivered this epoch (warm gate)
        self._stalls_at_tune = 0
        self._since_tune = 0
        self._batch_bytes = 0        # last transferred batch footprint
        self._bytes_total = 0
        self._stall_ms = []          # recent stall durations, capped
        self._stall_cap = 2048
        self._depth_changes = 0
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        """Spin up reader + prep workers + transfer thread.  Idempotent."""
        with self._lock:
            if self._started:
                return self
            if self._closed:
                raise RuntimeError("pipeline is closed")
            zombies = [t for t in getattr(self, "_zombies", ())
                       if t.is_alive()]
            if any(t.name.endswith("-reader") for t in zombies):
                # the _gen guard keeps a zombie's RESULTS out of the new
                # epoch, but nothing can stop it mid-call inside the
                # source's next(): restarting now would have two readers
                # mutating one source's cursor state — fail loudly
                raise RuntimeError(
                    "previous epoch's reader thread is still blocked "
                    "inside the source; cannot restart the pipeline over "
                    "a source another thread holds")
            self._zombies = zombies
            self._started = True
            self._stop.clear()
            self._buf = []
            self._ready = {}
            self._gen += 1
            # a resumed epoch starts its delivered-count at the snapshot
            # cursor, so a LATER snapshot of the same epoch stays exact
            skip, self._resume_skip = self._resume_skip, 0
            resets, self._resume_resets = self._resume_resets, 0
            self._epoch_batches = skip
            gen = self._gen
        q = self._prep_q = _queue.Queue(maxsize=self._num_workers * 2)
        self._threads = []
        t = threading.Thread(target=self._reader, args=(q, gen, skip, resets),
                             daemon=True,
                             name=f"mxnet-{self.name}-reader")
        self._threads.append(t)
        for i in range(self._num_workers):
            w = threading.Thread(target=self._prep_worker, args=(q, gen),
                                 daemon=True,
                                 name=f"mxnet-{self.name}-prep{i}")
            self._threads.append(w)
        x = threading.Thread(target=self._transfer, args=(gen,), daemon=True,
                             name=f"mxnet-{self.name}-transfer")
        self._threads.append(x)
        # device-memory ledger: this pipeline's infeed buffer occupancy
        # (alloc on transfer-in, free on consumer pop; name is per-
        # pipeline unique, so trackers never collide).  Created BEFORE
        # the threads start — the transfer stage accounts its first batch
        self._mem = _profiler.track_memory(f"io.{self.name}", "infeed")
        for t in self._threads:
            t.start()
        _profiler.register_metrics_provider(self.name, self._provider)
        return self

    def close(self):
        """Stop all stages, drain queues, and join every thread.  The
        metrics provider is unregistered so a dead pipeline's gauges
        leave the scrape surface.  Idempotent; also runs from
        ``__del__`` so an abandoned pipeline leaks no threads."""
        with self._lock:
            if self._closed and not self._started:
                return
            self._started = False
            self._closed = True
        self._stop.set()
        with self._buf_cond:
            self._buf_cond.notify_all()
            self._ready_cond.notify_all()
        # unblock a reader parked on a full prep queue
        if self._prep_q is not None:
            try:
                while True:
                    self._prep_q.get_nowait()
            except _queue.Empty:
                pass
        cur = threading.current_thread()
        for t in self._threads:
            if t is not cur:
                t.join(timeout=30.0)
        # a thread that outlived its join (prep_fn/source read stuck) is
        # remembered: restarting while the old READER still holds the
        # shared source would let two threads mutate its cursor state
        self._zombies = [t for t in self._threads
                         if t is not cur and t.is_alive()]
        self._threads = []
        with self._lock:
            self._buf = []
            self._ready = {}
        _profiler.unregister_metrics_provider(self.name)
        mem = getattr(self, "_mem", None)
        if mem is not None:
            mem.close()   # buffered bytes leave the ledger with the buffer

    def reset(self):
        """End the epoch: stop the stages, reset/re-open the source, and
        restart with an empty buffer (no pre-reset batch survives)."""
        self.close()
        with self._lock:
            self._closed = False
            self._finished = False
        self._epoch += 1
        self.start()

    # ------------------------------------------------------------------
    # cursor resume (elastic run snapshots)
    # ------------------------------------------------------------------
    def state_dict(self):
        """The CONSUMER's cursor — epoch and batches delivered this
        epoch.  Deliberately not the reader's position: the reader runs
        ahead, and snapshotting its source state would lose the batches
        buffered but not yet delivered.  Resume replays instead (see
        ``load_state_dict``), which is exact for any deterministic
        seeded source."""
        with self._lock:
            return {"kind": "DataPipeline",
                    "epoch": self._epoch,
                    "delivered": self._epoch_batches}

    def load_state_dict(self, state):
        """Arm the next ``start()`` to resume mid-epoch: the source is
        reset forward to the snapshot epoch (replaying its seeded
        shuffle stream — the pipeline must wrap a FRESHLY-built source
        identical to the original run's), and the reader drops the first
        ``delivered`` post-stride batches, so the consumer sees exactly
        the remaining batch sequence — same permutation, no duplicates,
        no omissions.  Call before the pipeline starts (build it with
        ``autostart=False``)."""
        if state.get("kind") not in (None, "DataPipeline"):
            raise ValueError(
                f"not a DataPipeline state: {state.get('kind')!r}")
        with self._lock:
            if self._started:
                raise RuntimeError(
                    "load_state_dict before start(): the reader already "
                    "consumed source batches this epoch")
            epoch = int(state["epoch"])
            self._epoch = epoch
            self._resume_skip = int(state["delivered"])
            # _open_epoch itself resets once when epoch > 0; a fresh
            # source needs epoch resets total to reach this epoch's
            # permutation
            self._resume_resets = max(0, epoch - 1) if epoch > 0 else 0

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def _open_epoch(self, extra_resets=0):
        src = self._source
        if callable(src) and not hasattr(src, "next") \
                and not hasattr(src, "__next__"):
            return iter(src())
        if hasattr(src, "reset") and hasattr(src, "next"):
            if self._epoch > 0 or getattr(self, "_source_used", False):
                src.reset()
            # cursor resume: a freshly-built source sits at epoch 0 — the
            # extra resets replay its (deterministic, seeded) shuffle
            # stream forward to the snapshot epoch's permutation
            for _ in range(extra_resets):
                src.reset()
            self._source_used = True
            return iter(src)
        self._source_used = True
        return iter(src)

    def _dead(self, gen):
        return self._stop.is_set() or gen != self._gen

    def _reader(self, q, gen, skip=0, extra_resets=0):
        """Single sequencer: pulls source batches in order, applies the
        batch-stride shard filter, and assigns each surviving batch the
        seq its delivery position demands.  ``skip`` drops the first N
        post-stride batches — cursor resume replays the epoch up to the
        snapshot point (stride phase included: the dropped batches are
        still pulled from the source, so a shared strided source stays
        aligned across parts)."""
        seq = 0
        skipped = 0
        try:
            it = self._open_epoch(extra_resets)
            for i, batch in enumerate(it):
                if self._dead(gen):
                    return
                if self._stride and i % self.num_parts != self.part_index:
                    continue
                if skipped < skip:
                    skipped += 1
                    continue
                self._put_prep(q, gen, (seq, batch, None))
                seq += 1
        except BaseException as e:  # noqa: BLE001 — delivered in order
            self._put_prep(q, gen, (seq, None, e))
            seq += 1
        self._put_prep(q, gen, (seq, _EOS, None))

    def _put_prep(self, q, gen, item):
        while not self._dead(gen):
            try:
                q.put(item, timeout=0.05)
                return
            except _queue.Full:
                continue

    def _prep_worker(self, q, gen):
        while not self._dead(gen):
            try:
                seq, batch, err = q.get(timeout=0.05)
            except _queue.Empty:
                continue
            if batch is _EOS:
                # re-queue for siblings, then park: the transfer thread is
                # the one that acts on EOS, in sequence order
                self._put_prep(q, gen, (seq, _EOS, None))
                self._publish(gen, seq, _EOS, None)
                return
            if err is None and self._prep_fn is not None:
                t0 = _perf() if _profiler._active else None
                try:
                    batch = self._prep_fn(batch)
                except BaseException as e:  # noqa: BLE001
                    batch, err = None, e
                if t0 is not None:
                    _profiler.record_span("io.prep", "io", t0)
            self._publish(gen, seq, batch, err)

    def _publish(self, gen, seq, batch, err):
        with self._ready_cond:
            if gen != self._gen:
                return  # zombie from a pre-reset generation
            if seq not in self._ready:  # EOS may be re-published by siblings
                self._ready[seq] = (batch, err)
            self._ready_cond.notify_all()

    def _transfer(self, gen):
        """Order-restoring device stage: waits for the next seq, moves it
        host→device, and parks it in the depth-bounded buffer.  With a
        window K > 1 (``set_window``/``stage_window``) it first np.stacks
        K consecutive prepped batches into ONE ``[K, ...]`` item and
        ships that — the K-step fold's pre-staged batch window, built
        entirely off the consumer thread.  An epoch tail (or the batches
        before an in-stream error) still ships, as a short window."""
        next_seq = 0
        window = max(1, int(self._window))
        pend = []    # prepped (leaves, rebuild) rows awaiting a window

        def emit(batch, err, nbytes, count, ready=None):
            # depth-bounded put that notices close(); False = stage died
            with self._buf_cond:
                while len(self._buf) >= self._depth \
                        and not self._dead(gen):
                    self._buf_cond.wait(timeout=0.05)
                if self._dead(gen):
                    return False
                if nbytes:
                    # alloc BEFORE the append becomes visible: a consumer
                    # racing next() could otherwise pop-and-free first and
                    # drive the tracker transiently negative
                    self._mem.alloc(nbytes)
                self._buf.append((batch, err, nbytes, count, ready))
                self._buf_cond.notify_all()
            return True

        def place_and_emit(item, count):
            # item: a raw batch (window == 1) or the pending rows list
            nbytes, err, ready = 0, None, None
            t0 = _perf() if _profiler._active else None
            try:
                if window == 1:
                    batch, nbytes, ready = self._place(item)
                else:
                    leaves = [torch.stack([r[0][i] for r in item])
                              for i in range(len(item[0][0]))]
                    batch, nbytes, ready = self._place_leaves(leaves, item[0][1])
            except BaseException as e:  # noqa: BLE001
                batch, err, nbytes, ready = None, e, 0, None
            if t0 is not None:
                args = {"bytes": nbytes}
                if window > 1:
                    args["window"] = count
                _profiler.record_span("io.transfer", "io", t0, args=args)
            if err is None:
                _profiler.incr("io_pipeline_bytes", nbytes)
                with self._lock:
                    self._batch_bytes = nbytes or self._batch_bytes
                    self._bytes_total += nbytes
            return emit(batch, err, nbytes, count, ready)

        def flush_pend():
            if not pend:
                return True
            rows, pend[:] = pend[:], []
            return place_and_emit(rows, len(rows))

        while True:
            with self._ready_cond:
                while next_seq not in self._ready and not self._dead(gen):
                    self._ready_cond.wait(timeout=0.05)
                if self._dead(gen):
                    return
                batch, err = self._ready.pop(next_seq)
            next_seq += 1
            if err is None and batch is not _EOS:
                if window == 1:
                    if not place_and_emit(batch, 1):
                        return
                else:
                    try:
                        leaves, rebuild = _leaves(batch)
                    except BaseException as e:  # noqa: BLE001
                        if not flush_pend() or not emit(None, e, 0, 0):
                            return
                        continue
                    # a row whose leaf shapes/dtypes disagree with the
                    # pending ones cannot stack — ship them short first
                    if pend and not _rows_compatible(pend[0][0], leaves):
                        if not flush_pend():
                            return
                    pend.append((leaves, rebuild))
                    if len(pend) >= window and not flush_pend():
                        return
                _profiler.maybe_sample_memory()  # pipeline tick: keep the
                self._maybe_autotune()           # watermark/counter live
                continue
            # error or end-of-epoch: the partial window ships first, in
            # order, then the terminator itself
            if not flush_pend():
                return
            if not emit(batch, err, 0, 0):
                return
            if batch is _EOS:
                return

    def _place(self, batch):
        """Move one prepped batch's leaves to the pipeline's device."""
        leaves, rebuild = _leaves(batch)
        return self._place_leaves(leaves, rebuild)

    def _place_leaves(self, leaves, rebuild):
        """``(item, nbytes, ready)``: the leaves on the target device, and on
        a card the copy's event with the tensors it wrote, which ``next()``
        orders against the consumer's stream.  On the CPU each leaf is a
        copy the consumer owns."""
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        if self._device.type != "cuda":
            return rebuild([t.to(self._device, copy=True) for t in leaves]), nbytes, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._device)
            self._slots = [_StagingSlot() for _ in range(_STAGING_SLOTS)]
        slot = self._slots[self._slot_pos]
        self._slot_pos = (self._slot_pos + 1) % len(self._slots)
        staged = slot.fill(leaves)  # waits for the copy that last read it
        with torch.cuda.stream(self._stream):
            placed = []
            for t, host in zip(leaves, staged):
                if host is None:  # made on a card by the source: copied as it is
                    placed.append(t.to(self._device, non_blocking=True))
                    continue
                dev = torch.empty(t.shape, dtype=t.dtype, device=self._device)
                dev.copy_(host, non_blocking=True)
                placed.append(dev)
            done = torch.cuda.Event()
            done.record(self._stream)
        slot.event = done
        return rebuild(placed), nbytes, (done, placed)

    # ------------------------------------------------------------------
    # consumer side
    # ------------------------------------------------------------------
    def set_window(self, k):
        """Configure the transfer stage to stack ``k`` consecutive source
        batches into one ``[k, ...]`` device-resident window (the K-step
        fold's pre-staged input).  ``k=1`` restores per-batch delivery.
        Must be set on a window boundary of the pipeline's own stream:
        before iteration starts, or right after ``reset()`` — changing it
        after batches were delivered this epoch raises."""
        k = max(1, int(k))
        with self._lock:
            if k == self._window:
                return
            if self._started and self._epoch_batches > 0:
                raise RuntimeError(
                    "set_window mid-epoch: batches were already delivered "
                    "this epoch — set the window before iterating (or "
                    "after reset())")
            was_started = self._started
            self._window = k
        if was_started:
            # the transfer thread snapshots the window per run: restart
            # the stages so the new width takes effect (the source epoch
            # is re-opened; nothing was delivered, so nothing is lost)
            self.close()
            with self._lock:
                self._closed = False
            self.start()

    @property
    def window(self):
        return self._window

    def ensure_epoch(self):
        """Facade ``__iter__`` hook: re-entering iteration after
        exhaustion re-opens the source (python-iterable ergonomics —
        DataIter callers may still reset() explicitly)."""
        if self._finished:
            self.reset()
        elif not self._started and not self._closed:
            self.start()

    def next(self):
        with self._buf_cond:
            if self._finished:
                raise StopIteration
            if not self._started:
                raise RuntimeError("pipeline is not started (closed?)")
            if not self._buf:
                # a consumer arriving at an empty buffer IS a stall —
                # counted once per arrival, duration recorded for the
                # p50/p99 gauges; only WARM stalls (the buffer had filled
                # this epoch already) feed the autotuner
                self._n_stalls += 1
                if self._epoch_batches >= self._depth:
                    self._warm_stalls += 1
                t0 = _perf()
                while not self._buf and not self._stop.is_set():
                    self._buf_cond.wait(timeout=0.05)
                dt = _perf() - t0
                self._stall_ms.append(dt * 1e3)
                if len(self._stall_ms) > self._stall_cap:
                    del self._stall_ms[:len(self._stall_ms) - self._stall_cap]
                if self._stop.is_set() and not self._buf:
                    raise RuntimeError("pipeline closed while waiting")
                stalled_t0 = t0
            else:
                stalled_t0 = None
            batch, err, nbytes, count, ready = self._buf.pop(0)
            self._buf_cond.notify_all()
        if nbytes:
            self._mem.free(nbytes)   # the consumer owns the batch now
        if stalled_t0 is not None:
            _profiler.incr("io_pipeline_stalls")
            if _profiler._active:
                _profiler.record_span("io.wait", "io", stalled_t0)
        if ready is not None:
            # the consumer's stream waits for the copy, and each tensor's
            # block stays the consumer's until its queued work is done
            done, placed = ready
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in placed:
                t.record_stream(stream)
        if err is not None:
            raise err
        if batch is _EOS:
            with self._lock:
                self._finished = True
            raise StopIteration
        # a stacked window counts every LOGICAL batch it carries — the
        # delivered-cursor (state_dict) stays window-width agnostic
        self._n_batches += count
        self._epoch_batches += count
        _profiler.incr("io_pipeline_batches", count)
        return batch

    # ------------------------------------------------------------------
    # autotune
    # ------------------------------------------------------------------
    @property
    def depth(self):
        return self._depth

    def _fits(self, depth):
        if self._budget_bytes is None or not self._batch_bytes:
            return True
        return depth * self._batch_bytes <= self._budget_bytes

    @staticmethod
    def _default_device_pressure(frac):
        # ONE shared admission API for the whole repo (profiler.
        # MemoryBudget over profiler.device_memory_stats) instead of a
        # private memory_stats() probe: reads CURRENT bytes_in_use —
        # deliberately not peak_bytes_in_use, whose never-decaying
        # watermark would report a warmup compile spike as pressure
        # forever — against the device bytes_limit AND any explicit
        # MXNET_MEM_BUDGET_MB process budget
        try:
            return _profiler.memory_budget().under_pressure(frac)
        except Exception:
            return False  # telemetry must never take the infeed down

    def _maybe_autotune(self):
        if not self._autotune:
            return
        self._since_tune += 1
        if self._since_tune < self._tune_interval:
            return
        self._since_tune = 0
        with self._lock:
            stalls = self._warm_stalls
            depth = self._depth
        stalled = stalls > self._stalls_at_tune
        self._stalls_at_tune = stalls
        try:
            window = (self._step_stats_fn() or [])[-8:]
        except Exception:
            window = []
        wall = sum(s.get("wall_ms", 0.0) for s in window)
        host = sum(s.get("host_ms", 0.0) for s in window)
        host_bound = wall > 0 and host / wall >= self._host_bound_frac
        pressure = self._device_pressure_fn(self._hbm_frac)
        if (pressure or not self._fits(depth)) and depth > self._min_depth:
            self._set_depth(depth - 1)
        elif (host_bound or stalled) and depth < self._max_depth \
                and self._fits(depth + 1) and not pressure:
            self._set_depth(depth + 1)

    def _set_depth(self, depth):
        with self._buf_cond:
            self._depth = depth
            self._depth_changes += 1
            self._buf_cond.notify_all()  # a raise frees transfer-side room
        _profiler.incr("io_pipeline_depth_change")

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    @staticmethod
    def _pct(sorted_xs, q):
        if not sorted_xs:
            return None
        i = min(len(sorted_xs) - 1, int(q * len(sorted_xs)))
        return sorted_xs[i]

    def stats(self):
        """Live pipeline stats (also the metrics-provider payload)."""
        with self._lock:
            stall = sorted(self._stall_ms)
            return {
                "depth": self._depth,
                "max_depth": self._max_depth,
                "buffer_occupancy": len(self._buf),
                "buffer_bytes": sum(item[2] for item in self._buf),
                "window": self._window,
                "batch_bytes": self._batch_bytes,
                "bytes_total": self._bytes_total,
                "batches": self._n_batches,
                "stalls": self._n_stalls,
                "stalls_warm": self._warm_stalls,
                "stall_ms_p50": self._pct(stall, 0.50),
                "stall_ms_p99": self._pct(stall, 0.99),
                "depth_changes": self._depth_changes,
                "workers": self._num_workers,
                "num_parts": self.num_parts,
                "part_index": self.part_index,
                "epoch": self._epoch,
            }

    def _provider(self):
        return self.stats()


class DataPipeline:
    """Wrap any batch source into a device-resident, depth-autotuned async
    infeed (see the module docstring for the
    architecture and :class:`_Engine` for every parameter).

    Usage::

        pipe = DataPipeline(NDArrayIter(x, y, batch_size=512), prep_fn=augment,
                            mesh=parallel.make_mesh())
        for epoch in range(epochs):
            for batch in pipe:             # device-resident DataBatch
                trainer.step(batch.data[0], batch.label[0])

    The facade is deliberately thin: stage threads reference the inner
    engine, not this object, so abandoning a pipeline mid-epoch lets the
    GC fire ``__del__`` → ``close()`` and no thread or buffered batch
    leaks (the ``PrefetchingIter`` failure mode this subsystem retires).
    """

    def __init__(self, source, **kwargs):
        self._eng = _Engine(source, **kwargs)

    @property
    def depth(self):
        """Current autotuned device-buffer depth."""
        return self._eng.depth

    @property
    def num_parts(self):
        return self._eng.num_parts

    @property
    def part_index(self):
        return self._eng.part_index

    @property
    def name(self):
        return self._eng.name

    def start(self):
        self._eng.start()
        return self

    def set_window(self, k):
        """Stack ``k`` consecutive source batches into one ``[k, ...]``
        device-resident window per delivery (see
        :meth:`_Engine.set_window`)."""
        self._eng.set_window(k)
        return self

    @property
    def window(self):
        """Current stacking width (1 = per-batch delivery)."""
        return self._eng.window

    def stage_window(self, k=None):
        """Hand the K-step fold its next pre-staged batch window: one
        device-resident item whose leaves are ``[k, batch, ...]`` stacked
        arrays, built by the transfer thread ahead of the scan (an epoch
        tail may be shorter).  ``k`` (optional after the first call)
        configures the width via :meth:`set_window`.  Raises
        ``StopIteration`` at end of epoch; iteration restarts the next
        epoch like ``__iter__`` does::

            pipe = DataPipeline(source)
            program = trainer.fold_steps(loss_fn, k=8)
            while True:
                try:
                    window = pipe.stage_window(8)
                except StopIteration:
                    break
                loss = program(window.data[0], window.label[0])
        """
        if k is not None:
            self._eng.set_window(k)
        self._eng.ensure_epoch()
        return self._eng.next()

    def close(self):
        self._eng.close()

    def reset(self):
        self._eng.reset()

    def stats(self):
        return self._eng.stats()

    def state_dict(self):
        """Cursor snapshot for exact mid-epoch resume (see
        :meth:`_Engine.state_dict`)."""
        return self._eng.state_dict()

    def load_state_dict(self, state):
        """Arm the next epoch to resume at the snapshot cursor — call on
        a freshly-built, not-yet-started pipeline over the same source
        configuration (see :meth:`_Engine.load_state_dict`)."""
        self._eng.load_state_dict(state)

    def __iter__(self):
        self._eng.ensure_epoch()
        return self

    def __next__(self):
        return self._eng.next()

    def next(self):
        return self._eng.next()

    def __enter__(self):
        self._eng.start()
        return self

    def __exit__(self, *a):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
