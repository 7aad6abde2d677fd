"""``InferenceServer`` — continuous batching under a latency SLO.

Counterpart of the JAX package's ``serving/server.py``: **dynamic
batching** (a thread-safe request queue whose scheduler forms the largest
batch it can without letting the oldest request miss its queueing
deadline) plus **shape bucketing** (variable-length requests padded up to
a small closed set of (batch, length) buckets, so after warm-up every
batch runs an executor whose plan is already built).  Per-request spans,
declared ``serving_*`` counters, and queue depth / latency percentiles in
``profiler.metrics_snapshot()`` keep the host-side queue observable.

Threading contract: ``submit()`` is safe from any thread and touches only
numpy; ALL torch work (padding-batch dispatch, executor rebinding) happens
on the single scheduler thread, so no two threads ever race on an
executor.  That thread is the first to launch the port's kernels outside
the main thread: every tensor it makes names its device, and each kernel
launcher makes the device's context current before it encodes a TMA map.

Request model: one request is ``{input_name: sample_array}`` WITHOUT a
batch axis; the server stacks samples along a new leading batch axis.
Inputs declared with a ``None`` dim in ``input_spec`` are
variable-length along that axis and are padded up to the length bucket
(``pad_value``).  The model must be padding-safe along that axis (per-
position ops; attention with masking; etc.) — the standard serving
contract.  Outputs are un-padded back per request (``unpad_output_axis``).
"""
from __future__ import annotations

import threading
import time

import numpy as _np

from .. import profiler
from ..context import Context
from ..predictor import Predictor, load_checkpoint
from .bucketing import ShapeBucketer


class ServerDrainingError(RuntimeError):
    """The server is draining (SIGTERM) or closed: the request was NOT
    admitted and is safe to retry against another replica.  A
    ``RuntimeError`` subclass so pre-drain callers that caught the old
    generic refusal keep working."""


def install_sigterm_drain(*servers, deadline_s=30.0):
    """Chain a SIGTERM handler that drains ``servers`` gracefully:
    ``/healthz`` flips to 503 ("draining") so load balancers stop
    routing here, admission stops (``submit`` raises
    :class:`ServerDrainingError`), in-flight and queued work shares
    ``deadline_s`` to finish, the remainder fails retriably, and then
    any previously-installed handler runs (e.g. ``CheckpointManager``'s
    save-on-SIGTERM).  Call from the main thread; returns the installed
    handler."""
    import os
    import signal

    prev = {"h": None}

    def handler(signum, frame):
        profiler.set_health("draining")
        share = deadline_s / max(1, len(servers))
        for s in servers:
            try:
                s.close(drain=True, timeout=share)
            except Exception:
                pass
        ph = prev["h"]
        if callable(ph):
            ph(signum, frame)
        elif ph == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    prev["h"] = signal.signal(signal.SIGTERM, handler)
    return handler

__all__ = ["InferenceServer", "PendingResult", "ServerDrainingError",
           "install_sigterm_drain"]

_perf = time.perf_counter


# one parse rule for env knobs across the repo: a typo'd value degrades
# to the default instead of raising (profiler.py owns the float variant)
_env_float = profiler._env_float
_env_int = profiler._env_int


class PendingResult:
    """Handle returned by :meth:`InferenceServer.submit` — a minimal
    future.  ``result()`` blocks until the scheduler completes the batch
    carrying this request (or raises what the dispatch raised)."""

    __slots__ = ("request_id", "latency_ms", "_ev", "_val", "_exc")

    def __init__(self, request_id):
        self.request_id = request_id
        self.latency_ms = None
        self._ev = threading.Event()
        self._val = None
        self._exc = None

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id!r} not completed in {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._val

    # scheduler-side completion
    def _set(self, val=None, exc=None, latency_ms=None):
        self._val = val
        self._exc = exc
        self.latency_ms = latency_ms
        self._ev.set()


class _Request:
    __slots__ = ("rid", "inputs", "length", "bucket", "t_enqueue",
                 "deadline", "pending")

    def __init__(self, rid, inputs, length, bucket, t_enqueue, deadline):
        self.rid = rid
        self.inputs = inputs
        self.length = length
        self.bucket = bucket
        self.t_enqueue = t_enqueue
        self.deadline = deadline
        self.pending = PendingResult(rid)


class InferenceServer:
    """Continuous-batching inference server over a :class:`Predictor`.

    Parameters
    ----------
    symbol, params : checkpoint, as :class:`Predictor` accepts them
        (paths or in-memory Symbol / param dict).
    input_spec : dict name -> per-SAMPLE shape tuple; ``None`` marks the
        variable-length axis (at most one per input; all variable inputs
        share one length).  The batch axis is added by the server.
    max_batch_size : dispatch cap (env ``MXNET_SERVING_MAX_BATCH``, 16).
    max_queue_ms : queueing budget per request — the scheduler dispatches
        a partial batch rather than let the oldest request wait longer
        (env ``MXNET_SERVING_MAX_QUEUE_MS``, 10.0).
    slo_ms : end-to-end latency SLO a completion is judged against
        (``serving_slo_violation`` counter; env ``MXNET_SERVING_SLO_MS``,
        default ``2 * max_queue_ms``).
    length_buckets / max_length : explicit length ladder, or the max
        length a powers-of-two ladder must cover (see
        :class:`ShapeBucketer`).  Omit both for fixed-shape inputs.
    batch_buckets : explicit batch-size ladder (default: powers of two
        up to ``max_batch_size``) — partial batches pad up to these so
        dispatch sizes stay inside the warm set.
    amp_dtype : None, ``"bfloat16"`` or ``"float16"`` — route the model
        through ``amp.convert_model`` at bind time (per-server tier).
    input_dtypes : dict name -> numpy dtype of the batch buffers
        (default float32 for every input).
    unpad_output_axis : per-output axis spec cutting each PER-SAMPLE
        output slice back to the request's true length.  ``"auto"`` =
        axis 0 for every output when any input is variable-length, else
        no un-padding; ``None`` disables; an int applies to every output;
        a sequence gives one axis (or None) per output in graph order; a
        dict maps output index -> axis (unlisted outputs are not
        un-padded).  Multi-output models return a LIST of arrays per
        request (single-output models keep returning the bare array).
    pad_value : fill for padded positions/rows (default 0.0).
    name : metrics-provider key (``providers[name]`` in
        ``metrics_snapshot()``; Prometheus gauges ``mxnet_<name>_*``).
    dev_type, dev_id : the device (``"gpu"``, the card, by default; with
        no card the constructor raises, ``"cpu"`` selects the CPU).
    warmup : bind every (batch, length) bucket pair and build its plan in
        ``start()`` so live traffic never sees a build.
    autostart : call :meth:`start` from the constructor.
    """

    def __init__(self, symbol, params, input_spec, *, max_batch_size=None,
                 max_queue_ms=None, slo_ms=None, length_buckets=None,
                 max_length=None, batch_buckets=None, amp_dtype=None,
                 input_dtypes=None, unpad_output_axis="auto", pad_value=0.0,
                 dev_type="gpu", dev_id=0, name="serving", warmup=True,
                 autostart=True):
        self.max_batch_size = int(max_batch_size
                                  if max_batch_size is not None
                                  else _env_int("MXNET_SERVING_MAX_BATCH", 16))
        if self.max_batch_size <= 0:
            raise ValueError("max_batch_size must be positive")
        self.max_queue_ms = float(
            max_queue_ms if max_queue_ms is not None
            else _env_float("MXNET_SERVING_MAX_QUEUE_MS", 10.0))
        self.slo_ms = float(slo_ms if slo_ms is not None
                            else _env_float("MXNET_SERVING_SLO_MS",
                                            2.0 * self.max_queue_ms))
        self.pad_value = pad_value
        self.name = str(name)
        self.amp_dtype = amp_dtype

        # -- input spec / bucketing ------------------------------------
        self._spec = {}
        self._var_axis = {}
        for iname, shape in dict(input_spec).items():
            shape = tuple(shape)
            var = [i for i, d in enumerate(shape) if d is None]
            if len(var) > 1:
                raise ValueError(
                    f"input {iname!r}: at most one variable axis, got "
                    f"{shape}")
            self._spec[iname] = shape
            self._var_axis[iname] = var[0] if var else None
        self._has_variable = any(a is not None
                                 for a in self._var_axis.values())
        if self._has_variable:
            self._len_bucketer = ShapeBucketer(buckets=length_buckets,
                                               max_length=max_length)
        else:
            self._len_bucketer = None
        # explicit batch_buckets that don't cover max_batch_size are
        # rejected by the bucketer itself (max_length past the top bucket)
        self._batch_bucketer = ShapeBucketer(
            buckets=batch_buckets, max_length=self.max_batch_size,
            min_bucket=1)
        if unpad_output_axis == "auto":
            unpad_output_axis = 0 if self._has_variable else None
        self._unpad_spec = unpad_output_axis
        self._unpad_axes = None   # resolved per-output at first dispatch
                                  # (output count known only post-bind)
        self._dtypes = {iname: _np.dtype((input_dtypes or {}).get(
            iname, "float32")) for iname in self._spec}

        # -- model bind (AMP tier routes through convert_model) --------
        Context(dev_type, dev_id).device  # with no card, raise before loading
        sym, arg_p, aux_p = load_checkpoint(symbol, params)
        if amp_dtype is not None:
            from .. import amp as _amp

            sym, arg_p, aux_p = _amp.convert_model(
                sym, arg_p, aux_p, target_dtype=str(amp_dtype))
        merged = {f"arg:{k}": v for k, v in arg_p.items()}
        merged.update({f"aux:{k}": v for k, v in aux_p.items()})
        first_lb = (self._len_bucketer.buckets[0]
                    if self._len_bucketer else 0)
        self._pred = Predictor(sym, merged,
                               self._shapes_for(
                                   self._batch_bucketer.buckets[0], first_lb),
                               dev_type=dev_type, dev_id=dev_id)
        # a sequence-form unpad spec can be checked NOW (the symbol knows
        # its output count): a misconfiguration must fail at construction,
        # not poison every batch from the scheduler thread
        if (self._unpad_spec is not None
                and not isinstance(self._unpad_spec, (int, dict))):
            self._unpad_for(self._pred.num_outputs())

        # -- queue / scheduler state -----------------------------------
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = []
        self._closing = False
        self._closed = False
        self._started = False
        self._thread = None
        self._rid = 0
        self._warm = set()          # (batch_bucket, length_bucket) bound+run
        self._warm_done = False
        self._depth_peak = 0
        self._n_requests = 0
        self._n_completed = 0
        self._n_failed = 0
        self._n_batches = 0
        self._n_batch_requests = 0
        self._n_hits = 0
        self._n_misses = 0
        self._miss_after_warmup = 0
        self._n_slo_violations = 0
        self._latencies = []        # recent latency_ms, capped
        self._lat_cap = 4096
        self._do_warmup = bool(warmup)
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    def _shapes_for(self, batch_bucket, length_bucket):
        shapes = {}
        for iname, spec in self._spec.items():
            shapes[iname] = (batch_bucket,) + tuple(
                length_bucket if d is None else d for d in spec)
        return shapes

    def start(self):
        """Warm every bucket pair (unless ``warmup=False``) and start the
        scheduler thread.  Idempotent."""
        with self._lock:
            if self._started:
                return self
            if self._closed:
                raise RuntimeError("server is closed")
            self._started = True
        if self._do_warmup:
            lbs = (self._len_bucketer.buckets
                   if self._len_bucketer else (0,))
            # warmup builds are expected and declared: they register in
            # the compile registry under their own site AND are exempt
            # from a guard another subsystem may already have armed
            with profiler.compile_site("serving.warmup"), \
                    profiler.compile_guard_paused():
                for bb in self._batch_bucketer.buckets:
                    for lb in lbs:
                        self._pred.reshape(self._shapes_for(bb, lb))
                        self._pred.forward()
                        self._warm.add((bb, lb))
        self._warm_done = True
        if self._do_warmup:
            # the bucket set is closed and built: any further build
            # is a steady-state violation (MXNET_COMPILE_GUARD escalates).
            # warmup=False opted out of that contract, so no auto-arm.
            profiler.arm_compile_guard("serving")
        self._thread = threading.Thread(
            target=self._loop, name=f"mx-{self.name}-scheduler",
            daemon=True)
        self._thread.start()
        profiler.register_metrics_provider(self.name, self._provider)
        return self

    # -- submission ----------------------------------------------------
    def submit(self, inputs, request_id=None):
        """Enqueue one request (``{input_name: per-sample array}``, no
        batch axis) and return its :class:`PendingResult`.  Raises
        synchronously on malformed inputs (wrong names/shape, length past
        the top bucket) — a request that can never be served must fail at
        the door, not poison a batch."""
        inputs = {k: _np.asarray(v, dtype=self._dtypes.get(k))
                  for k, v in inputs.items()}
        if set(inputs) != set(self._spec):
            raise ValueError(
                f"inputs {sorted(inputs)} != declared {sorted(self._spec)}")
        length = None
        for iname, a in inputs.items():
            spec = self._spec[iname]
            if a.ndim != len(spec):
                raise ValueError(
                    f"input {iname!r}: rank {a.ndim} != spec {spec}")
            for axis, d in enumerate(spec):
                if d is None:
                    if length is None:
                        length = a.shape[axis]
                    elif a.shape[axis] != length:
                        raise ValueError(
                            f"input {iname!r}: variable-axis size "
                            f"{a.shape[axis]} disagrees with {length}")
                elif a.shape[axis] != d:
                    raise ValueError(
                        f"input {iname!r}: dim {axis} is {a.shape[axis]}, "
                        f"spec wants {d}")
        bucket = (self._len_bucketer.bucket_for(length)
                  if length is not None else 0)

        t0 = _perf()
        with self._cond:
            if self._closing or self._closed:
                raise ServerDrainingError(
                    "server is draining/closed — retry against another "
                    "replica")
            if not self._started:
                raise RuntimeError("server is not started")
            self._rid += 1
            rid = request_id if request_id is not None else self._rid
            req = _Request(rid, inputs, length, bucket, t0,
                           t0 + self.max_queue_ms / 1e3)
            self._queue.append(req)
            self._n_requests += 1
            depth = len(self._queue)
            if depth > self._depth_peak:
                # strict counters are monotone adds; the watermark is
                # published as its cumulative raises
                profiler.incr("serving_queue_depth_peak",
                              depth - self._depth_peak)
                self._depth_peak = depth
            self._cond.notify_all()
        profiler.incr("serving_request")
        if profiler._active:
            profiler.record_span("serving.enqueue", "serving", t0,
                                 args={"request": rid,
                                       "length_bucket": bucket})
        return req.pending

    def infer(self, inputs, timeout=30.0):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(inputs).result(timeout)

    # -- scheduler -----------------------------------------------------
    def _select_batch_locked(self, now):
        """Batch-formation policy under the queue lock.  The head (oldest
        request) is checked FIRST: past its deadline — or while draining —
        its bucket group dispatches immediately, whatever other buckets
        hold (a full batch elsewhere must never starve a past-deadline
        minority bucket: sustained majority-bucket traffic would otherwise
        keep winning every wake and the head would wait unboundedly).
        Otherwise dispatch a FULL batch the moment any length bucket has
        one; else None (wait until the head's deadline)."""
        groups = {}
        for r in self._queue:
            groups.setdefault(r.bucket, []).append(r)
        head = self._queue[0]
        if now >= head.deadline or self._closing:
            chosen = groups[head.bucket][:self.max_batch_size]
        else:
            chosen = None
            for rs in groups.values():
                if len(rs) >= self.max_batch_size:
                    chosen = rs[:self.max_batch_size]
                    break
            if chosen is None:
                return None
        taken = set(map(id, chosen))
        self._queue = [r for r in self._queue if id(r) not in taken]
        return chosen

    def _unpad_for(self, n_outputs):
        """Resolve ``unpad_output_axis`` into one axis-or-None per output
        (cached; the output count is only known after the first bind)."""
        axes = self._unpad_axes
        if axes is not None and len(axes) == n_outputs:
            return axes
        spec = self._unpad_spec
        if spec is None:
            axes = (None,) * n_outputs
        elif isinstance(spec, int):
            axes = (spec,) * n_outputs
        elif isinstance(spec, dict):
            axes = tuple(spec.get(i) for i in range(n_outputs))
        else:
            axes = tuple(spec)
            if len(axes) != n_outputs:
                raise ValueError(
                    f"unpad_output_axis has {len(axes)} entries but the "
                    f"model produces {n_outputs} outputs")
        self._unpad_axes = axes
        return axes

    def _loop(self):
        while True:
            batch = None
            with self._cond:
                while batch is None:
                    if self._queue:
                        now = _perf()
                        batch = self._select_batch_locked(now)
                        if batch is None:
                            self._cond.wait(
                                max(0.0, self._queue[0].deadline - now))
                    elif self._closing:
                        return
                    else:
                        self._cond.wait()
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — fail the batch, not the server
                with self._lock:
                    self._n_failed += len(batch)
                for r in batch:
                    r.pending._set(exc=e)

    def _dispatch(self, reqs):
        n = len(reqs)
        lb = reqs[0].bucket
        bb = self._batch_bucketer.bucket_for(n)
        t_form = _perf()
        arrays = {}
        for iname, spec in self._spec.items():
            shape = (bb,) + tuple(lb if d is None else d for d in spec)
            buf = _np.full(shape, self.pad_value,
                           dtype=self._dtypes[iname])
            for i, r in enumerate(reqs):
                sample = r.inputs[iname]
                sl = (i,) + tuple(slice(0, s) for s in sample.shape)
                buf[sl] = sample
            arrays[iname] = buf
        key = (bb, lb)
        shapes = {k: v.shape for k, v in arrays.items()}
        warm = key in self._warm and self._pred.is_warm(shapes)
        if profiler._active:
            profiler.record_span(
                "serving.batch_form", "serving", t_form,
                args={"batch": n, "padded": bb, "length_bucket": lb,
                      "requests": [r.rid for r in reqs[:32]]})
        profiler.incr("serving_bucket_hit" if warm else "serving_bucket_miss")
        with self._lock:
            if warm:
                self._n_hits += 1
            else:
                self._n_misses += 1
                if self._warm_done:
                    self._miss_after_warmup += 1

        t_disp = _perf()
        # compile-registry attribution: a bind/build triggered by live
        # traffic reports as serving.dispatch — in steady state this site
        # must never appear (the guard armed at start() enforces it)
        try:
            with profiler.compile_site("serving.dispatch"):
                self._pred.reshape(shapes)
                for iname, buf in arrays.items():
                    self._pred.set_input(iname, buf)
                self._pred.forward()
        except Exception as e:
            # serving dispatch is an OOM choke point: one postmortem
            # naming the ledger's top owners before the batch fails
            profiler.maybe_oom_postmortem(e, "serving.dispatch")
            raise
        outs = self._pred.get_outputs()
        unpad = self._unpad_for(len(outs))
        self._warm.add(key)
        if profiler._active:
            profiler.record_span(
                "serving.dispatch", "serving", t_disp,
                args={"batch": n, "padded": bb, "length_bucket": lb,
                      "bucket_hit": warm})
        profiler.incr("serving_batch")
        profiler.incr("serving_batch_requests", n)

        t_done = _perf()
        lats = []
        for i, r in enumerate(reqs):
            slices = []
            for out, axis in zip(outs, unpad):
                res = out[i]
                if axis is not None and r.length is not None:
                    sl = [slice(None)] * res.ndim
                    sl[axis] = slice(0, r.length)
                    res = res[tuple(sl)]
                slices.append(res)
            # single-output models keep the bare-array contract
            res = slices[0] if len(slices) == 1 else slices
            lat_ms = (t_done - r.t_enqueue) * 1e3
            lats.append(lat_ms)
            if lat_ms > self.slo_ms:
                # exactly once per late request: this is the only place a
                # request's latency is ever judged
                profiler.incr("serving_slo_violation")
                with self._lock:
                    self._n_slo_violations += 1
            r.pending._set(val=res, latency_ms=lat_ms)
        with self._lock:
            self._n_completed += n
            self._n_batches += 1
            self._n_batch_requests += n
            self._latencies.extend(lats)
            if len(self._latencies) > self._lat_cap:
                del self._latencies[:len(self._latencies) - self._lat_cap]
        if profiler._active:
            profiler.record_span(
                "serving.complete", "serving", t_done,
                args={"batch": n,
                      "latency_ms_max": round(max(lats), 3) if lats else 0})
        # memory-counter-track tick: serving-only processes have no step
        # boundaries, so the scheduler samples the watermark (throttled)
        profiler.maybe_sample_memory()

    # -- observability -------------------------------------------------
    def stats(self):
        """Live serving stats (also the metrics-provider payload)."""
        with self._lock:
            lat = self._latencies
            return {
                "queue_depth": len(self._queue),
                "queue_depth_peak": self._depth_peak,
                "requests": self._n_requests,
                "completed": self._n_completed,
                "failed": self._n_failed,
                "batches": self._n_batches,
                "batch_requests": self._n_batch_requests,
                "bucket_hits": self._n_hits,
                "bucket_misses": self._n_misses,
                "bucket_miss_after_warmup": self._miss_after_warmup,
                "slo_violations": self._n_slo_violations,
                "slo_ms": self.slo_ms,
                "latency_ms_p50": profiler.percentile(lat, 0.50),
                "latency_ms_p99": profiler.percentile(lat, 0.99),
                "warm_buckets": len(self._warm),
            }

    def _provider(self):
        return self.stats()

    def compile_stats(self):
        """Pass-through of ``Predictor.compile_stats()`` — the evidence of
        zero builds after warm-up."""
        return self._pred.compile_stats()

    # -- lifecycle -----------------------------------------------------
    def close(self, drain=True, timeout=30.0):
        """Stop accepting requests and shut the scheduler down.  With
        ``drain=True`` (default) every queued request is still dispatched
        (deadline rules suspended — the queue flushes in bucket groups)
        under a ``timeout`` deadline; whatever the drain could not finish
        in time fails with a retriable :class:`ServerDrainingError`
        instead of hanging its clients.  ``drain=False`` fails queued
        requests immediately (same error)."""
        with self._cond:
            if self._closed:
                return
            self._closing = True
            if not drain:
                for r in self._queue:
                    r.pending._set(exc=ServerDrainingError(
                        "server closed without drain — retry against "
                        "another replica"))
                    self._n_failed += 1
                self._queue = []
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                # drain deadline exceeded: fail the remainder retriably
                with self._cond:
                    for r in self._queue:
                        r.pending._set(exc=ServerDrainingError(
                            f"drain deadline ({timeout}s) exceeded — "
                            "retry against another replica"))
                        self._n_failed += 1
                    self._queue = []
                    self._cond.notify_all()
        profiler.unregister_metrics_provider(self.name)
        self._pred.close()   # bound params leave the device-memory ledger
        with self._cond:
            self._closed = True
            self._closing = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.close()
        return False
