"""``mx.profiler``: structured tracing and telemetry.

Counterpart of the JAX package's ``profiler.py``, with the same names and
semantics, on PyTorch and the CUDA card:

* declared event counters (``incr``, ``declare_counter``, labeled
  breakdowns through ``incr_labeled``/``counter_labels``,
  ``reset_counters``): ``incr`` on an undeclared name raises;
* the span recorder: per-thread rings of ``(name, category, t0, t1, step,
  args)`` armed by ``start()`` (``span``, ``record_span``, ``scope``,
  ``Marker``), dumped as chrome://tracing JSON with the process metadata
  and clock anchor ``tools/trace_merge.py`` aligns by (``dump``;
  ``MXNET_PROFILER_TRACE_GZ=1`` gzips it); unarmed, an instrumentation
  site pays one read of ``profiler._active``;
* the device trace: ``start``/``resume`` also open a ``torch.profiler``
  session with ``ProfilerActivity.CUDA`` on a machine with a card, and
  ``stop``/``pause`` close it into the trace directory; ``dumps()`` lists
  the kernels it saw by name, count and total ms (a failure warns once and
  counts ``profiler_trace_error``);
* step telemetry: ``step_boundary`` (``gluon.Trainer.step`` and the step
  fold call it) closes a step, splits its wall time into host / comms /
  device buckets from the spans inside it, feeds ``step_stats``, the
  slow-step detector (``MXNET_PROFILER_SLOW_STEP_MS`` or 4x the rolling
  median after 16 steps, one log line a slow step) and the memory
  watermark (``torch.cuda.memory_stats``);
* the goodput ledger (``goodput_snapshot``, ``record_downtime``,
  ``cluster_goodput``): every armed second of the run in one bucket;
* metrics export: ``metrics_snapshot``, the JSONL log and the localhost
  ``/metrics``, ``/metrics.json`` and ``/healthz`` endpoint
  (``start_metrics``), peer snapshots and ``straggler_report``;
* the compile registry: an executor's plan, a stateful program's first
  call or the fold's capture reports its build (``record_compile``), with
  the recompile attribution line, the cost a site hands over (the port has
  no compiler cost analysis, so no figure is invented) and the steady-state
  guard (``MXNET_COMPILE_GUARD``, ``MXNET_COMPILE_WARMUP_STEPS``);
* the device-memory ledger (``track_memory``), OOM postmortems of
  ``torch.cuda.OutOfMemoryError`` and ``MemoryBudget`` admission.

``MXNET_PROFILER_AUTOSTART=1`` starts the recorder at import and dumps at
exit.  Clock offsets of a multi-process run come from
``parallel.sync_profiler_clock`` (a broadcast of rank 0's clock over the
process group at ``init_distributed``); the heartbeat wire that carries
peer metrics belongs to the asynchronous parameter server (ROADMAP §1
item 9).
"""
from __future__ import annotations

import atexit
import gzip as _gzip
import json
import logging
import os
import socket as _socket
import threading as _threading
import time
import warnings as _warnings
import weakref as _weakref
from collections import OrderedDict as _OrderedDict

import torch

__all__ = ["set_config", "start", "stop", "dump", "dumps", "pause", "resume",
           "scope", "span", "Marker", "state", "counters", "reset_counters",
           "incr", "incr_labeled", "counter_labels", "declare_counter",
           "record_span", "step_boundary",
           "current_step", "step_stats", "memory_watermark", "recorder_stats",
           "recording_enabled", "process_info", "set_process_info",
           "update_clock_offset", "sample_clock_offset", "metrics_snapshot",
           "publish_peer_metrics", "peer_metrics", "forget_peer_metrics",
           "register_metrics_provider", "register_metrics_provider_unique",
           "unregister_metrics_provider", "render_prometheus",
           "start_metrics", "stop_metrics", "metrics_server_port",
           "set_health", "health_state", "straggler_report", "percentile",
           "register_slow_step_annotator", "unregister_slow_step_annotator",
           # goodput
           "goodput_snapshot", "cluster_goodput", "record_downtime", "reset_goodput",
           # compile accounting
           "record_compile", "compile_site", "compile_registry",
           "compile_stats", "reset_compiles", "sig_array", "sig_static",
           "diff_signatures", "compile_cost_enabled", "jit_cache_size",
           "arm_compile_guard", "disarm_compile_guard", "compile_guard_state",
           "compile_guard_paused", "CompileGuardError",
           # device memory
           "track_memory", "memory_ledger", "memory_postmortems",
           "array_nbytes", "device_memory_stats", "sample_device_memory",
           "maybe_sample_memory", "memory_budget", "MemoryBudget",
           "MemoryBudgetError", "oom_postmortem", "maybe_oom_postmortem",
           "is_resource_exhausted"]

_logger = logging.getLogger(__name__)


def _env_float(name, default):
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def _env_int(name, default):
    # one parse rule for env knobs: a typo'd value degrades to the default
    # instead of raising
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


_config = {
    "filename": "profile.json",
    "ring_size": _env_int("MXNET_PROFILER_RING_SIZE", 65536),  # spans kept a thread
    "slow_step_ms": None,          # explicit threshold; None = auto mode
    "slow_step_auto": True,        # rolling-median detector when no threshold
    "slow_step_auto_mult": 4.0,
    "step_window": 256,            # rolling step-stats window length
    "memory_sampling": True,       # torch.cuda.memory_stats() at step boundaries
}
_state = {"running": False, "dir": None, "t0": None, "trace": None}
_agg = {}  # scope/marker name -> [count, total_s], under _counter_lock

# ts 0 of every trace this process dumps, and its wall-clock instant (the
# mean of two wall readings around the perf reading): the anchor
# tools/trace_merge.py aligns per-rank timelines with
_EPOCH = time.perf_counter()
_wt0 = time.time()
_EPOCH_UNIX = (_wt0 + time.time()) / 2.0 - (time.perf_counter() - _EPOCH)
del _wt0
_perf = time.perf_counter


def _tally(name, dur):
    with _counter_lock:
        cnt_tot = _agg.setdefault(name, [0, 0.0])
        cnt_tot[0] += 1
        cnt_tot[1] += dur


# -- event counters ------------------------------------------------------------
# THE declared set: ``incr`` on any other name raises; extensions declare
# theirs with ``declare_counter``.  Each subsystem of the port counts here;
# the JAX package's counters of subsystems the port does not have yet
# (dispatch cache, engine bulking, async PS, pipeline, MoE, elastic,
# gradient compression) come with them.
_counters = {
    "fused_step_call": 0,             # fused optimizer group updates (kernel launches
                                      # or one fold_update replay)
    "fused_step_params": 0,           # parameters updated through fused groups
    "fused_step_fallback_params": 0,  # parameters left to the per-tensor loop
    "step_fold_call": 0,              # folded-step calls (one replay each on the card)
    "step_fold_fallback": 0,          # fold entries that ran the eager path
                                      # (per-reason split: counter_labels())
    "fold_eval_call": 0,              # folded-eval calls
    "allreduce_overlap_launched": 0,  # buckets launched from the grad-readiness
                                      # hook (Trainer.backward overlap)
    "allreduce_bucket": 0,            # bucketed gradient all-reduces
    "allreduce_bucket_params": 0,     # grads carried by those buckets
    "profiler_trace_error": 0,        # torch.profiler start/stop failures
    "slow_step_detected": 0,          # slow-step detector firings
    "metrics_snapshot": 0,            # metrics_snapshot() captures taken
    "metrics_scrape": 0,              # HTTP GETs served by the endpoint
    "straggler_detected": 0,          # cross-rank straggler attributions
    "serving_request": 0,             # requests accepted by InferenceServer
    "serving_batch": 0,               # dynamic batches dispatched
    "serving_batch_requests": 0,      # requests carried by those batches
    "serving_bucket_hit": 0,          # batches landing on a warm bucket
    "serving_bucket_miss": 0,         # batches that had to bind/build a plan
    "serving_slo_violation": 0,       # requests completing past their SLO
    "serving_queue_depth_peak": 0,    # high-watermark of the request queue
    "generation_request": 0,          # prompts accepted by GenerationServer
    "generation_shed": 0,             # submissions rejected by admission control
    "generation_prefill": 0,          # prefill dispatches
    "generation_slot_join": 0,        # requests joining the decode batch
    "generation_slot_leave": 0,       # requests leaving (finish/cancel/error)
    "generation_decode_iter": 0,      # per-pool decode steps
    "generation_token": 0,            # tokens emitted by decode steps
    "generation_cancelled": 0,        # requests cancelled mid-stream
    "generation_slo_violation": 0,    # completions past their tenant's SLO
    "compile_total": 0,               # plans and captures built, across every site
    "compile_ms_total": 0,            # wall ms those builds cost
    "recompile_steady_state": 0,      # builds after the guard armed
    "memory_oom_postmortem": 0,       # OOM/budget postmortems emitted
    "memory_budget_refusal": 0,       # admissions deferred by a MemoryBudget
    "goodput_snapshot": 0,            # goodput_snapshot() captures taken
    "goodput_downtime_ms": 0,         # downtime ms recorded into the ledger
    "io_prefetch_batches": 0,         # batches produced by prefetch workers
    "io_pipeline_batches": 0,         # device-resident batches DataPipeline delivered
    "io_pipeline_stalls": 0,          # consumer arrivals that found the buffer empty
    "io_pipeline_depth_change": 0,    # autotuner depth raises + lowers
    "io_pipeline_bytes": 0,           # host->device bytes the transfer thread moved
}
_counter_lock = _threading.Lock()
# per-reason breakdowns of a declared counter (``incr_labeled``):
# {name: {label: n}}; the flat counter stays the aggregate
_counter_labels = {}


def declare_counter(name, initial=0):
    """Register an extension counter so ``incr(name)`` is legal."""
    with _counter_lock:
        _counters.setdefault(name, initial)


def _undeclared(name):
    return KeyError(f"undeclared profiler counter {name!r}; add it to profiler._counters "
                    "or call declare_counter() first")


def incr(name, n=1):
    with _counter_lock:
        try:
            _counters[name] += n
        except KeyError:
            raise _undeclared(name) from None


def incr_labeled(name, label, n=1):
    """Increment a declared counter and its per-reason label breakdown
    (``counter_labels``); labels are free-form strings made on first use."""
    label = str(label)
    with _counter_lock:
        try:
            _counters[name] += n
        except KeyError:
            raise _undeclared(name) from None
        lab = _counter_labels.setdefault(name, {})
        lab[label] = lab.get(label, 0) + n


def counter_labels(name=None):
    """``{counter: {label: n}}`` from :func:`incr_labeled` (one counter's
    ``{label: n}`` when ``name`` is given)."""
    with _counter_lock:
        if name is not None:
            return dict(_counter_labels.get(name, {}))
        return {k: dict(v) for k, v in _counter_labels.items()}


def counters():
    with _counter_lock:
        return dict(_counters)


def reset_counters():
    with _counter_lock:
        for k in _counters:
            _counters[k] = 0
        _counter_labels.clear()


# -- process identity and clock alignment -------------------------------------
# ``clock_offset_s`` is this process's wall clock minus the cluster
# reference's, from midpoint-of-RTT samples (the min-RTT sample wins).
_proc = {
    "rank": _env_int("DMLC_WORKER_ID", 0),
    "host": _socket.gethostname(),
    "pid": os.getpid(),
    "clock_offset_s": 0.0,
    "clock_rtt_s": None,
    "epoch_unix": _EPOCH_UNIX,
}


def process_info():
    """This process's identity and clock metadata (rank, host, pid,
    clock_offset_s, clock_rtt_s, epoch_unix)."""
    with _counter_lock:
        return dict(_proc)


def set_process_info(rank=None, host=None):
    """Pin this process's rank/host for traces and metrics
    (``DMLC_WORKER_ID`` is the default rank)."""
    with _counter_lock:
        if rank is not None:
            _proc["rank"] = int(rank)
        if host is not None:
            _proc["host"] = str(host)


def update_clock_offset(offset_s, rtt_s):
    """Record one clock-offset sample; the min-RTT sample of the process
    lifetime wins."""
    with _counter_lock:
        best = _proc["clock_rtt_s"]
        if best is None or rtt_s < best:
            _proc["clock_offset_s"] = float(offset_s)
            _proc["clock_rtt_s"] = float(rtt_s)


def sample_clock_offset(fetch_ref_time, samples=5):
    """Estimate this process's wall-clock offset against a reference whose
    ``time.time()`` ``fetch_ref_time()`` returns; records the winning
    sample and returns ``(offset_s, rtt_s)`` (None if no sample came)."""
    best = None
    for _ in range(max(1, int(samples))):
        t0 = time.time()
        ref = fetch_ref_time()
        t1 = time.time()
        if ref is None:
            continue
        rtt = t1 - t0
        off = (t0 + t1) / 2.0 - float(ref)
        if best is None or rtt < best[1]:
            best = (off, rtt)
    if best is not None:
        update_clock_offset(*best)
    return best


# -- span recorder -------------------------------------------------------------
# Gates the instrumentation sites read (one module attribute and a branch
# when off):
#   _recording  spans go to the rings (armed by start())
#   _telemetry  step buckets accumulate without a trace (slow-step knob)
#   _active     _recording or _telemetry: THE pre-check of hot paths
_recording = False
_telemetry = os.environ.get("MXNET_PROFILER_SLOW_STEP_MS") is not None
_active = _recording or _telemetry

_rings = []     # every live _Ring of the current recording generation
_ring_gen = 0   # bumped by a fresh start(): stale thread-local rings are abandoned
_tls = _threading.local()

# step-bucket attribution: only root spans bill (a nested phase would
# double-bill its parent's time): the kvstore's push/pull/pushpull bill
# "comms", and a bucket's kvstore.bucketed_pushpull does not, since the
# kvstore.pushpull of its wire wait lies inside it
_BUCKET_OF = {
    "dispatch.raw": "host",
    "fused.group_apply": "host",
    "io.wait": "host",
    "spmd.shard_batch": "host",  # a step's host-to-device batch copy
    "kvstore.pushpull": "comms",
    "kvstore.push": "comms",
    "kvstore.pull": "comms",
}

# run-level goodput attribution: the same root-span rule, into the run
# ledger's exclusive overhead buckets.  Compile time lands in "compile"
# once, through the "compile.jit" span record_compile emits; only spans of
# the step-driving thread bill (a serving or prefetch thread overlaps the
# run on the wall clock).
_GOODPUT_BUCKET_OF = {
    "dispatch.raw": "host",
    "fused.group_apply": "host",
    "io.wait": "data_wait",
    "kvstore.pushpull": "comm",
    "kvstore.push": "comm",
    "kvstore.pull": "comm",
    "compile.jit": "compile",
    "elastic.snapshot": "checkpoint",
    "elastic.restore": "checkpoint",
}

_ring_uid = 0  # unique chrome-trace tid a ring: OS thread idents are recycled


class _Ring:
    """Fixed-capacity span buffer of one thread.  Only the owner writes;
    ``snapshot()`` from the dump thread rides the GIL."""

    __slots__ = ("buf", "cap", "pos", "count", "dropped", "tid", "tname", "gen", "owner")

    def __init__(self, cap, gen):
        global _ring_uid
        self.cap = max(1, int(cap))
        self.buf = [None] * self.cap
        self.pos = 0
        self.count = 0
        self.dropped = 0
        _ring_uid += 1          # the caller holds _counter_lock
        self.tid = _ring_uid
        thread = _threading.current_thread()
        self.tname = thread.name
        self.owner = _weakref.ref(thread)
        self.gen = gen

    def dead(self):
        t = self.owner()
        return t is None or not t.is_alive()

    def add(self, ev):
        p = self.pos
        self.buf[p] = ev
        self.pos = (p + 1) % self.cap
        if self.count < self.cap:
            self.count += 1
        else:
            self.dropped += 1

    def snapshot(self):
        """Spans in insertion order."""
        if self.count < self.cap:
            return self.buf[:self.count]
        p = self.pos
        return self.buf[p:] + self.buf[:p]


# dead threads' rings survive for dump(), up to this many rings
_MAX_RINGS = 64
_evicted = [0, 0]  # spans, dropped carried by evicted dead rings


def _ring():
    r = getattr(_tls, "ring", None)
    if r is None or r.gen != _ring_gen:
        with _counter_lock:
            r = _Ring(_config["ring_size"], _ring_gen)
            _tls.ring = r
            _rings.append(r)
            if len(_rings) > _MAX_RINGS:
                for x in [x for x in _rings if x.dead() and x is not _step_ring][
                        :len(_rings) - _MAX_RINGS]:
                    _evicted[0] += x.count
                    _evicted[1] += x.dropped
                    _rings.remove(x)
    return r


_step_ring = None  # the step spans' own timeline: a user scope may straddle a
                   # boundary, and would then break B/E nesting on its row


def _get_step_ring():
    global _step_ring
    with _counter_lock:
        if _step_ring is None or _step_ring.gen != _ring_gen:
            r = _Ring(_config["ring_size"], _ring_gen)
            r.tname = "steps (telemetry)"
            _rings.append(r)
            _step_ring = r
        return _step_ring


def recording_enabled():
    return _recording


def recorder_stats():
    """Recorded and ring-evicted (dropped-oldest) spans of this session."""
    with _counter_lock:
        rings = list(_rings)
        ev_spans, ev_dropped = _evicted
    return {"recording": _recording, "threads": len(rings),
            "spans": sum(r.count for r in rings),
            "dropped": sum(r.dropped for r in rings) + ev_spans + ev_dropped,
            "ring_size": _config["ring_size"]}


def record_span(name, category, t0, t1=None, args=None, step=None):
    """Record one completed span between two ``time.perf_counter()``
    readings (``t1`` defaults to now); ``step`` defaults to the current
    step id.  A no-op unless the recorder or telemetry is armed; hot paths
    check ``profiler._active`` first."""
    if not _active:
        return
    if t1 is None:
        t1 = _perf()
    if t0 < _armed_at:
        # a span straddling the arming instant is clamped to the armed
        # window, so that it nests validly in the trace
        t0 = _armed_at
        if t1 < t0:
            t1 = t0
    bucket = _BUCKET_OF.get(name)
    gbucket = _GOODPUT_BUCKET_OF.get(name)
    if (bucket is not None or gbucket is not None) and _threading.get_ident() == _step_thread:
        with _counter_lock:
            if bucket is not None:
                _step_acc[bucket] = _step_acc.get(bucket, 0.0) + (t1 - t0)
            if gbucket is not None:
                _goodput_acc[gbucket] = _goodput_acc.get(gbucket, 0.0) + (t1 - t0)
    if _recording:
        _ring().add((name, category, t0, t1, _step_id if step is None else step, args))


class span:
    """``with profiler.span('fwd', 'user'):``: a recorded trace span
    (pure Python, hot-path safe)."""

    __slots__ = ("_name", "_cat", "_args", "_t0")

    def __init__(self, name, category="user", args=None):
        self._name = name
        self._cat = category
        self._args = args

    def __enter__(self):
        self._t0 = _perf() if _active else None
        return self

    def __exit__(self, *a):
        if self._t0 is not None and _active:
            record_span(self._name, self._cat, self._t0, args=self._args)
        return False


# -- step telemetry ------------------------------------------------------------
_step_id = 1          # spans inherit this; step boundaries advance it
_step_t0 = None       # perf_counter at the current step's start (None: the
                      # first boundary after arming only anchors)
_step_thread = _threading.get_ident()   # the thread whose spans bill the step
_armed_at = 0.0       # perf_counter of the last arming
_step_acc = {"host": 0.0, "comms": 0.0}
_step_window = []     # per-step stat dicts, capped at step_window
_mem_watermark = {}   # device -> peak bytes allocated observed


def current_step():
    """The step id spans inherit (advanced by ``step_boundary``)."""
    return _step_id


def step_stats():
    """The rolling window of per-step telemetry dicts
    (``step``/``wall_ms``/``host_ms``/``comms_ms``/``device_ms``)."""
    with _counter_lock:
        return [dict(s) for s in _step_window]


def memory_watermark():
    """Peak bytes allocated observed per card (empty without one)."""
    with _counter_lock:
        return dict(_mem_watermark)


def _card_index(d):
    """A card index from an int, a ``torch.device``, a ``Context`` or a
    ``"cuda:i"`` string."""
    d = getattr(d, "device", d)  # a Context's torch.device
    if isinstance(d, torch.device):
        return d.index or 0
    if isinstance(d, str):
        return torch.device(d).index or 0
    return int(d)


def device_memory_stats(devices=None):
    """``{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}``
    from ``torch.cuda.memory_stats`` (the caching allocator's live and peak
    bytes) and ``torch.cuda.mem_get_info`` (the card's total) of
    ``devices`` (card indices, ``torch.device``s, contexts or ``"cuda:i"``
    strings; default every card), once this process has touched a card;
    empty on a machine without one.  Never raises."""
    out = {}
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        idx = (range(torch.cuda.device_count()) if devices is None
               else [_card_index(d) for d in devices])
        for i in idx:
            s = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
                                "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
                                "bytes_limit": int(torch.cuda.mem_get_info(i)[1])}
    except Exception:
        pass  # telemetry must never take training or serving down
    return out


# memory counter-track samples of the chrome trace: (perf_t, {device:
# bytes_in_use}, {category: ledger bytes}); cleared per fresh session
_mem_samples = []
_MAX_MEM_SAMPLES = _env_int("MXNET_PROFILER_MEM_SAMPLES", 4096)
_mem_last = [0.0]   # perf_counter of the last sample (the throttle)


def sample_device_memory():
    """Take one device-memory sample: update the per-card watermark and,
    while the recorder is armed, append a counter-track point (each card's
    bytes in use and the ledger's per-category totals).  No-op under
    ``set_config(memory_sampling=False)``."""
    if not _config.get("memory_sampling", True):
        return
    now = _perf()
    _mem_last[0] = now
    stats = device_memory_stats()
    dev_use = {}
    with _counter_lock:
        for key, s in stats.items():
            dev_use[key] = s["bytes_in_use"]
            if s["peak_bytes_in_use"] > _mem_watermark.get(key, -1):
                _mem_watermark[key] = s["peak_bytes_in_use"]
    if _recording:
        cats = _ledger_categories()
        if dev_use or cats:
            with _counter_lock:
                _mem_samples.append((now, dev_use, cats))
                del _mem_samples[:-_MAX_MEM_SAMPLES]


def maybe_sample_memory(min_interval_s=None):
    """Throttled :func:`sample_device_memory` (the schedulers' ticks and
    ``metrics_snapshot``): at most every ``MXNET_PROFILER_MEM_SAMPLE_S``
    seconds (default 0.05)."""
    if not _config.get("memory_sampling", True):
        return
    if min_interval_s is None:
        min_interval_s = _env_float("MXNET_PROFILER_MEM_SAMPLE_S", 0.05)
    if _perf() - _mem_last[0] < min_interval_s:
        return
    sample_device_memory()


def _slow_threshold_ms():
    """The explicit slow-step threshold (``set_config`` over the env), inf
    when it is 0 or less (off), or None for the automatic mode."""
    v = _config.get("slow_step_ms")
    if v is None:
        env = os.environ.get("MXNET_PROFILER_SLOW_STEP_MS")
        if env:
            try:
                v = float(env)
            except ValueError:
                v = None
    if v is not None and v <= 0:
        return float("inf")
    return v


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def percentile(xs, q):
    """Nearest-rank percentile (the serving tier's latency convention);
    None on empty input."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


_slow_step_annotators = {}   # key -> fn(step stats) -> str | None


def register_slow_step_annotator(key, fn):
    """When a step is slow, call ``fn(step stats)`` and log a truthy
    return as one extra line (``slow step N <key>: <line>``)."""
    with _counter_lock:
        _slow_step_annotators[str(key)] = fn


def unregister_slow_step_annotator(key):
    with _counter_lock:
        _slow_step_annotators.pop(str(key), None)


def step_boundary():
    """Close the current telemetry step (``gluon.Trainer.step`` and the
    step fold call it; custom loops may too).

    Records the step's span, splits its wall time into host / comms /
    device buckets from the root spans of this thread since the previous
    boundary (device is the residue: on the card, kernels still queued when
    the step returns are not in it), feeds the rolling window and the
    slow-step detector, samples device memory and advances the step id.
    The compile guard's warm-up count moves even when the profiler is off;
    everything else is a no-op then."""
    global _step_id, _step_t0, _step_thread
    _guard_tick()
    if not _active:
        return
    now = _perf()
    _step_thread = _threading.get_ident()
    with _counter_lock:
        sid = _step_id
        t0 = _step_t0
        _step_t0 = now
        host = _step_acc.get("host", 0.0)
        comms = _step_acc.get("comms", 0.0)
        _step_acc["host"] = 0.0
        _step_acc["comms"] = 0.0
        _step_id = sid + 1
    if t0 is None:
        return  # armed mid-step: this boundary only anchors the next one
    if _recording:
        ring = _get_step_ring()
        with _counter_lock:
            ring.add(("step", "step", max(t0, _armed_at), now, sid,
                      {"host_ms": round(host * 1e3, 3), "comms_ms": round(comms * 1e3, 3)}))
    wall_ms = (now - t0) * 1e3
    host_ms = host * 1e3
    comms_ms = comms * 1e3
    device_ms = max(0.0, wall_ms - host_ms - comms_ms)
    stats = {"step": sid, "wall_ms": wall_ms, "host_ms": host_ms,
             "comms_ms": comms_ms, "device_ms": device_ms}
    thr = _slow_threshold_ms()
    slow, why = False, ""
    with _counter_lock:
        prior = [s["wall_ms"] for s in _step_window]
        _step_window.append(stats)
        del _step_window[:-int(_config.get("step_window", 256))]
    if thr is not None:
        if wall_ms > thr:
            slow, why = True, f"threshold {thr:g} ms"
    elif _config.get("slow_step_auto", True) and len(prior) >= 16:
        med = _median(prior)
        mult = float(_config.get("slow_step_auto_mult", 4.0))
        if med > 0 and wall_ms > mult * med:
            slow, why = True, f"auto: > {mult:g}x rolling median {med:.1f} ms"
    if slow:
        incr("slow_step_detected")
        _logger.warning("slow step %d: %.1f ms (host-dispatch %.1f ms, comms %.1f ms, "
                        "device/other %.1f ms) [%s]", sid, wall_ms, host_ms, comms_ms,
                        device_ms, why)
        with _counter_lock:
            annots = list(_slow_step_annotators.items())
        for key, fn in annots:
            try:
                line = fn(dict(stats))
            except Exception:
                line = None
            if line:
                _logger.warning("slow step %d %s: %s", sid, key, line)
        rep = straggler_report()
        if rep is not None:
            incr("straggler_detected")
            _logger.warning("slow step %d straggler: rank %d (%s) — step %s wall %.1f ms "
                            "(host-dispatch %.1f ms, comms %.1f ms, device/other %.1f ms)",
                            sid, rep["rank"], rep["host"], rep["step"], rep["wall_ms"],
                            rep["host_ms"], rep["comms_ms"], rep["device_ms"])
    if _config.get("memory_sampling", True):
        sample_device_memory()


# -- metrics export --------------------------------------------------------------
_metrics_seq = 0       # monotone snapshot sequence number of this process
_peer_metrics = {}     # rank -> the latest snapshot that rank published
_metrics_providers = {}  # key -> fn() -> flat {field: number} dict


def register_metrics_provider(key, fn):
    """Attach a gauge source to ``metrics_snapshot()``: ``fn`` returns a flat
    ``{field: number}`` dict, captured under ``snapshot["providers"][key]``
    and rendered as ``mxnet_<key>_<field>`` gauges.  Re-registering a key
    replaces the previous provider."""
    with _counter_lock:
        _metrics_providers[str(key)] = fn


def register_metrics_provider_unique(base, fn):
    """Register ``fn`` under ``base``, or ``base2``, ``base3``... if the name
    is taken, probing and inserting under one lock; returns the name."""
    base = str(base)
    with _counter_lock:
        name, n = base, 2
        while name in _metrics_providers:
            name, n = f"{base}{n}", n + 1
        _metrics_providers[name] = fn
    return name


def unregister_metrics_provider(key):
    with _counter_lock:
        _metrics_providers.pop(str(key), None)


def _provider_metrics():
    with _counter_lock:
        providers = dict(_metrics_providers)
    out = {}
    for key, fn in providers.items():
        try:
            d = fn()
        except Exception:
            continue  # telemetry must never take serving down
        if isinstance(d, dict):
            out[key] = {str(k): v for k, v in d.items()
                        if isinstance(v, (int, float)) or v is None}
    return out


def metrics_snapshot():
    """One self-describing metrics capture: process identity, counters and
    their labels, the step window's summary and the last step's buckets,
    memory watermarks and every provider's gauges.  This dict is the JSONL
    schema (``schema`` versions it) and what peers publish."""
    global _metrics_seq
    incr("metrics_snapshot")
    maybe_sample_memory()
    with _counter_lock:
        _metrics_seq += 1
        seq = _metrics_seq
    steps = step_stats()
    walls = [s["wall_ms"] for s in steps]
    return {
        "schema": 1,
        "rank": _proc["rank"],
        "host": _proc["host"],
        "pid": _proc["pid"],
        "seq": seq,
        "time_unix": time.time(),
        "clock_offset_s": _proc["clock_offset_s"],
        "counters": counters(),
        "counter_labels": counter_labels(),
        "last_step": dict(steps[-1]) if steps else None,
        "window": {"n": len(steps),
                   "wall_ms_median": _median(walls) if walls else None,
                   "wall_ms_max": max(walls) if walls else None},
        "memory_watermark_bytes": memory_watermark(),
        "providers": _provider_metrics(),
    }


def publish_peer_metrics(snap):
    """Register a peer rank's metrics snapshot.  An older snapshot of the
    same process is dropped; a restarted peer (new pid) replaces its
    predecessor."""
    if not isinstance(snap, dict) or "rank" not in snap:
        return
    rank = int(snap["rank"])
    with _counter_lock:
        old = _peer_metrics.get(rank)
        if (old is None or old.get("pid") != snap.get("pid")
                or snap.get("seq", 0) >= old.get("seq", 0)):
            _peer_metrics[rank] = dict(snap)


def peer_metrics():
    """``{rank: snapshot}`` of the peers."""
    with _counter_lock:
        return {r: dict(s) for r, s in _peer_metrics.items()}


def forget_peer_metrics(rank):
    """Drop a departed rank's snapshot."""
    with _counter_lock:
        _peer_metrics.pop(int(rank), None)


def _cluster_snapshots():
    """The local snapshot first, then the peers by rank.  On a rank clash
    the local one wins, unless it has no step and the peer (another
    process) has."""
    local = metrics_snapshot()
    rows = [local]
    for rank, snap in sorted(peer_metrics().items()):
        if rank != local["rank"]:
            rows.append(snap)
        elif (snap.get("pid") != local.get("pid") and local.get("last_step") is None
              and snap.get("last_step") is not None):
            rows[0] = snap
    return rows


def _prom_escape(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")


def render_prometheus():
    """Every known snapshot (local and peers) as Prometheus text
    (exposition format 0.0.4): counters with their labels, each rank's last
    step and window, clock offsets, memory watermarks and provider
    gauges."""
    out = ["# HELP mxnet_profiler_counter_total profiler event counters",
           "# TYPE mxnet_profiler_counter_total counter"]
    gauges = _OrderedDict()

    def gauge(name, help_, labels, value):
        if value is None:
            return
        lab = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in labels)
        gauges.setdefault(name, (help_, []))[1].append(f"{name}{{{lab}}} {value}")

    for snap in _cluster_snapshots():
        base = (("rank", snap.get("rank")), ("host", snap.get("host", "?")))
        for cname, v in sorted((snap.get("counters") or {}).items()):
            lab = ",".join(f'{k}="{_prom_escape(v2)}"' for k, v2 in (("counter", cname),) + base)
            out.append(f"mxnet_profiler_counter_total{{{lab}}} {v}")
        for cname, labs in sorted((snap.get("counter_labels") or {}).items()):
            for reason, v in sorted((labs or {}).items()):
                lab = ",".join(f'{k}="{_prom_escape(v2)}"' for k, v2 in
                               (("counter", cname), ("reason", reason)) + base)
                out.append(f"mxnet_profiler_counter_total{{{lab}}} {v}")
        ls = snap.get("last_step") or {}
        gauge("mxnet_step_last_id", "id of the last closed step", base, ls.get("step"))
        for bucket in ("wall_ms", "host_ms", "comms_ms", "device_ms"):
            gauge(f"mxnet_step_last_{bucket}",
                  f"last closed step {bucket.replace('_', ' ')} split", base, ls.get(bucket))
        win = snap.get("window") or {}
        gauge("mxnet_step_window_n", "steps in the rolling telemetry window", base,
              win.get("n"))
        gauge("mxnet_step_wall_ms_median", "rolling-window median step wall", base,
              win.get("wall_ms_median"))
        gauge("mxnet_step_wall_ms_max", "rolling-window max step wall", base,
              win.get("wall_ms_max"))
        gauge("mxnet_clock_offset_seconds",
              "estimated wall-clock offset vs the cluster reference", base,
              snap.get("clock_offset_s"))
        gauge("mxnet_metrics_snapshot_seq", "snapshot sequence number", base, snap.get("seq"))
        for dev, b in sorted((snap.get("memory_watermark_bytes") or {}).items()):
            gauge("mxnet_memory_watermark_bytes", "peak device bytes in use observed",
                  base + (("device", dev),), b)
        for pkey, fields in sorted((snap.get("providers") or {}).items()):
            for field, v in sorted((fields or {}).items()):
                gauge(f"mxnet_{pkey}_{field}",
                      f"{pkey} subsystem gauge (registered metrics provider)", base, v)
    for name, (help_, lines) in gauges.items():
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} gauge")
        out.extend(lines)
    return "\n".join(out) + "\n"


class _MetricsExporter(_threading.Thread):
    """The periodic JSONL metrics log: one ``metrics_snapshot()`` object a
    line, appended."""

    def __init__(self, path, interval_s):
        super().__init__(name="mx-metrics-exporter", daemon=True)
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self.stop_event = _threading.Event()

    def run(self):
        while not self.stop_event.wait(self.interval_s):
            try:
                snap = metrics_snapshot()
                with open(self.path, "a") as f:
                    f.write(json.dumps(snap) + "\n")
            except Exception:
                pass  # telemetry must never take training down

    def stop(self):
        self.stop_event.set()


_metrics_http = None      # (ThreadingHTTPServer, serving thread)
_metrics_exporter = None  # _MetricsExporter
_metrics_lock = _threading.Lock()
# process health for /healthz: "serving" (200) until a graceful drain
# begins (serving.install_sigterm_drain), then "draining" (503)
_health = "serving"


def set_health(state):
    """Set the health ``/healthz`` reports ("serving" → 200, anything else
    → 503 with the state in the body)."""
    global _health
    _health = str(state)


def health_state():
    return _health


def _make_metrics_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            incr("metrics_scrape")
            path = self.path.split("?", 1)[0]
            status = 200
            if path in ("/", "/metrics"):
                body = render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps({"local": metrics_snapshot(),
                                   "peers": {str(r): s for r, s in
                                             peer_metrics().items()}}).encode()
                ctype = "application/json"
            elif path == "/healthz":
                state = health_state()
                body = (state + "\n").encode()
                ctype = "text/plain; charset=utf-8"
                status = 200 if state == "serving" else 503
            else:
                self.send_error(404)
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes must not spam stderr
            pass

    return Handler


def start_metrics(port=None, jsonl=None, interval_s=None):
    """Start the live metrics surface: the ``/metrics``, ``/metrics.json``
    and ``/healthz`` endpoint on localhost and/or the periodic JSONL log.
    ``port=None`` reads ``MXNET_METRICS_PORT`` (0 or unset: no endpoint);
    an explicit ``port=0`` binds a free port (read it back with
    ``metrics_server_port()``).  ``jsonl=None`` reads
    ``MXNET_METRICS_JSONL`` (unset: no log), written every ``interval_s``
    seconds (``MXNET_METRICS_INTERVAL_S``, default 10).  A port already
    taken warns and serves nothing.  Idempotent per surface."""
    global _metrics_http, _metrics_exporter
    env_port = port is None
    if env_port:
        port = _env_int("MXNET_METRICS_PORT", 0)
    if jsonl is None:
        jsonl = os.environ.get("MXNET_METRICS_JSONL") or None
    if interval_s is None:
        interval_s = _env_float("MXNET_METRICS_INTERVAL_S", 10.0)
    with _metrics_lock:
        if _metrics_http is None and (port > 0 or (port == 0 and not env_port)):
            from http.server import ThreadingHTTPServer

            try:
                srv = ThreadingHTTPServer(("127.0.0.1", port), _make_metrics_handler())
                srv.daemon_threads = True
                th = _threading.Thread(target=srv.serve_forever, name="mx-metrics-http",
                                       daemon=True)
                th.start()
                _metrics_http = (srv, th)
            except OSError as e:
                _warnings.warn(f"metrics endpoint: cannot bind port {port} ({e}); serving "
                               "no metrics from this process", RuntimeWarning, stacklevel=2)
        if jsonl and _metrics_exporter is None:
            _metrics_exporter = _MetricsExporter(jsonl, interval_s)
            _metrics_exporter.start()
    return metrics_server_port()


def metrics_server_port():
    with _metrics_lock:
        return _metrics_http[0].server_address[1] if _metrics_http else None


def stop_metrics():
    """Tear the metrics surface down (the endpoint and the JSONL log)."""
    global _metrics_http, _metrics_exporter
    with _metrics_lock:
        if _metrics_http is not None:
            srv, th = _metrics_http
            _metrics_http = None
            srv.shutdown()
            srv.server_close()
            th.join(5.0)
        if _metrics_exporter is not None:
            _metrics_exporter.stop()
            _metrics_exporter.join(5.0)
            _metrics_exporter = None


def straggler_report():
    """The slowest rank's last closed step among this process's and the
    peers' (``{"rank", "host", "step", "wall_ms", "host_ms", "comms_ms",
    "device_ms", "ranks_compared"}``), or None with fewer than two ranks of
    step data.  Peer snapshots older than ``MXNET_METRICS_PEER_TTL_S``
    (default 120) are left out; peer fields are read defensively."""
    rows = []
    steps = step_stats()
    if steps:
        with _counter_lock:
            me = dict(rank=_proc["rank"], host=_proc["host"])
        rows.append({**me, **steps[-1]})
    now_ref = time.time() - _proc["clock_offset_s"]
    ttl = _env_float("MXNET_METRICS_PEER_TTL_S", 120.0)
    for rank, snap in sorted(peer_metrics().items()):
        if rows and rank == rows[0]["rank"]:
            continue
        ls = snap.get("last_step")
        if not isinstance(ls, dict) or "wall_ms" not in ls:
            continue
        t = snap.get("time_unix")
        if ttl > 0 and isinstance(t, (int, float)):
            age = now_ref - (t - (snap.get("clock_offset_s") or 0.0))
            if age > ttl:
                continue
        rows.append({"rank": rank, "host": snap.get("host", "?"), **ls})
    if len(rows) < 2:
        return None
    worst = max(rows, key=lambda r: r.get("wall_ms", 0.0))
    return {"rank": worst["rank"], "host": worst["host"], "step": worst.get("step"),
            "wall_ms": worst.get("wall_ms", 0.0), "host_ms": worst.get("host_ms", 0.0),
            "comms_ms": worst.get("comms_ms", 0.0), "device_ms": worst.get("device_ms", 0.0),
            "ranks_compared": len(rows)}


# -- the goodput ledger ----------------------------------------------------------
# Run-scoped (not session-scoped): start/stop/pause/resume only open and
# close the wall window it integrates over; reset_goodput() zeroes it.
# Downtime (record_downtime) goes into its bucket and the wall.  The
# buckets sum to the wall by construction: compute is the clamped residue.
_goodput_acc = {"host": 0.0, "data_wait": 0.0, "comm": 0.0,
                "compile": 0.0, "checkpoint": 0.0, "downtime": 0.0}
_goodput_downtime = {}        # reason -> seconds
_goodput_wall_s = 0.0         # closed armed windows, summed
_goodput_win_t0 = _perf() if _active else None  # the open window's start
_goodput_bubble_base_ms = 0   # pipeline_bubble_ms at the last reset

_GOODPUT_BUCKETS = ("compute", "host", "data_wait", "comm", "compile",
                    "checkpoint", "bubble", "downtime")


def _goodput_open(now=None):
    global _goodput_win_t0
    with _counter_lock:
        if _goodput_win_t0 is None:
            _goodput_win_t0 = _perf() if now is None else now


def _goodput_close(now=None):
    global _goodput_wall_s, _goodput_win_t0
    with _counter_lock:
        if _goodput_win_t0 is not None:
            _goodput_wall_s += (_perf() if now is None else now) - _goodput_win_t0
            _goodput_win_t0 = None


def reset_goodput():
    """Zero the run ledger; reopen its window when the profiler is armed."""
    global _goodput_wall_s, _goodput_win_t0, _goodput_bubble_base_ms
    with _counter_lock:
        for k in _goodput_acc:
            _goodput_acc[k] = 0.0
        _goodput_downtime.clear()
        _goodput_wall_s = 0.0
        _goodput_win_t0 = _perf() if _active else None
        _goodput_bubble_base_ms = _counters.get("pipeline_bubble_ms", 0)


def record_downtime(seconds, reason="downtime"):
    """Account seconds this process did not exist or could not train (a
    supervisor's restart gap) into the downtime bucket and the wall."""
    seconds = float(seconds)
    if seconds <= 0:
        return
    reason = str(reason)
    with _counter_lock:
        _goodput_acc["downtime"] += seconds
        _goodput_downtime[reason] = _goodput_downtime.get(reason, 0.0) + seconds
    incr("goodput_downtime_ms", int(round(seconds * 1e3)))


def goodput_snapshot():
    """The run's wall-clock decomposition: ``{"schema", "rank", "host",
    "time_unix", "active", "wall_s", "goodput", "buckets_s": {compute,
    host, data_wait, comm, compile, checkpoint, bubble, downtime},
    "overhead_s", "top_overhead", "downtime_detail"}``; the buckets sum to
    ``wall_s`` and ``goodput`` is compute over wall (None before any
    wall)."""
    incr("goodput_snapshot")
    now = _perf()
    with _counter_lock:
        acc = dict(_goodput_acc)
        wall = _goodput_wall_s
        if _goodput_win_t0 is not None:
            wall += now - _goodput_win_t0
        bubble_ms = max(0, _counters.get("pipeline_bubble_ms", 0) - _goodput_bubble_base_ms)
        detail = dict(_goodput_downtime)
        rank, host = _proc["rank"], _proc["host"]
        armed = _goodput_win_t0 is not None
    wall += acc["downtime"]
    buckets = {"host": acc["host"], "data_wait": acc["data_wait"], "comm": acc["comm"],
               "compile": acc["compile"], "checkpoint": acc["checkpoint"],
               "bubble": bubble_ms / 1e3, "downtime": acc["downtime"]}
    overhead = sum(buckets.values())
    buckets["compute"] = max(0.0, wall - overhead)
    buckets = {k: round(buckets[k], 6) for k in _GOODPUT_BUCKETS}
    top = sorted(((k, v) for k, v in buckets.items() if k != "compute" and v > 0),
                 key=lambda kv: -kv[1])
    return {
        "schema": 1,
        "rank": rank,
        "host": host,
        "time_unix": time.time(),
        "active": armed,
        "wall_s": round(wall, 6),
        "goodput": round(buckets["compute"] / wall, 6) if wall > 0 else None,
        "buckets_s": buckets,
        "overhead_s": round(min(overhead, wall), 6),
        "top_overhead": [[k, v] for k, v in top[:3]],
        "downtime_detail": {k: round(v, 6) for k, v in detail.items()},
    }


def _goodput_provider():
    """The built-in "goodput" metrics provider: the ledger as flat gauges."""
    snap = goodput_snapshot()
    out = {"wall_s": snap["wall_s"], "goodput": snap["goodput"]}
    for k, v in snap["buckets_s"].items():
        out[f"{k}_s"] = v
    return out


register_metrics_provider("goodput", _goodput_provider)


def cluster_goodput():
    """Whole-job goodput over every known rank: ``{"schema", "ranks",
    "wall_s", "goodput", "worst": {"rank", "host", "goodput", "bucket",
    "bucket_s"}}`` (wall-weighted; the worst rank with its largest overhead
    bucket), or None when no rank has any wall."""
    rows = []
    for snap in _cluster_snapshots():
        g = (snap.get("providers") or {}).get("goodput")
        if not isinstance(g, dict):
            continue
        wall = g.get("wall_s")
        if not isinstance(wall, (int, float)) or wall <= 0:
            continue
        rows.append((snap.get("rank", -1), snap.get("host", "?"), g))
    if not rows:
        return None
    tot_wall = sum(g["wall_s"] for _, _, g in rows)
    tot_compute = sum(g.get("compute_s") or 0.0 for _, _, g in rows)
    worst_rank, worst_host, worst = min(
        rows, key=lambda r: (r[2].get("goodput") is None, r[2].get("goodput") or 0.0))
    over = [(k[:-2], v) for k, v in worst.items()
            if k.endswith("_s") and k not in ("wall_s", "compute_s")
            and isinstance(v, (int, float)) and v > 0]
    top = max(over, key=lambda kv: kv[1]) if over else (None, 0.0)
    return {"schema": 1, "ranks": len(rows), "wall_s": round(tot_wall, 6),
            "goodput": round(tot_compute / tot_wall, 6) if tot_wall > 0 else None,
            "worst": {"rank": worst_rank, "host": worst_host, "goodput": worst.get("goodput"),
                      "bucket": top[0], "bucket_s": round(top[1], 6)}}


# -- device memory ---------------------------------------------------------------
_mem_lock = _threading.Lock()
_mem_owners = {}        # owner name -> MemoryTracker (THE ledger)
_mem_postmortems = []
_MAX_POSTMORTEMS = 64


class MemoryTracker:
    """Owner-scoped accounting handle of :func:`track_memory`: ``alloc`` and
    ``free`` move bytes in and out of the owner's row, ``set`` pins a
    total, ``close`` removes a sole owner's row."""

    __slots__ = ("owner", "category", "bytes", "peak", "allocs", "frees")

    def __init__(self, owner, category):
        self.owner = str(owner)
        self.category = str(category)
        self.bytes = self.peak = self.allocs = self.frees = 0

    def alloc(self, nbytes):
        with _mem_lock:
            self.bytes += int(nbytes)
            self.allocs += 1
            self.peak = max(self.peak, self.bytes)
        return self

    def free(self, nbytes):
        with _mem_lock:
            self.bytes -= int(nbytes)
            self.frees += 1
        return self

    def set(self, nbytes):
        with _mem_lock:
            self.bytes = int(nbytes)
            self.peak = max(self.peak, self.bytes)
        return self

    def close(self):
        with _mem_lock:
            self.bytes = 0
            if _mem_owners.get(self.owner) is self:
                del _mem_owners[self.owner]

    def __repr__(self):
        return f"MemoryTracker({self.owner!r}, {self.category!r}, bytes={self.bytes})"


def array_nbytes(x):
    """Footprint of a tensor / NDArray / list of them from shape × dtype
    (never touches the buffer); None and unshaped objects count 0."""
    if x is None:
        return 0
    if isinstance(x, (list, tuple)):
        return sum(array_nbytes(s) for s in x)
    t = getattr(x, "_data", x)
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def track_memory(owner, category="other"):
    """Register (or look up) a ledger owner and return its tracker."""
    with _mem_lock:
        t = _mem_owners.get(str(owner))
        if t is None:
            t = _mem_owners[str(owner)] = MemoryTracker(owner, category)
        return t


def memory_ledger():
    """``{"owners": {owner: {category, bytes, peak, allocs, frees}},
    "by_category": {category: bytes}, "total_bytes": int}``."""
    with _mem_lock:
        owners = {o: {"category": t.category, "bytes": t.bytes, "peak": t.peak,
                      "allocs": t.allocs, "frees": t.frees} for o, t in _mem_owners.items()}
    cats = {}
    for info in owners.values():
        cats[info["category"]] = cats.get(info["category"], 0) + info["bytes"]
    return {"owners": owners, "by_category": cats,
            "total_bytes": sum(i["bytes"] for i in owners.values())}


def _ledger_categories():
    """Flat ``{category: bytes}`` plus ``total`` for the counter track."""
    with _mem_lock:
        if not _mem_owners:
            return {}
        cats = {}
        for t in _mem_owners.values():
            cats[t.category] = cats.get(t.category, 0) + t.bytes
        cats["total"] = sum(t.bytes for t in _mem_owners.values())
    return cats


def memory_postmortems():
    with _mem_lock:
        return [dict(r) for r in _mem_postmortems]


_OOM_TOKENS = ("out of memory", "Out of memory", "OutOfMemory", "RESOURCE_EXHAUSTED")


def is_resource_exhausted(exc):
    """Whether an exception is a device allocation failure
    (``torch.cuda.OutOfMemoryError``, a refused :class:`MemoryBudget`, or a
    message saying "out of memory")."""
    if exc is None:
        return False
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryBudgetError)):
        return True
    msg = str(exc)
    return any(t in msg for t in _OOM_TOKENS)


def _parse_failed_bytes(msg):
    """The size of the failed allocation from an OOM message (PyTorch's
    ``Tried to allocate 20.00 MiB``, XLA's ``trying to allocate N bytes``);
    None when there is none."""
    import re

    m = re.search(r"(?:allocat\w+|reserve)\s+([0-9][0-9.]*)\s*(bytes?|[KMG]i?B?\b)?",
                  msg or "", re.IGNORECASE)
    if not m:
        return None
    try:
        val = float(m.group(1))
    except ValueError:
        return None
    unit = (m.group(2) or "bytes").upper()
    return int(val * {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(unit[0], 1))


def _fmt_bytes(n):
    if n is None:
        return "?"
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"


def oom_postmortem(where, failed_bytes=None, error=None, kind="oom"):
    """Emit ONE device-memory postmortem (top ledger owners, per-category
    totals, live device stats, the failed allocation's size, the current
    step) as an ERROR log line; returns the report.  ``kind`` is ``"oom"``
    (a device allocation failed) or ``"budget"`` (:meth:`MemoryBudget.check`
    refused one)."""
    led = memory_ledger()
    top = sorted(led["owners"].items(), key=lambda kv: -kv[1]["bytes"])[:8]
    report = {"kind": kind, "where": str(where), "time_unix": time.time(), "step": _step_id,
              "failed_bytes": failed_bytes,
              "error": str(error)[:500] if error is not None else None,
              "device": device_memory_stats(), "ledger_total_bytes": led["total_bytes"],
              "by_category": led["by_category"],
              "top_owners": [{"owner": o, **info} for o, info in top]}
    with _mem_lock:
        _mem_postmortems.append(report)
        del _mem_postmortems[:-_MAX_POSTMORTEMS]
    incr("memory_oom_postmortem")
    _logger.error("device-memory postmortem at %s: failed to allocate %s (%s): %s; ledger "
                  "attributes %s, top owners %s", where, _fmt_bytes(failed_bytes), kind,
                  str(error)[:200], _fmt_bytes(led["total_bytes"]),
                  [(o, i["bytes"]) for o, i in top[:4]])
    return report


def maybe_oom_postmortem(exc, where):
    """When ``exc`` is a device allocation failure, emit exactly one
    postmortem for it (it rides on the exception); returns the report, or
    None for unrelated errors.  Callers re-raise ``exc``."""
    if not is_resource_exhausted(exc):
        return None
    rep = getattr(exc, "_mx_postmortem", None)
    if rep is None:
        rep = oom_postmortem(where, failed_bytes=_parse_failed_bytes(str(exc)), error=exc)
        try:
            exc._mx_postmortem = rep
        except Exception:
            pass
    return rep


class MemoryBudgetError(RuntimeError):
    """An allocation was refused by :meth:`MemoryBudget.check`; the
    budget's postmortem rides on ``._mx_postmortem``."""


class MemoryBudget:
    """The admission API device-buffer holders consult.

    ``limit_mb``: an explicit budget in MiB; None follows
    ``MXNET_MEM_BUDGET_MB`` at every call (0 or unset: no explicit cap,
    only the card's own total caps).  ``pressure_frac``: the occupancy
    counted as pressure (``MXNET_MEM_PRESSURE_FRAC``, default 0.95).
    ``usage_bytes()`` is the caching allocator's live bytes on the busiest
    card when a card is in use, else the ledger's total, so a budget works
    on the CPU as on the card."""

    def __init__(self, limit_mb=None, pressure_frac=None):
        self._limit_mb = limit_mb
        self.pressure_frac = (float(pressure_frac) if pressure_frac is not None
                              else _env_float("MXNET_MEM_PRESSURE_FRAC", 0.95))

    @property
    def limit_bytes(self):
        mb = self._limit_mb
        if mb is None:
            mb = _env_float("MXNET_MEM_BUDGET_MB", 0.0)
        return int(float(mb) * (1 << 20)) if mb else None

    @staticmethod
    def _usage(stats):
        if stats:
            return max(s["bytes_in_use"] for s in stats.values())
        return memory_ledger()["total_bytes"]

    def usage_bytes(self):
        return self._usage(device_memory_stats())

    def headroom_bytes(self):
        """Bytes left under the explicit limit; None when uncapped."""
        limit = self.limit_bytes
        return None if limit is None else limit - self.usage_bytes()

    def would_fit(self, nbytes=0):
        """Whether ``nbytes`` more fit: under the explicit limit when one is
        set, else under every card's total."""
        n = int(nbytes)
        stats = device_memory_stats()
        limit = self.limit_bytes
        if limit is not None:
            return self._usage(stats) + n <= limit
        return all(not s["bytes_limit"] or s["bytes_in_use"] + n <= s["bytes_limit"]
                   for s in stats.values())

    def under_pressure(self, frac=None):
        """Whether occupancy exceeds ``frac`` of a card's total or of the
        explicit budget: the signal ``GenerationServer``'s admission reads."""
        frac = self.pressure_frac if frac is None else float(frac)
        stats = device_memory_stats()
        if any(s["bytes_limit"] and s["bytes_in_use"] > frac * s["bytes_limit"]
               for s in stats.values()):
            return True
        limit = self.limit_bytes
        return limit is not None and self._usage(stats) > frac * limit

    def check(self, nbytes, owner="?"):
        """Raise :class:`MemoryBudgetError`, with exactly one postmortem,
        when ``nbytes`` does not fit."""
        if self.would_fit(nbytes):
            return
        rep = oom_postmortem(f"budget:{owner}", failed_bytes=int(nbytes), kind="budget")
        err = MemoryBudgetError(
            f"memory budget refused {_fmt_bytes(int(nbytes))} for {owner!r}: usage "
            f"{_fmt_bytes(self.usage_bytes())} of limit {_fmt_bytes(self.limit_bytes)} "
            "(MXNET_MEM_BUDGET_MB / MemoryBudget)")
        err._mx_postmortem = rep
        raise err

    def stats(self):
        return {"limit_bytes": self.limit_bytes, "pressure_frac": self.pressure_frac,
                "usage_bytes": self.usage_bytes()}


_process_budget = None


def memory_budget():
    """The process-wide :class:`MemoryBudget`, which follows
    ``MXNET_MEM_BUDGET_MB``."""
    global _process_budget
    if _process_budget is None:
        _process_budget = MemoryBudget()
    return _process_budget


def _memory_provider():
    """The built-in "memory" metrics provider: ledger totals per category,
    owners, postmortems and the busiest card's occupancy."""
    led = memory_ledger()
    out = {"ledger_bytes": led["total_bytes"], "owners": len(led["owners"])}
    for cat, b in led["by_category"].items():
        out[f"{cat}_bytes"] = b
    with _mem_lock:
        out["postmortems"] = len(_mem_postmortems)
    stats = device_memory_stats()
    if stats:
        out["device_bytes_in_use"] = max(s["bytes_in_use"] for s in stats.values())
        out["device_bytes_limit"] = max(s["bytes_limit"] for s in stats.values())
    b = _process_budget
    if b is not None and b.limit_bytes is not None:
        out["budget_limit_bytes"] = b.limit_bytes
    return out


register_metrics_provider("memory", _memory_provider)


# -- compile accounting --------------------------------------------------------
# Where the JAX package compiles a program, the port builds one: an
# executor's plan, a stateful program's first call, the step fold's
# capture.  Each reports here with its signature; a build of a program the
# site built before at another signature is a recompile, diffed against the
# nearest cached signature and named in one attribution line.
class CompileGuardError(RuntimeError):
    """A plan was built while the steady-state compile guard was armed and
    ``MXNET_COMPILE_GUARD=raise``."""


_compile_lock = _threading.Lock()
_compile_records = []      # bounded FIFO of per-build record dicts
_compile_sites = {}        # site -> {"count", "ms", "recompiles", "sigs"}
_MAX_COMPILE_RECORDS = _env_int("MXNET_COMPILE_LOG_SIZE", 4096)
_MAX_SITE_SIGS = 128
_site_tls = _threading.local()
_guard = {"armed": False, "armed_by": None, "warned": False, "boundaries": 0, "paused": 0}


def _guard_mode():
    """None (off), "warn" or "raise": ``set_config(compile_guard=...)``
    wins over ``MXNET_COMPILE_GUARD``; any other value there than None
    ("off", False) forces the guard off."""
    v = _config.get("compile_guard")
    if v is None:
        v = os.environ.get("MXNET_COMPILE_GUARD") or None
    return v if v in ("warn", "raise") else None


def _guard_warmup_steps():
    v = _config.get("compile_warmup_steps")
    if v is None:
        return _env_int("MXNET_COMPILE_WARMUP_STEPS", 32)
    return int(v)


def jit_cache_size(fn):
    """How many signatures a bound program has built: the counterpart of
    the reference's jit cache size, for a program of
    ``predictor.StatefulExecutor`` (anything with a ``signatures`` set); a
    growth across a call is one build.  -1 for anything else, so that a
    caller records nothing rather than a build that did not happen."""
    sigs = getattr(fn, "signatures", None)
    return len(sigs) if sigs is not None else -1


def compile_cost_enabled():
    """Whether a site should work out a build's cost for the registry
    (``MXNET_COMPILE_COST=1`` / ``set_config(compile_cost=True)``)."""
    v = _config.get("compile_cost")
    if v is None:
        return os.environ.get("MXNET_COMPILE_COST", "0") == "1"
    return bool(v)


def arm_compile_guard(source="manual"):
    """From now on every build reported to the registry counts as a
    steady-state violation (``recompile_steady_state``);
    ``InferenceServer.start()`` arms it after its bucket warm-up, the step
    fold after its capture."""
    with _compile_lock:
        if not _guard["armed"]:
            _guard["armed"] = True
            _guard["armed_by"] = source


def disarm_compile_guard():
    """Disarm the guard and reset its warn-once latch and warm-up count."""
    with _compile_lock:
        _guard["armed"] = False
        _guard["armed_by"] = None
        _guard["warned"] = False
        _guard["boundaries"] = 0


def compile_guard_state():
    with _compile_lock:
        return {"armed": _guard["armed"], "armed_by": _guard["armed_by"],
                "mode": _guard_mode(), "paused": _guard["paused"] > 0,
                "warmup_steps": _guard_warmup_steps(), "boundaries": _guard["boundaries"]}


class compile_guard_paused:
    """Builds inside the block are registered but not judged (a declared
    warm-up phase)."""

    def __enter__(self):
        with _compile_lock:
            _guard["paused"] += 1
        return self

    def __exit__(self, *a):
        with _compile_lock:
            _guard["paused"] -= 1
        return False


def _guard_tick():
    """Count one step boundary toward the ``MXNET_COMPILE_WARMUP_STEPS``
    auto-arm (profiler armed or not)."""
    if _guard["armed"] or _guard_mode() is None:
        return
    with _compile_lock:
        _guard["boundaries"] += 1
        if _guard["boundaries"] >= _guard_warmup_steps():
            _guard["armed"] = True
            _guard["armed_by"] = "warmup_steps"


class compile_site:
    """``with profiler.compile_site('serving.warmup'):``: nested
    ``record_compile`` calls on this thread report under this label
    (innermost wins)."""

    __slots__ = ("_label",)

    def __init__(self, label):
        self._label = str(label)

    def __enter__(self):
        st = getattr(_site_tls, "stack", None)
        if st is None:
            st = _site_tls.stack = []
        st.append(self._label)
        return self

    def __exit__(self, *a):
        _site_tls.stack.pop()
        return False


def _active_site(site):
    st = getattr(_site_tls, "stack", None)
    return st[-1] if st else site


def sig_array(a):
    """Signature token of a tensor argument: shape and dtype (named as the
    JAX package names it, ``float32``)."""
    t = getattr(a, "_data", a)
    try:
        return {"k": "array", "shape": tuple(int(d) for d in t.shape),
                "dtype": str(t.dtype).replace("torch.", "")}
    except Exception:
        return sig_static(type(a).__name__)


def sig_static(v):
    """Signature token of a static value."""
    return {"k": "static", "value": repr(v)[:120]}


def _tok_str(tok):
    if not isinstance(tok, dict):
        return str(tok)
    if tok.get("k") == "array":
        out = f"{tok.get('dtype', '?')}[{'x'.join(str(d) for d in tok.get('shape', ()))}]"
        if "sharding" in tok:
            out += f"@{tok['sharding']}"
        return out
    return str(tok.get("value"))


_DRIFT_NAMES = {"shape": "shape drift", "dtype": "dtype flip", "static": "new static value",
                "sharding": "sharding change", "kind": "array/static kind change",
                "added": "new argument", "removed": "argument removed"}


def diff_signatures(old, new):
    """What changed between two signatures: a list of ``{"arg", "kind",
    "old", "new"}``, kind one of shape / dtype / sharding / static / kind /
    added / removed."""
    findings = []
    for name in sorted(set(old) | set(new)):
        if name == "__program__":
            continue
        o, n = old.get(name), new.get(name)
        if o == n:
            continue
        if o is None or n is None:
            findings.append({"arg": name, "kind": "added" if o is None else "removed",
                             "old": _tok_str(o) if o else None,
                             "new": _tok_str(n) if n else None})
            continue
        o = o if isinstance(o, dict) else {"k": "static", "value": str(o)}
        n = n if isinstance(n, dict) else {"k": "static", "value": str(n)}
        if o.get("k") != n.get("k"):
            kind = "kind"
        elif o.get("k") == "array":
            if tuple(o.get("shape", ())) != tuple(n.get("shape", ())):
                kind = "shape"
            elif o.get("dtype") != n.get("dtype"):
                kind = "dtype"
            else:
                kind = "sharding"
        else:
            kind = "static"
        findings.append({"arg": name, "kind": kind, "old": _tok_str(o), "new": _tok_str(n)})
    return findings


def _attribution_line(findings):
    if not findings:
        return "identical signature recompiled (jit cache evicted?)"
    f = findings[0]
    line = f"argument {f['arg']!r}: {_DRIFT_NAMES.get(f['kind'], f['kind'])} {f['old']} -> {f['new']}"
    if len(findings) > 1:
        line += f" (+{len(findings) - 1} more drifted)"
    return line


def _sig_key(signature):
    return repr(sorted((k, sorted(v.items()) if isinstance(v, dict) else v)
                       for k, v in signature.items()))


def _sig_similarity(a, b):
    """How alike two signatures are, field by field: 4 an equal argument, 1
    an equal shape / dtype / sharding of an array that differs."""
    score = 0
    for k, av in a.items():
        bv = b.get(k)
        if bv is None:
            continue
        if av == bv:
            score += 4
        elif (isinstance(av, dict) and isinstance(bv, dict)
              and av.get("k") == "array" and bv.get("k") == "array"):
            score += tuple(av.get("shape", ())) == tuple(bv.get("shape", ()))
            score += av.get("dtype") == bv.get("dtype")
            score += av.get("sharding") == bv.get("sharding")
    return score


def _extract_cost(lowered):
    """The cost a site handed over: a mapping of figures (``flops``,
    ``bytes_accessed``, ``temp_bytes``, ``code_bytes``...) or an object
    whose ``cost_analysis()`` returns one; its numbers, or None.  Never
    raises."""
    try:
        src = lowered if isinstance(lowered, dict) else lowered.cost_analysis()
        out = {str(k).replace(" ", "_"): v for k, v in dict(src).items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    except Exception:
        return None
    return out or None


def record_compile(site, signature, wall_ms, fn=None, args=None, kwargs=None, lowered=None):
    """Report one build (an executor's plan, a stateful program's first call
    or a step fold's capture at a new signature) into the registry.

    ``signature`` maps names to :func:`sig_array` / :func:`sig_static`
    tokens, plus an optional ``"__program__"``; ``wall_ms`` is the build's
    wall time; ``fn`` the built callable, whose qualified name the record
    keeps as ``"fn"``.  The record's ``"cost"`` is what the site hands over
    in ``lowered`` (see ``_extract_cost``), or, when
    :func:`compile_cost_enabled`, ``fn.cost_analysis(*args, **kwargs)`` if
    ``fn`` has one; else None: the port has no compiler cost analysis.  A
    build of a program the site built before is a recompile, logged with
    the attribution line.  With the guard armed it counts in
    ``recompile_steady_state``, and ``MXNET_COMPILE_GUARD=raise`` raises
    :class:`CompileGuardError` after the bookkeeping."""
    site = _active_site(str(site))
    signature = dict(signature or {})
    program = signature.get("__program__")
    wall_ms = float(wall_ms)
    if lowered is None and fn is not None and compile_cost_enabled():
        cost_fn = getattr(fn, "cost_analysis", None)
        if callable(cost_fn):
            try:
                lowered = cost_fn(*(args or ()), **(kwargs or {}))
            except Exception:
                lowered = None
    cost = _extract_cost(lowered) if lowered is not None else None
    if cost and cost.get("code_bytes"):
        track_memory("compiled_programs", "programs").alloc(cost["code_bytes"])
    key = _sig_key(signature)
    now = _perf()
    with _compile_lock:
        ent = _compile_sites.setdefault(site, {"count": 0, "ms": 0.0, "recompiles": 0,
                                               "sigs": _OrderedDict()})
        sigs = ent["sigs"]
        recompile, findings = False, []
        if key in sigs:
            recompile = True  # a signature this site built before
            sigs.move_to_end(key)
        else:
            peers = [s for s in sigs.values() if s.get("__program__") == program]
            if peers:
                recompile = True
                nearest = max(reversed(peers), key=lambda s: _sig_similarity(s, signature))
                findings = diff_signatures(nearest, signature)
            sigs[key] = signature
            while len(sigs) > _MAX_SITE_SIGS:
                sigs.popitem(last=False)
        ent["count"] += 1
        ent["ms"] += wall_ms
        ent["recompiles"] += recompile
        armed = _guard["armed"] and _guard["paused"] == 0
        attribution = _attribution_line(findings) if recompile else None
        rec = {"site": site, "program": program, "signature": signature,
               "fn": None if fn is None else getattr(fn, "__qualname__", repr(fn)),
               "wall_ms": round(wall_ms, 3), "step": _step_id, "time_unix": time.time(),
               "recompile": recompile, "attribution": attribution, "findings": findings,
               "steady_state": armed, "cost": cost}
        _compile_records.append(rec)
        del _compile_records[:-_MAX_COMPILE_RECORDS]
    incr("compile_total")
    incr("compile_ms_total", int(round(wall_ms)))
    if armed:
        incr("recompile_steady_state")
    if _active:
        record_span("compile.jit", "compile", now - wall_ms / 1e3, now,
                    args={"site": site, "wall_ms": round(wall_ms, 3), "program": program})
        if recompile:
            record_span("compile.recompile", "compile", now, now,
                        args={"site": site, "attribution": attribution})
    if recompile:
        _logger.info("recompile at %s%s: %s (wall %.1f ms, step %d)", site,
                     f" [{program}]" if program else "", attribution, wall_ms, rec["step"])
    if armed:
        mode = _guard_mode()
        if mode == "raise":
            raise CompileGuardError(
                f"steady-state compile guard (armed by {_guard['armed_by']}): {site} built "
                f"{'— ' + attribution if attribution else 'a new program'} after warmup "
                f"(wall {wall_ms:.1f} ms)")
        if mode == "warn":
            with _compile_lock:
                first = not _guard["warned"]
                _guard["warned"] = True
            if first:
                _logger.warning("steady-state compile guard (armed by %s): %s built a plan "
                                "after warmup%s (wall %.1f ms); further violations count in "
                                "recompile_steady_state without logging", _guard["armed_by"],
                                site, f" — {attribution}" if attribution else "", wall_ms)
    return rec


def compile_registry():
    """``{"sites": {site: {count, ms, recompiles, signatures}}, "records":
    [...]}``: what ``dump()`` embeds under ``otherData.compiles`` and
    ``tools/compile_report.py`` reads."""
    with _compile_lock:
        sites = {s: {"count": e["count"], "ms": round(e["ms"], 3),
                     "recompiles": e["recompiles"], "signatures": len(e["sigs"])}
                 for s, e in _compile_sites.items()}
        records = [dict(r) for r in _compile_records]
    return {"sites": sites, "records": records}


def compile_stats():
    """Per-site build summary ``{site: {count, ms, recompiles, signatures}}``."""
    return compile_registry()["sites"]


def reset_compiles():
    """Drop every build record and cached signature (tests; a fresh
    measurement window).  The guard's state is apart:
    :func:`disarm_compile_guard`."""
    with _compile_lock:
        _compile_records.clear()
        _compile_sites.clear()


def _compile_provider():
    """The built-in "compile" metrics provider: per-site counts and wall
    totals as flat gauges."""
    out = {}
    total = ms = rec = 0
    with _compile_lock:
        for site, e in _compile_sites.items():
            k = site.replace(".", "_")
            out[f"{k}_total"] = e["count"]
            out[f"{k}_ms"] = round(e["ms"], 3)
            out[f"{k}_recompiles"] = e["recompiles"]
            total += e["count"]
            ms += e["ms"]
            rec += e["recompiles"]
    out["total"] = total
    out["ms_total"] = round(ms, 3)
    out["recompiles"] = rec
    out["guard_armed"] = 1 if _guard["armed"] else 0
    return out


register_metrics_provider("compile", _compile_provider)


# -- control surface and the device trace --------------------------------------
def set_config(**kwargs):
    """Parity: ``mx.profiler.set_config``; unknown keys are accepted and
    ignored.  Meaningful keys: ``filename``, ``ring_size`` (from the next
    ``start()``), ``slow_step_ms``, ``slow_step_auto``,
    ``slow_step_auto_mult``, ``step_window``, ``memory_sampling``,
    ``compile_guard`` ("warn"/"raise"/None, over ``MXNET_COMPILE_GUARD``),
    ``compile_warmup_steps`` and ``compile_cost``."""
    global _telemetry, _active, _step_t0
    _config.update(kwargs)
    if "slow_step_ms" in kwargs:
        was_active = _active
        _telemetry = (kwargs["slow_step_ms"] is not None
                      or os.environ.get("MXNET_PROFILER_SLOW_STEP_MS") is not None)
        _active = _recording or _telemetry
        if _active and not was_active:
            _step_t0 = None  # re-anchor: the disabled gap is no step's time
            _goodput_open()
        elif was_active and not _active:
            _goodput_close()


def state():
    return "running" if _state["running"] else "stopped"


_trace_warned = False


def _trace_error(what, exc):
    """A device trace that fails warns once a process and always counts."""
    global _trace_warned
    incr("profiler_trace_error")
    if not _trace_warned:
        _trace_warned = True
        _warnings.warn(f"torch.profiler {what} failed ({type(exc).__name__}: {exc}); the "
                       "device trace is unavailable for this run, the span recorder still "
                       "captures host spans (warned once; see the profiler_trace_error "
                       "counter)", RuntimeWarning, stacklevel=3)


# kernels of the device trace, accumulated over the sessions since the last
# fresh start(): name -> [count, total µs]
_device_ops = {}
_trace_files = [0]
# kineto keeps only the records whose device time, mapped onto the host's
# clock, falls inside the session; late in a long process on the card that
# mapping ran tens of ms late and cut the last kernels of a step off the
# table, so a session outlives the synchronize by this much
_TRACE_TAIL_S = 0.2


def _start_device_trace(trace_dir):
    """Open a ``torch.profiler`` session over the card's kernels; None on a
    machine without a card (nothing to trace)."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    sess = profile(activities=[ProfilerActivity.CUDA])
    sess.start()
    return sess


def _stop_device_trace(sess, trace_dir):
    """Close a session: its kernels join the device table and its trace is
    written into the trace directory."""
    torch.cuda.synchronize()  # kernels still queued would miss the session
    time.sleep(_TRACE_TAIL_S)
    sess.stop()
    skip = set(_agg)  # scopes and markers show up as device ranges too
    rows = {}
    for ev in sess.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.name in skip or ev.name.startswith("mx."):
            continue
        r = rows.setdefault(ev.name, [0, 0.0])
        r[0] += 1
        r[1] += ev.time_range.elapsed_us()
    with _counter_lock:
        for name, (n, us) in rows.items():
            r = _device_ops.setdefault(name, [0, 0.0])
            r[0] += n
            r[1] += us
    _trace_files[0] += 1
    sess.export_chrome_trace(os.path.join(trace_dir, f"device_{os.getpid()}_"
                                                     f"{_trace_files[0]}.json"))


def _device_op_stats(topn=40):
    """The device trace's kernels as ``[(name, count, total_s)]``, longest
    first: the counterpart of the JAX package's per-HLO-op table."""
    with _counter_lock:
        rows = [(k, c, us / 1e6) for k, (c, us) in _device_ops.items()]
    rows.sort(key=lambda r: -r[2])
    return rows[:topn]


def _arm(fresh):
    """The body of start and resume: open the device trace and arm the span
    recorder; ``fresh`` discards earlier spans, telemetry and device
    rows."""
    global _recording, _active, _ring_gen, _step_t0, _step_thread, _armed_at
    logdir = os.path.dirname(os.path.abspath(_config["filename"])) or "."
    trace_dir = os.path.join(logdir, "device_trace")
    os.makedirs(trace_dir, exist_ok=True)
    try:
        _state["trace"] = _start_device_trace(trace_dir)
    except Exception as e:  # the recorder still arms; the failure is visible
        _state["trace"] = None
        _trace_error("start", e)
    with _counter_lock:
        # the bucket sums restart with the step clock: a pause mid-step
        # leaves a partial step's sums behind
        _step_acc["host"] = 0.0
        _step_acc["comms"] = 0.0
        if fresh:
            _ring_gen += 1
            _rings.clear()
            _evicted[0] = _evicted[1] = 0
            _step_window.clear()
            _mem_watermark.clear()
            _mem_samples.clear()
            _device_ops.clear()
    _armed_at = _step_t0 = _perf()
    _step_thread = _threading.get_ident()
    _recording = True
    _active = True
    _goodput_open(_armed_at)
    _state.update(running=True, dir=trace_dir, t0=time.perf_counter())


def start():
    """Start a fresh recording session: arm the span recorder (dropping
    earlier spans and telemetry) and open a device trace into
    ``dirname(filename)/device_trace``."""
    if _state["running"]:
        return
    _arm(fresh=True)


def resume():
    """Re-arm after ``pause()`` keeping what was recorded before it."""
    if _state["running"]:
        return
    _arm(fresh=False)


def stop():
    """Disarm the span recorder and close the device trace; recorded spans
    survive for ``dump()``."""
    global _recording, _active, _step_t0
    if not _state["running"]:
        return
    sess = _state["trace"]
    if sess is not None:
        _state["trace"] = None
        try:
            _stop_device_trace(sess, _state["dir"])
        except Exception as e:
            _trace_error("stop", e)
    _recording = False
    _active = _telemetry
    _step_t0 = None  # a later telemetry-only boundary anchors afresh
    if not _active:
        _goodput_close()
    _state["running"] = False


pause = stop  # stop keeps recorded spans, so pause/resume accumulates


def _trace_events():
    """Recorded spans as chrome-trace B/E pairs, nested validly per thread
    (ties: E before B, outer B before inner B), and the memory counter
    track as "C" events."""
    pid = os.getpid()
    with _counter_lock:
        rings = list(_rings)
    keyed = []
    for r in rings:
        for ev in r.snapshot():
            if ev is None:
                continue
            name, cat, t0, t1, step, args = ev
            ts = (t0 - _EPOCH) * 1e6
            te = (t1 - _EPOCH) * 1e6
            if te <= ts:
                te = ts + 0.001
            a = {"step": step}
            if args:
                a.update(args)
            keyed.append(((ts, 1, ts - te), {"ph": "B", "name": name, "cat": cat, "ts": ts,
                                             "pid": pid, "tid": r.tid, "args": a}))
            keyed.append(((te, 0, te - ts), {"ph": "E", "name": name, "cat": cat, "ts": te,
                                             "pid": pid, "tid": r.tid}))
    keyed.sort(key=lambda kv: kv[0])
    events = [{"ph": "M", "pid": pid, "name": "process_name",
               "args": {"name": f"rank {_proc['rank']} ({_proc['host']})"}}]
    events.extend({"ph": "M", "pid": pid, "tid": r.tid, "name": "thread_name",
                   "args": {"name": r.tname}} for r in rings)
    events.extend(e for _, e in keyed)
    with _counter_lock:
        samples = list(_mem_samples)
    for t, dev_use, cats in samples:
        ts = (t - _EPOCH) * 1e6
        for dev, b in dev_use.items():
            events.append({"ph": "C", "name": f"memory {dev}", "pid": pid, "ts": ts,
                           "args": {"bytes_in_use": b}})
        if cats:
            events.append({"ph": "C", "name": "memory ledger", "pid": pid, "ts": ts,
                           "args": dict(cats)})
    return events


def dump(finished=True, profile_process="worker"):
    """Write the recorded spans as chrome://tracing JSON to
    ``set_config(filename=...)`` (parity: ``mx.profiler.dump``), with the
    process metadata, counters, steps, memory, recorder, goodput and
    compile registry under ``otherData``.  ``finished`` also stops the
    recorder; ``MXNET_PROFILER_TRACE_GZ=1`` gzips the file (``.gz`` is
    appended).  Returns the path."""
    path = _config["filename"]
    gz = os.environ.get("MXNET_PROFILER_TRACE_GZ", "0") == "1"
    if gz and not path.endswith(".gz"):
        path += ".gz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "traceEvents": _trace_events(),
        "displayTimeUnit": "ms",
        "otherData": {
            "process": process_info(),
            "counters": counters(),
            "counter_labels": counter_labels(),
            "steps": step_stats(),
            "memory_watermark_bytes": memory_watermark(),
            "memory": {"ledger": memory_ledger(), "postmortems": memory_postmortems(),
                       "budget": (memory_budget().stats()
                                  if _process_budget is not None
                                  or os.environ.get("MXNET_MEM_BUDGET_MB") else None)},
            "recorder": recorder_stats(),
            "goodput": goodput_snapshot(),
            "compiles": compile_registry(),
            "compile_guard": compile_guard_state(),
            "device_trace_dir": _state["dir"],
        },
    }
    opener = (lambda p: _gzip.open(p, "wt")) if gz else (lambda p: open(p, "w"))
    with opener(path) as f:
        json.dump(payload, f)
    if finished:
        stop()
    return path


def dumps(reset=False):
    """Aggregate stats as text (parity: ``mx.profiler.dumps``): the scope
    and marker table, counters with their labels, step telemetry, memory
    watermark and ledger, goodput, compilations, and the device trace's
    kernels by name, count and total ms.  ``reset`` clears what it
    shows (the ledger's live bytes stay)."""
    with _counter_lock:
        agg_rows = sorted(((k, v[0], v[1]) for k, v in _agg.items()), key=lambda r: -r[2])
    lines = ["Profile Statistics (python markers):",
             f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}{'Avg(ms)':>12}"]
    for name, cnt, tot in agg_rows:
        lines.append(f"{name:<40}{cnt:>8}{tot * 1e3:>12.3f}{tot / cnt * 1e3:>12.3f}")
    snap = counters()
    labels = counter_labels()
    if any(snap.values()):
        lines.append("")
        lines.append("Counters:")
        for name, v in sorted(snap.items()):
            lines.append(f"{name:<40}{v:>8}")
            for lab, n in sorted(labels.get(name, {}).items()):
                row = f'  {name}{{reason="{lab}"}}'
                lines.append(f"{row:<40}{n:>8}")
    steps = step_stats()
    if steps:
        lines.append("")
        lines.append("Step telemetry (rolling window):")
        lines.append(f"{'Step':>6}{'Wall(ms)':>12}{'Host(ms)':>12}{'Comms(ms)':>12}"
                     f"{'Device(ms)':>12}")
        for s in steps[-20:]:
            lines.append(f"{s['step']:>6}{s['wall_ms']:>12.3f}{s['host_ms']:>12.3f}"
                         f"{s['comms_ms']:>12.3f}{s['device_ms']:>12.3f}")
    wm = memory_watermark()
    if wm:
        lines.append("")
        lines.append("Device memory watermark (bytes allocated, peak):")
        for dev, b in sorted(wm.items()):
            lines.append(f"{dev:<40}{b:>16}")
    led = memory_ledger()
    if led["owners"]:
        lines.append("")
        lines.append("Device memory ledger (see tools/memory_report.py):")
        lines.append(f"{'Owner':<36}{'Category':<18}{'Bytes':>14}{'Peak':>14}")
        for o, i in sorted(led["owners"].items(), key=lambda kv: -kv[1]["bytes"]):
            lines.append(f"{o:<36}{i['category']:<18}{i['bytes']:>14}{i['peak']:>14}")
        lines.append(f"{'TOTAL':<36}{'':<18}{led['total_bytes']:>14}")
    gp = goodput_snapshot()
    if gp["wall_s"] > 0:
        lines.append("")
        lines.append(f"Goodput ledger: wall {gp['wall_s']:.3f} s, goodput "
                     f"{gp['goodput'] * 100:.1f}%"
                     + "".join(f", {k} {v:.3f} s" for k, v in gp["top_overhead"]))
    csites = compile_stats()
    if csites:
        lines.append("")
        lines.append("Compilations (per site; see compile_report.py):")
        lines.append(f"{'Site':<28}{'Count':>8}{'Total(ms)':>12}{'Recompiles':>12}")
        for s, e in sorted(csites.items(), key=lambda kv: -kv[1]["ms"]):
            lines.append(f"{s:<28}{e['count']:>8}{e['ms']:>12.1f}{e['recompiles']:>12}")
    if _state["dir"]:
        dev = _device_op_stats()
        if dev:
            lines.append("")
            lines.append(f"Device kernels ({_state['dir']}):")
            lines.append(f"{'Kernel':<56}{'Count':>8}{'Total(ms)':>12}")
            for name, cnt, tot in dev:
                lines.append(f"{name[:56]:<56}{cnt:>8}{tot * 1e3:>12.3f}")
        else:
            lines.append(f"(no device kernels captured; trace dir: {_state['dir']})")
    if reset:
        with _counter_lock:
            _agg.clear()
            _step_window.clear()
            _mem_watermark.clear()
            _mem_samples.clear()
            _device_ops.clear()
        with _mem_lock:
            _mem_postmortems.clear()
        reset_counters()
        reset_compiles()
    return "\n".join(lines)


class scope:
    """``with profiler.scope('fwd'):``: a named region, a
    ``torch.profiler.record_function`` range in the device trace, tallied
    in ``dumps()``, and (recorder armed) a ``user`` span."""

    def __init__(self, name="<unk>"):
        self._name = name
        self._ctx = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        try:
            self._ctx = torch.profiler.record_function(self._name)
            self._ctx.__enter__()
        except Exception:
            self._ctx = None
        return self

    def __exit__(self, *a):
        if self._ctx is not None:
            self._ctx.__exit__(*a)
        t1 = time.perf_counter()
        _tally(self._name, t1 - self._t0)
        if _active:
            record_span(self._name, "user", self._t0, t1)
        return False


class Marker:
    """Instant marker (parity: ``profiler.Marker(...).mark()``)."""

    def __init__(self, name, scope_name="process"):
        self._name = name

    def mark(self, scope_name="process"):
        _tally(self._name, 0.0)
        if _recording:
            t = _perf()
            record_span(self._name, "marker", t, t)


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    start()
    atexit.register(dump)

if (os.environ.get("MXNET_METRICS_PORT", "0") not in ("", "0")
        or os.environ.get("MXNET_METRICS_JSONL")):
    start_metrics()  # the env-driven surfaces come up with the process
