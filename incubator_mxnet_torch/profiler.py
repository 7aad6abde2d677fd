"""``mx.profiler``: the part of the JAX package's ``profiler.py`` that the
serving path calls.

Counterpart of the JAX package's ``profiler.py`` (2976 lines), ported as
far as ``predictor.py`` and ``serving/`` reach it:
* declared event counters (``incr``, ``counters``);
* the span recorder (``record_span``) and its chrome-trace
  ``dump`` (``set_config``/``start``/``stop``);
* ``percentile``, the one rule for every p50/p99 the port reports;
* metrics providers, ``metrics_snapshot`` and ``render_prometheus``, served
  with ``/healthz`` on a localhost HTTP endpoint (``start_metrics``);
* the compile registry: a bound executor's first run at a new signature
  builds its plan, which reports here (``record_compile``) as a JAX compile
  does there, with ``compile_site``, the steady-state compile guard and
  ``compile_stats``;
* the device-memory ledger (``track_memory``, ``array_nbytes``), watermarks
  from ``torch.cuda.memory_stats`` (``maybe_sample_memory``) and the OOM
  postmortem of ``torch.cuda.OutOfMemoryError`` (``maybe_oom_postmortem``);
* the part the generation tier calls: :class:`MemoryBudget` and
  ``memory_budget()`` (admission under a byte budget, over
  ``torch.cuda.mem_get_info`` and the ledger), ``disarm_compile_guard``,
  ``reset_compiles`` and ``jit_cache_size``, which counts the signatures a
  bound program has built (``predictor.StatefulExecutor``).
Step telemetry, goodput, the straggler report, the JSONL exporter, compile
cost accounting and the device trace wait in ROADMAP §1 item 5.
"""
from __future__ import annotations

import json
import logging
import os
import threading as _threading
import time
import warnings as _warnings
from collections import OrderedDict as _OrderedDict

import torch

__all__ = ["set_config", "start", "stop", "dump", "record_span", "incr", "counters",
           "percentile", "register_metrics_provider", "unregister_metrics_provider",
           "metrics_snapshot", "render_prometheus", "set_health", "health_state",
           "start_metrics", "stop_metrics", "metrics_server_port", "record_compile",
           "compile_site", "compile_registry", "compile_stats", "sig_array", "sig_static",
           "arm_compile_guard", "compile_guard_state", "compile_guard_paused",
           "CompileGuardError", "track_memory", "memory_ledger", "array_nbytes",
           "device_memory_stats", "maybe_sample_memory", "memory_watermark",
           "oom_postmortem", "maybe_oom_postmortem", "memory_postmortems",
           "MemoryBudgetError", "MemoryBudget", "memory_budget", "disarm_compile_guard",
           "reset_compiles", "jit_cache_size"]

_logger = logging.getLogger(__name__)

_config = {
    "filename": "profile.json",
    "ring_size": 65536,            # spans kept per thread (oldest dropped)
    "memory_sampling": True,       # torch.cuda.memory_stats() on scheduler ticks
}
_state = {"running": False}
_EPOCH = time.perf_counter()       # ts 0 of every trace this process dumps
_perf = time.perf_counter


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


# -- event counters ------------------------------------------------------------
# THE declared set: ``incr`` on any other name raises.
_counters = {
    "metrics_snapshot": 0,            # metrics_snapshot() captures taken
    "metrics_scrape": 0,              # HTTP GETs served by the endpoint
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
    "compile_total": 0,               # executor plans built, across every site
    "compile_ms_total": 0,            # wall ms those builds cost
    "recompile_steady_state": 0,      # builds after the guard armed
    "memory_oom_postmortem": 0,       # OOM postmortems emitted
    "memory_budget_refusal": 0,       # admissions deferred by a MemoryBudget
}
_counter_lock = _threading.Lock()


def incr(name, n=1):
    with _counter_lock:
        try:
            _counters[name] += n
        except KeyError:
            raise KeyError(
                f"undeclared profiler counter {name!r}; add it to profiler._counters"
            ) from None


def counters():
    with _counter_lock:
        return dict(_counters)


# -- span recorder ---------------------------------------------------------------
_recording = False
_active = False       # hot paths pre-check this before building a span
_armed_at = 0.0
_rings = []           # [(tid, thread name, deque of spans)] of this session
_tls = _threading.local()
_ring_gen = 0


def _ring():
    r = getattr(_tls, "ring", None)
    if r is None or r[0] != _ring_gen:
        from collections import deque

        with _counter_lock:
            r = (_ring_gen, len(_rings) + 1, _threading.current_thread().name,
                 deque(maxlen=max(1, int(_config["ring_size"]))))
            _rings.append(r)
        _tls.ring = r
    return r


def record_span(name, category, t0, t1=None, args=None, step=None):
    """Record one completed span between two ``time.perf_counter()``
    readings (``t1`` defaults to now).  ``step`` tags the span with a step
    id, written into the trace event's ``args`` as ``"step"`` (the port has
    no step telemetry yet, so an untagged span carries none).  A no-op
    unless ``start()`` armed the recorder; hot paths check
    ``profiler._active`` first."""
    if not _active:
        return
    if t1 is None:
        t1 = _perf()
    t0 = max(t0, _armed_at)
    if step is not None:
        args = {"step": step, **(args or {})}
    _ring()[3].append((name, category, t0, max(t1, t0), args))


def set_config(**kwargs):
    """Parity: ``mx.profiler.set_config``; unknown keys are accepted and
    ignored.  Meaningful keys: ``filename``, ``ring_size``,
    ``memory_sampling`` and ``compile_guard`` ("warn"/"raise"/None,
    overrides ``MXNET_COMPILE_GUARD``)."""
    _config.update(kwargs)


def start():
    """Start a fresh recording session (spans of an earlier one are
    dropped)."""
    global _recording, _active, _armed_at, _ring_gen
    if _state["running"]:
        return
    with _counter_lock:
        _ring_gen += 1
        _rings.clear()
        _mem_watermark.clear()
    _armed_at = _perf()
    _recording = _active = True
    _state["running"] = True


def stop():
    """Disarm the recorder; recorded spans survive for ``dump()``."""
    global _recording, _active
    _recording = _active = False
    _state["running"] = False


def _trace_events():
    """Recorded spans as chrome-trace B/E pairs, nested validly per thread
    (ties: E before B, outer B before inner B)."""
    pid = os.getpid()
    with _counter_lock:
        rings = list(_rings)
    keyed = []
    for _, tid, _, spans in rings:
        for name, cat, t0, t1, args in list(spans):
            ts = (t0 - _EPOCH) * 1e6
            te = max((t1 - _EPOCH) * 1e6, ts + 0.001)
            keyed.append(((ts, 1, ts - te), {"ph": "B", "name": name, "cat": cat, "ts": ts,
                                             "pid": pid, "tid": tid, "args": dict(args or {})}))
            keyed.append(((te, 0, te - ts), {"ph": "E", "name": name, "cat": cat, "ts": te,
                                             "pid": pid, "tid": tid}))
    keyed.sort(key=lambda kv: kv[0])
    events = [{"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
               "args": {"name": tname}} for _, tid, tname, _ in rings]
    events.extend(e for _, e in keyed)
    return events


def dump(finished=True, profile_process="worker"):
    """Write the recorded spans as chrome://tracing JSON to
    ``set_config(filename=...)`` (parity: ``mx.profiler.dump``), with the
    counters, the compile registry and the memory ledger under
    ``otherData``.  ``finished`` also stops the recorder.  Returns the
    path."""
    path = _config["filename"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "traceEvents": _trace_events(),
        "displayTimeUnit": "ms",
        "otherData": {"counters": counters(), "compiles": compile_registry(),
                      "compile_guard": compile_guard_state(),
                      "memory": {"ledger": memory_ledger(),
                                 "watermark_bytes": memory_watermark(),
                                 "postmortems": memory_postmortems()}},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    if finished:
        stop()
    return path


def percentile(xs, q):
    """Nearest-rank percentile (the serving tier's latency convention);
    None on empty input."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


# -- metrics surface -------------------------------------------------------------
_metrics_seq = 0
_metrics_providers = {}  # key -> fn() -> flat {field: number} dict


def register_metrics_provider(key, fn):
    """Attach a gauge source to ``metrics_snapshot()``: ``fn`` returns a flat
    ``{field: number}`` dict, captured under ``snapshot["providers"][key]``
    and rendered as ``mxnet_<key>_<field>`` gauges.  Re-registering a key
    replaces the previous provider."""
    with _counter_lock:
        _metrics_providers[str(key)] = fn


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
    """One metrics capture: process identity, counters, memory watermarks
    and every provider's gauges (the JAX package's schema; the step
    telemetry fields stay empty until ROADMAP §1 item 5)."""
    global _metrics_seq
    incr("metrics_snapshot")
    maybe_sample_memory()
    with _counter_lock:
        _metrics_seq += 1
        seq = _metrics_seq
    return {
        "schema": 1,
        "rank": 0,
        "host": os.uname().nodename if hasattr(os, "uname") else "?",
        "pid": os.getpid(),
        "seq": seq,
        "time_unix": time.time(),
        "counters": counters(),
        "last_step": None,
        "window": {"n": 0, "wall_ms_median": None, "wall_ms_max": None},
        "memory_watermark_bytes": memory_watermark(),
        "providers": _provider_metrics(),
    }


def _prom_escape(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")


def render_prometheus():
    """The local snapshot as Prometheus text (exposition format 0.0.4):
    counters, memory watermarks and provider gauges."""
    snap = metrics_snapshot()
    base = (("rank", snap["rank"]), ("host", snap["host"]))
    out = ["# HELP mxnet_profiler_counter_total profiler event counters",
           "# TYPE mxnet_profiler_counter_total counter"]
    for cname, v in sorted(snap["counters"].items()):
        lab = ",".join(f'{k}="{_prom_escape(v2)}"' for k, v2 in (("counter", cname),) + base)
        out.append(f"mxnet_profiler_counter_total{{{lab}}} {v}")
    gauges = _OrderedDict()

    def gauge(name, help_, labels, value):
        if value is None:
            return
        lab = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in labels)
        gauges.setdefault(name, (help_, []))[1].append(f"{name}{{{lab}}} {value}")

    gauge("mxnet_metrics_snapshot_seq", "snapshot sequence number", base, snap["seq"])
    for dev, b in sorted(snap["memory_watermark_bytes"].items()):
        gauge("mxnet_memory_watermark_bytes", "peak device bytes in use observed",
              base + (("device", dev),), b)
    for pkey, fields in sorted(snap["providers"].items()):
        for field, v in sorted(fields.items()):
            gauge(f"mxnet_{pkey}_{field}", f"{pkey} subsystem gauge (registered metrics "
                  "provider)", base, v)
    for name, (help_, lines) in gauges.items():
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} gauge")
        out.extend(lines)
    return "\n".join(out) + "\n"


_metrics_http = None      # (ThreadingHTTPServer, serving thread)
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
    """Start the ``/metrics`` and ``/healthz`` endpoint
    on localhost.  ``port=None`` reads ``MXNET_METRICS_PORT`` (0 or unset:
    no endpoint); an explicit ``port=0`` binds a free port (read it back
    with ``metrics_server_port()``).  A port already taken warns and serves
    nothing.  Idempotent.  ``jsonl`` and ``interval_s`` (the reference's
    periodic JSONL log) are accepted at their default, None; the exporter
    waits in ROADMAP §1 item 5, and a value raises."""
    global _metrics_http
    if jsonl is not None or interval_s is not None:
        raise NotImplementedError(
            "start_metrics(jsonl=, interval_s=): the periodic JSONL metrics log waits in "
            "ROADMAP §1 item 5; serve /metrics with port= instead")
    env_port = port is None
    if env_port:
        port = _env_int("MXNET_METRICS_PORT", 0)
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
    return metrics_server_port()


def metrics_server_port():
    with _metrics_lock:
        return _metrics_http[0].server_address[1] if _metrics_http else None


def stop_metrics():
    global _metrics_http
    with _metrics_lock:
        if _metrics_http is not None:
            srv, th = _metrics_http
            _metrics_http = None
            srv.shutdown()
            srv.server_close()
            th.join(5.0)


# -- device memory ---------------------------------------------------------------
_mem_lock = _threading.Lock()
_mem_owners = {}        # owner name -> MemoryTracker (THE ledger)
_mem_postmortems = []
_MAX_POSTMORTEMS = 64
_mem_watermark = {}     # device -> peak bytes allocated observed
_mem_last = [0.0]


class MemoryTracker:
    """Owner-scoped accounting handle of :func:`track_memory`: ``alloc``
    and ``free`` move bytes in and out of the owner's row."""

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
    with _mem_lock:
        owners = {o: {"category": t.category, "bytes": t.bytes, "peak": t.peak,
                      "allocs": t.allocs, "frees": t.frees} for o, t in _mem_owners.items()}
    cats = {}
    for info in owners.values():
        cats[info["category"]] = cats.get(info["category"], 0) + info["bytes"]
    return {"owners": owners, "by_category": cats,
            "total_bytes": sum(i["bytes"] for i in owners.values())}


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
        pass  # telemetry must never take serving down
    return out


def memory_watermark():
    with _counter_lock:
        return dict(_mem_watermark)


def maybe_sample_memory(min_interval_s=None):
    """Throttled device-memory sample (the serving scheduler's tick): at
    most every ``MXNET_PROFILER_MEM_SAMPLE_S`` seconds (default 0.05) it
    updates the per-device watermark."""
    if not _config.get("memory_sampling", True):
        return
    if min_interval_s is None:
        min_interval_s = _env_float("MXNET_PROFILER_MEM_SAMPLE_S", 0.05)
    now = _perf()
    if now - _mem_last[0] < min_interval_s:
        return
    _mem_last[0] = now
    for dev, s in device_memory_stats().items():
        with _counter_lock:
            _mem_watermark[dev] = max(_mem_watermark.get(dev, 0), s["peak_bytes_in_use"])


def memory_postmortems():
    with _mem_lock:
        return [dict(r) for r in _mem_postmortems]


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
    totals, live device stats, the failed allocation's size) as an ERROR
    log line; returns the report.  ``kind`` is ``"oom"`` (a device
    allocation failed) or ``"budget"`` (:meth:`MemoryBudget.check` refused
    one); ``step`` is the current step id, None here until the port has
    step telemetry (ROADMAP §1 item 5)."""
    led = memory_ledger()
    top = sorted(led["owners"].items(), key=lambda kv: -kv[1]["bytes"])[:8]
    report = {"kind": kind, "where": str(where), "time_unix": time.time(), "step": None,
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
    """When ``exc`` is a device allocation failure
    (``torch.cuda.OutOfMemoryError``, or a message saying "out of
    memory"), emit exactly one postmortem for it; returns the report, or
    None for unrelated errors.  Callers re-raise ``exc``."""
    if exc is None or not (isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryBudgetError))
                           or "out of memory" in str(exc).lower()):
        return None
    rep = getattr(exc, "_mx_postmortem", None)
    if rep is None:
        rep = oom_postmortem(where, failed_bytes=_parse_failed_bytes(str(exc)), error=exc)
        try:
            exc._mx_postmortem = rep
        except Exception:
            pass
    return rep


# -- budgeted admission ----------------------------------------------------------
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


# -- compile registry ----------------------------------------------------------
class CompileGuardError(RuntimeError):
    """A plan was built while the steady-state compile guard was armed and
    ``MXNET_COMPILE_GUARD=raise``."""


_compile_lock = _threading.Lock()
_compile_records = []      # bounded FIFO of per-build record dicts
_compile_sites = {}        # site -> {"count", "ms", "recompiles", "sigs"}
_MAX_COMPILE_RECORDS = _env_int("MXNET_COMPILE_LOG_SIZE", 4096)
_MAX_SITE_SIGS = 128
_site_tls = _threading.local()
_guard = {"armed": False, "armed_by": None, "warned": False, "paused": 0}


def _guard_mode():
    """None (off), "warn" or "raise": ``set_config(compile_guard=...)`` wins
    over ``MXNET_COMPILE_GUARD``."""
    v = _config.get("compile_guard")
    if v is None:
        v = os.environ.get("MXNET_COMPILE_GUARD") or None
    return v if v in ("warn", "raise") else None


def arm_compile_guard(source="manual"):
    """From now on every build reported to the registry counts as a
    steady-state violation (``recompile_steady_state``);
    ``InferenceServer.start()`` arms it after its bucket warm-up."""
    with _compile_lock:
        if not _guard["armed"]:
            _guard["armed"] = True
            _guard["armed_by"] = source


def disarm_compile_guard():
    """Disarm the guard and reset its warn-once latch (tests; re-warming a
    model after a deliberate shape change)."""
    with _compile_lock:
        _guard["armed"] = False
        _guard["armed_by"] = None
        _guard["warned"] = False


def jit_cache_size(fn):
    """How many signatures a bound program has built: the counterpart of
    the reference's jit cache size, for a program of
    ``predictor.StatefulExecutor`` (anything with a ``signatures`` set); a
    growth across a call is one build.  -1 for anything else, so that a
    caller records nothing rather than a build that did not happen."""
    sigs = getattr(fn, "signatures", None)
    return len(sigs) if sigs is not None else -1


def compile_guard_state():
    with _compile_lock:
        return {"armed": _guard["armed"], "armed_by": _guard["armed_by"],
                "mode": _guard_mode(), "paused": _guard["paused"] > 0}


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


class compile_site:
    """``with profiler.compile_site('serving.warmup'):`` — nested
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
    """Signature token of a tensor argument: shape and dtype."""
    t = getattr(a, "_data", a)
    try:
        return {"k": "array", "shape": tuple(int(d) for d in t.shape), "dtype": str(t.dtype)}
    except Exception:
        return sig_static(type(a).__name__)


def sig_static(v):
    return {"k": "static", "value": repr(v)[:120]}


def _drift(old, new):
    """``name: old → new`` for each field the two signatures differ in."""
    out = []
    for k in sorted(set(old) | set(new)):
        if k != "__program__" and old.get(k) != new.get(k):
            out.append(f"{k}: {old.get(k)} -> {new.get(k)}")
    return "; ".join(out[:4]) or "same signature"


def record_compile(site, signature, wall_ms, fn=None, args=None, kwargs=None, lowered=None):
    """Report one build (an executor's plan, or a stateful program's first
    call, at a new signature) into the registry.  ``signature`` maps names
    to :func:`sig_array` / :func:`sig_static` tokens, plus an optional
    ``"__program__"``; ``fn`` is the built callable, whose qualified name
    the record keeps as ``"fn"``.  A build of a program the site built
    before at another signature is a recompile, logged with the fields that
    drifted.  With the guard armed it counts in ``recompile_steady_state``,
    and ``MXNET_COMPILE_GUARD=raise`` raises :class:`CompileGuardError`
    after the bookkeeping.  ``args``, ``kwargs`` and ``lowered`` feed the
    reference's compile cost accounting, which waits in ROADMAP §1 item 5:
    accepted at None, any other value raises."""
    if args is not None or kwargs is not None or lowered is not None:
        raise NotImplementedError(
            "record_compile(args=, kwargs=, lowered=): compile cost accounting waits in "
            "ROADMAP §1 item 5")
    site = _active_site(str(site))
    signature = dict(signature or {})
    program = signature.get("__program__")
    key = json.dumps(signature, sort_keys=True, default=str)
    now = _perf()
    with _compile_lock:
        ent = _compile_sites.setdefault(site, {"count": 0, "ms": 0.0, "recompiles": 0,
                                               "sigs": _OrderedDict()})
        sigs = ent["sigs"]
        peers = [s for s in sigs.values() if s.get("__program__") == program]
        recompile = bool(peers)
        attribution = _drift(peers[-1], signature) if peers else None
        sigs[key] = signature
        sigs.move_to_end(key)
        while len(sigs) > _MAX_SITE_SIGS:
            sigs.popitem(last=False)
        ent["count"] += 1
        ent["ms"] += float(wall_ms)
        ent["recompiles"] += recompile
        armed = _guard["armed"] and _guard["paused"] == 0
        rec = {"site": site, "program": program, "signature": signature,
               "fn": None if fn is None else getattr(fn, "__qualname__", repr(fn)),
               "wall_ms": round(float(wall_ms), 3), "time_unix": time.time(),
               "recompile": recompile, "attribution": attribution, "steady_state": armed}
        _compile_records.append(rec)
        del _compile_records[:-_MAX_COMPILE_RECORDS]
    incr("compile_total")
    incr("compile_ms_total", int(round(wall_ms)))
    if armed:
        incr("recompile_steady_state")
    if _active:
        record_span("compile.plan", "compile", now - wall_ms / 1e3, now,
                    args={"site": site, "program": program})
    if recompile:
        _logger.info("recompile at %s [%s]: %s (wall %.1f ms)", site, program, attribution,
                     wall_ms)
    if armed:
        mode = _guard_mode()
        if mode == "raise":
            raise CompileGuardError(f"steady-state compile guard (armed by "
                                    f"{_guard['armed_by']}): {site} built a plan after warmup "
                                    f"({attribution or 'a new program'})")
        if mode == "warn" and not _guard["warned"]:
            _guard["warned"] = True
            _logger.warning("steady-state compile guard (armed by %s): %s built a plan after "
                            "warmup", _guard["armed_by"], site)
    return rec


def compile_registry():
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
