"""The port's ``mx.profiler`` against the JAX package's, on the CPU: the
span recorder and chrome trace, step telemetry and the slow-step detector,
counters, pause/resume, metrics export and straggler attribution.

The single-process scenarios of ``tests/test_profiler.py`` (``TestChromeTrace``,
``TestStepTelemetry``, ``TestCounters``, ``TestPauseResumeWindow``,
``TestMetricsExport``, ``TestStragglerAttribution``,
``TestStragglerRegistryHygiene``) run through both packages
(``profiler_parity.both``), with tiny ``Dense`` nets and ``Trainer`` where
they train, and the test compares field names, step ids, counter names and
labels, the slow-step and straggler lines and the exported formats.  The
port's dump passes ``tools/trace_merge.py --check``, ``trace_report.py``,
``memory_report.py`` and ``compile_report.py``.  The multi-process
scenarios (the async PS's peer feed, the two-worker trace smoke) wait for
the port's kvstore (ROADMAP §1 item 6).
"""
import json
import logging
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon import step_fold as jstep_fold
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon import step_fold as tstep_fold

from profiler_parity import (both, dirs, jprof, paired_spans, peer_snap, tool, tprof,  # noqa: F401
                             warnings_of)

# the JAX package's helpers that read xprof's files, and the port's
# counterpart of each (the device trace is torch.profiler's there)
XPROF_ONLY = {"iter_xplane_ops": "_device_op_stats", "collapse_hlo_name": "_device_op_stats"}


def test_every_public_name_of_the_jax_profiler_is_in_the_port():
    missing = sorted(set(jprof.__all__) - set(tprof.__all__))
    assert missing == []
    for name in jprof.__all__:
        assert callable(getattr(tprof, name)) or isinstance(getattr(tprof, name), type), name
    for jax_name, port_name in XPROF_ONLY.items():
        assert hasattr(jprof, jax_name) and callable(getattr(tprof, port_name))


def test_declared_counters_are_jax_names():
    """Every counter the port declares is one the JAX package declares
    (the port adds none of its own), and the fold's fallback labels are
    the JAX labels."""
    assert set(tprof.counters()) <= set(jprof.counters())
    assert set(tstep_fold.FALLBACK_LABELS) <= set(jstep_fold.FALLBACK_LABELS)
    for name in ("fused_step_call", "fused_step_params", "fused_step_fallback_params",
                 "step_fold_call", "step_fold_fallback", "fold_eval_call",
                 "slow_step_detected", "straggler_detected", "profiler_trace_error",
                 "goodput_snapshot", "goodput_downtime_ms"):
        assert name in tprof.counters(), name


# -- the chrome trace ------------------------------------------------------------------


def _train(pkg, p, steps=3):
    """``steps`` SGD-momentum steps of a Dense(8) on ones(4, 16) under
    ``p.start()``; returns (first step id, dump path)."""
    if pkg is mx:
        net = mx.gluon.nn.Dense(8, in_units=16)
        net.initialize(ctx=mx.cpu())
        x = mx.nd.ones((4, 16), ctx=mx.cpu())
    else:
        net = mxj.gluon.nn.Dense(8, in_units=16)
        net.initialize()
        x = mxj.nd.ones((4, 16))
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9}, kvstore="device")
    p.start()
    first = p.current_step()
    for _ in range(steps):
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(4)
    return first, p.dump()


def test_train_trace_roundtrip(dirs):
    got = both(lambda p, d: _train(mx if p is tprof else mxj, p), dirs)
    cats = {}
    for name, (first, path) in got.items():
        with open(path) as f:
            doc = json.load(f)
        spans = paired_spans(doc["traceEvents"])
        cats[name] = {s["cat"] for s in spans}
        steps = sorted((s for s in spans if s["cat"] == "step"), key=lambda s: s["ts"])
        assert [s["args"]["step"] - first for s in steps] == [0, 1, 2], name
        for s in spans:  # every trainer/optimizer span inside its step, with its id
            if s["cat"] in ("optimizer", "trainer"):
                owner = [st for st in steps if st["ts"] <= s["ts"] and s["_end"] <= st["_end"]]
                assert owner and s["args"]["step"] == owner[0]["args"]["step"], (name, s)
        names = {s["name"] for s in spans}
        assert {"trainer.update", "trainer.allreduce", "fused.group_apply"} <= names, name
        stats = doc["otherData"]["steps"]
        assert [s["step"] - first for s in stats] == [0, 1, 2]
        for s in stats:
            assert set(s) == {"step", "wall_ms", "host_ms", "comms_ms", "device_ms"}
            assert s["wall_ms"] >= s["host_ms"] >= 0 and s["device_ms"] >= 0
        assert set(doc["otherData"]) >= {"process", "counters", "steps", "memory",
                                         "recorder", "goodput", "compiles", "compile_guard"}
    # the port records the categories the JAX package does, less the
    # subsystems it has not (engine bulking, kvstore)
    assert {"dispatch", "optimizer", "trainer", "step"} <= cats["torch"] <= cats["jax"]


def test_port_dump_passes_the_trace_tools(dirs):
    p = tprof
    p.track_memory("test.owner", "params").alloc(1 << 20)
    p.record_compile("test.site", {"__program__": "p", "x": p.sig_array(np.ones((2, 3)))}, 3.0)
    p.record_compile("test.site", {"__program__": "p", "x": p.sig_array(np.ones((4, 3)))}, 2.0)
    try:
        first, path = _train(mx, p)
        rc, out, err = tool("trace_merge.py", path, "-o", dirs["torch"] / "merged.json",
                            "--check", "--expect-ranks", "1")
        assert rc == 0, err
        assert tool("trace_report.py", path)[0] == 0
        rc, out, err = tool("memory_report.py", path)
        assert rc == 0 and "test.owner" in out, err
        rc, out, err = tool("compile_report.py", path)
        assert rc == 0 and "test.site" in out and "shape" in out, err
    finally:
        p.track_memory("test.owner").close()


def test_dump_finished_false_keeps_recording(dirs):
    def run(p, d):
        p.start()
        with p.span("before", "user"):
            pass
        p.dump(finished=False)
        running = (p.state(), p.recording_enabled())
        with p.span("after", "user"):
            pass
        path = p.dump()
        names = {s["name"] for s in paired_spans(json.load(open(path))["traceEvents"])}
        return running, (p.state(), p.recording_enabled()), {"before", "after"} <= names

    got = both(run, dirs)
    assert got["torch"] == got["jax"] == (("running", True), ("stopped", False), True)


def test_multithreaded_span_counts(dirs):
    def run(p, d, n_threads=4, n_spans=250):
        p.start()
        barrier = threading.Barrier(n_threads)

        def work():
            barrier.wait()
            for i in range(n_spans):
                p.record_span(f"mt_{i % 7}", "user", time.perf_counter())

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        p.stop()
        per_tid = {}
        for s in paired_spans(p._trace_events()):
            if s["name"].startswith("mt_"):
                per_tid[s["tid"]] = per_tid.get(s["tid"], 0) + 1
        return sorted(per_tid.values())

    got = both(run, dirs)
    assert got["torch"] == got["jax"] == [250] * 4


def test_ring_buffer_bounds_memory(dirs):
    def run(p, d):
        p.set_config(ring_size=64)
        p.start()
        for i in range(200):
            p.record_span(f"ring_{i}", "user", time.perf_counter())
        stats = p.recorder_stats()
        p.stop()
        kept = sorted(int(s["name"].split("_")[1]) for s in paired_spans(p._trace_events())
                      if s["name"].startswith("ring_"))
        return stats["spans"], stats["dropped"], kept, sorted(stats)

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (64, 136, list(range(136, 200)))


def test_ring_registry_bounded_under_thread_churn(dirs):
    def run(p, d):
        p.set_config(ring_size=8)
        p.start()
        for _ in range(p._MAX_RINGS + 20):
            t = threading.Thread(target=lambda: p.record_span("churn", "user",
                                                              time.perf_counter()))
            t.start()
            t.join()
        n = p.recorder_stats()["threads"]
        p.stop()
        return n <= p._MAX_RINGS + 1

    assert both(run, dirs) == {"jax": True, "torch": True}


# -- step telemetry ------------------------------------------------------------


def test_slow_step_detector_fires_exactly_once(dirs, caplog):
    def run(p, d):
        p.set_config(slow_step_ms=50.0)
        p.start()
        for _ in range(4):
            p.step_boundary()
        time.sleep(0.08)  # the injected stall
        p.step_boundary()
        for _ in range(4):
            p.step_boundary()
        p.stop()
        lines = [m for m in warnings_of(caplog, p) if "slow step" in m]
        return len(lines), lines[0].split(":")[0].split()[:2], p.counters()["slow_step_detected"]

    with caplog.at_level(logging.WARNING):
        got = both(run, dirs)
    assert got["torch"] == got["jax"] == (1, ["slow", "step"], 1)
    lines = [m for m in warnings_of(caplog, tprof) if "slow step" in m]
    assert "host-dispatch" in lines[0] and "comms" in lines[0] and "threshold 50 ms" in lines[0]


def test_slow_step_auto_mode(dirs, caplog):
    def run(p, d):
        p.set_config(slow_step_ms=None, slow_step_auto=True, slow_step_auto_mult=4.0)
        p.start()
        for _ in range(20):
            time.sleep(0.01)
            p.step_boundary()
        time.sleep(0.3)  # far above 4x the ~10 ms median
        p.step_boundary()
        p.stop()
        return len([m for m in warnings_of(caplog, p) if "auto:" in m])

    with caplog.at_level(logging.WARNING):
        assert both(run, dirs) == {"jax": 1, "torch": 1}


def test_slow_step_annotator_adds_one_line(dirs, caplog):
    def run(p, d):
        p.set_config(slow_step_ms=30.0)
        p.register_slow_step_annotator("stage", lambda s: f"stage 1 of step {s['step']}")
        try:
            p.start()
            p.step_boundary()
            time.sleep(0.05)
            p.step_boundary()
            p.step_boundary()
            p.stop()
        finally:
            p.unregister_slow_step_annotator("stage")
        return [m.split(": ", 1)[1] for m in warnings_of(caplog, p) if " stage: " in m]

    with caplog.at_level(logging.WARNING):
        got = both(run, dirs)
    assert len(got["torch"]) == len(got["jax"]) == 1
    assert got["torch"][0].startswith("stage 1 of step")


def test_step_buckets_accumulate(dirs):
    def run(p, d):
        p.start()
        sid = p.current_step()
        t0 = time.perf_counter()
        p.record_span("kvstore.pushpull", "comms", t0, t0 + 0.010)
        p.record_span("dispatch.raw", "dispatch", t0, t0 + 0.005)
        p.record_span("bulk.trace", "bulk", t0, t0 + 0.003)  # nested: no bucket

        def off_thread():  # another thread's spans do not bill the step
            p.record_span("dispatch.raw", "dispatch", t0, t0 + 0.5)

        th = threading.Thread(target=off_thread)
        th.start()
        th.join()
        p.step_boundary()
        p.stop()
        s = [s for s in p.step_stats() if s["step"] == sid][-1]
        return round(s["comms_ms"], 3), round(s["host_ms"], 3)

    got = both(run, dirs)
    assert got["torch"] == pytest.approx(got["jax"], abs=1e-6)
    assert got["torch"] == pytest.approx((10.0, 5.0), abs=1e-6)


def test_memory_watermark_surface(dirs):
    def run(p, d):
        p.start()
        p.step_boundary()
        p.step_boundary()
        p.stop()
        wm = p.memory_watermark()
        return isinstance(wm, dict) and all(isinstance(v, int) and v >= 0 for v in wm.values())

    assert both(run, dirs) == {"jax": True, "torch": True}


def test_trainer_step_ids_and_boundaries_match(dirs):
    """Three Trainer steps advance the step id by three in both packages;
    with the profiler off, step_boundary only counts toward the guard's
    warm-up."""
    def run(p, d):
        before = p.current_step()
        _train(mx if p is tprof else mxj, p)
        after = p.current_step()
        p.set_config(compile_guard="warn", compile_warmup_steps=2)
        p.step_boundary()
        p.step_boundary()
        st = p.compile_guard_state()
        return after - before, st["armed"], st["armed_by"], sorted(st)

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (3, True, "warmup_steps")


# -- counters ------------------------------------------------------------------


def test_counters_strict_declared_and_labeled(dirs):
    def run(p, d):
        with pytest.raises(KeyError):
            p.incr("metrics_scrpe")
        with pytest.raises(KeyError):
            p.incr_labeled("no_such_counter", "x")
        p.declare_counter("test_custom_counter")
        p.incr("test_custom_counter", 3)
        p.incr_labeled("step_fold_fallback", "env-off")
        p.incr_labeled("step_fold_fallback", "env-off", 2)
        p.incr_labeled("step_fold_fallback", "capture-failure")
        out = (p.counters()["test_custom_counter"], p.counters()["step_fold_fallback"],
               p.counter_labels("step_fold_fallback"), p.counter_labels())
        snap = p.metrics_snapshot()
        prom = p.render_prometheus()
        out += (snap["counter_labels"]["step_fold_fallback"],
                'reason="capture-failure"' in prom)
        p.reset_counters()
        return out + (p.counters()["test_custom_counter"], p.counter_labels())

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (3, 4, {"env-off": 3, "capture-failure": 1})


def test_incr_exact_under_concurrency(dirs):
    def run(p, d, n_threads=8, n_incr=500):
        def work():
            for _ in range(n_incr):
                p.incr("metrics_scrape")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return p.counters()["metrics_scrape"]

    assert both(run, dirs) == {"jax": 4000, "torch": 4000}


def test_tally_exact_under_concurrency_and_dumps(dirs):
    def run(p, d, n_threads=4, n_tallies=200):
        name = "tally_race_probe"
        with p._counter_lock:
            p._agg.pop(name, None)
        stop = threading.Event()

        def dump_loop():
            while not stop.is_set():
                p.dumps()

        reader = threading.Thread(target=dump_loop)
        reader.start()

        def work():
            for _ in range(n_tallies):
                p._tally(name, 0.001)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        reader.join()
        cnt, tot = p._agg.pop(name)
        return cnt, round(tot, 6)

    got = both(run, dirs)
    assert got["torch"] == got["jax"] == (800, 0.8)


def test_trace_error_warns_once_and_counts(dirs, monkeypatch):
    import jax

    def boom(*a, **k):
        raise RuntimeError("no trace here")

    monkeypatch.setattr(jax.profiler, "start_trace", boom)
    monkeypatch.setattr(tprof, "_start_device_trace", boom)

    def run(p, d):
        monkeypatch.setattr(p, "_trace_warned", False)
        with pytest.warns(RuntimeWarning, match="profiler_trace_error"):
            p.start()
        out = (p.recording_enabled(), p.counters()["profiler_trace_error"])
        p.stop()
        p.start()  # warned once a process: the second failure only counts
        p.stop()
        return out + (p.counters()["profiler_trace_error"],)

    got = both(run, dirs)
    assert got["torch"] == got["jax"] == (True, 1, 2)


def test_scope_marker_and_dumps_sections(dirs):
    def run(p, d):
        p.start()
        with p.scope("user_region"):
            time.sleep(0.001)
        p.Marker("user_mark").mark()
        p.record_compile("d.site", {"x": p.sig_static(1)}, 1.0)
        p.step_boundary()
        p.step_boundary()
        p.stop()
        p._state["dir"] = None  # no device trace here (profiler_parity.reset)
        text = p.dumps()
        heads = [ln for ln in text.splitlines() if ln.endswith(":") or ln.endswith("):")]
        names = {s["name"] for s in paired_spans(p._trace_events())}
        rows = [ln.split()[:2] for ln in text.splitlines() if ln.startswith("user_")]
        p.dumps(reset=True)
        return heads, {"user_region", "user_mark"} <= names, sorted(rows), p.step_stats()

    got = both(run, dirs)
    assert got["torch"][1:] == got["jax"][1:]
    assert got["torch"][2] == [["user_mark", "1"], ["user_region", "1"]]

    def stems(heads):
        return {h.split("(")[0].strip().rstrip(":") for h in heads}

    # the port's sections are the JAX package's (its counters' header is
    # not "Dispatch counters": it has no dispatch cache)
    assert stems(got["torch"][0]) - {"Counters"} <= stems(got["jax"][0])
    assert {"Profile Statistics", "Step telemetry", "Compilations"} <= \
        stems(got["torch"][0]) & stems(got["jax"][0])


# -- pause / resume ------------------------------------------------------------


def test_pause_gap_not_billed_to_window(dirs):
    def run(p, d):
        p.start()
        p.step_boundary()
        time.sleep(0.01)
        p.step_boundary()
        p.pause()
        time.sleep(0.25)
        p.resume()
        time.sleep(0.01)
        p.step_boundary()
        p.stop()
        steps = p.step_stats()
        return len(steps), all(s["wall_ms"] < 200.0 for s in steps)

    assert both(run, dirs) == {"jax": (3, True), "torch": (3, True)}


def test_dump_unfinished_keeps_window_accumulating(dirs):
    def run(p, d):
        p.start()
        time.sleep(0.002)
        p.step_boundary()
        p.dump(finished=False)
        armed = p.recording_enabled()
        time.sleep(0.002)
        p.step_boundary()
        p.dump()
        return armed, len(p.step_stats())

    assert both(run, dirs) == {"jax": (True, 2), "torch": (True, 2)}


def test_metrics_snapshot_monotone_across_session_events(dirs):
    def run(p, d):
        p.start()
        p.step_boundary()
        s1 = p.metrics_snapshot()
        time.sleep(0.005)
        p.step_boundary()
        p.dump(finished=False)
        s2 = p.metrics_snapshot()
        p.pause()
        p.resume()
        s3 = p.metrics_snapshot()
        p.stop()
        for a, b in ((s1, s2), (s2, s3)):
            assert b["seq"] > a["seq"] and b["time_unix"] >= a["time_unix"]
            assert b["window"]["n"] >= a["window"]["n"]
            assert all(b["counters"][k] >= v for k, v in a["counters"].items())
        return (sorted(s2), sorted(s2["window"]), s2["window"]["n"],
                s2["last_step"]["wall_ms"] >= 4.0, sorted(s2["last_step"]))

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][2:4] == (2, True)


# -- metrics export ------------------------------------------------------------


def _two_steps(p):
    p.start()
    time.sleep(0.003)
    p.step_boundary()
    time.sleep(0.003)
    p.step_boundary()


def test_render_prometheus_includes_local_and_peers(dirs):
    def run(p, d):
        _two_steps(p)
        p.publish_peer_metrics(peer_snap(9))
        txt = p.render_prometheus()
        p.stop()
        me = p.process_info()["rank"]
        assert 'mxnet_profiler_counter_total{counter="metrics_snapshot",rank="9"' in txt
        assert f'rank="{me}"' in txt and 'mxnet_step_last_comms_ms{rank="9"' in txt
        return sorted({ln.split()[2] for ln in txt.splitlines() if ln.startswith("# TYPE")})

    got = both(run, dirs)
    # the step, window, clock, goodput, memory and compile gauges by the same names
    assert set(got["torch"]) <= set(got["jax"])
    assert {"mxnet_step_last_wall_ms", "mxnet_step_last_id", "mxnet_step_window_n",
            "mxnet_step_wall_ms_median", "mxnet_clock_offset_seconds",
            "mxnet_goodput_wall_s", "mxnet_goodput_compute_s", "mxnet_compile_total",
            "mxnet_memory_ledger_bytes"} <= set(got["torch"])


def test_peer_registry_replaces_by_seq_and_pid(dirs):
    def run(p, d):
        p.publish_peer_metrics(peer_snap(4, seq=5, wall=100.0))
        p.publish_peer_metrics(peer_snap(4, seq=3, wall=999.0))
        kept = p.peer_metrics()[4]["last_step"]["wall_ms"]
        restarted = peer_snap(4, seq=1, wall=50.0)
        restarted["pid"] = 4242
        p.publish_peer_metrics(restarted)
        replaced = p.peer_metrics()[4]["last_step"]["wall_ms"]
        p.forget_peer_metrics(4)
        return kept, replaced, p.peer_metrics()

    assert both(run, dirs) == {"jax": (100.0, 50.0, {}), "torch": (100.0, 50.0, {})}


def test_http_endpoint_serves_cluster(dirs):
    def run(p, d):
        _two_steps(p)
        p.publish_peer_metrics(peer_snap(9))
        port = p.start_metrics(port=0)
        try:
            assert port == p.metrics_server_port()
            body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                          timeout=10).read().decode()
            doc = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics.json",
                                                    timeout=10).read())
            health = urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                            timeout=10).read().decode()
            return ('rank="9"' in body, "mxnet_step_last_wall_ms" in body, sorted(doc),
                    "9" in doc["peers"], health, p.counters()["metrics_scrape"])
        finally:
            p.stop_metrics()
            p.stop()
            assert p.metrics_server_port() is None

    got = both(run, dirs)
    assert got["torch"] == got["jax"] == (True, True, ["local", "peers"], True, "serving\n", 3)


def test_jsonl_exporter_writes_monotone_snapshots(dirs, monkeypatch):
    def run(p, d):
        path = d / "metrics.jsonl"
        p.start()
        p.step_boundary()
        p.start_metrics(port=None, jsonl=str(path), interval_s=0.05)
        time.sleep(0.35)
        p.stop_metrics()
        p.stop()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        seqs = [ln["seq"] for ln in lines]
        return (len(lines) >= 2, seqs == sorted(set(seqs)), {ln["schema"] for ln in lines},
                len({ln["rank"] for ln in lines}), sorted(lines[0]))

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == (True, True, {1}, 1)
    # and from the environment, as at import
    path = dirs["torch"] / "env.jsonl"
    monkeypatch.setenv("MXNET_METRICS_JSONL", str(path))
    monkeypatch.setenv("MXNET_METRICS_INTERVAL_S", "0.05")
    tprof.start_metrics()
    time.sleep(0.2)
    tprof.stop_metrics()
    assert path.read_text().count("\n") >= 2


# -- straggler attribution -----------------------------------------------------


def test_straggler_named_exactly_once_per_anomalous_step(dirs, caplog):
    def run(p, d):
        p.set_config(slow_step_ms=30.0)
        p.start()
        p.publish_peer_metrics(peer_snap(5, host="worker-h5", wall=900.0, comms=700.0))
        p.step_boundary()
        time.sleep(0.05)
        p.step_boundary()
        p.step_boundary()
        p.stop()
        lines = [m for m in warnings_of(caplog, p) if "straggler" in m]
        return len(lines), lines[0].split(": ", 1)[1], p.counters()["straggler_detected"]

    with caplog.at_level(logging.WARNING):
        got = both(run, dirs)
    assert got["torch"] == got["jax"]
    n, line, count = got["torch"]
    assert (n, count) == (1, 1)
    assert line.startswith("rank 5 (worker-h5)") and "900.0 ms" in line and "700.0 ms" in line


def test_no_straggler_line_without_peer_data(dirs, caplog):
    def run(p, d):
        p.set_config(slow_step_ms=30.0)
        p.start()
        p.step_boundary()
        time.sleep(0.05)
        p.step_boundary()
        p.stop()
        return (bool([m for m in warnings_of(caplog, p) if "slow step" in m]),
                [m for m in warnings_of(caplog, p) if "straggler" in m],
                p.counters()["straggler_detected"])

    with caplog.at_level(logging.WARNING):
        assert both(run, dirs) == {"jax": (True, [], 0), "torch": (True, [], 0)}


def test_straggler_report_compares_local_and_peers(dirs):
    def run(p, d):
        _two_steps(p)
        alone = p.straggler_report()
        p.publish_peer_metrics(peer_snap(2, wall=5000.0))
        rep = p.straggler_report()
        p.stop()
        return alone, rep

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] is None
    assert got["torch"][1]["rank"] == 2 and got["torch"][1]["ranks_compared"] == 2
    assert got["torch"][1]["step"] == 77 and got["torch"][1]["wall_ms"] == 5000.0


def test_schema_light_peer_snapshot_cannot_break_step_boundary(dirs, caplog):
    def run(p, d):
        p.set_config(slow_step_ms=30.0)
        p.start()
        p.publish_peer_metrics({"rank": 8, "pid": 1, "seq": 1, "time_unix": time.time(),
                                "last_step": {"step": 3, "wall_ms": 5000.0}})
        p.step_boundary()
        time.sleep(0.05)
        p.step_boundary()
        p.stop()
        lines = [m for m in warnings_of(caplog, p) if "straggler" in m]
        p.publish_peer_metrics({"rank": 9, "pid": 1, "seq": 1, "last_step": "garbage"})
        rep = p.straggler_report()
        return len(lines), "rank 8" in lines[0], rep is None or rep["rank"] != 9

    with caplog.at_level(logging.WARNING):
        assert both(run, dirs) == {"jax": (1, True, True), "torch": (1, True, True)}


def test_stale_peer_snapshot_aged_out_of_comparison(dirs):
    def run(p, d):
        _two_steps(p)
        p.publish_peer_metrics(peer_snap(6, wall=9000.0, time_unix=time.time() - 3600.0))
        ghost = p.straggler_report()
        p.publish_peer_metrics(peer_snap(7, wall=8000.0))
        rep = p.straggler_report()
        p.stop()
        return ghost, rep["rank"]

    assert both(run, dirs) == {"jax": (None, 7), "torch": (None, 7)}


def test_process_metadata_and_clock_offset(dirs):
    def run(p, d):
        info0 = p.process_info()
        p.update_clock_offset(0.5, 0.01)
        p.update_clock_offset(9.0, 0.5)  # a worse sample loses
        ref = time.time() - 2.0
        best = p.sample_clock_offset(lambda: ref, samples=3)
        info = p.process_info()
        p.start()
        p.step_boundary()
        path = p.dump()
        proc = json.load(open(path))["otherData"]["process"]
        with p._counter_lock:  # restore
            p._proc["clock_offset_s"], p._proc["clock_rtt_s"] = 0.0, None
        return (sorted(info0), info["clock_offset_s"] == 0.5 or best[1] < 0.01,
                proc["pid"] == os.getpid(), proc["epoch_unix"] > 0)

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == (True, True, True)


def test_trace_gz_roundtrip(dirs, monkeypatch):
    monkeypatch.setenv("MXNET_PROFILER_TRACE_GZ", "1")
    p = tprof
    p.start()
    with p.span("gz_work", "user"):
        time.sleep(0.002)
    p.step_boundary()
    path = p.dump()
    assert path.endswith(".json.gz") and os.path.exists(path)
    rc, out, err = tool("trace_report.py", path)
    assert rc == 0 and "gz_work" in out, err
