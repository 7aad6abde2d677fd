"""The port's goodput ledger against the JAX package's, on the CPU.

The single-process scenarios of ``tests/test_goodput.py`` run through both
packages' ``profiler`` (``profiler_parity.both``): bucket exclusivity (the
buckets sum to the wall), off-thread spans billing nothing, downtime,
pause/resume freezing the wall, ``start()`` keeping the run ledger, cluster
aggregation naming the worst rank and its bucket, and the export surfaces
(metrics provider, Prometheus, the dump).  A Trainer run of tiny ``Dense``
nets holds the ledger's host bucket to the ``fused.group_apply`` and
``dispatch.raw`` spans.  The supervised multi-process run waits for the
port's elastic training (ROADMAP §1 item 9).
"""
import json
import threading
import time

import pytest

import incubator_mxnet_torch as mx

from profiler_parity import both, dirs, tprof  # noqa: F401


def _arm(p):
    p.start()
    p.reset_goodput()


def _span(p, name, cat, dur):
    now = time.perf_counter()
    p.record_span(name, cat, now - dur, now)


def test_buckets_sum_to_wall_and_land_exclusively(dirs):
    def run(p, d):
        _arm(p)
        time.sleep(0.12)
        _span(p, "io.wait", "io", 0.05)
        _span(p, "kvstore.pushpull", "comms", 0.03)
        _span(p, "elastic.snapshot", "elastic", 0.02)
        _span(p, "compile.jit", "compile", 0.01)
        snap = p.goodput_snapshot()
        b = snap["buckets_s"]
        assert sum(b.values()) == pytest.approx(snap["wall_s"], abs=1e-4)
        assert snap["overhead_s"] == pytest.approx(snap["wall_s"] - b["compute"], abs=1e-4)
        assert 0 < snap["goodput"] <= 1
        return (sorted(snap), sorted(b),
                {k: round(b[k], 2) for k in ("data_wait", "comm", "checkpoint", "compile")},
                [k for k, _ in snap["top_overhead"]])

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == {"data_wait": 0.05, "comm": 0.03, "checkpoint": 0.02,
                               "compile": 0.01}


def test_off_thread_and_parent_spans_do_not_bill(dirs):
    def run(p, d):
        _arm(p)
        th = threading.Thread(target=lambda: _span(p, "io.wait", "io", 0.05))
        th.start()
        th.join()
        _span(p, "kvstore.bucketed_pushpull", "comms", 0.5)  # a parent: only leaves bill
        b = p.goodput_snapshot()["buckets_s"]
        return b["data_wait"], b["comm"]

    assert both(run, dirs) == {"jax": (0, 0), "torch": (0, 0)}


def test_downtime_lands_in_bucket_and_grows_wall(dirs):
    def run(p, d):
        _arm(p)
        w0 = p.goodput_snapshot()["wall_s"]
        c0 = p.counters()["goodput_downtime_ms"]
        p.record_downtime(0.25, "elastic_restart")
        p.record_downtime(0.0)
        p.record_downtime(-5.0)
        snap = p.goodput_snapshot()
        assert snap["wall_s"] >= w0 + 0.25
        assert sum(snap["buckets_s"].values()) == pytest.approx(snap["wall_s"], abs=1e-4)
        return (snap["buckets_s"]["downtime"], snap["downtime_detail"],
                ["downtime", 0.25] in snap["top_overhead"],
                p.counters()["goodput_downtime_ms"] - c0)

    got = both(run, dirs)
    assert got["torch"] == got["jax"] == (0.25, {"elastic_restart": 0.25}, True, 250)


def test_wall_is_monotone_and_freezes_while_paused(dirs):
    def run(p, d):
        _arm(p)
        time.sleep(0.02)
        w1 = p.goodput_snapshot()["wall_s"]
        p.pause()
        w2 = p.goodput_snapshot()["wall_s"]
        time.sleep(0.06)
        w3 = p.goodput_snapshot()["wall_s"]
        p.resume()
        time.sleep(0.02)
        w4 = p.goodput_snapshot()["wall_s"]
        return w1 <= w2, abs(w3 - w2) < 5e-3, w4 > w3, w4 - w3 < 0.06

    assert both(run, dirs) == {"jax": (True,) * 4, "torch": (True,) * 4}


def test_start_does_not_reset_the_run_ledger(dirs):
    def run(p, d):
        _arm(p)
        p.record_downtime(0.2, "elastic_restart")
        p.stop()
        p.set_config(filename=str(d / "trace2.json"))
        p.start()
        return p.goodput_snapshot()["buckets_s"]["downtime"]

    assert both(run, dirs) == {"jax": 0.2, "torch": 0.2}


def _peer(rank, wall, compute, **buckets):
    g = {"wall_s": wall, "goodput": compute / wall, "compute_s": compute}
    g.update({f"{k}_s": v for k, v in buckets.items()})
    return {"schema": 1, "rank": rank, "pid": 990000 + rank, "seq": 1, "host": f"peer{rank}",
            "providers": {"goodput": g}}


def test_worst_rank_and_its_bucket_are_named(dirs):
    def run(p, d):
        _arm(p)
        time.sleep(0.05)
        p.publish_peer_metrics(_peer(1, 10.0, 9.0, comm=1.0))
        p.publish_peer_metrics(_peer(2, 10.0, 2.0, comm=1.0, downtime=7.0))
        agg = p.cluster_goodput()
        return (sorted(agg), agg["ranks"], agg["worst"]["rank"], agg["worst"]["bucket"],
                agg["worst"]["bucket_s"], agg["goodput"] < 0.75)

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == (3, 2, "downtime", 7.0, True)


def test_none_when_no_rank_has_wall(dirs):
    def run(p, d):
        p.stop()
        p.reset_goodput()
        return p.cluster_goodput()

    assert both(run, dirs) == {"jax": None, "torch": None}


def test_provider_rides_metrics_snapshot_and_prometheus(dirs):
    def run(p, d):
        _arm(p)
        time.sleep(0.02)
        g = p.metrics_snapshot()["providers"]["goodput"]
        text = p.render_prometheus()
        return (sorted(g), g["wall_s"] > 0, "mxnet_goodput_wall_s" in text,
                "mxnet_goodput_compute_s" in text)

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == (True, True, True)


def test_snapshot_roundtrips_json_and_rides_dump(dirs):
    def run(p, d):
        _arm(p)
        _span(p, "io.wait", "io", 0.01)
        snap = json.loads(json.dumps(p.goodput_snapshot()))
        p.stop()
        with open(p.dump()) as f:
            gp = json.load(f)["otherData"]["goodput"]
        c0 = p.counters()["goodput_snapshot"]
        p.goodput_snapshot()
        p.goodput_snapshot()
        return (snap["schema"], set(snap["buckets_s"]) == set(p._GOODPUT_BUCKETS),
                gp["schema"], gp["buckets_s"]["data_wait"] > 0,
                p.counters()["goodput_snapshot"] - c0)

    assert both(run, dirs) == {"jax": (1, True, 1, True, 2), "torch": (1, True, 1, True, 2)}


def test_trainer_steps_bill_host_and_sum_to_wall(dirs):
    """A port Trainer run: the fused update and the NDArray ops bill the
    host bucket (their spans' sum), the buckets sum to the wall, and
    goodput is the compute share."""
    net = mx.gluon.nn.Dense(8, in_units=16)
    net.initialize(ctx=mx.cpu())
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    x = mx.nd.ones((4, 16), ctx=mx.cpu())
    _arm(tprof)
    for _ in range(5):
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(4)
    snap = tprof.goodput_snapshot()
    steps = tprof.step_stats()
    tprof.stop()
    b = snap["buckets_s"]
    assert sum(b.values()) == pytest.approx(snap["wall_s"], abs=1e-4)
    assert b["host"] > 0 and b["comm"] == b["data_wait"] == 0
    # the steps' host buckets are the same spans the ledger billed
    assert sum(s["host_ms"] for s in steps) / 1e3 <= b["host"] + 1e-4
    # goodput is the unrounded compute share; the buckets are rounded to 1 µs
    assert snap["goodput"] == pytest.approx(b["compute"] / snap["wall_s"], abs=1e-3)
