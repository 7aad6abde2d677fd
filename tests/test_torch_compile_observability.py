"""The port's compile accounting against the JAX package's, on the CPU.

The single-process scenarios of ``tests/test_compile_observability.py``
run through both packages' ``profiler`` (``profiler_parity.both``):
``diff_signatures`` naming each drift kind, ``record_compile``'s
recompile detection and attribution line (the nearest signature by
field), ``compile_site``, the registry and its metrics provider, the dump,
the cost a site hands over, and the steady-state guard (counting only when
armed, warn once, raise, paused, the warm-up auto-arm, "off" over the
environment).  Then the port's sites against the JAX package's: a
``Predictor`` reshape attributed to its input, the serving warm-up
registered per bucket with nothing built after it, and the step fold's
build reported under ``gluon.step_fold`` with the guard armed after it.
``tools/compile_report.py`` reads the port's registry and dump.  Where the
JAX package compiles a program, the port builds a plan or captures a
graph; the port has no compiler cost analysis, so a record's cost is what
the site hands over, else None.
"""
import json
import logging

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx

from profiler_parity import both, dirs, jprof, tool, tprof, warnings_of  # noqa: F401


def _arr(shape, dtype="float32", sharding=None):
    tok = {"k": "array", "shape": tuple(shape), "dtype": dtype}
    if sharding is not None:
        tok["sharding"] = sharding
    return tok


DIFF_CASES = {
    "shape": ({"x": _arr((4, 8))}, {"x": _arr((4, 16))}),
    "dtype": ({"x": _arr((4, 8))}, {"x": _arr((4, 8), "bfloat16")}),
    "static": ({"k": {"k": "static", "value": "3"}}, {"k": {"k": "static", "value": "4"}}),
    "sharding": ({"x": _arr((4, 8), sharding="PartitionSpec('dp',)")},
                 {"x": _arr((4, 8), sharding="PartitionSpec(None,)")}),
    "added_removed": ({"a": _arr((2,))}, {"b": _arr((2,))}),
    "kind": ({"x": _arr((2,))}, {"x": {"k": "static", "value": "2"}}),
    "program": ({"__program__": "f"}, {"__program__": "g"}),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_signatures_names_each_drift(case):
    old, new = DIFF_CASES[case]
    assert tprof.diff_signatures(old, new) == jprof.diff_signatures(old, new)
    assert tprof.sig_static(3) == jprof.sig_static(3)


def test_record_compile_recompiles_and_attribution(dirs, caplog):
    def run(p, d):
        out = []
        r = p.record_compile("t.site", {"__program__": "p", "x": _arr((2, 2))}, 5.0)
        out.append((r["recompile"], r["attribution"], p.counters()["compile_total"],
                    p.counters()["compile_ms_total"]))
        p.record_compile("t.site", {"__program__": "p", "a": _arr((2, 2)), "b": _arr((3, 3))}, 1)
        r = p.record_compile("t.site", {"__program__": "p", "a": _arr((2, 2)), "b": _arr((3, 5))},
                             1.0)
        out.append((r["recompile"], r["attribution"]))
        r = p.record_compile("t.site", {"__program__": "q", "x": _arr((4, 4))}, 1.0)
        out.append(r["recompile"])
        # the nearest cached signature, field by field
        p.record_compile("n.site", {"__program__": "p", "x": _arr((4, 8))}, 1.0)
        p.record_compile("n.site", {"__program__": "p", "x": _arr((4, 16))}, 1.0)
        r = p.record_compile("n.site", {"__program__": "p", "x": _arr((4, 16), "bfloat16")}, 1)
        out.append(r["attribution"])
        sig = {"__program__": "p", "x": _arr((2, 2))}
        p.record_compile("i.site", sig, 1.0)
        out.append(p.record_compile("i.site", sig, 1.0)["attribution"])
        with p.compile_site("outer.phase"):
            out.append(p.record_compile("inner.site", {"x": _arr((1,))}, 1.0)["site"])
        out.append(p.record_compile("inner.site", {"x": _arr((1,))}, 1.0)["site"])
        rec = p.compile_registry()["records"][-1]
        out.append(sorted(set(rec) - {"fn"}))
        out.append(p.compile_stats()["t.site"])
        return out

    with caplog.at_level(logging.INFO):
        got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == (True, "argument 'b': shape drift float32[3x3] -> float32[3x5]")
    assert "dtype flip" in got["torch"][3] and "float32[4x16]" in got["torch"][3]
    assert "evicted" in got["torch"][4]
    lines = [r.getMessage() for r in caplog.records
             if r.name == tprof.__name__ and "[3x5]" in r.getMessage()]
    assert len(lines) == 1 and lines[0] == (
        "recompile at t.site [p]: argument 'b': shape drift float32[3x3] -> float32[3x5] "
        f"(wall 1.0 ms, step {tprof.current_step()})")


def test_registry_provider_and_dump(dirs):
    def run(p, d):
        p.record_compile("prov.site", {"x": _arr((1,))}, 2.0)
        prov = p.metrics_snapshot()["providers"]["compile"]
        p.start()
        with open(p.dump()) as f:
            doc = json.load(f)
        return (prov, sorted(doc["otherData"]["compiles"]["sites"]),
                doc["otherData"]["compile_guard"]["armed"], sorted(p.compile_guard_state()))

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["prov_site_total"] == 1 and got["torch"][0]["total"] == 1


def test_cost_is_what_the_site_hands_over(dirs):
    """The JAX package asks XLA; the port takes the figures a site hands
    over (``lowered=``, or ``fn.cost_analysis`` when cost accounting is on)
    and invents none."""
    class Built:
        calls = 0

        def cost_analysis(self, *args, **kwargs):
            Built.calls += 1
            return {"flops": 2.0 * args[0], "bytes accessed": 64.0}

    p = tprof
    fn = Built()
    assert p.record_compile("c.site", {"x": _arr((1,))}, 1.0, fn=fn, args=(8,))["cost"] is None
    assert Built.calls == 0 and not p.compile_cost_enabled()  # off by default
    p.set_config(compile_cost=True)
    assert p.compile_cost_enabled()
    rec = p.record_compile("c.site", {"x": _arr((2,))}, 1.0, fn=fn, args=(8,))
    assert rec["cost"] == {"flops": 16.0, "bytes_accessed": 64.0}
    rec = p.record_compile("c.site", {"x": _arr((3,))}, 1.0,
                           lowered={"temp_bytes": 128, "note": "kept out"})
    assert rec["cost"] == {"temp_bytes": 128}
    p.set_config(compile_cost=None)


def test_guard_counts_warns_raises_and_pauses(dirs, caplog):
    def run(p, d):
        out = []
        p.record_compile("g.site", {"x": _arr((1,))}, 1.0)
        out.append(p.counters()["recompile_steady_state"])
        p.arm_compile_guard("test")
        p.record_compile("g.site", {"x": _arr((2,))}, 1.0)
        out.append(p.counters()["recompile_steady_state"])
        p.set_config(compile_guard="warn")
        for n in (3, 4, 5):
            p.record_compile("g.site", {"x": _arr((n,))}, 1.0)
        warns = [m for m in warnings_of(caplog, p) if "steady-state compile guard" in m]
        out.append((len(warns), "armed by test" in warns[0], p.counters()["recompile_steady_state"]))
        p.set_config(compile_guard="raise")
        with pytest.raises(p.CompileGuardError) as ei:
            p.record_compile("r.site", {"x": _arr((1,))}, 1.0)
        out.append(("r.site" in str(ei.value), p.compile_stats()["r.site"]["count"]))
        with p.compile_guard_paused():
            p.record_compile("r.site", {"x": _arr((2,))}, 1.0)
        out.append(p.counters()["recompile_steady_state"])
        return out

    with caplog.at_level(logging.WARNING):
        got = both(run, dirs)
    assert got["torch"] == got["jax"] == [0, 1, (1, True, 4), (True, 1), 5]


def test_guard_warmup_auto_arm_and_config_off(dirs, monkeypatch):
    def run(p, d):
        out = []
        p.set_config(compile_guard="warn", compile_warmup_steps=2)
        p.step_boundary()
        out.append(p.compile_guard_state()["armed"])
        p.step_boundary()
        st = p.compile_guard_state()
        out.append((st["armed"], st["armed_by"], st["boundaries"]))
        p.disarm_compile_guard()
        p.set_config(compile_guard=None, compile_warmup_steps=1)
        p.step_boundary()
        p.step_boundary()
        out.append(p.compile_guard_state()["armed"])  # no mode: never auto-armed
        monkeypatch.setenv("MXNET_COMPILE_GUARD", "raise")
        p.arm_compile_guard("test")
        p.set_config(compile_guard="off")
        p.record_compile("g.site", {"x": _arr((1,))}, 1.0)  # no raise
        out.append(p.compile_guard_state()["mode"])
        p.set_config(compile_guard=None)
        out.append(p.compile_guard_state()["mode"])
        monkeypatch.delenv("MXNET_COMPILE_GUARD")
        return out

    got = both(run, dirs)
    assert got["torch"] == got["jax"] == [False, (True, "warmup_steps", 2), False, None, "raise"]


# -- the port's sites against the JAX package's -------------------------------------


def _fc(pkg):
    pkg.symbol.symbol._reset_naming()
    return pkg.symbol.FullyConnected(pkg.symbol.var("data"), num_hidden=3, name="fc1")


def test_predictor_recompile_attributed_to_input(dirs):
    def run(p, d):
        pkg = mx if p is tprof else mxj
        kw = {"dev_type": "cpu"} if pkg is mx else {}
        ctx = {"ctx": mx.cpu()} if pkg is mx else {}
        params = {"arg:fc1_weight": pkg.nd.array(np.ones((3, 4), np.float32), **ctx),
                  "arg:fc1_bias": pkg.nd.array(np.zeros(3, np.float32), **ctx)}
        pred = pkg.predictor.Predictor(_fc(pkg), params, {"data": (2, 4)}, **kw)
        pred.predict(data=np.ones((2, 4), np.float32))
        pred.reshape({"data": (6, 4)})
        pred.predict(data=np.ones((6, 4), np.float32))
        recs = [r for r in p.compile_registry()["records"]
                if r["site"] == "predictor.forward" and r["recompile"]]
        return recs[-1]["attribution"], recs[-1]["findings"]

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "argument 'data': shape drift float32[2x4] -> float32[6x4]"


def _serving_model(pkg):
    pkg.symbol.symbol._reset_naming()
    S = pkg.symbol
    sym = S.Activation(S.FullyConnected(S.var("data"), num_hidden=6, flatten=False, name="fc1"),
                       act_type="tanh", name="t1")
    rng = np.random.RandomState(0)
    ctx = {"ctx": mx.cpu()} if pkg is mx else {}
    return sym, {"arg:fc1_weight": pkg.nd.array(rng.randn(6, 4).astype(np.float32), **ctx),
                 "arg:fc1_bias": pkg.nd.array(rng.randn(6).astype(np.float32), **ctx)}


def test_serving_warmup_registered_per_bucket_nothing_after(dirs):
    def run(p, d):
        pkg = mx if p is tprof else mxj
        kw = {"dev_type": "cpu"} if pkg is mx else {}
        p.set_config(compile_guard="raise")
        p.arm_compile_guard("elsewhere")  # the warm-up is exempt from a guard armed before
        sym, params = _serving_model(pkg)
        srv = pkg.serving.InferenceServer(sym, params, {"data": (None, 4)}, max_batch_size=4,
                                          max_queue_ms=20.0, length_buckets=[8, 16],
                                          batch_buckets=[2, 4], name="compile_test", **kw)
        try:
            warm = p.compile_stats()["serving.warmup"]["count"]
            before = (p.counters()["compile_total"], p.counters()["recompile_steady_state"])
            rng = np.random.RandomState(1)
            shapes = [srv.infer({"data": rng.rand(n, 4).astype(np.float32)},
                                timeout=30.0).shape for n in (3, 8, 11, 16)]
            after = (p.counters()["compile_total"], p.counters()["recompile_steady_state"])
            return warm >= 4, before == after, shapes, p.compile_guard_state()["armed_by"]
        finally:
            srv.close()

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (True, True, [(3, 6), (8, 6), (11, 6), (16, 6)])


def _fold_net(pkg):
    net = pkg.gluon.nn.Dense(1, in_units=3)
    if pkg is mx:
        net.initialize(ctx=mx.cpu())
    else:
        net.initialize()
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    loss = pkg.gluon.loss.L2Loss()
    return net, tr, lambda a, b: loss(net(a), b)


def test_step_fold_build_reports_and_arms_the_guard(dirs):
    """Three folded calls of one signature: one build under
    ``gluon.step_fold`` (the first call on the CPU), the guard armed after
    it, three step boundaries and ``step_fold_call`` three, then a window
    of another batch signature counted as a recompile with the drifted
    input named."""
    def run(p, d):
        pkg = mx if p is tprof else mxj
        net, tr, loss_fn = _fold_net(pkg)
        rng = np.random.RandomState(0)
        x, y = rng.rand(4, 3).astype(np.float32), rng.rand(4, 1).astype(np.float32)
        if pkg is mx:
            x, y = torch.from_numpy(x), torch.from_numpy(y)
        else:
            x, y = mxj.nd.array(x), mxj.nd.array(y)
        net(x)
        prog = tr.fold_step(loss_fn, block=net)
        step0 = p.current_step()
        p.start()
        for _ in range(3):
            prog(x, y)
        p.stop()
        recs = [r for r in p.compile_registry()["records"] if r["site"] == "gluon.step_fold"]
        st = p.compile_guard_state()
        out = ([r["program"] for r in recs], [r["steady_state"] for r in recs], st["armed"],
               st["armed_by"], p.counters()["step_fold_call"], p.current_step() - step0,
               sorted(s for s in recs[0]["signature"] if s.startswith("in")))
        p.disarm_compile_guard()
        return out

    got = both(run, dirs)
    assert got["torch"] == got["jax"]
    assert got["torch"][:6] == (["step_fold"], [False], True, "gluon.step_fold", 3, 3)


def test_compile_report_reads_the_port_registry_and_dump(dirs):
    p = tprof
    p.record_compile("spmd.step", {"__program__": "step", "input0": _arr((16, 12)),
                                   "label": _arr((16,))}, 50.0)
    p.record_compile("spmd.step", {"__program__": "step", "input0": _arr((24, 12)),
                                   "label": _arr((24,))}, 40.0)
    path = dirs["torch"] / "reg.json"
    path.write_text(json.dumps(p.compile_registry()))
    rc, out, err = tool("compile_report.py", path)
    assert rc == 0 and "spmd.step" in out and "input0" in out and "90.0 ms total" in out, err
    rc, out, err = tool("compile_report.py", path, "--json")
    summ = json.loads(out)
    assert summ["total_compiles"] == 2
    assert (summ["culprits"][0]["arg"], summ["culprits"][0]["kind"]) == ("input0", "shape")
    p.start()
    trace = p.dump()
    rc, out, err = tool("compile_report.py", trace)
    assert rc == 0 and "spmd.step" in out, err
