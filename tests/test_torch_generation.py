"""The port's generation tier on the CPU: ``StatefulExecutor``, the slot KV
cache and ``GenerationServer``, with ``tests/test_generation.py``'s
behaviours and shapes (vocabulary 17, units 24, 2 heads, 1-2 layers each
side).

* equivalence: a request decoded inside a churning mixed batch gives the
  tokens it gives decoded alone, and the static mode the same;
* the server against ``greedy_search`` and against the JAX package's
  ``GenerationServer`` over the same weights (tokens equal);
* cancellation, streaming, ``on_token``, finish reasons, admission control
  (shedding, slot caps, SLO accounting), memory-budget deferral;
* zero builds after warm-up with the compile guard in raise mode, the
  warm-up's builds declared, counters, the metrics provider and spans;
* ``close`` with and without drain.

The copy task is trained with the port's ``gluon.Trainer`` where the JAX
test uses ``SPMDTrainer``.  Everything is held to counts and values, never
to wall-time ratios.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo.transformer import Transformer as JTransformer
from incubator_mxnet_tpu import profiler as jprofiler
from incubator_mxnet_tpu.serving import GenerationServer as JGenerationServer
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import profiler
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon.model_zoo.transformer import Transformer, greedy_search
from incubator_mxnet_torch.ops.nn import streaming_softmax_ce
from incubator_mxnet_torch.predictor import StatefulExecutor
from incubator_mxnet_torch.serving import (AdmissionError, GenerationResult, GenerationServer,
                                           KVCacheLadder, ShapeBucketer, SlotKVCache, Tenant)

VOCAB, BOS, EOS = 17, 1, 2
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_guard():
    """A server's start() arms the process-wide compile guard; a guard left
    armed would count every later build as a steady-state violation."""
    profiler.disarm_compile_guard()
    profiler.set_config(compile_guard=None)
    yield
    profiler.disarm_compile_guard()
    profiler.set_config(compile_guard=None)


def _net(layers, seed=0):
    mx.random.seed(seed)
    net = Transformer(VOCAB, units=24, hidden_size=48, num_heads=2, num_encoder_layers=layers,
                      num_decoder_layers=layers, dropout=0.0, max_length=64)
    net.initialize(ctx=mx.cpu())
    net(torch.ones((1, 8), dtype=torch.int32), torch.ones((1, 1), dtype=torch.int32))
    return net


@pytest.fixture(scope="module")
def tiny_net():
    """Untrained (but materialized) 2+2-layer transformer."""
    return _net(2)


def _copy_batch(B, S, seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, VOCAB, (B, S)).astype(np.int32)
    tgt_out = np.concatenate([src[:, :-1], np.full((B, 1), EOS, np.int32)], axis=1)
    tgt_in = np.concatenate([np.full((B, 1), BOS, np.int32), tgt_out[:, :-1]], axis=1)
    return [torch.from_numpy(a) for a in (src, tgt_in, tgt_out)]


@pytest.fixture(scope="module")
def trained_net():
    """150 Adam steps of the copy-with-EOS task (target: the prompt's first
    7 tokens, then EOS): diverse tokens and a real eos path, so
    equivalence failures cannot hide behind degenerate outputs."""
    net = _net(1)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 5e-3})
    for i in range(150):
        src, tgt_in, tgt_out = _copy_batch(16, 8, i)
        with mx.autograd.record():
            loss = streaming_softmax_ce(net(src, tgt_in), tgt_out).mean(-1)
        mx.autograd.backward(loss)
        trainer.step(16)
    return net


def _server(net, **kw):
    kw.setdefault("bos", BOS)
    kw.setdefault("eos", EOS)
    kw.setdefault("max_prompt_length", 16)
    kw.setdefault("max_new_tokens", 24)
    kw.setdefault("decode_buckets", [24])
    kw.setdefault("slots_per_bucket", 4)
    kw.setdefault("name", "gen_test")
    return GenerationServer(net, **kw)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(3, VOCAB, n).astype(np.int32)


# -- units: bucketer ceiling, slot cache, stateful executor ---------------------------


def test_bucketer_ceiling():
    b = ShapeBucketer(buckets=[8, 16, 32], max_length=20)
    assert b.max_length == 20 and b.bucket_for(17) == 32
    with pytest.raises(ValueError, match="max_length"):
        b.bucket_for(21)
    with pytest.raises(ValueError, match="top bucket"):
        ShapeBucketer(buckets=[8, 16], max_length=64)
    assert ShapeBucketer(buckets=[8, 16]).max_length == 16
    assert ShapeBucketer(max_length=100, min_bucket=8).max_length == 100


def test_slot_cache_alloc_free_cycle():
    c = SlotKVCache(layers=2, slots=2, bucket=8, mem_width=8, heads=2, head_dim=4, device=CPU)
    s0 = c.alloc("a", mem_len=3, first_token=BOS)
    s1 = c.alloc("b", mem_len=5, first_token=BOS)
    assert {s0, s1} == {0, 1} and c.n_active == 2
    assert c.alloc("c", 1, BOS) is None          # exhausted
    c.free(s0)
    assert c.n_free == 1 and c.owners[s0] is None
    assert c.mem_len[s0] == 1                    # the NaN guard's floor
    with pytest.raises(ValueError):
        c.free(s0)                               # a double free is loud
    s2 = c.alloc("c", 2, BOS)
    assert s2 == s0 and c.joins == 3 and c.leaves == 1
    assert c.state["self_k"].shape == (2, 2, 8, 2, 4) and c.state["mem_v"].shape == (2, 2, 8, 2, 4)
    assert c.nbytes == 4 * 2 * 2 * 8 * 2 * 4 * 4


def test_slot_cache_ledger_and_dtype():
    before = profiler.memory_ledger()["owners"].get("kv_cache.pool_40", {}).get("bytes", 0)
    c = SlotKVCache(1, 3, 40, 8, 2, 4, dtype="bfloat16", device=CPU)
    assert c.state["self_k"].dtype == torch.bfloat16
    assert profiler.memory_ledger()["owners"]["kv_cache.pool_40"]["bytes"] == before + c.nbytes
    c.release()
    c.release()                                  # idempotent
    assert profiler.memory_ledger()["owners"]["kv_cache.pool_40"]["bytes"] == before


def test_ladder_walks_up_when_tight_pool_full():
    lad = KVCacheLadder(layers=1, heads=2, head_dim=4, mem_width=8, buckets=[8, 16],
                        slots_per_bucket=1, device=CPU)
    p0, _ = lad.try_alloc(6, "a", 1, BOS)
    assert p0.bucket == 8
    p1, _ = lad.try_alloc(6, "b", 1, BOS)        # 8-pool full -> 16
    assert p1.bucket == 16
    assert lad.try_alloc(6, "c", 1, BOS) is None
    with pytest.raises(ValueError):
        lad.bucket_for(17)
    lad2 = KVCacheLadder(1, 2, 4, 8, max_length=20, slots_per_bucket={8: 2, "default": 1},
                         device=CPU)
    assert list(lad2.buckets) == [8, 16, 20] and [p.slots for p in lad2.pools.values()] == [2, 1, 1]


def test_stateful_executor_state_advances_and_warms():
    exe = StatefulExecutor({"x": torch.zeros(4)}, name="t", compile_site="test.stateful")

    def step(state, inputs):
        x = state["x"] + inputs["d"]
        return x.sum(), {"x": x}

    exe.add_program("step", step)
    assert not exe.is_warm("step")
    assert float(exe.run("step", d=np.float32(1.0))) == 4.0 and exe.is_warm("step")
    assert float(exe.run("step", d=np.float32(1.0))) == 8.0      # state carried over
    st = exe.compile_stats()
    assert st["calls"]["step"] == 2 and st["entries"] == 1 and st["compiles"] == 1
    with pytest.raises(ValueError, match="already bound"):
        exe.add_program("step", step)


def test_stateful_executor_in_place_and_builds():
    """A program that updates its state in place hands back the same
    tensors; a call at a new input signature is one build, reported under
    the executor's site, and after the guard arms it raises in raise mode
    with the state already rebound."""
    buf = torch.zeros(3, 4)
    exe = StatefulExecutor({"buf": buf}, compile_site="test.inplace")

    def write(state, inputs):
        state["buf"][int(inputs["row"])] = inputs["vals"].float()
        return state["buf"].sum(), state

    exe.add_program("write", write)
    profiler.reset_compiles()
    exe.run("write", row=np.int32(1), vals=np.arange(4, dtype=np.int32))
    assert exe.state["buf"] is buf and buf[1].tolist() == [0.0, 1.0, 2.0, 3.0]
    exe.run("write", row=np.int32(2), vals=np.arange(4, dtype=np.int32))  # same signature
    assert profiler.compile_stats()["test.inplace"]["count"] == 1
    assert profiler.compile_registry()["records"][-1]["fn"].endswith("write")
    assert profiler.jit_cache_size(exe._programs["write"]) == 1
    profiler.set_config(compile_guard="raise")
    profiler.arm_compile_guard("test")
    with pytest.raises(profiler.CompileGuardError):
        exe.run("write", row=np.int32(0), vals=np.arange(4, dtype=np.int64))  # new dtype
    assert buf[0].tolist() == [0.0, 1.0, 2.0, 3.0] and exe.compile_stats()["entries"] == 2


def test_stateful_executor_without_donation_keeps_the_state():
    x = torch.zeros(2)
    exe = StatefulExecutor({"x": x})

    def bump(state, inputs):
        state["x"].add_(1.0)
        return (), state

    exe.add_program("bump", bump, donate_state=False)
    exe.run("bump")
    assert x.tolist() == [0.0, 0.0] and exe.state["x"].tolist() == [1.0, 1.0]


def test_stateful_executor_dropped_state_key_is_loud():
    exe = StatefulExecutor({"x": torch.zeros(2), "y": torch.zeros(2)})
    exe.add_program("bad", lambda s, i: (s["x"], {"x": s["x"]}))
    with pytest.raises(RuntimeError, match="y"):
        exe.run("bad")
    with pytest.raises(KeyError):
        exe.run("missing")


# -- the server ---------------------------------------------------------------------


def test_single_request_matches_greedy_oracle(trained_net):
    srv = _server(trained_net)
    try:
        p = _prompt(8, 3)
        toks = srv.submit(p, max_new_tokens=12).result(timeout=60.0)
        gt, gl = greedy_search(trained_net, torch.from_numpy(p[None]), bos=BOS, eos=EOS,
                               max_length=13)
        np.testing.assert_array_equal(toks, gt[0, 1:int(gl[0])])  # gt[0, 0] is the BOS prime
        assert toks[-1] == EOS
    finally:
        srv.close()


def test_finish_reasons_and_latency_fields(trained_net):
    srv = _server(trained_net)
    try:
        res_eos = srv.submit(_prompt(8, 4))
        res_len = srv.submit(_prompt(8, 5), max_new_tokens=3)
        assert isinstance(res_eos, GenerationResult)
        assert res_eos.result(60.0)[-1] == EOS and res_eos.finish_reason == "eos"
        assert len(res_len.result(60.0)) == 3 and res_len.finish_reason == "length"
        assert res_eos.ttft_ms is not None and res_eos.ttft_ms > 0
        assert res_eos.tpot_ms is not None
    finally:
        srv.close()


def test_submit_rejects_oversized_at_the_door(tiny_net):
    srv = _server(tiny_net)
    try:
        with pytest.raises(ValueError, match="max_prompt_length"):
            srv.submit(_prompt(17, 0))           # the prompt ceiling is 16
        with pytest.raises(ValueError, match="decode ladder"):
            srv.submit(_prompt(4, 0), max_new_tokens=25)
        with pytest.raises(ValueError):
            srv.submit(np.zeros(0, np.int32))
        with pytest.raises(ValueError):
            srv.submit(_prompt(4, 0), tenant="nope")
    finally:
        srv.close()


def test_streaming_yields_before_done(tiny_net):
    srv = _server(tiny_net)
    try:
        res = srv.submit(_prompt(6, 7), max_new_tokens=24)
        seen = []
        for tok in res.stream(timeout=30.0):
            if not seen:
                assert not res.done()            # mid-stream, not a replay
            seen.append(tok)
        assert len(seen) >= 1
        np.testing.assert_array_equal(seen, res.result(1.0))
    finally:
        srv.close()


def test_on_token_callback(tiny_net):
    srv = _server(tiny_net)
    try:
        got = []
        toks = srv.submit(_prompt(6, 8), max_new_tokens=5,
                          on_token=lambda r, t: got.append(t)).result(60.0)
        np.testing.assert_array_equal(got, toks)
    finally:
        srv.close()


def test_churning_mixed_batch_matches_alone(trained_net):
    """The target request's tokens are the same whether it decodes alone
    or inside a batch with requests of other lengths joining and leaving
    around it (3 slots, 9 requests with staggered lifetimes)."""
    srv = _server(trained_net, slots_per_bucket=3, max_prefills_per_iter=2)
    try:
        target = _prompt(8, 42)
        alone = srv.submit(target, max_new_tokens=20).result(60.0)
        others = [srv.submit(_prompt(3 + (i % 9), 100 + i), max_new_tokens=3 + 2 * i)
                  for i in range(4)]
        res_t = srv.submit(target, max_new_tokens=20)
        others += [srv.submit(_prompt(3 + (i % 9), 200 + i), max_new_tokens=3 + 2 * i)
                   for i in range(4)]
        churned = res_t.result(120.0)
        for r in others:
            r.result(120.0)
        np.testing.assert_array_equal(churned, alone)
        st = srv.stats()
        assert st["completed"] == 10
        joins = sum(p["joins"] for p in st["pools"].values())
        assert joins == 10 > srv._ladder.n_slots   # the batch churned
    finally:
        srv.close()


def test_requests_equal_alone_across_pools(trained_net):
    """With two pools (buckets 8 and 24) and one slot each, a request whose
    tight pool is busy walks up the ladder: its tokens still equal those it
    gives alone (decode self-attention runs at the ladder top's width in
    every pool)."""
    srv = _server(trained_net, decode_buckets=[8, 24], slots_per_bucket=1)
    try:
        prompts = [_prompt(5 + i, 300 + i) for i in range(4)]
        alone = [srv.submit(p, max_new_tokens=6).result(60.0) for p in prompts]
        rs = [srv.submit(p, max_new_tokens=6) for p in prompts]
        for a, r in zip(alone, rs):
            np.testing.assert_array_equal(r.result(60.0), a)
        assert srv.stats()["pools"][24]["joins"] >= 1
    finally:
        srv.close()


def test_static_mode_also_correct(trained_net):
    """Drain-and-refill (the benchmark baseline) gives the same tokens."""
    srv = _server(trained_net, batching="static", slots_per_bucket=2)
    try:
        target = _prompt(8, 42)
        alone = srv.submit(target, max_new_tokens=20).result(60.0)
        rs = [srv.submit(_prompt(5, 300 + i), max_new_tokens=6) for i in range(3)]
        res = srv.submit(target, max_new_tokens=20)
        np.testing.assert_array_equal(res.result(120.0), alone)
        for r in rs:
            r.result(120.0)
    finally:
        srv.close()
    with pytest.raises(ValueError, match="batching"):
        _server(trained_net, batching="eager", autostart=False)


def test_cancel_frees_slot_for_queued_request(tiny_net):
    """Mid-stream cancellation: the slot comes back and the queued request
    takes it over.  ``a``'s second token holds the scheduler until the
    cancel is in, so ``a`` cannot run to its length first however the
    threads are scheduled."""
    srv = _server(tiny_net, slots_per_bucket=1, decode_buckets=[24])
    gate = threading.Event()

    def hold(res, tok):
        if len(res.tokens_so_far()) == 2:
            gate.wait(30.0)

    try:
        a = srv.submit(_prompt(6, 1), max_new_tokens=24, on_token=hold)
        b = srv.submit(_prompt(6, 2), max_new_tokens=4)  # queued: one slot
        it = a.stream(timeout=30.0)
        next(it)
        next(it)
        a.cancel()
        gate.set()
        assert len(b.result(60.0)) == 4                # b got the slot
        with pytest.raises(StopIteration):             # a's stream ended
            while True:
                next(it)
        assert a.finish_reason == "cancelled"
        assert a.cancelled() and len(a.tokens_so_far()) < 24
        st = srv.stats()
        assert st["active_slots"] == 0 and st["tenants"]["default"]["cancelled"] == 1
    finally:
        srv.close()


def test_queue_depth_load_shedding(tiny_net):
    srv = _server(tiny_net, tenants={"capped": dict(max_queue=2, max_slots=0)})
    try:
        c0 = profiler.counters()["generation_shed"]
        srv.submit(_prompt(4, 0), tenant="capped")
        srv.submit(_prompt(4, 1), tenant="capped")
        with pytest.raises(AdmissionError):
            srv.submit(_prompt(4, 2), tenant="capped")
        assert profiler.counters()["generation_shed"] == c0 + 1
        st = srv.stats()["tenants"]["capped"]
        assert st["shed"] == 1 and st["submitted"] == 2
        assert isinstance(srv.tenants["capped"], Tenant)
        # the default tenant is unaffected by the capped tenant's backlog
        assert len(srv.submit(_prompt(4, 3), max_new_tokens=2).result(60.0)) == 2
    finally:
        srv.close(drain=False)


def test_tenant_slot_cap_respected(tiny_net):
    srv = _server(tiny_net, slots_per_bucket=4, tenants={"small": dict(max_slots=1)})
    try:
        peak = {"v": 0}

        def watch(r, t):
            peak["v"] = max(peak["v"], srv.stats()["tenants"]["small"]["active_slots"])

        rs = [srv.submit(_prompt(4, i), tenant="small", max_new_tokens=6, on_token=watch)
              for i in range(3)]
        for r in rs:
            r.result(60.0)
        assert peak["v"] == 1
    finally:
        srv.close()


def test_per_tenant_slo_accounting(tiny_net):
    # an SLO of 0 ms is violated by construction: the accounting is tested
    srv = _server(tiny_net, tenants={"strict": dict(slo_ttft_ms=0.0, slo_tpot_ms=0.0)})
    try:
        c0 = profiler.counters()["generation_slo_violation"]
        srv.submit(_prompt(4, 0), tenant="strict", max_new_tokens=3).result(60.0)
        srv.submit(_prompt(4, 1), max_new_tokens=3).result(60.0)
        assert profiler.counters()["generation_slo_violation"] == c0 + 1
        assert srv.stats()["tenants"]["strict"]["slo_violations"] == 1
        assert srv.stats()["tenants"]["default"]["slo_violations"] == 0
    finally:
        srv.close()


def test_churn_workload_zero_builds_guard_raise(trained_net):
    """With the guard armed in raise mode after warm-up, a mixed-length
    workload with requests joining and leaving completes without a build:
    join and leave are host-side slot indexing."""
    profiler.set_config(compile_guard="raise")
    srv = _server(trained_net, slots_per_bucket=2)
    try:
        c0 = profiler.counters()["recompile_steady_state"]
        comp0 = srv.compile_stats()["compiles"]
        rng = np.random.RandomState(0)
        rs = []
        for i in range(12):
            rs.append(srv.submit(_prompt(int(rng.randint(2, 16)), 1000 + i),
                                 max_new_tokens=int(rng.randint(2, 24))))
            if i % 3 == 0:
                time.sleep(0.01)                 # joins mid-decode
        for r in rs:
            r.result(120.0)                      # raise mode: a build would fail it
        assert profiler.counters()["recompile_steady_state"] == c0
        assert srv.compile_stats()["compiles"] == comp0
        assert profiler.compile_guard_state()["armed"]
    finally:
        srv.close()


def test_warmup_builds_are_declared(tiny_net):
    profiler.reset_compiles()
    srv = _server(tiny_net, decode_buckets=[8, 24])
    try:
        reg = profiler.compile_registry()["sites"]
        # 2 prompt buckets (8, 16) + 2 pools x (decode + insert)
        assert reg["generation.warmup"]["count"] == 6
        assert "generation.decode" not in reg    # nothing outside warm-up
        assert srv.compile_stats()["compiles"] == 6
    finally:
        srv.close()


def test_metrics_provider_and_counters(tiny_net):
    c0 = dict(profiler.counters())
    srv = _server(tiny_net, name="gen_metrics")
    try:
        srv.submit(_prompt(5, 0), max_new_tokens=4).result(60.0)
        prov = profiler.metrics_snapshot()["providers"]["gen_metrics"]
        assert prov["tenant_default_completed"] == 1
        assert prov["tenant_default_tokens"] == 4
        assert prov["active_slots"] == 0
        c = profiler.counters()
        assert c["generation_request"] == c0["generation_request"] + 1
        assert c["generation_token"] >= c0["generation_token"] + 4
        assert c["generation_slot_join"] == c0["generation_slot_join"] + 1
        assert c["generation_slot_leave"] == c0["generation_slot_leave"] + 1
        assert c["generation_prefill"] == c0["generation_prefill"] + 1
        assert "mxnet_gen_metrics_tenant_default_completed" in profiler.render_prometheus()
    finally:
        srv.close()
    assert "gen_metrics" not in profiler.metrics_snapshot()["providers"]


def test_generation_spans_in_trace(tiny_net, tmp_path):
    srv = _server(tiny_net, name="gen_spans")
    try:
        profiler.set_config(filename=str(tmp_path / "gen_trace.json"))
        profiler.start()
        srv.submit(_prompt(5, 0), max_new_tokens=3).result(60.0)
        profiler.stop()
    finally:
        srv.close()
    with open(profiler.dump()) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for want in ("generation.enqueue", "generation.prefill", "generation.step",
                 "generation.complete"):
        assert want in names, names


def test_admission_defers_under_memory_budget():
    """A server whose budget reports pressure defers queued prefills (the
    request stays pending, memory_budget_refusal counts) and admits when
    the budget recovers; its pools leave the ledger on close."""
    net = _net(1)

    class FlipBudget:
        blocked = True

        def under_pressure(self, frac=None):
            return self.blocked

    budget = FlipBudget()
    base = profiler.memory_ledger()["owners"].get("kv_cache.pool_8", {}).get("bytes", 0)
    srv = GenerationServer(net, bos=1, eos=2, max_prompt_length=8, max_new_tokens=8,
                           slots_per_bucket=2, memory_budget=budget, name="memtest")
    try:
        before = profiler.counters()["memory_budget_refusal"]
        res = srv.submit(np.array([3, 4, 5], np.int32))
        deadline = time.time() + 5.0
        while profiler.counters()["memory_budget_refusal"] == before:
            assert time.time() < deadline, "no budget refusal recorded"
            time.sleep(0.01)
        assert not res.done() and srv.stats()["active_slots"] == 0
        budget.blocked = False
        assert len(res.result(timeout=30.0)) >= 1
    finally:
        srv.close(drain=False)
    assert profiler.memory_ledger()["owners"]["kv_cache.pool_8"]["bytes"] == base


def test_memory_budget_on_the_ledger(monkeypatch):
    """No card: usage is the ledger's total; ``check`` raises with one
    postmortem of kind ``budget``."""
    monkeypatch.setattr(profiler, "device_memory_stats", lambda *a: {})
    owner = profiler.track_memory("test.budget_owner", "test")
    owner.alloc(1000 * 1024)
    try:
        budget = profiler.MemoryBudget(limit_mb=1)
        assert budget.usage_bytes() >= 1000 * 1024
        assert not budget.would_fit(200 * 1024) and budget.under_pressure()
        assert profiler.MemoryBudget(limit_mb=1024).would_fit(200 * 1024)
        before = profiler.counters()["memory_oom_postmortem"]
        with pytest.raises(profiler.MemoryBudgetError) as ei:
            budget.check(64 << 20, "test.forced")
        assert profiler.counters()["memory_oom_postmortem"] == before + 1
        rep = ei.value._mx_postmortem
        assert (rep["kind"], rep["failed_bytes"], rep["where"]) == (
            "budget", 64 << 20, "budget:test.forced")
        assert profiler.maybe_oom_postmortem(ei.value, "again") is rep
        monkeypatch.setenv("MXNET_MEM_BUDGET_MB", "2048")
        assert profiler.memory_budget().limit_bytes == 2048 << 20  # follows the env
    finally:
        owner.free(1000 * 1024)


def test_close_drains(tiny_net):
    srv = _server(tiny_net, slots_per_bucket=1)
    rs = [srv.submit(_prompt(4, i), max_new_tokens=3) for i in range(4)]
    srv.close(drain=True)
    for r in rs:
        assert len(r.result(1.0)) == 3
    with pytest.raises(RuntimeError):
        srv.submit(_prompt(4, 9))


def test_drain_close_with_unadmittable_queue_returns(tiny_net):
    """A zero-slot tenant's queued request can never run: the scheduler
    parks on it instead of spinning, and close(drain=True) fails it and
    returns promptly."""
    srv = _server(tiny_net, tenants={"frozen": dict(max_slots=0)})
    res = srv.submit(_prompt(4, 0), tenant="frozen")
    time.sleep(0.2)
    assert srv.stats()["iterations"] <= 2
    t0 = time.perf_counter()
    srv.close(drain=True, timeout=30.0)
    assert time.perf_counter() - t0 < 10.0
    with pytest.raises(RuntimeError, match="slot-capped"):
        res.result(1.0)


def test_close_no_drain_fails_queued(tiny_net):
    srv = _server(tiny_net, slots_per_bucket=1)
    rs = [srv.submit(_prompt(4, i), max_new_tokens=24) for i in range(4)]
    srv.close(drain=False)
    outcomes = []
    for r in rs:
        try:
            r.result(5.0)
            outcomes.append(r.finish_reason)
        except RuntimeError:
            outcomes.append("error")
    assert all(o in ("error", "cancelled", "eos", "length") for o in outcomes)
    assert "error" in outcomes                  # the queued tail failed


def test_submitters_from_threads(tiny_net):
    """Four threads submit at once; every request equals itself decoded
    alone."""
    srv = _server(tiny_net, slots_per_bucket=2, decode_buckets=[8, 24])
    try:
        prompts = [_prompt(3 + i % 12, 500 + i) for i in range(12)]
        budgets = [4 + (i * 5) % 20 for i in range(12)]
        alone = [srv.submit(p, max_new_tokens=n).result(60.0) for p, n in zip(prompts, budgets)]
        got = [None] * 12

        def worker(k):
            for i in range(k, 12, 4):
                got[i] = srv.submit(prompts[i], max_new_tokens=budgets[i]).result(60.0)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for a, g in zip(alone, got):
            np.testing.assert_array_equal(g, a)
        assert srv.stats()["tenants"]["default"]["failed"] == 0
    finally:
        srv.close()


def test_tokens_match_the_jax_server():
    """The port's GenerationServer and the JAX package's, over the same
    weights on the CPU, give the same tokens for the same prompts."""
    jprofiler.disarm_compile_guard()
    mxj.random.seed(0)
    j = JTransformer(VOCAB, units=24, hidden_size=48, num_heads=2, num_encoder_layers=2,
                     num_decoder_layers=2, dropout=0.0, max_length=64)
    j.initialize()
    j(mxj.nd.array(np.ones((1, 8), np.int32), dtype="int32"),
      mxj.nd.array(np.ones((1, 1), np.int32), dtype="int32"))
    t = Transformer(VOCAB, units=24, hidden_size=48, num_heads=2, num_encoder_layers=2,
                    num_decoder_layers=2, dropout=0.0, max_length=64)
    load_numpy_params(t, {k: p.data().asnumpy() for k, p in
                          j._collect_params_with_prefix().items()}, ctx=mx.cpu())
    prompts = [_prompt(3 + 2 * i, 700 + i) for i in range(6)]
    budgets = [6, 12, 20, 9, 24, 15]
    kw = dict(bos=BOS, eos=EOS, max_prompt_length=16, max_new_tokens=24, decode_buckets=[24],
              slots_per_bucket=4)
    jsrv = JGenerationServer(j, name="gen_parity_jax", **kw)
    try:
        want = [r.result(120.0) for r in [jsrv.submit(p, max_new_tokens=n)
                                          for p, n in zip(prompts, budgets)]]
    finally:
        jsrv.close()
        jprofiler.disarm_compile_guard()
    srv = GenerationServer(t, name="gen_parity", **kw)
    try:
        got = [r.result(60.0) for r in [srv.submit(p, max_new_tokens=n)
                                        for p, n in zip(prompts, budgets)]]
    finally:
        srv.close()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
