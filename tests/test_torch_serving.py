"""The port's serving tier against the JAX package's, on the CPU.

Mirrors ``tests/test_serving.py`` and ``tests/test_serving_drain.py``:
bucket ladders equal to the JAX ones; batch formation (full batches,
deadline dispatch, bucket groups, a past-deadline head beating full
batches); input validation; per-output un-padding; padding that round-trips
exactly against ``Predictor.forward``; batched rows equal to unbatched
ones; the bf16 tier within the JAX test's tolerance of the fp32 tier; the
SLO counter; bucket hits after warm-up; metrics, Prometheus and spans;
concurrent submitters; close with and without drain, the drain deadline,
``/healthz`` and the SIGTERM chain.  Then the tiny ``bert_symbol`` served
by both packages' ``InferenceServer`` with fixed-length int32 inputs.
Everything is held to counts and values, never to wall-time ratios.
"""
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_tpu.symbol as J
from incubator_mxnet_tpu.serving import InferenceServer as JServer
from incubator_mxnet_tpu.serving import ShapeBucketer as JBucketer
import incubator_mxnet_torch as mx
import incubator_mxnet_torch.symbol as S
from incubator_mxnet_torch import profiler
from incubator_mxnet_torch.predictor import Predictor
from incubator_mxnet_torch.serving import (InferenceServer, ServerDrainingError, ShapeBucketer,
                                           install_sigterm_drain)

from sym_bert import bert_symbol

FEAT = 4
HID = 6
# fp32 through 2 post-LN layers in another summation order
# (tests/test_torch_bert.py).
FP32_TOL = 1e-4
# the JAX test_serving.py bound of the bf16 tier against the fp32 one
BF16_TOL = 0.05


def _model(seed=0, two_outputs=False):
    """Padding-safe per-position model: FC(flatten=False) + tanh over
    (batch, length, FEAT); with ``two_outputs`` Group([tanh(fc), fc])."""
    S.symbol._reset_naming()
    fc = S.FullyConnected(S.var("data"), num_hidden=HID, flatten=False, name="fc1")
    sym = S.Activation(fc, act_type="tanh", name="t1")
    rng = np.random.RandomState(seed)
    w = rng.randn(HID, FEAT).astype(np.float32)
    b = rng.randn(HID).astype(np.float32)
    params = {"arg:fc1_weight": mx.nd.array(w, ctx=mx.cpu()),
              "arg:fc1_bias": mx.nd.array(b, ctx=mx.cpu())}
    if two_outputs:
        return S.Group([sym, fc]), params, w, b
    return sym, params


def _server(sym, params, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_queue_ms", 50.0)
    kw.setdefault("max_length", 16)
    kw.setdefault("name", "serving_test")
    kw.setdefault("dev_type", "cpu")
    return InferenceServer(sym, params, {"data": (None, FEAT)}, **kw)


def _reference(sym, params, sample, bucket):
    pred = Predictor(sym, params, {"data": (1, bucket, FEAT)}, dev_type="cpu")
    buf = np.zeros((1, bucket, FEAT), np.float32)
    buf[0, :sample.shape[0]] = sample
    return pred.predict(data=buf)[0, :sample.shape[0]]


@pytest.fixture(autouse=True)
def serving_health():
    profiler.set_health("serving")
    yield
    profiler.set_health("serving")


@pytest.mark.parametrize("kw", [dict(max_length=100, min_bucket=8), dict(buckets=[64, 16, 32]),
                                dict(max_length=64, min_bucket=1), dict(buckets=[8, 16],
                                                                        max_length=12)],
                         ids=["pow2", "explicit", "batch", "ceiling"])
def test_bucket_ladders_equal_the_jax_ones(kw):
    b, j = ShapeBucketer(**kw), JBucketer(**kw)
    assert b.buckets == j.buckets and b.max_length == j.max_length
    for n in range(1, b.max_length + 1):
        assert b.bucket_for(n) == j.bucket_for(n)
    with pytest.raises(ValueError):
        b.bucket_for(b.max_length + 1)


def test_bucketer_needs_max_length_and_a_served_ceiling():
    with pytest.raises(ValueError):
        ShapeBucketer()
    with pytest.raises(ValueError):
        ShapeBucketer(buckets=[8], max_length=9)


def test_full_batches_respect_max_batch_size():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=4, max_queue_ms=5000.0)
    try:
        rng = np.random.RandomState(1)
        pendings = [srv.submit({"data": rng.rand(8, FEAT).astype(np.float32)})
                    for _ in range(8)]
        outs = [p.result(timeout=30.0) for p in pendings]
        assert all(o.shape == (8, HID) for o in outs)
        st = srv.stats()
        assert st["batches"] == 2 and st["batch_requests"] == 8
        # full batches went out at once: nobody waited out the 5 s deadline
        assert max(p.latency_ms for p in pendings) < 2000.0
    finally:
        srv.close()


def test_deadline_dispatches_a_partial_batch():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=8, max_queue_ms=100.0)
    try:
        t0 = time.perf_counter()
        out = srv.infer({"data": np.ones((3, FEAT), np.float32)}, timeout=30.0)
        assert out.shape == (3, HID)
        assert 0.05 <= time.perf_counter() - t0 < 10.0
        assert srv.stats()["batches"] == 1
    finally:
        srv.close()


def test_mixed_lengths_split_into_bucket_groups():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=4, max_queue_ms=100.0, length_buckets=[8, 16])
    try:
        rng = np.random.RandomState(2)
        pendings = [srv.submit({"data": rng.rand(n, FEAT).astype(np.float32)})
                    for n in (3, 12, 5, 16)]
        for p in pendings:
            p.result(timeout=30.0)
        st = srv.stats()
        assert st["batches"] == 2 and st["batch_requests"] == 4
    finally:
        srv.close()


def test_past_deadline_head_beats_full_batches():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=2, max_queue_ms=5.0, length_buckets=[8, 16])
    try:
        rng = np.random.RandomState(8)
        minority = srv.submit({"data": rng.rand(12, FEAT).astype(np.float32)})
        stop = threading.Event()

        def flood():  # keeps bucket-8 full batches always available
            while not stop.is_set():
                ps = [srv.submit({"data": rng.rand(4, FEAT).astype(np.float32)})
                      for _ in range(4)]
                for p in ps:
                    p.result(timeout=30.0)

        th = threading.Thread(target=flood, daemon=True)
        th.start()
        try:
            out = minority.result(timeout=10.0)
        finally:
            stop.set()
            th.join(30.0)
        assert out.shape == (12, HID)
    finally:
        srv.close()


def test_submit_validates_inputs():
    sym, params = _model()
    srv = _server(sym, params, max_length=16)
    try:
        with pytest.raises(ValueError):   # too long for the top bucket
            srv.submit({"data": np.ones((17, FEAT), np.float32)})
        with pytest.raises(ValueError):   # wrong fixed dim
            srv.submit({"data": np.ones((4, FEAT + 1), np.float32)})
        with pytest.raises(ValueError):   # wrong input name
            srv.submit({"nope": np.ones((4, FEAT), np.float32)})
    finally:
        srv.close()


@pytest.mark.parametrize("spec,shapes", [([0, 0], [(5, HID), (5, HID)]),
                                         ("auto", [(5, HID), (5, HID)]),
                                         ({0: 0}, [(5, HID), (8, HID)])],
                         ids=["list", "auto", "dict"])
def test_multi_output_unpadding(spec, shapes):
    sym, params, w, b = _model(two_outputs=True)
    srv = InferenceServer(sym, params, {"data": (None, FEAT)}, max_batch_size=4,
                          max_queue_ms=5.0, length_buckets=[8, 16], unpad_output_axis=spec,
                          name="mo_test", dev_type="cpu")
    try:
        x = np.random.RandomState(1).rand(5, FEAT).astype(np.float32)
        out = srv.infer({"data": x}, timeout=30.0)
        assert isinstance(out, list) and [o.shape for o in out] == shapes
        ref = x @ w.T + b
        np.testing.assert_allclose(out[1][:5], ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out[0], np.tanh(ref), rtol=1e-5, atol=1e-6)
    finally:
        srv.close()


def test_wrong_unpad_spec_fails_at_construction():
    sym, params, _, _ = _model(two_outputs=True)
    with pytest.raises(ValueError, match="3 entries.*2 outputs"):
        InferenceServer(sym, params, {"data": (None, FEAT)}, max_batch_size=4,
                        max_length=16, unpad_output_axis=[0, 0, 0], name="mo_bad",
                        warmup=False, autostart=False, dev_type="cpu")


def test_single_output_keeps_the_bare_array():
    sym, params = _model()
    srv = _server(sym, params, max_queue_ms=5.0)
    try:
        out = srv.infer({"data": np.ones((4, FEAT), np.float32)}, timeout=30.0)
        assert isinstance(out, np.ndarray)
    finally:
        srv.close()


def test_padding_round_trips_exactly():
    sym, params = _model()
    srv = _server(sym, params, max_queue_ms=5.0, length_buckets=[8, 16])
    try:
        rng = np.random.RandomState(3)
        for n in (2, 8, 11, 16):
            x = rng.rand(n, FEAT).astype(np.float32)
            out = srv.infer({"data": x}, timeout=30.0)
            ref = _reference(sym, params, x, srv._len_bucketer.bucket_for(n))
            assert out.shape == ref.shape
            np.testing.assert_array_equal(out, ref)
    finally:
        srv.close()


def test_batched_rows_equal_unbatched_ones():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=4, max_queue_ms=2000.0)
    try:
        rng = np.random.RandomState(4)
        xs = [rng.rand(5, FEAT).astype(np.float32) for _ in range(4)]
        pendings = [srv.submit({"data": x}) for x in xs]
        for x, p in zip(xs, pendings):
            np.testing.assert_allclose(p.result(timeout=30.0), _reference(sym, params, x, 8),
                                       rtol=0, atol=1e-6)
        assert srv.stats()["batches"] == 1
    finally:
        srv.close()


def test_bf16_tier_within_tolerance_of_fp32():
    sym, params = _model()
    srv32 = _server(sym, params, max_queue_ms=5.0, name="srv_fp32")
    srv16 = _server(sym, params, max_queue_ms=5.0, name="srv_bf16", amp_dtype="bfloat16")
    try:
        x = np.random.RandomState(5).rand(7, FEAT).astype(np.float32)
        o32 = srv32.infer({"data": x}, timeout=30.0)
        o16 = srv16.infer({"data": x}, timeout=30.0)
        # bf16 comes back as float32 of the bf16 values (numpy has no bf16
        # on every machine the port runs on)
        assert o16.dtype == np.float32
        assert np.array_equal(o16, torch.from_numpy(o16).bfloat16().float().numpy())
        np.testing.assert_allclose(o32, o16, rtol=0, atol=BF16_TOL)
        assert not np.array_equal(o32, o16)
    finally:
        srv32.close()
        srv16.close()


def test_slo_violation_exactly_once_per_late_request():
    sym, params = _model()
    srv = _server(sym, params, max_queue_ms=5.0, slo_ms=1e-6)
    try:
        before = profiler.counters()["serving_slo_violation"]
        pendings = [srv.submit({"data": np.ones((4, FEAT), np.float32)}) for _ in range(6)]
        for p in pendings:
            p.result(timeout=30.0)
        assert profiler.counters()["serving_slo_violation"] - before == 6
        assert srv.stats()["slo_violations"] == 6
    finally:
        srv.close()


def test_no_violation_under_a_generous_slo():
    sym, params = _model()
    srv = _server(sym, params, max_queue_ms=5.0, slo_ms=60_000.0)
    try:
        before = profiler.counters()["serving_slo_violation"]
        srv.infer({"data": np.ones((4, FEAT), np.float32)}, timeout=30.0)
        assert profiler.counters()["serving_slo_violation"] == before
    finally:
        srv.close()


def test_bucket_hits_after_warmup_and_no_builds():
    sym, params = _model()
    srv = _server(sym, params, max_queue_ms=5.0)
    try:
        warm = srv.compile_stats()
        assert warm["fwd_entries"] == 3 * 2   # batch buckets 1, 2, 4 × lengths 8, 16
        for _ in range(3):
            srv.infer({"data": np.ones((4, FEAT), np.float32)}, timeout=30.0)
        st = srv.stats()
        assert (st["bucket_misses"], st["bucket_miss_after_warmup"], st["bucket_hits"]) == \
            (0, 0, 3)
        assert srv.compile_stats() == warm
        assert profiler.compile_guard_state()["armed"]
    finally:
        srv.close()


def test_metrics_provider_in_snapshot_and_prometheus():
    sym, params = _model()
    srv = _server(sym, params, max_queue_ms=5.0, name="srv_metrics")
    try:
        srv.infer({"data": np.ones((2, FEAT), np.float32)}, timeout=30.0)
        prov = profiler.metrics_snapshot()["providers"]["srv_metrics"]
        assert prov["completed"] >= 1 and prov["latency_ms_p99"] is not None
        text = profiler.render_prometheus()
        assert "mxnet_srv_metrics_latency_ms_p99" in text
        assert "mxnet_srv_metrics_queue_depth" in text
    finally:
        srv.close()
    assert "srv_metrics" not in profiler.metrics_snapshot()["providers"]


def test_spans_appear_in_dump(tmp_path):
    sym, params = _model()
    srv = _server(sym, params, max_queue_ms=5.0)
    try:
        profiler.set_config(filename=str(tmp_path / "trace.json"))
        profiler.start()
        srv.infer({"data": np.ones((2, FEAT), np.float32)}, timeout=30.0)
        profiler.stop()
        with open(profiler.dump()) as f:
            trace = json.load(f)
        names = {e.get("name") for e in trace["traceEvents"]}
        for want in ("serving.enqueue", "serving.batch_form", "serving.dispatch",
                     "serving.complete"):
            assert want in names, f"missing span {want}"
        assert trace["otherData"]["counters"]["serving_batch"] >= 1
    finally:
        profiler.stop()
        srv.close()


def test_concurrent_submitters_get_their_own_results():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=4, max_queue_ms=20.0, length_buckets=[8, 16])
    try:
        lengths = {0: 3, 1: 8, 2: 11, 3: 16, 4: 5, 5: 13}
        expected = {t: _reference(sym, params, np.full((n, FEAT), t + 1, np.float32) / 10.0,
                                  srv._len_bucketer.bucket_for(n))
                    for t, n in lengths.items()}
        errors = []

        def worker(tid):
            x = np.full((lengths[tid], FEAT), tid + 1, np.float32) / 10.0
            for _ in range(4):
                out = srv.infer({"data": x}, timeout=30.0)
                if out.shape != expected[tid].shape or \
                        not np.allclose(out, expected[tid], atol=1e-6):
                    errors.append(tid)

        threads = [threading.Thread(target=worker, args=(t,)) for t in lengths]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not errors, f"cross-request leakage for threads {errors}"
        assert srv.stats()["completed"] == 4 * len(lengths)
    finally:
        srv.close()


def test_close_drains_the_queue_and_context_manager():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=8, max_queue_ms=60_000.0)
    rng = np.random.RandomState(6)
    pendings = [srv.submit({"data": rng.rand(4, FEAT).astype(np.float32)}) for _ in range(5)]
    srv.close()
    for p in pendings:
        assert p.done() and p.result(timeout=1.0).shape == (4, HID)
    assert srv.stats()["completed"] == 5
    with pytest.raises(ServerDrainingError, match="retry"):
        srv.submit({"data": np.ones((4, FEAT), np.float32)})
    with pytest.raises(RuntimeError):   # a RuntimeError for pre-drain callers
        srv.submit({"data": np.ones((4, FEAT), np.float32)})
    with _server(sym, params, max_queue_ms=5.0) as srv2:
        assert srv2.infer({"data": np.ones((2, FEAT), np.float32)},
                          timeout=30.0).shape == (2, HID)


def test_close_without_drain_fails_queued_retriably():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=2, max_queue_ms=10_000.0)
    gate = threading.Event()
    orig = srv._pred.forward
    srv._pred.forward = lambda: (gate.wait(10), orig())[1]
    try:
        pending = [srv.submit({"data": np.zeros((3, FEAT), np.float32)}) for _ in range(4)]
        srv.close(drain=False, timeout=5.0)
        gate.set()
        failures = 0
        for p in pending:
            try:
                p.result(timeout=10.0)
            except ServerDrainingError:
                failures += 1
        assert failures >= 2   # whatever never dispatched failed fast
    finally:
        gate.set()


def test_drain_deadline_fails_the_remainder():
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=1, max_queue_ms=5.0)
    orig = srv._pred.forward
    srv._pred.forward = lambda: (time.sleep(1.0), orig())[1]
    pending = [srv.submit({"data": np.zeros((3, FEAT), np.float32)}) for _ in range(4)]
    t0 = time.perf_counter()
    srv.close(drain=True, timeout=0.3)
    assert time.perf_counter() - t0 < 5.0
    outcomes = []
    for p in pending:
        try:
            p.result(timeout=10.0)
            outcomes.append("ok")
        except Exception as e:  # noqa: BLE001
            outcomes.append(e)
    assert any(isinstance(o, ServerDrainingError) for o in outcomes), outcomes


def test_healthz_flips_with_set_health():
    port = profiler.start_metrics(port=0)
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10)
        assert body.status == 200 and body.read().decode().strip() == "serving"
        profiler.set_health("draining")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10)
        assert ei.value.code == 503 and ei.value.read().decode().strip() == "draining"
        assert urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).status == 200
    finally:
        profiler.stop_metrics()


def test_sigterm_drains_flips_health_and_chains_the_previous_handler():
    chained = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    sym, params = _model()
    srv = _server(sym, params, max_batch_size=2, max_queue_ms=30.0)
    try:
        install_sigterm_drain(srv, deadline_s=2.0)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10.0
        while not chained and time.monotonic() < deadline:
            time.sleep(0.01)
        assert chained == [signal.SIGTERM]
        assert profiler.health_state() == "draining"
        with pytest.raises(ServerDrainingError):
            srv.submit({"data": np.zeros((3, FEAT), np.float32)})
    finally:
        signal.signal(signal.SIGTERM, prev)
        srv.close()


def test_server_without_dev_type_raises_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sym, params = _model()
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        InferenceServer(sym, params, {"data": (None, FEAT)}, max_length=8)


def test_tiny_bert_served_by_both_packages():
    """Fixed-length int32 inputs, max_batch_size 2: the port's answers
    within FP32_TOL of the JAX server's, one full batch each."""
    cfg = dict(num_layers=2, units=64, hidden_size=128, num_heads=4, vocab_size=100,
               seq_len=16, num_masked=3, max_length=64)
    sym = bert_symbol(S, **cfg)
    spec = {"token_ids": (16,), "token_types": (16,), "masked_positions": (3,)}
    shapes = {k: (2,) + v for k, v in spec.items()}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    weights = {n: (rng.randn(*s) * 0.2).astype(np.float32)
               for n, s in zip(sym.list_arguments(), arg_shapes) if n not in spec}
    reqs = [{"token_ids": rng.randint(0, 100, 16), "token_types": rng.randint(0, 2, 16),
             "masked_positions": rng.randint(0, 16, 3)} for _ in range(2)]
    kw = dict(input_dtypes={k: "int32" for k in spec}, max_batch_size=2, max_queue_ms=5000.0)
    srv = InferenceServer(sym, {"arg:" + k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in weights.items()}, spec, name="bert_port",
                          dev_type="cpu", **kw)
    jsrv = JServer(bert_symbol(J, **cfg), {"arg:" + k: mxj.nd.array(v)
                                           for k, v in weights.items()}, spec,
                   name="bert_jax", **kw)
    try:
        got = [p.result(timeout=60.0) for p in [srv.submit(r) for r in reqs]]
        want = [p.result(timeout=60.0) for p in [jsrv.submit(r) for r in reqs]]
        assert srv.stats()["batches"] == 1 and jsrv.stats()["batches"] == 1
        for g, w in zip(got, want):
            assert [a.shape for a in g] == [(3, 100), (2,)]
            for a, b in zip(g, w):
                np.testing.assert_allclose(a, b, rtol=FP32_TOL, atol=FP32_TOL)
        assert srv.stats()["bucket_miss_after_warmup"] == 0
    finally:
        srv.close()
        jsrv.close()
