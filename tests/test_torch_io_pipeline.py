"""The port's ``io.DataPipeline`` on the CPU, against the JAX package's.

Delivery in source order whatever worker finishes first, windows stacked
by ``stage_window`` (short at an epoch tail and before an in-stream error)
equal to the JAX pipeline's, errors in order, ``reset``/``close`` joining
every thread, cursor resume, the autotuner driven through its injected
hooks (exact by count), the counters and spans, and ``fold_steps`` fed by
``stage_window`` bit-equal to windows the caller stacks.  No test paces a
consumer with ``sleep`` or reads a wall-time ratio: sources and prep
functions are gated by ``threading.Event``.
"""
import gc
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.io import DataPipeline as JPipeline
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import profiler
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.io import DataPipeline, NDArrayIter

CPU = "cpu"


def _threads():
    return [t for t in threading.enumerate() if t.name.startswith("mxnet-") and t.is_alive()]


def _wait(cond, timeout=10.0, what="condition"):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(autouse=True)
def no_thread_leak():
    yield
    gc.collect()
    _wait(lambda: not _threads(), timeout=10.0, what="pipeline threads to exit")


@pytest.fixture
def clean_profiler(tmp_path):
    profiler.stop()
    profiler.set_config(filename=str(tmp_path / "trace.json"), slow_step_ms=None)
    profiler.reset_counters()
    yield tmp_path
    profiler.stop()
    profiler.set_config(slow_step_ms=None, slow_step_auto=True)
    profiler.reset_counters()


def _src(n, shape=(4, 2)):
    return [np.full(shape, i, np.float32) for i in range(n)]


def _values(item):
    if isinstance(item, mx.io.DataBatch):
        return [x.asnumpy() for x in item.data + (item.label or [])]
    if isinstance(item, (list, tuple)):
        return [np.asarray(x.asnumpy() if isinstance(x, mx.nd.NDArray) else x) for x in item]
    return [np.asarray(item)]


def _jvalues(item):
    if isinstance(item, mxj.io.DataBatch):
        return [x.asnumpy() for x in item.data + (item.label or [])]
    if isinstance(item, (list, tuple)):
        return [np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x) for x in item]
    return [np.asarray(item)]


# -- delivery -----------------------------------------------------------------


def test_source_order_with_several_workers():
    """Batch 0's prep waits until batches 1-3 are prepped: the workers finish
    out of order and delivery is still source order."""
    later = threading.Event()
    done = []
    lock = threading.Lock()

    def prep(b):
        i = int(b[0, 0])
        if i == 0:
            assert later.wait(10.0)
        with lock:
            done.append(i)
            if {1, 2, 3} <= set(done):
                later.set()
        return b * 2

    with DataPipeline(_src(12), prep_fn=prep, num_workers=4, device=CPU) as pipe:
        got = [int(t[0, 0]) for t in pipe]
    assert got == [2 * i for i in range(12)]
    assert done.index(0) > 0


def test_values_and_types_match_the_jax_pipeline():
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = np.arange(20, dtype=np.int32)
    sources = {
        "ndarray_iter": (lambda: NDArrayIter(x, y, batch_size=4, shuffle=True, seed=3),
                         lambda: mxj.io.NDArrayIter(x, y, batch_size=4, shuffle=True, seed=3)),
        "tuples": (lambda: [(x[i:i + 2], y[i:i + 2]) for i in range(0, 20, 2)],) * 2,
        "dicts": (lambda: [{"a": x[i:i + 5]} for i in range(0, 20, 5)],) * 2,
    }
    for name, (make_t, make_j) in sources.items():
        with DataPipeline(make_t(), device=CPU, prep_fn=None) as tp:
            got = [_values(b) if not isinstance(b, dict) else [b["a"].numpy()] for b in tp]
        with JPipeline(make_j(), device=None) as jp:
            want = [_jvalues(b) if not isinstance(b, dict) else [np.asarray(b["a"])] for b in jp]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_ndarray_batches_come_back_as_cpu_ndarrays_and_tensors_as_tensors():
    x = np.ones((8, 2), np.float32)
    with DataPipeline(NDArrayIter(x, np.zeros(8), batch_size=4), device=mx.cpu()) as pipe:
        b = next(iter(pipe))
        assert isinstance(b, mx.io.DataBatch) and isinstance(b.data[0], mx.nd.NDArray)
        assert b.data[0].context == mx.cpu() and b.label[0].dtype == np.float32
    with DataPipeline([torch.ones(2, 2)], device="cpu") as pipe:
        t = next(iter(pipe))
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"


def test_sharded_pipeline_strides_as_the_jax_one():
    src = _src(10)
    for part in (0, 1):
        with DataPipeline(src, device=CPU, num_parts=2, part_index=part) as tp:
            got = [float(t[0, 0]) for t in tp]
        with JPipeline(src, num_parts=2, part_index=part) as jp:
            want = [float(np.asarray(a)[0, 0]) for a in jp]
        assert got == want == [float(i) for i in range(part, 10, 2)]
    with pytest.raises(ValueError, match="sharded"):
        DataPipeline(NDArrayIter(np.zeros((8, 2)), batch_size=2, num_parts=2),
                     device=CPU, num_parts=2, part_index=1)


# -- windows ------------------------------------------------------------------


def _windows(pipe, k):
    out = []
    while True:
        try:
            out.append(pipe.stage_window(k))
        except StopIteration:
            return out


@pytest.mark.parametrize("n,k", [(8, 4), (10, 4), (3, 4), (7, 3)])
def test_stage_window_equals_the_jax_windows(n, k):
    x = np.arange(n * 6, dtype=np.float32).reshape(n * 2, 3)
    y = np.arange(n * 2, dtype=np.int32)
    tp = DataPipeline(NDArrayIter(x, y, batch_size=2), device=CPU)
    jp = JPipeline(mxj.io.NDArrayIter(x, y, batch_size=2))
    try:
        got, want = _windows(tp, k), _windows(jp, k)
        assert [w.data[0].shape[0] for w in got] == [w.data[0].shape[0] for w in want]
        assert sum(w.data[0].shape[0] for w in got) == n
        for g, w in zip(got, want):
            for a, b in zip(_values(g), _jvalues(w)):
                np.testing.assert_array_equal(a, b)
        # a second epoch restarts from the source's first batch
        again = tp.stage_window()
        np.testing.assert_array_equal(again.data[0].asnumpy()[0], x[:2])
        assert tp.state_dict()["delivered"] == again.data[0].shape[0]
    finally:
        tp.close()
        jp.close()


def _failing(n_ok, k_err="bad batch"):
    def gen():
        for i in range(n_ok):
            yield np.full((2, 2), i, np.float32)
        raise ValueError(k_err)
    return gen


def test_windows_cut_by_an_error_ship_short_then_raise():
    tp = DataPipeline(_failing(5), device=CPU)
    jp = JPipeline(_failing(5))
    try:
        for pipe in (tp, jp):
            sizes = [pipe.stage_window(4).shape[0], pipe.stage_window(4).shape[0]]
            assert sizes == [4, 1]
            with pytest.raises(ValueError, match="bad batch"):
                pipe.stage_window(4)
    finally:
        tp.close()
        jp.close()


def test_set_window_mid_epoch_raises():
    with DataPipeline(_src(8), device=CPU) as pipe:
        next(iter(pipe))
        with pytest.raises(RuntimeError, match="mid-epoch"):
            pipe.set_window(2)
        pipe.reset()
        assert pipe.set_window(2).window == 2
        assert pipe.stage_window().shape == (2, 4, 2)


def test_fold_steps_fed_by_stage_window_bit_equal_to_caller_windows():
    """``Trainer.fold_steps(k=2)`` on CPU tensors: windows staged by the
    pipeline and the same windows stacked by the caller give the same
    parameters, optimizer states and losses, bit for bit."""
    rng = np.random.RandomState(0)
    x = rng.randn(24, 6).astype(np.float32)
    y = rng.randint(0, 3, (24,)).astype(np.int32)

    def run(windows):
        mx.random.seed(1)
        net = nn.Dense(3, in_units=6)
        net.initialize(ctx=mx.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.05})
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        prog = tr.fold_steps(lambda a, b: ce(net(a), b), k=2)
        losses = [prog(*w).clone() for w in windows]
        mx.profiler.disarm_compile_guard()
        return ([p.data().clone() for p in net.collect_params().values()],
                [s.clone() for st in tr._states.values() for s in st], losses)

    pipe = DataPipeline(NDArrayIter(x, y, batch_size=4), device=CPU)
    try:
        staged = [[a._data for a in w.data + w.label] for w in _windows(pipe, 2)]
    finally:
        pipe.close()
    caller = [[torch.from_numpy(x[i:i + 8].reshape(2, 4, 6)),
               torch.from_numpy(y[i:i + 8].reshape(2, 4))] for i in range(0, 24, 8)]
    assert len(staged) == 3
    for a, b in zip(staged, caller):
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    got, want = run(staged), run(caller)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(torch.equal(p, q) for p, q in zip(g, w))


# -- errors, lifecycle, resume --------------------------------------------------


def test_errors_arrive_in_order():
    def prep(b):
        if b[0, 0] == 3:
            raise KeyError("prep failed at 3")
        return b

    with DataPipeline(_src(6), prep_fn=prep, num_workers=3, device=CPU) as pipe:
        it = iter(pipe)
        assert [float(next(it)[0, 0]) for _ in range(3)] == [0.0, 1.0, 2.0]
        with pytest.raises(KeyError, match="prep failed at 3"):
            next(it)


def test_close_joins_every_thread_and_reset_restarts():
    gate = threading.Event()

    def prep(b):
        gate.wait(10.0)
        return b

    pipe = DataPipeline(_src(50), prep_fn=prep, num_workers=3, device=CPU)
    assert len(_threads()) == 5  # reader, 3 workers, transfer
    gate.set()
    next(iter(pipe))
    pipe.reset()
    assert [float(t[0, 0]) for t in pipe][:3] == [0.0, 1.0, 2.0]
    pipe.close()
    assert not _threads()
    with pytest.raises(StopIteration):
        next(pipe)
    pipe.close()  # idempotent


def test_abandoned_pipeline_is_collected():
    pipe = DataPipeline(_src(100), device=CPU)
    next(iter(pipe))
    del pipe
    gc.collect()
    _wait(lambda: not _threads(), what="an abandoned pipeline's threads")


def test_state_dict_resume_gives_the_rest_of_the_epoch():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)

    def source():
        return NDArrayIter(x, batch_size=2, shuffle=True, seed=9)

    with DataPipeline(source(), device=CPU) as full:
        first = [b.data[0].asnumpy() for b in full]
        second = [b.data[0].asnumpy() for b in full]
    pipe = DataPipeline(source(), device=CPU)
    assert sum(1 for _ in pipe) == len(first)  # epoch 0
    it = iter(pipe)  # epoch 1
    head = [next(it).data[0].asnumpy() for _ in range(4)]
    state = pipe.state_dict()
    pipe.close()
    assert state == {"kind": "DataPipeline", "epoch": 1, "delivered": 4}
    resumed = DataPipeline(source(), device=CPU, autostart=False)
    resumed.load_state_dict(state)
    try:
        rest = [b.data[0].asnumpy() for b in resumed]
    finally:
        resumed.close()
    assert len(head) + len(rest) == len(second)
    for a, b in zip(head + rest, second):
        np.testing.assert_array_equal(a, b)


def test_load_state_dict_after_start_raises():
    with DataPipeline(_src(4), device=CPU) as pipe:
        with pytest.raises(RuntimeError, match="before start"):
            pipe.load_state_dict({"epoch": 0, "delivered": 1})
        with pytest.raises(ValueError, match="not a DataPipeline"):
            pipe.load_state_dict({"kind": "NDArrayIter"})


# -- the autotuner, driven through its hooks ------------------------------------


HOST_BOUND = [{"wall_ms": 10.0, "host_ms": 9.0, "comms_ms": 0.0, "device_ms": 1.0}] * 8
DEVICE_BOUND = [{"wall_ms": 10.0, "host_ms": 1.0, "comms_ms": 0.0, "device_ms": 9.0}] * 8


def _tuner(monkeypatch, stats, pressure, **kw):
    monkeypatch.setenv("MXNET_IO_TUNE_INTERVAL", "1")
    pipe = DataPipeline(_src(4), device=CPU, autostart=False, _step_stats_fn=lambda: stats,
                        _device_pressure_fn=lambda frac: pressure(), **kw)
    return pipe, pipe._eng


def test_autotune_raises_one_a_tick_to_the_cap(monkeypatch):
    pipe, eng = _tuner(monkeypatch, HOST_BOUND, lambda: False, depth=2, max_depth=5)
    depths = []
    for _ in range(5):
        eng._maybe_autotune()
        depths.append(pipe.depth)
    assert depths == [3, 4, 5, 5, 5] and eng.stats()["depth_changes"] == 3


def test_autotune_holds_a_device_bound_run(monkeypatch):
    pipe, eng = _tuner(monkeypatch, DEVICE_BOUND, lambda: False, depth=2, max_depth=5)
    for _ in range(4):
        eng._maybe_autotune()
    assert pipe.depth == 2 and eng.stats()["depth_changes"] == 0
    eng._warm_stalls = 1  # a stall after the buffer filled is a signal of its own
    eng._maybe_autotune()
    assert pipe.depth == 3


def test_autotune_budget_caps_and_backs_off(monkeypatch):
    batch = 4 * 2 * 4
    pipe, eng = _tuner(monkeypatch, HOST_BOUND, lambda: False, depth=2, max_depth=8,
                       memory_budget_mb=3 * batch / (1 << 20))
    eng._batch_bytes = batch
    for _ in range(4):
        eng._maybe_autotune()
    assert pipe.depth == 3
    eng._batch_bytes = 2 * batch  # batches grew: depth 3 no longer fits
    eng._maybe_autotune()
    assert pipe.depth == 2
    eng._maybe_autotune()
    assert pipe.depth == 2  # never below double buffering


def test_autotune_pressure_backs_off_to_the_floor(monkeypatch):
    pressure = {"on": True}
    pipe, eng = _tuner(monkeypatch, HOST_BOUND, lambda: pressure["on"], depth=5, max_depth=8)
    depths = []
    for _ in range(4):
        eng._maybe_autotune()
        depths.append(pipe.depth)
    assert depths == [4, 3, 2, 2]
    pressure["on"] = False
    eng._maybe_autotune()
    assert pipe.depth == 3


def test_autotune_off_and_interval(monkeypatch):
    pipe, eng = _tuner(monkeypatch, HOST_BOUND, lambda: False, autotune=False, depth=3)
    for _ in range(3):
        eng._maybe_autotune()
    assert pipe.depth == 3
    monkeypatch.setenv("MXNET_IO_TUNE_INTERVAL", "3")
    pipe = DataPipeline(_src(4), device=CPU, autostart=False, _step_stats_fn=lambda: HOST_BOUND,
                        _device_pressure_fn=lambda frac: False)
    depths = []
    for _ in range(6):
        pipe._eng._maybe_autotune()
        depths.append(pipe.depth)
    assert depths == [2, 2, 3, 3, 3, 4]


def test_autotune_raises_in_a_running_pipeline(monkeypatch):
    monkeypatch.setenv("MXNET_IO_TUNE_INTERVAL", "1")
    with DataPipeline(_src(40), device=CPU, depth=2, max_depth=4,
                      _step_stats_fn=lambda: HOST_BOUND,
                      _device_pressure_fn=lambda frac: False) as pipe:
        it = iter(pipe)
        for _ in range(4):
            next(it)
        _wait(lambda: pipe.depth == 4, what="the depth to reach its cap")
        assert pipe.stats()["depth_changes"] == 2


# -- observability --------------------------------------------------------------


def test_stall_counter_is_exact(clean_profiler):
    """Each next() issued while the gated prep holds the only batch is one
    stall: exactly four for four batches."""
    gates = [threading.Event() for _ in range(4)]
    arrived = threading.Event()

    def prep(b):
        i = int(b[0, 0])
        gates[i].wait(10.0)
        return b

    pipe = DataPipeline(_src(4), prep_fn=prep, num_workers=1, autotune=False, device=CPU)
    try:
        it = iter(pipe)
        for i in range(4):
            opener = threading.Thread(target=lambda i=i: (arrived.wait(10.0), gates[i].set()))
            opener.start()
            # the consumer is parked in next() before the gate opens: poll the
            # stall counter the pipeline bumps on arrival
            threading.Thread(target=lambda i=i: (_wait(lambda: pipe.stats()["stalls"] == i + 1),
                                                 arrived.set())).start()
            assert float(next(it)[0, 0]) == i
            opener.join(20.0)
            assert not opener.is_alive()
            arrived.clear()
    finally:
        for g in gates:
            g.set()
        pipe.close()
    st = pipe.stats()
    assert profiler.counters()["io_pipeline_stalls"] == 4 and st["stalls"] == 4
    assert st["stall_ms_p99"] >= st["stall_ms_p50"] > 0


def test_counters_spans_and_bytes(clean_profiler):
    profiler.start()
    try:
        with DataPipeline(_src(5, (8, 4)), prep_fn=lambda b: b + 1.0, device=CPU) as pipe:
            got = [t for t in pipe]
        names = {e.get("name") for e in profiler._trace_events() if e.get("ph") in ("B", "X")}
    finally:
        profiler.stop()
    c = profiler.counters()
    assert c["io_pipeline_batches"] == 5 and c["io_pipeline_bytes"] == 5 * 8 * 4 * 4
    assert {"io.prep", "io.transfer"} <= names
    assert float(got[-1][0, 0]) == 5.0


def test_io_wait_bills_the_data_wait_bucket(clean_profiler):
    gate = threading.Event()

    def prep(b):
        gate.wait(10.0)
        return b

    profiler.start()
    try:
        profiler.reset_goodput()
        with DataPipeline(_src(1), prep_fn=prep, device=CPU, autotune=False) as pipe:
            threading.Timer(0.05, gate.set).start()
            next(iter(pipe))
        snap = profiler.goodput_snapshot()
    finally:
        profiler.stop()
    assert snap["buckets_s"]["data_wait"] > 0.0


def test_metrics_provider_lifecycle():
    pipe = DataPipeline(_src(4), device=CPU, name="io_lifecycle_probe")
    try:
        snap = profiler.metrics_snapshot()
        assert "io_lifecycle_probe" in str(snap)
        st = pipe.stats()
        assert {"depth", "buffer_occupancy", "buffer_bytes", "stall_ms_p99", "window"} <= set(st)
    finally:
        pipe.close()
    assert "io_lifecycle_probe" not in str(profiler.metrics_snapshot())


# -- what waits, and the default device -----------------------------------------


def test_sequence_placement_raises_naming_6b():
    with pytest.raises(NotImplementedError, match="6b"):
        DataPipeline(_src(2), device=CPU, sp_axis=1)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(mx.MXNetError, match="CUDA device"):
        DataPipeline(_src(2))
    with mx.cpu():
        with DataPipeline(_src(2)) as pipe:
            assert [float(t[0, 0]) for t in pipe] == [0.0, 1.0]


def test_mesh_placement_is_the_rank_device():
    mesh = mx.parallel.make_mesh(devices=["cpu"])
    with DataPipeline(_src(3), mesh=mesh) as pipe:
        assert all(t.device.type == "cpu" for t in pipe)
    with mx.parallel.mesh_scope(mesh):
        with DataPipeline(_src(3)) as pipe:
            assert pipe._eng._device.type == "cpu"
