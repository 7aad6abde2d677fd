"""The port's ``mx.io`` iterators against the JAX package's, on the CPU.

``NDArrayIter`` (the three ``last_batch_handle`` modes, pads, shards, the
seeded epoch-aware shuffle, resume from ``state_dict``), ``ResizeIter``,
``PrefetchingIter`` and ``CSVIter`` are driven batch by batch through both
packages on the same numpy data; every batch must be equal in values,
dtype, pad and index.  Batches are NDArrays on the CPU context.
"""
import gc
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import profiler


def _data(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32), rng.randint(0, 5, (n,)).astype(np.int32),
            rng.randn(n, 2, 2).astype(np.float32))


def _batches(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lab.asnumpy() for lab in (b.label or [])], b.pad,
                        None if b.index is None else np.asarray(b.index)))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp, gi), (wd, wl, wp, wi) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        if wi is None:
            assert gi is None
        else:
            np.testing.assert_array_equal(gi, wi)


ITER_CASES = [
    dict(batch_size=3, last_batch_handle="pad"),
    dict(batch_size=3, last_batch_handle="discard"),
    dict(batch_size=3, last_batch_handle="roll_over"),
    dict(batch_size=4, shuffle=True, seed=7),
    dict(batch_size=4, shuffle=True, seed=7, last_batch_handle="roll_over"),
    dict(batch_size=2, num_parts=2, part_index=1),
    dict(batch_size=2, num_parts=3, part_index=2, allow_pad=True, shuffle=True, seed=3),
    dict(batch_size=5, last_batch_handle="discard", shuffle=True, seed=1),
]


@pytest.mark.parametrize("kw", ITER_CASES, ids=[str(i) for i in range(len(ITER_CASES))])
def test_ndarray_iter_matches_jax_over_epochs(kw):
    x, y, z = _data()
    got = _batches(mx.io.NDArrayIter([x, z], y, **kw), epochs=3)
    want = _batches(mxj.io.NDArrayIter([x, z], y, **kw), epochs=3)
    _assert_same(got, want)


def test_ndarray_iter_batches_live_on_the_cpu():
    x, y, _ = _data()
    b = next(iter(mx.io.NDArrayIter(x, y.astype(np.int64), batch_size=4)))
    assert b.data[0].context == mx.cpu() and b.label[0].context == mx.cpu()
    assert b.label[0].dtype == np.int32  # 64-bit narrowed, as nd.array does


def test_ndarray_iter_dict_input_and_descs():
    x, y, _ = _data()
    kw = dict(batch_size=4, data_name="img", label_name="lab")
    t = mx.io.NDArrayIter({"a": x, "b": x * 2}, {"lab": y}, **kw)
    j = mxj.io.NDArrayIter({"a": x, "b": x * 2}, {"lab": y}, **kw)
    assert [(d.name, d.shape, d.dtype) for d in t.provide_data] == \
        [(d.name, d.shape, d.dtype) for d in j.provide_data]
    assert [tuple(d) for d in t.provide_label] == [tuple(d) for d in j.provide_label]
    _assert_same(_batches(t), _batches(j))


def test_uneven_shards_raise_as_the_reference():
    x, y, _ = _data(n=10)
    with pytest.raises(ValueError, match="allow_pad"):
        mx.io.NDArrayIter(x, y, batch_size=2, num_parts=3)
    with pytest.raises(ValueError, match="part_index"):
        mx.io.NDArrayIter(x, y, batch_size=2, num_parts=2, part_index=2)


@pytest.mark.parametrize("mode", ["pad", "roll_over"])
def test_resume_from_state_dict_matches_jax(mode):
    """Two batches, a snapshot, the rest in a fresh iterator from the
    snapshot: the same sequence as the JAX iterator run straight through."""
    x, y, _ = _data(n=13)
    kw = dict(batch_size=3, shuffle=True, seed=5, last_batch_handle=mode)
    full = _batches(mxj.io.NDArrayIter(x, y, **kw), epochs=2)
    it = mx.io.NDArrayIter(x, y, **kw)
    head = [it.next() for _ in range(2)]
    state = it.state_dict()
    resumed = mx.io.NDArrayIter(x, y, **kw)
    resumed.load_state_dict(state)
    rest = _batches(resumed, epochs=1)
    resumed.reset()
    rest += [([d.asnumpy() for d in b.data], [lab.asnumpy() for lab in b.label], b.pad,
              np.asarray(b.index)) for b in resumed]
    got = [([d.asnumpy() for d in b.data], [lab.asnumpy() for lab in b.label], b.pad,
            np.asarray(b.index)) for b in head] + rest
    _assert_same(got, full)
    assert state["kind"] == "NDArrayIter"


def test_load_state_dict_refuses_another_layout():
    x, y, _ = _data(n=12)
    state = mx.io.NDArrayIter(x, y, batch_size=2, num_parts=2, part_index=0).state_dict()
    with pytest.raises(ValueError, match="sharding layout changed"):
        mx.io.NDArrayIter(x, y, batch_size=2, num_parts=2, part_index=1).load_state_dict(state)
    with pytest.raises(ValueError, match="not an NDArrayIter"):
        mx.io.NDArrayIter(x, y, batch_size=2).load_state_dict({"kind": "DataPipeline"})


@pytest.mark.parametrize("size,reset_internal", [(2, True), (7, True), (7, False)])
def test_resize_iter_matches_jax(size, reset_internal):
    x, y, _ = _data()
    t = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=3), size, reset_internal)
    j = mxj.io.ResizeIter(mxj.io.NDArrayIter(x, y, batch_size=3), size, reset_internal)
    _assert_same(_batches(t, epochs=2), _batches(j, epochs=2))
    assert t.provide_data[0].shape == j.provide_data[0].shape


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.is_alive() and "_worker" in t.name]


def test_prefetching_iter_matches_jax_and_counts():
    x, y, _ = _data(n=11)
    before = profiler.counters()["io_prefetch_batches"]
    with mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=4, shuffle=True, seed=2),
                               depth=2) as t:
        got = _batches(t, epochs=2)
    with mxj.io.PrefetchingIter(mxj.io.NDArrayIter(x, y, batch_size=4, shuffle=True, seed=2),
                                depth=2) as j:
        want = _batches(j, epochs=2)
    _assert_same(got, want)
    assert profiler.counters()["io_prefetch_batches"] - before == 6
    with pytest.raises(RuntimeError, match="closed"):
        t.iter_next()


def test_prefetching_iter_error_surfaces_and_close_joins():
    class Broken(mx.io.DataIter):
        def __init__(self):
            super().__init__(2)
            self.n = 0

        def next(self):
            self.n += 1
            if self.n == 2:
                raise ValueError("bad record")
            return mx.io.DataBatch([mx.nd.array(np.zeros(2), ctx=mx.cpu())])

    it = mx.io.PrefetchingIter(Broken())
    try:
        it.next()
        with pytest.raises(ValueError, match="bad record"):
            it.next()
    finally:
        it.close()
    assert it._thread is None
    gc.collect()


def test_prefetching_iter_depth_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_IO_PREFETCH_DEPTH", "5")
    x, y, _ = _data()
    with mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=4)) as it:
        assert it._depth == 5


def test_csv_iter_matches_jax(tmp_path):
    x, y, _ = _data(n=9)
    np.savetxt(tmp_path / "d.csv", x, delimiter=",")
    np.savetxt(tmp_path / "l.csv", y, delimiter=",")
    for round_batch in (True, False):
        kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(3,),
                  label_csv=str(tmp_path / "l.csv"), batch_size=4, round_batch=round_batch)
        _assert_same(_batches(mx.io.CSVIter(**kw), epochs=2),
                     _batches(mxj.io.CSVIter(**kw), epochs=2))


def test_data_desc_and_batch_contract():
    d = mx.io.DataDesc("data", (4, 3, 8, 8))
    name, shape = d
    assert (name, shape, d[2], d[3]) == ("data", (4, 3, 8, 8), np.float32, "NCHW")
    assert mx.io.DataDesc.get_batch_axis("TNC") == 1 and mx.io.DataDesc.get_batch_axis(None) == 0
    assert repr(d) == repr(mxj.io.DataDesc("data", (4, 3, 8, 8)))
    b = mx.io.DataBatch([mx.nd.array(np.zeros((2, 3)), ctx=mx.cpu())], pad=1)
    assert "pad 1" in repr(b)
    with pytest.raises(NotImplementedError):
        mx.io.DataIter().iter_next()
