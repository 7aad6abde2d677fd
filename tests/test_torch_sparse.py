"""Row-sparse and CSR storage, and the lazy updates, in the port against
the JAX package, on the CPU.

* ``mx.nd.sparse``: ``row_sparse_array`` and ``csr_matrix`` from their
  parts and from dense arrays, ``zeros``/``empty``/``array``, ``tostype``
  and ``nd.cast_storage`` both ways, ``add`` and ``retain``: values,
  indices and indptr exactly equal; ``dot`` (csr · dense, csrᵀ · dense,
  and ``transpose_b``; a row_sparse operand densified) within 1e-5 (sums in
  another order).
* example/sparse_linear_classification.py's model at 10,000 features
  (``Embedding(num_features, 1, sparse_grad=True)`` summed over 32 ids,
  ``SigmoidBinaryCrossEntropyLoss``), three steps of SGD with momentum (lr
  0.5, momentum 0.9) and of Adam from the same weights: weights and
  optimizer states within 1e-6 of the JAX package's, every row no id of
  the batch touched bit-unchanged in weight and state.
* A fused Trainer leaves the lazy parameter out of its group (it takes the
  per-tensor lazy update), and ``Trainer.fold_step`` refuses the trainer
  with the JAX package's message.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.optimizer import fused as tfused

TOL = dict(rtol=1e-5, atol=1e-5)
_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "example", "sparse_linear_classification.py")


def _synthetic(*args, **kw):
    spec = importlib.util.spec_from_file_location("sparse_example", _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synthetic_sparse(*args, **kw)


def _dense(seed, shape=(6, 5), density=0.3):
    r = np.random.RandomState(seed)
    return (r.randn(*shape) * (r.rand(*shape) < density)).astype(np.float32)


def _same(t, j):
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_row_sparse_constructors():
    d = _dense(0)
    d[2] = 0.0
    t = mx.nd.sparse.row_sparse_array(d, ctx=mx.cpu())
    j = mxj.nd.sparse.row_sparse_array(d)
    _same(t, j)
    _same(t.indices, j.indices)
    _same(t.data, j.data)
    assert t.stype == "row_sparse" and t.shape == (6, 5)
    parts = (np.ones((2, 5), np.float32), np.array([4, 1], np.int32))
    _same(mx.nd.sparse.row_sparse_array(parts, shape=(6, 5), ctx=mx.cpu()),
          mxj.nd.sparse.row_sparse_array(parts, shape=(6, 5)))
    z = mx.nd.sparse.zeros("row_sparse", (4, 3), ctx=mx.cpu())
    assert z.asnumpy().shape == (4, 3) and not z.asnumpy().any()
    assert mx.nd.sparse.empty("csr", (2, 3), ctx=mx.cpu()).indptr.shape == (3,)
    _same(mx.nd.sparse.array(t), t)


def test_csr_constructors_and_rows():
    d = _dense(1)
    t = mx.nd.sparse.csr_matrix(d, ctx=mx.cpu())
    j = mxj.nd.sparse.csr_matrix(d)
    for a, b in ((t, j), (t.indices, j.indices), (t.indptr, j.indptr), (t.data, j.data)):
        _same(a, b)
    parts = (np.array([1.0, 2.0, 3.0], np.float32), np.array([0, 4, 2], np.int32),
             np.array([0, 2, 2, 3], np.int32))
    _same(mx.nd.sparse.csr_matrix(parts, shape=(3, 5), ctx=mx.cpu()),
          mxj.nd.sparse.csr_matrix(parts, shape=(3, 5)))
    for i in range(6):
        _same(t[i], j[i])


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_cast_storage_and_tostype(stype):
    d = _dense(2)
    t = mx.nd.cast_storage(mx.nd.array(d, ctx=mx.cpu()), stype)
    j = mxj.nd.cast_storage(mxj.nd.array(d), stype)
    assert t.stype == j.stype == stype
    _same(t, j)
    back = mx.nd.cast_storage(t, "default")
    assert back.stype == "default"
    np.testing.assert_array_equal(back.asnumpy(), d)
    assert mx.nd.array(d, ctx=mx.cpu()).tostype(stype).stype == stype
    if stype != "default":
        assert t.tostype("default").stype == "default"
        other = "csr" if stype == "row_sparse" else "row_sparse"
        _same(t.tostype(other), j.tostype(other))


@pytest.mark.parametrize("transpose_a,transpose_b", [(False, False), (True, False),
                                                     (False, True)])
def test_csr_dot(transpose_a, transpose_b):
    d = _dense(3, (7, 9))
    r = np.random.RandomState(4)
    rhs = r.randn(*((9, 4) if not transpose_a else (7, 4))).astype(np.float32)
    if transpose_b:
        rhs = np.ascontiguousarray(rhs.T)
    t = mx.nd.sparse.dot(mx.nd.sparse.csr_matrix(d, ctx=mx.cpu()), mx.nd.array(rhs, ctx=mx.cpu()),
                         transpose_a=transpose_a, transpose_b=transpose_b)
    j = mxj.nd.sparse.dot(mxj.nd.sparse.csr_matrix(d), mxj.nd.array(rhs),
                          transpose_a=transpose_a, transpose_b=transpose_b)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    np.testing.assert_allclose(t.asnumpy(), (d.T if transpose_a else d)
                               @ (rhs.T if transpose_b else rhs), **TOL)


def test_row_sparse_dot_add_and_retain():
    a, b = _dense(5), _dense(6)
    ta = mx.nd.sparse.row_sparse_array(a, ctx=mx.cpu())
    tb = mx.nd.sparse.row_sparse_array(b, ctx=mx.cpu())
    ja, jb = mxj.nd.sparse.row_sparse_array(a), mxj.nd.sparse.row_sparse_array(b)
    s, js = mx.nd.sparse.add(ta, tb), mxj.nd.sparse.add(ja, jb)
    assert s.stype == "row_sparse"
    _same(s, js)
    _same(s.indices, js.indices)
    _same(ta + tb, ja + jb)
    keep = np.array([0, 3, 5], np.int32)
    rt, rj = ta.retain(keep), ja.retain(keep)
    _same(rt, rj)
    _same(rt.indices, rj.indices)
    rhs = np.random.RandomState(7).randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(mx.nd.sparse.dot(ta, mx.nd.array(rhs, ctx=mx.cpu())).asnumpy(),
                               mxj.nd.sparse.dot(ja, mxj.nd.array(rhs)).asnumpy(), **TOL)


def test_conversions_stay_where_their_source_lies():
    """A dense source's sparse forms, and their conversions, stay on its
    device and round-trip bit-equal; parts and numpy sources without a ctx
    go to the current context (``gpu(0)`` unless the caller asks for the
    CPU); ``retain`` takes tensor indices on the stored rows' device."""
    d = _dense(8, (7, 6))
    d[3] = 0.0
    src = mx.nd.array(d, ctx=mx.cpu())
    for stype, other in (("row_sparse", "csr"), ("csr", "row_sparse")):
        sp = mx.nd.cast_storage(src, stype)
        conv = sp.tostype(other)
        for arr in (sp, conv, src.tostype(stype)):
            assert arr.context == mx.cpu()
            assert {t._data.device.type for t in (arr.data, arr.indices)} == {"cpu"}
            np.testing.assert_array_equal(arr.tostype("default").asnumpy(), d)
    with mx.cpu():
        assert mx.nd.sparse.csr_matrix(d).context == mx.cpu()
        parts = (np.ones((2, 6), np.float32), np.array([4, 1], np.int32))
        assert mx.nd.sparse.row_sparse_array(parts, shape=(7, 6)).context == mx.cpu()
    assert mx.nd.sparse.row_sparse_array(torch.from_numpy(d)).context == mx.cpu()
    if not torch.cuda.is_available():
        with pytest.raises(mx.base.MXNetError, match=r"gpu\(0\) requested"):
            mx.nd.sparse.csr_matrix(d)
    rs = mx.nd.sparse.row_sparse_array(src)
    kept = rs.retain(torch.tensor([1, 2, 3, 5]))
    rows = [r for r in (1, 2, 3, 5) if d[r].any()]
    assert len(rows) == 3  # row 3 is zero, so not stored
    np.testing.assert_array_equal(kept.indices.asnumpy(), rows)
    np.testing.assert_array_equal(kept.data.asnumpy(), d[rows])


FEATURES, NNZ, BATCH = 10_000, 32, 128
OPTS = {"sgd": ("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
        "adam": ("adam", {"learning_rate": 0.05, "wd": 1e-3})}


def _model(pkg, weight, opt):
    embed = pkg.gluon.nn.Embedding(FEATURES, 1, sparse_grad=True)
    embed.initialize(ctx=pkg.cpu())
    embed.weight.set_data(pkg.nd.array(weight, ctx=pkg.cpu()))
    name, kw = OPTS[opt]
    return embed, pkg.gluon.Trainer(embed.collect_params(), name, dict(kw))


def _step(pkg, embed, trainer, xb, yb):
    x, y = pkg.nd.array(xb, ctx=pkg.cpu()), pkg.nd.array(yb, ctx=pkg.cpu())
    loss_fn = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    with pkg.autograd.record():
        logits = pkg.nd.sum(embed(x).reshape((xb.shape[0], -1)), axis=1)
        loss = loss_fn(logits, y)
    loss.backward()
    trainer.step(xb.shape[0])
    return loss.asnumpy()


def _states(trainer, pkg):
    st = trainer._states[0]
    st = st if isinstance(st, (list, tuple)) else [st]
    return [s.detach().numpy().copy() if isinstance(s, torch.Tensor) else s.asnumpy().copy()
            for s in st]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_sparse_example_steps_match_the_jax_package(opt):
    X, y = _synthetic(3 * BATCH, FEATURES, NNZ)
    w0 = np.random.RandomState(9).uniform(-0.07, 0.07, (FEATURES, 1)).astype(np.float32)
    tm, ttr = _model(mx, w0, opt)
    jm, jtr = _model(mxj, w0, opt)
    before_w = w0.copy()
    before_s = None
    for k in range(3):
        xb, yb = X[k * BATCH:(k + 1) * BATCH], y[k * BATCH:(k + 1) * BATCH]
        tl, jl = _step(mx, tm, ttr, xb, yb), _step(mxj, jm, jtr, xb, yb)
        np.testing.assert_allclose(tl, jl, **TOL)
        tw, jw = tm.weight.data().detach().numpy().copy(), jm.weight.data().asnumpy()
        np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-6)
        ts, js = _states(ttr, mx), _states(jtr, mxj)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        untouched = np.ones(FEATURES, bool)
        untouched[np.unique(xb.astype(np.int64))] = False
        assert untouched.sum() > FEATURES // 2
        np.testing.assert_array_equal(tw[untouched], before_w[untouched])
        if before_s is not None:
            for a, b in zip(ts, before_s):
                np.testing.assert_array_equal(a[untouched], b[untouched])
        before_w, before_s = tw.copy(), ts


def _mixed_net():
    mx.random.seed(1)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Embedding(50, 4, sparse_grad=True), mx.gluon.nn.Dense(1, flatten=True))
    net.initialize(ctx=mx.cpu())
    x = torch.randint(0, 50, (6, 3)).float()
    net(x)
    return net, x, torch.rand(6, 1)


def test_fused_trainer_leaves_the_lazy_parameter_out():
    net, x, y = _mixed_net()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    emb = net[0].weight
    assert emb.stype == "row_sparse" and tr._optimizer._lazy_for(0)
    groups, rest = tfused.plan_groups(
        tr._optimizer, [(i, p.data(), None) for i, p in enumerate(tr._params)],
        {i: tr._optimizer.create_state_multi_precision(i, p.data())
         for i, p in enumerate(tr._params)})
    assert [i for i, _, _ in rest] == [0]
    assert sorted(i for members in groups.values() for i, *_ in members) == [1, 2]
    before = (tfused.fused_update.params, tfused.fused_update.fallback_params)
    w0 = emb.data().clone()
    with mx.autograd.record():
        loss = mx.gluon.loss.L2Loss()(net(x), y)
    mx.autograd.backward(loss)
    tr.step(6)
    assert (tfused.fused_update.params - before[0],
            tfused.fused_update.fallback_params - before[1]) == (2, 1)
    touched = torch.zeros(50, dtype=torch.bool)
    touched[x.long().unique()] = True
    assert torch.equal(emb.data()[~touched], w0[~touched])
    assert not torch.equal(emb.data()[touched], w0[touched])


def test_fold_refuses_the_lazy_parameter_with_the_jax_message():
    net, x, y = _mixed_net()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    prog = tr.fold_step(lambda a, b: mx.gluon.loss.L2Loss()(net(a), b), block=net)
    prog(x, y)
    assert not prog.folded
    assert "(lazy/sparse or unsupported)" in prog.fallback_reason
    assert prog.fallback_reason.startswith("no fused kernels for SGD on")
    mx.profiler.disarm_compile_guard()
