"""``mx.mod`` (``Module``, ``BucketingModule``) and ``mx.model.FeedForward``
of the port against the JAX package's, on the CPU.

The cases of ``tests/test_module.py``: both packages' modules start from
the same numpy parameters (``arg_params``/``aux_params``; the two
packages' initializers draw from different generators), see the same
batches (``NDArrayIter`` shuffles from a seeded ``RandomState`` in both)
and take the same steps.  Parameters, moving statistics and optimizer
states agree within ``FP32_TOL`` of the larger of each array's largest
magnitude and 1 after every step of a two-epoch ``fit`` (fp32 through the
same ops in another summation order, compounded over the steps); so do
``score``, ``predict`` (which strips the last batch's pad), a fixed
parameter (which does not move), a checkpoint with optimizer states
written by either package and resumed by the other, the buckets of a
``BucketingModule`` (one set of weights), and ``FeedForward``.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
import incubator_mxnet_tpu.symbol as J
import incubator_mxnet_torch as mx
import incubator_mxnet_torch.symbol as S

FP32_TOL = 1e-4


def _close(a, b, tol=FP32_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(np.abs(b).max(initial=0.0), 1.0)


def _toy(n=120, d=10, k=3, seed=42):
    rng = np.random.RandomState(seed)
    W = rng.randn(k, d)
    X = rng.randn(n, d).astype(np.float32)
    return X, (X @ W.T).argmax(axis=1).astype(np.float32)


def _mlp(S, hidden=16, k=3, bn=True):
    # no bias before the BatchNorm: its exact gradient is zero, so what
    # either package computes for it is rounding noise, which Adam's
    # normalised step would blow up to the learning rate's size
    x = S.FullyConnected(S.var("data"), num_hidden=hidden, name="fc1", no_bias=bn)
    if bn:
        x = S.BatchNorm(x, name="bn1", fix_gamma=False)
    x = S.Activation(x, act_type="relu", name="a1")
    x = S.FullyConnected(x, num_hidden=k, name="fc2")
    return S.SoftmaxOutput(x, S.var("softmax_label"), name="softmax", normalization="batch")


def _params(sym, d=10, seed=0):
    """Seeded numpy ``arg_params`` and ``aux_params`` for ``sym``."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(8, d))
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _same_params(mt, mj):
    (ta, tx), (ja, jx) = mt.get_params(), mj.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ja:
        _close(ta[k].asnumpy(), ja[k].asnumpy())
    for k in jx:
        _close(tx[k].asnumpy(), jx[k].asnumpy())


def _iters(pkg, X, Y, batch_size, **kw):
    return pkg.io.NDArrayIter(X, Y, batch_size=batch_size, **kw)


def _pair_modules(**kw):
    return (mxj.mod.Module(_mlp(J, **kw), context=mxj.cpu()),
            mx.mod.Module(_mlp(S, **kw), context=mx.cpu()))


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.2, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01}),
])
def test_fit_two_epochs_step_by_step(opt, opt_params):
    X, Y = _toy()
    args, aux = _params(_mlp(S))
    snaps = {"jax": [], "port": []}

    def recorder(key, mod):
        def cb(param):
            snaps[key].append(({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                               {k: v.asnumpy() for k, v in mod.get_params()[1].items()},
                               param.eval_metric.get_name_value()))
        return cb

    mj, mt = _pair_modules()
    for key, pkg, mod in (("jax", mxj, mj), ("port", mx, mt)):
        train = _iters(pkg, X[:96], Y[:96], 16, shuffle=True)
        val = _iters(pkg, X[96:], Y[96:], 16)
        mod.fit(train, eval_data=val, eval_metric=["acc", "ce"], optimizer=opt,
                optimizer_params=dict(opt_params), arg_params=args, aux_params=aux,
                num_epoch=2, batch_end_callback=recorder(key, mod))
    assert len(snaps["port"]) == len(snaps["jax"]) == 12
    for (ta, tx, tm), (ja, jx, jm) in zip(snaps["port"], snaps["jax"]):
        for k in ja:
            _close(ta[k], ja[k])
        for k in jx:
            _close(tx[k], jx[k])
        assert [n for n, _ in tm] == [n for n, _ in jm]
        np.testing.assert_allclose([v for _, v in tm], [v for _, v in jm], rtol=1e-4)
    # the optimizer states too
    for name, sj in mj._updater_states.items():
        st = mt._updater_states[name]
        sj, st = (sj, st) if isinstance(sj, tuple) else ((sj,), (st,))
        for a, b in zip(st, sj):
            if b is not None:
                _close(a.detach().numpy(), b.asnumpy())
    for pkg, mod in ((mxj, mj), (mx, mt)):
        mod.score_result = mod.score(_iters(pkg, X[96:], Y[96:], 16), ["acc", "ce"])
    assert [n for n, _ in mt.score_result] == [n for n, _ in mj.score_result]
    np.testing.assert_allclose([v for _, v in mt.score_result],
                               [v for _, v in mj.score_result], rtol=1e-4)


@pytest.mark.parametrize("merge", [True, False])
def test_predict_strips_pad_and_score(merge):
    X, Y = _toy(n=110)
    args, aux = _params(_mlp(S))
    outs = []
    for pkg, mod in zip((mxj, mx), _pair_modules()):
        it = _iters(pkg, X, Y, 50, last_batch_handle="pad")
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.init_params(arg_params=args, aux_params=aux)
        outs.append((mod.predict(it, merge_batches=merge), mod.score(it, "acc")))
    (pj, sj), (pt, st) = outs
    if merge:
        assert pt.shape == pj.shape == (110, 3)
        _close(pt.asnumpy(), pj.asnumpy())
    else:
        assert [o[0].shape for o in pt] == [o[0].shape for o in pj] == [(50, 3), (50, 3),
                                                                         (10, 3)]
        for a, b in zip(pt, pj):
            _close(a[0].asnumpy(), b[0].asnumpy())
    assert st[0][0] == sj[0][0]
    assert abs(st[0][1] - sj[0][1]) < 1e-9


def test_forward_backward_update_and_fixed_params():
    X, Y = _toy(n=100)
    args, aux = _params(_mlp(S))
    mods = []
    for pkg, Spkg in ((mxj, J), (mx, S)):
        it = _iters(pkg, X, Y, 20)
        mod = pkg.mod.Module(_mlp(Spkg), context=pkg.cpu(), fixed_param_names=["fc1_weight"])
        mod.bind(it.provide_data, it.provide_label, for_training=True)
        mod.init_params(arg_params=args, aux_params=aux)
        mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.1})
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        mods.append(mod)
    mj, mt = mods
    np.testing.assert_array_equal(mt.get_params()[0]["fc1_weight"].asnumpy(), args["fc1_weight"])
    assert not np.allclose(mt.get_params()[0]["fc2_weight"].asnumpy(), args["fc2_weight"])
    _same_params(mt, mj)
    _close(mt.get_outputs()[0].asnumpy(), mj.get_outputs()[0].asnumpy())
    assert mt.output_shapes == mj.output_shapes
    assert mt.get_input_grads() == [None]


def test_inputs_need_grad():
    X, Y = _toy(n=16)
    args, aux = _params(_mlp(S))
    grads = []
    for pkg, mod in zip((mxj, mx), _pair_modules()):
        it = _iters(pkg, X, Y, 16)
        mod.bind(it.provide_data, it.provide_label, for_training=True, inputs_need_grad=True)
        mod.init_params(arg_params=args, aux_params=aux)
        mod.forward_backward(next(iter(it)))
        grads.append(mod.get_input_grads()[0].asnumpy())
    _close(grads[1], grads[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_with_optimizer_states_crosses_packages(tmp_path, writer):
    """One package fits two epochs with Adam and saves a checkpoint with
    its optimizer states; the other loads it (``Module.load(...,
    load_optimizer_states=True)``) and continues, step for step as the
    writer continues."""
    X, Y = _toy(n=40)
    args, aux = _params(_mlp(S))
    first, second = ((mxj, J), (mx, S)) if writer == "jax" else ((mx, S), (mxj, J))
    pkg, Spkg = first
    it = _iters(pkg, X, Y, 20)
    mod = pkg.mod.Module(_mlp(Spkg), context=pkg.cpu())
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": 0.01}, num_epoch=2,
            arg_params=args, aux_params=aux)
    prefix = str(tmp_path / "resume")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)

    pkg2 = second[0]
    resumed = pkg2.mod.Module.load(prefix, 2, load_optimizer_states=True, context=pkg2.cpu())
    assert sorted(resumed._preloaded_opt_states) == sorted(mod._param_names)
    counts = dict(mod._optimizer._index_update_count)
    for m, p in ((mod, pkg), (resumed, pkg2)):
        it2 = _iters(p, X, Y, 20)
        if m is resumed:
            m.bind(it2.provide_data, it2.provide_label, for_training=True)
            m.init_params()
            m.init_optimizer(optimizer="adam", optimizer_params={"learning_rate": 0.01})
            # Adam's step count is not in the states file: the resumed
            # optimizer continues from the writer's count, as a resume
            # from epoch 2 of the same run would
            m._optimizer._index_update_count = dict(counts)
            m._optimizer.num_update = max(counts.values())
        for batch in it2:
            m.forward_backward(batch)
            m.update()
    mt, mj = (resumed, mod) if writer == "jax" else (mod, resumed)
    _same_params(mt, mj)


def test_checkpoint_round_trip_scores_the_same(tmp_path):
    X, Y = _toy(n=100)
    args, aux = _params(_mlp(S))
    it = _iters(mx, X, Y, 50)
    mod = mx.mod.Module(_mlp(S), context=mx.cpu())
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": 0.2, "momentum": 0.9},
            num_epoch=2, arg_params=args, aux_params=aux)
    ref = mod.score(it, "acc")[0][1]
    prefix = str(tmp_path / "ckpt")
    mod.save_checkpoint(prefix, 2)
    mod2 = mx.mod.Module.load(prefix, 2, context=mx.cpu())
    mod2.bind(it.provide_data, it.provide_label, for_training=False)
    mod2.init_params()
    assert abs(mod2.score(it, "acc")[0][1] - ref) < 1e-9
    mcb = mx.callback.module_checkpoint(mod, str(tmp_path / "cb"), save_optimizer_states=True)
    mcb(0)
    assert (tmp_path / "cb-0001.states").exists()


def _bucket_sym_gen(S):
    def sym_gen(seq_len):
        x = S.FullyConnected(S.var("data"), num_hidden=8, name="fc1", flatten=True)
        x = S.Activation(x, act_type="relu", name="a")
        x = S.FullyConnected(x, num_hidden=2, name="fc2")
        x = S.SoftmaxOutput(x, S.var("softmax_label"), name="softmax", normalization="batch")
        return x, ("data",), ("softmax_label",)
    return sym_gen


def _bucket_case():
    rng = np.random.RandomState(0)
    data = {16: rng.randn(16, 6).astype(np.float32), 8: rng.randn(8, 6).astype(np.float32)}
    label = {16: rng.randint(0, 2, 16).astype(np.float32),
             8: rng.randint(0, 2, 8).astype(np.float32)}
    args = {"fc1_weight": (rng.randn(8, 6) * 0.3).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": (rng.randn(2, 8) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}
    return data, label, args


def _train_buckets(pkg, Spkg, kvstore="local"):
    """A ``BucketingModule`` of buckets 16 and 8 after the steps 16, 8, 16,
    8 of SGD with momentum."""
    data, label, args = _bucket_case()
    mod = pkg.mod.BucketingModule(_bucket_sym_gen(Spkg), default_bucket_key=16,
                                  context=pkg.cpu())
    desc = pkg.io.DataDesc
    mod.bind([desc("data", (16, 6))], [desc("softmax_label", (16,))])
    mod.init_params(arg_params=args)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    to_nd = (lambda v: mx.nd.array(v, ctx=mx.cpu())) if pkg is mx else mxj.nd.array
    for key in (16, 8, 16, 8):
        batch = pkg.io.DataBatch([to_nd(data[key])], [to_nd(label[key])], bucket_key=key,
                                 provide_data=[desc("data", (key, 6))],
                                 provide_label=[desc("softmax_label", (key,))])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    return mod


def test_buckets_share_weights():
    """Two buckets train one set of weights, as in the JAX package."""
    mj, mt = _train_buckets(mxj, J), _train_buckets(mx, S)
    for name in _bucket_case()[2]:
        assert mt._buckets[8]._exec.arg_dict[name] is mt._buckets[16]._exec.arg_dict[name]
        assert mt._buckets[8]._exec.grad_dict[name] is mt._buckets[16]._exec.grad_dict[name]
    assert mt._buckets[8]._updater_states is mt._buckets[16]._updater_states
    _same_params(mt, mj)


class _CountingDistStore(mx.kvstore.KVStoreDist):
    """A one-worker dist store that counts the pushes of each key."""

    def __init__(self):
        super().__init__("dist_sync")
        self.pushes = {}

    def push(self, key, value, priority=0):
        self.pushes[key] = self.pushes.get(key, 0) + 1
        super().push(key, value, priority)


def test_buckets_share_a_dist_store():
    """With a dist store every bucket's update goes through it (push, then
    pull of the store's updated weight), not only the default bucket's,
    and the weights are those of the JAX package's local-store run."""
    store = _CountingDistStore()
    mt = _train_buckets(mx, S, kvstore=store)
    assert mt._buckets[8]._kv_dist and mt._buckets[8]._kvstore is store
    assert mt._buckets[8]._kv_inited is mt._buckets[16]._kv_inited
    assert store.pushes == {name: 4 for name in _bucket_case()[2]}
    _same_params(mt, _train_buckets(mxj, J))


def test_feedforward(tmp_path):
    """``FeedForward`` fit on arrays (shuffled, padded batches), predict,
    score, save and load; ``create`` fits in one call."""
    rng = np.random.RandomState(0)
    X = rng.rand(70, 4).astype(np.float32)
    y = (X.sum(1) > 2).astype(np.float32)
    args = {"fc_weight": (rng.randn(2, 4) * 0.1).astype(np.float32),
            "fc_bias": np.zeros(2, np.float32)}
    models = []
    for pkg, Spkg in ((mxj, J), (mx, S)):
        net = Spkg.SoftmaxOutput(Spkg.FullyConnected(Spkg.var("data"), num_hidden=2, name="fc"),
                                 Spkg.var("softmax_label"), name="softmax")
        model = pkg.model.FeedForward(net, ctx=pkg.cpu(), num_epoch=3, optimizer="sgd",
                                      learning_rate=0.5, numpy_batch_size=32,
                                      arg_params=dict(args))
        model.fit(X, y)
        models.append(model)
    fj, ft = models
    for k in args:
        _close(ft.arg_params[k].asnumpy(), fj.arg_params[k].asnumpy())
    pt, pj = ft.predict(X), fj.predict(X)
    assert pt.shape == (70, 2)
    _close(pt, pj)
    assert ft.score(X, y) == pytest.approx(fj.score(X, y), abs=1e-9)
    prefix = str(tmp_path / "ff")
    ft.save(prefix, 3)
    loaded = mx.model.FeedForward.load(prefix, 3, ctx=mx.cpu())
    np.testing.assert_allclose(loaded.predict(X), pt, rtol=1e-6)
    net = S.SoftmaxOutput(S.FullyConnected(S.var("data"), num_hidden=2, name="fc"),
                          S.var("softmax_label"), name="softmax")
    created = mx.model.FeedForward.create(net, X, y, ctx=mx.cpu(), num_epoch=1,
                                          learning_rate=0.5, arg_params=dict(args))
    assert created.arg_params is not None


def test_default_context_is_the_card():
    mod = mx.mod.Module(_mlp(S))
    assert mod._context == [mx.gpu(0)]
    assert mx.mod.BucketingModule(_bucket_sym_gen(S), default_bucket_key=4)._gen_module(
        4)._context == [mx.gpu(0)]
