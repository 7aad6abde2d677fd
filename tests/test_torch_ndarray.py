"""The port's NDArray against the JAX package's, on the CPU.

Every method, property and operator of ``ndarray/ndarray.py`` and its
module functions run on the same values in both packages; results must
agree in value (1e-5 relative in fp32, exact where the op only moves or
compares) and in dtype.  Then the autograd surface (``attach_grad`` under
``write`` and ``add``, ``loss.backward()`` on a per-sample loss) against
the JAX package's gradients, and the currency rule: a tensor in gives a
tensor out, an NDArray in an NDArray out, for ``mx.nd`` ops and for
``Block.__call__``.
"""
import operator

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.base import dtype_name
from incubator_mxnet_torch.gluon import nn

REL = 1e-5
R = np.random.RandomState(0)
X = R.uniform(-2, 2, (3, 4)).astype(np.float32)
Y = (R.uniform(0.5, 2, (3, 4)) * R.choice([-1, 1], (3, 4))).astype(np.float32)
P4 = R.uniform(0.5, 2, (3, 4)).astype(np.float32)
M = R.uniform(-1, 1, (4, 2)).astype(np.float32)
IDX = np.array([2, 0], np.int32)


def _name(x):
    dt = x.dtype
    return dt.name if hasattr(dt, "name") else dtype_name(dt)


def _value(x):
    """Comparable form of a result: numpy arrays (with dtype names) for
    NDArrays, recursively for lists, the value itself otherwise."""
    if isinstance(x, (mx.nd.NDArray, mxj.nd.NDArray)):
        a = x.asnumpy()
        return ("nd", _name(x), a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    if isinstance(x, (list, tuple)):
        return [_value(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("np", x.dtype.name, x)
    return x


def _compare(got, ref):
    if isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _compare(g, r)
    elif isinstance(ref, tuple) and ref and ref[0] in ("nd", "np"):
        assert got[0] == ref[0] and got[1] == ref[1], (got[:2], ref[:2])
        assert got[2].shape == ref[2].shape
        np.testing.assert_allclose(got[2].astype(np.float64), ref[2].astype(np.float64),
                                   rtol=REL, atol=REL * max(1.0, float(np.abs(ref[2]).max(
                                       initial=0.0))))
    else:
        assert got == ref, (got, ref)


def both(fn):
    """fn(pkg, nd_array_maker) in each package; the port's on the CPU."""
    with mx.cpu():
        got = _value(fn(mx, mx.nd.array))
    ref = _value(fn(mxj, mxj.nd.array))
    _compare(got, ref)


CASES = {
    # properties
    "shape": lambda pkg, A: A(X).shape,
    "size": lambda pkg, A: A(X).size,
    "ndim": lambda pkg, A: A(X).ndim,
    "dtype": lambda pkg, A: [A(X).dtype.name, A(X, dtype="int32").dtype.name,
                             A(X).astype("float16").dtype.name],
    "stype": lambda pkg, A: A(X).stype,
    "len": lambda pkg, A: len(A(X)),
    "T": lambda pkg, A: A(X).T,
    "context": lambda pkg, A: str(A(X, ctx=pkg.cpu()).context) + str(A(X, ctx=pkg.cpu()).ctx),
    # host transfer
    "asnumpy": lambda pkg, A: A(X).asnumpy(),
    "asscalar": lambda pkg, A: A([2.5]).asscalar(),
    "item": lambda pkg, A: A([[7.0]]).item(),
    "tolist": lambda pkg, A: A(X).tolist(),
    "__array__": lambda pkg, A: np.asarray(A(X)),
    "__array__-dtype": lambda pkg, A: np.asarray(A(X), dtype=np.float64),
    "scalars": lambda pkg, A: [bool(A([0.0])), bool(A([2.0])), float(A([1.5])),
                               int(A([3.7])), [10, 20, 30][A([2], dtype="int32")]],
    # conversion and placement
    "astype": lambda pkg, A: A(X).astype("int32"),
    "astype-nocopy": lambda pkg, A: A(X).astype("float32", copy=False).shape,
    "copyto-ctx": lambda pkg, A: A(X).copyto(pkg.cpu()),
    "copyto-nd": lambda pkg, A: A(X).copyto(pkg.nd.zeros((3, 4), dtype="float16")),
    "copy": lambda pkg, A: A(X).copy(),
    "as_in_context": lambda pkg, A: A(X).as_in_context(pkg.cpu()),
    "detach": lambda pkg, A: A(X).detach(),
    # indexing
    "getitem-int": lambda pkg, A: A(X)[1],
    "getitem-neg": lambda pkg, A: A(X)[-1],
    "getitem-slice": lambda pkg, A: A(X)[1:3],
    "getitem-tuple": lambda pkg, A: A(X)[0, 1:3],
    "getitem-column": lambda pkg, A: A(X)[:, 2],
    "getitem-nd": lambda pkg, A: A(X)[A(IDX)],
    "iter": lambda pkg, A: list(A(X)),
}


def _set(pkg, A, key, value):
    a = A(X)
    a[key] = value(pkg, A) if callable(value) else value
    return a


CASES.update({
    "setitem-all": lambda pkg, A: _set(pkg, A, slice(None), 1.5),
    "setitem-row-nd": lambda pkg, A: _set(pkg, A, 1, lambda pkg, A: A([9.0, 8.0, 7.0, 6.0])),
    "setitem-elem": lambda pkg, A: _set(pkg, A, (0, 2), 7.0),
    "setitem-column": lambda pkg, A: _set(pkg, A, (slice(None), 1), -3.0),
    "setitem-all-nd": lambda pkg, A: _set(pkg, A, slice(None), lambda pkg, A: A(Y)),
})

_BINOPS = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "truediv": operator.truediv, "mod": operator.mod, "pow": operator.pow,
           "eq": operator.eq, "ne": operator.ne, "gt": operator.gt, "ge": operator.ge,
           "lt": operator.lt, "le": operator.le}
for _n, _f in _BINOPS.items():
    lhs = P4 if _n == "pow" else X
    CASES[f"__{_n}__-nd"] = lambda pkg, A, f=_f, lhs=lhs: f(A(lhs), A(Y))
    CASES[f"__{_n}__-scalar"] = lambda pkg, A, f=_f, lhs=lhs: f(A(lhs), 1.5)
    if _n not in ("eq", "ne", "gt", "ge", "lt", "le"):
        CASES[f"__r{_n}__"] = lambda pkg, A, f=_f: f(2.0, A(P4 if f is operator.pow else Y))
CASES.update({
    "__neg__": lambda pkg, A: -A(X),
    "__abs__": lambda pkg, A: abs(A(X)),
    "__matmul__": lambda pkg, A: A(X) @ A(M),
    "__eq__-None": lambda pkg, A: [A(X) == None, A(X) != None],  # noqa: E711
})


def _inplace(pkg, A, op):
    a = A(X)
    b = a
    a = op(a, A(Y))
    a = op(a, 2.0)
    return [a, a is b]


for _n, _f in {"iadd": operator.iadd, "isub": operator.isub, "imul": operator.imul,
               "itruediv": operator.itruediv}.items():
    CASES[f"__{_n}__"] = lambda pkg, A, f=_f: _inplace(pkg, A, f)

P3 = R.uniform(0.5, 2, (1, 2, 3, 4)).astype(np.float32)
CASES.update({
    "reshape": lambda pkg, A: A(X).reshape(4, 3),
    "reshape-tuple": lambda pkg, A: A(X).reshape((2, -1)),
    "reshape-codes": lambda pkg, A: A(P3).reshape((0, -3, -1)),
    "reshape_like": lambda pkg, A: A(X).reshape_like(A(np.zeros((6, 2), np.float32))),
    "flatten": lambda pkg, A: A(P3).flatten(),
    "transpose": lambda pkg, A: A(P3).transpose((2, 0, 3, 1)),
    "transpose-none": lambda pkg, A: A(P3).transpose(),
    "swapaxes": lambda pkg, A: A(P3).swapaxes(1, 3),
    "expand_dims": lambda pkg, A: A(X).expand_dims(1),
    "squeeze": lambda pkg, A: A(P3).squeeze(),
    "broadcast_to": lambda pkg, A: A(X[:1]).broadcast_to((3, 4)),
    "broadcast_like": lambda pkg, A: A(X[:, :1]).broadcast_like(A(X)),
    "tile": lambda pkg, A: A(X).tile((2, 1)),
    "pad": lambda pkg, A: A(P3).pad(mode="constant", pad_width=(0, 0, 0, 0, 1, 1, 2, 0),
                                    constant_value=3.0),
    "round": lambda pkg, A: A(np.array([0.5, -0.5, 1.5, -2.5, 0.49], np.float32)).round(),
    "floor": lambda pkg, A: A(X).floor(),
    "ceil": lambda pkg, A: A(X).ceil(),
    "diag": lambda pkg, A: A(X).diag(1),
    "repeat": lambda pkg, A: A(X).repeat(2, axis=0),
    "flip": lambda pkg, A: A(X).flip(1),
    "split": lambda pkg, A: A(X).split(2, axis=1),
    "slice": lambda pkg, A: A(X).slice((1, 0), (3, 3)),
    "slice_axis": lambda pkg, A: A(X).slice_axis(1, 1, 3),
    "take": lambda pkg, A: A(X).take(A(IDX)),
    "one_hot": lambda pkg, A: A(IDX).one_hot(4),
    "pick": lambda pkg, A: A(X).pick(A([1, 0, 3], dtype="int32")),
    "clip": lambda pkg, A: A(X).clip(-1.0, 1.0),
    "abs": lambda pkg, A: A(X).abs(),
    "sign": lambda pkg, A: A(X).sign(),
    "sqrt": lambda pkg, A: A(P4).sqrt(),
    "square": lambda pkg, A: A(X).square(),
    "exp": lambda pkg, A: A(X).exp(),
    "log": lambda pkg, A: A(P4).log(),
    "relu": lambda pkg, A: A(X).relu(),
    "sigmoid": lambda pkg, A: A(X).sigmoid(),
    "tanh": lambda pkg, A: A(X).tanh(),
    "softmax": lambda pkg, A: A(X).softmax(temperature=2.0),
    "log_softmax": lambda pkg, A: A(X).log_softmax(axis=0),
    "dot": lambda pkg, A: A(X).dot(A(M)),
    "dot-transpose": lambda pkg, A: A(X).dot(A(Y), transpose_b=True),
    "zeros_like": lambda pkg, A: A(X).zeros_like(),
    "ones_like": lambda pkg, A: A(X).ones_like(),
    "as_np_ndarray": lambda pkg, A: A(X).as_np_ndarray(),
    "as_nd_ndarray": lambda pkg, A: A(X).as_nd_ndarray(),
    "tostype": lambda pkg, A: A(X).tostype("default"),
    "sum": lambda pkg, A: A(X).sum(axis=1),
    "mean": lambda pkg, A: A(X).mean(),
    "prod": lambda pkg, A: A(P4).prod(axis=0, keepdims=True),
    "max": lambda pkg, A: A(X).max(axis=1),
    "min": lambda pkg, A: A(X).min(),
    "argmax": lambda pkg, A: A(X).argmax(axis=1),
    "argmin": lambda pkg, A: A(X).argmin(axis=0),
    "norm": lambda pkg, A: A(X).norm(),
    "topk": lambda pkg, A: A(X).topk(k=2, ret_typ="both"),
    "sort": lambda pkg, A: A(X).sort(is_ascend=False),
    "argsort": lambda pkg, A: A(X).argsort(axis=0),
    # module functions
    "array-list": lambda pkg, A: pkg.nd.array([[1, 2], [3, 4]]),
    "array-f64": lambda pkg, A: pkg.nd.array(np.ones((2, 2), np.float64)),
    "array-i64": lambda pkg, A: pkg.nd.array(np.arange(4, dtype=np.int64)),
    "array-nd": lambda pkg, A: pkg.nd.array(A(X), dtype="float16"),
    "zeros": lambda pkg, A: pkg.nd.zeros((2, 3), dtype="int32"),
    "ones": lambda pkg, A: pkg.nd.ones(4),
    "full": lambda pkg, A: pkg.nd.full((2, 2), 7.5),
    "empty": lambda pkg, A: pkg.nd.empty((2, 3)).shape,
    "arange": lambda pkg, A: pkg.nd.arange(1, 7, 2, repeat=2),
    "arange-stop": lambda pkg, A: pkg.nd.arange(5, dtype="int32"),
    "waitall": lambda pkg, A: [pkg.nd.waitall(), A(X).wait_to_read().shape,
                               A(X).wait_to_write().shape],
})


@pytest.mark.parametrize("name", sorted(CASES))
def test_ndarray_surface_matches_jax(name):
    both(CASES[name])


def test_every_public_method_is_ported():
    want = {n for n in dir(mxj.nd.NDArray) if not n.startswith("_")}
    have = {n for n in dir(mx.nd.NDArray) if not n.startswith("_")}
    assert want <= have, sorted(want - have)
    assert {"__getitem__", "__setitem__", "__iadd__", "__matmul__", "__array__"} <= set(
        dir(mx.nd.NDArray))


def test_invoke_wraps_a_tensor_function():
    with mx.cpu():
        a = mx.nd.array(X)
        out = mx.nd.invoke(lambda t, s: t * s, (a, 3.0), {})
        parts = mx.nd.invoke(lambda t: (t[0], t[1]), (a,), {})
    np.testing.assert_array_equal(out.asnumpy(), X * 3.0)
    assert isinstance(parts, list) and all(isinstance(p, mx.nd.NDArray) for p in parts)


def test_bf16_dtype_and_asnumpy():
    with mx.cpu():
        a = mx.nd.array(X, dtype="bfloat16")
    assert a.dtype == "bfloat16" and a.dtype.name == "bfloat16" and a.dtype.itemsize == 2
    assert dtype_name(a.dtype) == "bfloat16" and a.astype(a.dtype).dtype == "bfloat16"
    host = a.asnumpy()
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host, torch.from_numpy(X).bfloat16().float().numpy())


def test_asnumpy_is_a_copy():
    with mx.cpu():
        a = mx.nd.array(X)
    host = a.asnumpy()
    host[:] = 0
    assert a.asnumpy().any()


# -- autograd -----------------------------------------------------------------------


def _two_backwards(pkg, req):
    x = pkg.nd.array(X)
    x.attach_grad(grad_req=req)
    for scale in (1.0, 2.0):
        with pkg.autograd.record():
            y = (x * x * scale).sum()
        y.backward()
    return x.grad.asnumpy()


@pytest.mark.parametrize("req", ["write", "add"])
def test_attach_grad_write_and_add(req):
    with mx.cpu():
        got = _two_backwards(mx, req)
    ref = _two_backwards(mxj, req)
    np.testing.assert_allclose(got, ref, rtol=REL)
    want = 2 * X * (2.0 if req == "write" else 3.0)
    np.testing.assert_allclose(got, want, rtol=REL)


def _per_sample(pkg, out_grad):
    w = pkg.nd.array(M)
    w.attach_grad()
    x = pkg.nd.array(X)
    with pkg.autograd.record():
        loss = (pkg.nd.dot(x, w) ** 2).mean(axis=1)  # one loss per sample
    assert loss.shape == (3,)
    loss.backward(None if out_grad is None else pkg.nd.array(out_grad))
    g = w.grad.asnumpy()
    w.zero_grad()
    return g, w.grad.asnumpy()


@pytest.mark.parametrize("seeded", [False, True], ids=["ones", "out_grad"])
def test_per_sample_loss_backward_matches_jax(seeded):
    """``loss.backward()`` on a per-sample vector seeds with ones, as MXNet
    does (PyTorch's ``Tensor.backward`` would refuse a non-scalar)."""
    head = np.array([0.5, -1.0, 2.0], np.float32) if seeded else None
    with mx.cpu():
        got, zeroed = _per_sample(mx, head)
    ref, _ = _per_sample(mxj, head)
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL)
    assert not zeroed.any()


def test_leaf_stays_a_leaf_across_an_inplace_update():
    """The reference's manual SGD idiom: ``w -= lr * w.grad`` outside
    ``record()``, then another recorded step."""
    with mx.cpu():
        w = mx.nd.array(M)
        w.attach_grad()
        grads = []
        for _ in range(2):
            with mx.autograd.record():
                loss = (w * w).sum()
            loss.backward()
            grads.append(w.grad.asnumpy().copy())
            w -= 0.1 * w.grad
    np.testing.assert_allclose(grads[1], 0.8 * grads[0], rtol=REL)


def test_ops_outside_record_build_no_graph():
    with mx.cpu():
        w = mx.nd.array(M)
        w.attach_grad()
        y = w * 2
        assert not y._data.requires_grad
        with mx.autograd.record():
            z = w * 2
        assert z._data.requires_grad
        assert not mx.nd.argmax(z, axis=1)._data.requires_grad


# -- the currency rule --------------------------------------------------------------


def test_tensors_in_give_tensors_out():
    t = torch.from_numpy(X)
    out = mx.nd.relu(t)
    assert type(out) is torch.Tensor and torch.equal(out, torch.relu(t))
    parts = mx.nd.split(t, num_outputs=2, axis=1)
    assert isinstance(parts, tuple) and all(type(p) is torch.Tensor for p in parts)
    with mx.cpu():
        nd_parts = mx.nd.split(mx.nd.array(X), num_outputs=2, axis=1)
        mixed = mx.nd.broadcast_add(mx.nd.array(X), t)
    assert isinstance(nd_parts, list) and all(isinstance(p, mx.nd.NDArray) for p in nd_parts)
    assert isinstance(mixed, mx.nd.NDArray)


def test_out_argument():
    with mx.cpu():
        out = mx.nd.zeros((3, 4))
        got = mx.nd.exp(mx.nd.array(X), out=out)
    assert got is out
    np.testing.assert_allclose(out.asnumpy(), np.exp(X), rtol=REL)
    t_out = torch.zeros(3, 4)
    assert mx.nd.exp(torch.from_numpy(X), out=t_out) is t_out
    np.testing.assert_allclose(t_out.numpy(), np.exp(X), rtol=REL)


def test_raw_ops_take_ndarray_lists():
    with mx.cpu():
        ws = [mx.nd.array(X), mx.nd.array(Y)]
        gs = [mx.nd.ones((3, 4)), mx.nd.ones((3, 4))]
        out = mx.nd.multi_sgd_update(ws, gs, [0.5, 0.25], [0.0, 0.0])
    assert isinstance(out, list) and all(isinstance(o, mx.nd.NDArray) for o in out)
    np.testing.assert_allclose(ws[0].asnumpy(), X - 0.5, rtol=REL)
    np.testing.assert_allclose(out[1].asnumpy(), Y - 0.25, rtol=REL)


def test_torch_functions_take_ndarrays():
    with mx.cpu():
        a, b = mx.nd.array(X), mx.nd.array(X)
    assert torch.equal(a, b)
    s = torch.stack([a, b])
    assert isinstance(s, mx.nd.NDArray) and s.shape == (2, 3, 4)


def test_amp_casts_apply_to_ndarrays():
    mx.amp.init("bfloat16")
    try:
        with mx.cpu():
            out = mx.nd.FullyConnected(mx.nd.array(X), mx.nd.array(M.T), None, num_hidden=2,
                                       no_bias=True)
    finally:
        mx.amp.disable()
    assert out.dtype == "bfloat16"


def test_contrib_namespace():
    assert mx.nd.contrib.boolean_mask is mx.nd._contrib_boolean_mask
    # the control-flow ops are ported (tests/test_torch_control_flow.py):
    # foreach over NDArrays equals the JAX package's
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    h = np.ones(4, np.float32)

    def run(pkg):
        body = lambda xt, s: (xt * s, s + xt)  # noqa: E731
        return pkg.nd.contrib.foreach(body, pkg.nd.array(x, ctx=pkg.cpu()),
                                      pkg.nd.array(h, ctx=pkg.cpu()))

    with mx.cpu():
        got = run(mx)
    want = run(mxj)
    for g, w in zip(got, want):
        assert isinstance(g, mx.nd.NDArray)
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(AttributeError):
        mx.nd.contrib.no_such_op


def _dense_net():
    mx.random.seed(1)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(5, in_units=4, activation="relu"), nn.Dense(2, in_units=5))
    net.initialize(ctx=mx.cpu())
    return net


def test_block_call_follows_the_currency_rule():
    net = _dense_net()
    t = torch.from_numpy(X)
    want = net(t)
    assert type(want) is torch.Tensor
    with mx.cpu():
        got = net(mx.nd.array(X))
    assert isinstance(got, mx.nd.NDArray) and got.context == mx.cpu()
    np.testing.assert_array_equal(got.asnumpy(), want.detach().numpy())
    loss = mx.gluon.loss.L2Loss()
    with mx.cpu():
        label = mx.nd.zeros((3, 2))
        with mx.autograd.record():
            out = loss(net(mx.nd.array(X)), label)
        out.backward()
    assert isinstance(out, mx.nd.NDArray) and out.shape == (3,)
    assert net[0].weight.grad().abs().sum().item() > 0


def test_block_returns_nested_outputs_as_ndarrays():
    from incubator_mxnet_torch.gluon.model_zoo import bert

    net = bert.BERTForPretrain(bert.BERTModel(vocab_size=32, units=16, hidden_size=32,
                                              num_layers=1, num_heads=2, max_length=16,
                                              dropout=0.0), vocab_size=32)
    net.initialize(ctx=mx.cpu())
    ids = np.random.RandomState(2).randint(0, 32, (2, 8)).astype(np.int32)
    pos = np.array([[1, 2], [3, 4]], np.int32)
    want = net(torch.from_numpy(ids), None, torch.from_numpy(pos))
    with mx.cpu():
        got = net(mx.nd.array(ids, dtype="int32"), None, mx.nd.array(pos, dtype="int32"))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert isinstance(g, mx.nd.NDArray)
        np.testing.assert_array_equal(g.asnumpy(), w.numpy())


def test_custom_op_follows_the_currency_rule():
    @mx.operator.register("nd_surface_double")
    class DoubleProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Double()

    class Double(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    with mx.cpu():
        out = mx.nd.Custom(mx.nd.array(X), op_type="nd_surface_double")
    assert isinstance(out, mx.nd.NDArray)
    np.testing.assert_array_equal(out.asnumpy(), X * 2)
    t = mx.nd.Custom(torch.from_numpy(X), op_type="nd_surface_double")
    assert type(t) is torch.Tensor
