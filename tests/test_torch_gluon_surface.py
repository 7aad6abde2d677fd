"""The port's Gluon surface added with the rest of the training slice,
against the JAX package on the CPU: the losses, the initializers (in
distribution where the two packages' generators differ), the layers,
Block hooks, ``apply``, ``summary``, ``infer_shape`` and ``optimize_for``,
the module-level ``name_scope``, the Parameter and ParameterDict methods,
``Trainer.close`` and the context functions."""
import io
import contextlib
import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon.block import name_scope

FP32_TOL = dict(rtol=1e-5, atol=1e-6)

LOSSES = {
    "L1Loss": ((), 2, {}),
    "SigmoidBinaryCrossEntropyLoss": ((), 2, {}),
    "SigmoidBCELoss_from_sigmoid": (("SigmoidBCELoss",), 2, {"from_sigmoid": True}),
    "KLDivLoss": ((), 2, {"from_logits": False}),
    "HuberLoss": ((), 2, {"rho": 0.5}),
    "HingeLoss": ((), 2, {}),
    "SquaredHingeLoss": ((), 2, {}),
    "LogisticLoss": ((), 2, {}),
    "LogisticLoss_binary": (("LogisticLoss",), 2, {"label_format": "binary"}),
    "TripletLoss": ((), 3, {}),
    "SDMLLoss": ((), 2, {}),
    "PoissonNLLLoss": ((), 2, {}),
    "PoissonNLLLoss_full": (("PoissonNLLLoss",), 2, {"compute_full": True}),
    "CosineEmbeddingLoss": ((), 2, {"margin": 0.2}),
}


def _loss_inputs(name, n, rng):
    xs = [rng.randn(4, 6).astype(np.float32) for _ in range(n)]
    if "from_sigmoid" in name:
        xs[0] = 1 / (1 + np.exp(-xs[0]))
    if name.startswith(("SigmoidBinary", "SigmoidBCE", "LogisticLoss_binary")):
        xs[1] = (xs[1] > 0).astype(np.float32)
    if name.startswith("KLDiv"):
        xs[1] = np.exp(xs[1]) / np.exp(xs[1]).sum(-1, keepdims=True)
    if name.startswith(("Hinge", "SquaredHinge", "LogisticLoss")) and "binary" not in name:
        xs[1] = np.sign(xs[1])
    if name.startswith("PoissonNLL"):
        xs[1] = np.abs(xs[1]) * 3
    if name == "CosineEmbeddingLoss":
        xs.append(np.array([1, -1, 1, -1], np.float32))
    return xs


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "sample_weight"])
@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(name, weighted):
    alias, n, kw = LOSSES[name]
    cls = alias[0] if alias else name
    rng = np.random.RandomState(len(name))
    xs = _loss_inputs(name, n, rng)
    extra = []
    if weighted and name not in ("SDMLLoss", "PoissonNLLLoss", "PoissonNLLLoss_full"):
        extra = [np.abs(rng.randn(4, 1)).astype(np.float32)]
        if name in ("TripletLoss", "CosineEmbeddingLoss"):
            extra = [extra[0][:, 0]]
    t = getattr(mx.gluon.loss, cls)(**kw)(*(torch.from_numpy(x) for x in xs + extra))
    j = getattr(mxj.gluon.loss, cls)(**kw)(*(mxj.nd.array(x) for x in xs + extra))
    np.testing.assert_allclose(t.numpy(), j.asnumpy(), **FP32_TOL)


def test_ctc_loss_waits_for_its_op():
    """Ported with the CTC op (the name kept from when it raised): the loss
    of both layouts equals the JAX package's (tests/test_torch_ctc.py holds
    the lengths, weights and gradients)."""
    rng = np.random.RandomState(5)
    pred = rng.randn(3, 6, 5).astype(np.float32)
    label = np.array([[1, 2, 0], [3, 4, 4], [2, 0, 0]], np.float32)
    for layout, x in (("NTC", pred), ("TNC", np.ascontiguousarray(pred.transpose(1, 0, 2)))):
        t = mx.gluon.loss.CTCLoss(layout=layout)(torch.from_numpy(x), torch.from_numpy(label))
        j = mxj.gluon.loss.CTCLoss(layout=layout)(mxj.nd.array(x), mxj.nd.array(label))
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), **FP32_TOL)


# -- initializers ------------------------------------------------------------------------


def _jax_init(init, name, shape):
    arr = mxj.nd.zeros(shape)
    init(mxj.init.InitDesc(name), arr)
    return arr.asnumpy()


def _port_init(init, name, shape):
    arr = torch.zeros(shape)
    init(mx.init.InitDesc(name), arr)
    return arr.numpy()


@pytest.mark.parametrize("case", ["bilinear", "lstmbias", "load", "mixed"])
def test_deterministic_initializers_match_jax(case):
    if case == "bilinear":
        args = ("Bilinear", (), "up_weight", (2, 3, 4, 4))
    elif case == "lstmbias":
        args = ("LSTMBias", (0.5,), "lstm_i2h_bias", (16,))
    if case in ("bilinear", "lstmbias"):
        cls, a, name, shape = args
        np.testing.assert_array_equal(_port_init(getattr(mx.init, cls)(*a), name, shape),
                                      _jax_init(getattr(mxj.init, cls)(*a), name, shape))
        return
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    if case == "load":
        t = mx.init.Load({"arg:w": src}, default_init=mx.init.One())
        j = mxj.init.Load({"arg:w": mxj.nd.array(src)}, default_init=mxj.init.One())
        for name in ("w", "other_bias"):
            np.testing.assert_array_equal(_port_init(t, name, (2, 3)), _jax_init(j, name, (2, 3)))
        with pytest.raises(ValueError):
            mx.init.Load({})("w", torch.zeros(2))
        return
    t = mx.init.Mixed([".*bias", ".*"], [mx.init.Constant(0.5), mx.init.One()])
    j = mxj.init.Mixed([".*bias", ".*"], [mxj.init.Constant(0.5), mxj.init.One()])
    for name in ("fc_bias", "fc_weight"):
        np.testing.assert_array_equal(_port_init(t, name, (3,)), _jax_init(j, name, (3,)))


def test_initializer_dumps_and_init_attribute_match_jax():
    for cls, kw in (("Uniform", {"scale": 0.2}), ("Xavier", {"magnitude": 2}),
                    ("MSRAPrelu", {"slope": 0.1}), ("Orthogonal", {"scale": 1.1}),
                    ("Constant", {"value": 3.0}), ("LSTMBias", {"forget_bias": 2.0})):
        assert getattr(mx.init, cls)(**kw).dumps() == getattr(mxj.init, cls)(**kw).dumps()
    desc = mx.init.InitDesc("odd_name", attrs={"__init__": mx.init.Constant(2.0).dumps()})
    arr = torch.zeros(3)
    mx.init.Uniform()(desc, arr)
    assert arr.tolist() == [2.0, 2.0, 2.0]


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthogonal(rand_type):
    """The generators differ, so the draw is held to what it must be: the
    JAX rule's factor of an SVD, scaled; the same seed, the same weight."""
    for shape in ((6, 4), (4, 6), (3, 2, 2)):
        w = []
        for _ in range(2):
            mx.random.seed(7)
            arr = torch.zeros(shape)
            mx.init.Orthogonal(scale=1.5, rand_type=rand_type)("w_weight", arr)
            w.append(arr)
        assert torch.equal(w[0], w[1])
        m = w[0].reshape(shape[0], -1).double()
        small = m.t() @ m if m.shape[0] >= m.shape[1] else m @ m.t()
        torch.testing.assert_close(small, 2.25 * torch.eye(small.shape[0], dtype=torch.double),
                                   rtol=0, atol=1e-5)


def test_msraprelu_in_distribution():
    mx.random.seed(8)
    arr = torch.zeros(256, 128, 3, 3)
    mx.init.MSRAPrelu(factor_type="in", slope=0.0)("c_weight", arr)
    want = np.sqrt(2.0 / (128 * 9))
    assert abs(arr.std().item() / want - 1) < 0.01 and abs(arr.mean().item()) < 1e-3


# -- layers --------------------------------------------------------------------------------


@pytest.mark.parametrize("layer", ["GroupNorm", "InstanceNorm"])
def test_norm_layers_match_jax(layer):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 4, 3, 5).astype(np.float32)
    gamma, beta = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    kw = {"num_groups": 2} if layer == "GroupNorm" else {"scale": True}
    t, j = getattr(mx.gluon.nn, layer)(**kw), getattr(mxj.gluon.nn, layer)(**kw)
    t.initialize(ctx=mx.cpu())
    j.initialize()
    t(torch.from_numpy(x))
    j(mxj.nd.array(x))
    for blk, arr in ((t, lambda a: torch.from_numpy(a)), (j, mxj.nd.array)):
        blk.gamma.set_data(arr(gamma))
        blk.beta.set_data(arr(beta))
    np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(), j(mxj.nd.array(x)).asnumpy(),
                               **FP32_TOL)


def test_identity_lambda_concatenate_match_jax():
    x = np.random.RandomState(10).randn(2, 3).astype(np.float32)
    for name, make in (("Identity", lambda nn: nn.Identity()),
                       ("Lambda", lambda nn: nn.Lambda("tanh")),
                       ("HybridLambda", lambda nn: nn.HybridLambda(lambda F, a: F.relu(a) * 2)),
                       ("HybridLambda_str", lambda nn: nn.HybridLambda("sigmoid"))):
        t, j = make(mx.gluon.nn), make(mxj.gluon.nn)
        np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(), j(mxj.nd.array(x)).asnumpy(),
                                   **FP32_TOL, err_msg=name)
    for cls in ("Concatenate", "HybridConcatenate"):
        t, j = getattr(mx.gluon.nn, cls)(axis=1), getattr(mxj.gluon.nn, cls)(axis=1)
        t.add(mx.gluon.nn.Identity(), mx.gluon.nn.Lambda("relu"))
        j.add(mxj.gluon.nn.Identity(), mxj.gluon.nn.Lambda("relu"))
        got = t(torch.from_numpy(x))
        assert tuple(got.shape) == (2, 6)
        np.testing.assert_allclose(got.numpy(), j(mxj.nd.array(x)).asnumpy(), **FP32_TOL)


# -- Block surface -----------------------------------------------------------------------


def _mlp():
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(5, activation="relu"), mx.gluon.nn.Dense(2))
    return net


def test_forward_hooks_have_mxnets_semantics():
    """A hook sees the call's arguments and output as the caller passed and
    received them (NDArrays in, NDArrays seen); what it returns is ignored;
    ``detach()`` removes it; pre-hooks run first."""
    net = _mlp()
    net.initialize(ctx=mx.cpu())
    seen = []
    h1 = net.register_forward_pre_hook(lambda b, args: seen.append(("pre", type(args[0]))))
    h2 = net.register_forward_hook(lambda b, args, out: seen.append(
        ("post", type(args[0]), type(out))) or torch.zeros(1))
    x = mx.nd.array(np.ones((3, 4), np.float32), ctx=mx.cpu())
    out = net(x)
    assert isinstance(out, mx.nd.NDArray) and out.shape == (3, 2)
    assert seen == [("pre", mx.nd.NDArray), ("post", mx.nd.NDArray, mx.nd.NDArray)]
    net(torch.ones(3, 4))
    assert seen[-1] == ("post", torch.Tensor, torch.Tensor)
    h1.detach()
    h2.remove()
    net(x)
    assert len(seen) == 4
    # PyTorch's keywords register PyTorch's own hook, with its semantics
    calls = []
    handle = net.register_forward_hook(lambda m, a, o: calls.append(type(a[0])), prepend=True)
    net(x)
    handle.remove()
    net(x)
    assert calls == [torch.Tensor] and len(seen) == 4


def test_apply_summary_infer_shape_optimize_for():
    net = _mlp()
    visited = []
    assert net.apply(lambda b: visited.append(type(b).__name__)) is net
    assert visited == ["Dense", "Dense", "HybridSequential"]
    net.initialize(ctx=mx.cpu())
    net.infer_shape(torch.ones(2, 4))
    assert net[0].weight.shape == (5, 4) and net[0].weight.grad_req == "write"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        net.summary(torch.ones(2, 4))
    lines = buf.getvalue().splitlines()
    assert "Output shape" in lines[0] and "(2, 5)" in lines[2] and "25" in lines[2]
    assert net.optimize_for(torch.ones(2, 4)) is None and net._active


def test_module_name_scope_restarts_the_counters():
    with name_scope():
        a = mx.gluon.nn.Dense(2)
        b = mx.gluon.nn.Dense(2)
    with name_scope():
        c = mx.gluon.nn.Dense(2)
    assert (a.prefix, b.prefix, c.prefix) == ("dense0_", "dense1_", "dense0_")
    with mxj.gluon.block.name_scope():
        d = mxj.gluon.nn.Dense(2)
    assert d.prefix == a.prefix


# -- Parameter, ParameterDict, Trainer, context ---------------------------------------------


def test_parameter_and_dict_surface():
    pd = mx.gluon.ParameterDict("net_")
    jd = mxj.gluon.ParameterDict("net_")
    value = np.arange(4, dtype=np.float32).reshape(2, 2)
    c, jc = pd.get_constant("c", value), jd.get_constant("c", value)
    assert isinstance(c, mx.gluon.Constant) and c.grad_req == jc.grad_req == "null"
    assert pd.get_constant("c") is c
    with pytest.raises(KeyError):
        pd.get_constant("missing")
    w = pd.get("w", shape=(2, 3))
    pd.initialize(ctx=mx.cpu())
    np.testing.assert_array_equal(c.data().numpy(), value)
    assert [d.shape for d in w.list_data()] == [(2, 3)] and w.list_ctx() == [mx.cpu()]
    assert w.var().name == "net_w" and c.var().name == jc.var().name
    pd.setattr("lr_mult", 0.5)
    assert w.lr_mult == c.lr_mult == 0.5
    w.grad().fill_(3.0)
    pd.zero_grad()
    assert float(w.grad().abs().sum()) == 0.0
    old = w.data()
    pd.reset_ctx(mx.cpu())
    assert w.data() is not old and torch.equal(w.data(), old) and w.data().requires_grad


def test_trainer_close_and_context_surface():
    pd = mx.gluon.ParameterDict("t_")
    pd.get("w", shape=(2,))
    pd.initialize(ctx=mx.cpu())
    with mx.gluon.Trainer(pd, "sgd") as tr:
        tr.close()
    tr.close()
    assert mx.cpu_pinned(1) == mx.context.cpu_pinned(1) and str(mx.cpu_pinned()) == str(
        mxj.cpu_pinned())
    assert mx.cpu_pinned().device == torch.device("cpu")
    assert mx.context.current_device() == mx.current_context()
    with mx.cpu():
        assert mx.context.current_device() == mx.cpu()
    mx.cpu().empty_cache()
    assert mx.context.Context(mx.cpu(2)) == mx.cpu(2)
