"""ResNet training in the PyTorch port against the JAX package, on the CPU:
the Convolution and Pooling ops, the Gluon Conv2D, pooling and BatchNorm
blocks, a small ResNetV1 (BottleneckV1, layers [1, 1, 1, 1], channels
[8, 16, 32, 64, 128], 10 classes) in its thumbnail and 7x7-stem forms with
three SGD-momentum steps (losses, parameters and running statistics), a
ResNetV2 forward, and AMP bf16.  Inputs and weights come from numpy seeds
and the JAX package's initialization, carried across by structural key.

Every port BatchNorm here runs in training through ``ops/bn.py``'s
trainable BatchNorm (the kernels' plain versions on the CPU); the JAX side
takes its reference BatchNorm.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jvision
from incubator_mxnet_tpu.ops import nn as jnn
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_torch.ops import nn as tnn

# Ops in fp32: the same arithmetic in another summation order.
OP_TOL = dict(rtol=1e-5, atol=1e-5)
# The small ResNet, fp32: logits, losses and gradients through 16
# BatchNorms in training agree to ~1e-5 relative.  A batch-normalized
# network in training is chaotic: after an SGD step at lr 0.1, parameter
# differences of a few fp32 roundings grow into gradient differences far
# above that, so the steps are compared one at a time: each port step
# starts from the JAX parameters (running statistics included) after the
# step before, with the port Trainer's own momentum.  Losses to 1e-5 relative, parameters and
# running statistics to 1e-4 relative / 1e-5 absolute (lr 0.1 times a
# gradient difference of ~1e-5 relative).  The conv biases that feed a
# BatchNorm have an exact gradient of zero; both sides compute rounding
# noise of ~1e-5, which moves them by ~1e-6.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10)
CASES = {"thumbnail": (True, 32), "stem7x7": (False, 64)}
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
B = 2


def _images(size, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 3, size, size).astype(np.float32),
            rng.randint(0, SMALL["classes"], (B,)).astype(np.int32))


def _jax_net(thumbnail, size, version=1):
    """Hybridized: one compiled program per mode instead of one compile per
    eager op keeps the JAX side to seconds."""
    mxj.random.seed(0)
    block = jvision.BottleneckV1 if version == 1 else jvision.BottleneckV2
    cls = jvision.ResNetV1 if version == 1 else jvision.ResNetV2
    net = cls(block, SMALL["layers"], SMALL["channels"], classes=SMALL["classes"],
              thumbnail=thumbnail)
    net.initialize()
    net(mxj.nd.zeros((1, 3, size, size)))  # materialize deferred shapes
    net.hybridize()
    return net


def _port_net(arrays, thumbnail, version=1):
    block = tvision.BottleneckV1 if version == 1 else tvision.BottleneckV2
    cls = tvision.ResNetV1 if version == 1 else tvision.ResNetV2
    net = cls(block, SMALL["layers"], SMALL["channels"], classes=SMALL["classes"],
              thumbnail=thumbnail)
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, arrays)
    return net


def _params(net):
    return {k: np.array(p.data().asnumpy() if hasattr(p.data(), "asnumpy")
                        else p.data().detach().numpy())
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def jax_runs():
    """For each form of the small ResNetV1, built once: its initial
    parameters, predict-mode logits, the loss and all parameters (running
    statistics included) after each of three Trainer steps, and the net."""
    out = {}
    for name, (thumbnail, size) in CASES.items():
        jnet = _jax_net(thumbnail, size)
        start = _params(jnet)
        img, labels = _images(size)
        x, y = mxj.nd.array(img), mxj.nd.array(labels, dtype="int32")
        with mxj.autograd.predict_mode():
            logits = jnet(x).asnumpy()
        trainer = mxj.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
        loss_fn = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
        steps = []
        for _ in range(3):
            with mxj.autograd.record():
                loss = loss_fn(jnet(x), y)
            loss.backward()
            trainer.step(B)
            steps.append((loss.asnumpy(), _params(jnet)))
        out[name] = (start, logits, steps, jnet)
    return out


# -- ops ---------------------------------------------------------------------

CONV_CASES = [
    dict(shape=(2, 4, 9, 11), w=(6, 4, 3, 3), kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(shape=(2, 4, 9, 11), w=(6, 4, 3, 3), kernel=(3, 3), dilate=(2, 2), pad=(2, 1)),
    dict(shape=(2, 4, 8, 8), w=(6, 2, 3, 3), kernel=(3, 3), num_group=2, bias=True),
    dict(shape=(2, 4, 8, 8), w=(5, 4, 7, 7), kernel=(7, 7), stride=(2, 2), pad=(3, 3)),
    dict(shape=(2, 3, 10), w=(4, 3, 3), kernel=(3,), stride=(2,), pad=(1,), bias=True),
    dict(shape=(1, 2, 5, 6, 7), w=(3, 2, 3, 3, 3), kernel=(3, 3, 3), pad=(1, 1, 1)),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c['shape']}-{c['w']}")
def test_convolution_matches_jax(case):
    rng = np.random.RandomState(1)
    x = rng.randn(*case["shape"]).astype(np.float32)
    w = rng.randn(*case["w"]).astype(np.float32)
    b = rng.randn(case["w"][0]).astype(np.float32) if case.get("bias") else None
    kw = {k: v for k, v in case.items() if k not in ("shape", "w", "bias")}
    want = jnn.convolution(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                           no_bias=b is None, **kw)
    got = tnn.convolution(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b), no_bias=b is None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


POOL_CASES = [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max", pooling_convention="full"),
    dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg", count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="avg", pooling_convention="full",
         count_include_pad=False),
    dict(kernel=(2, 3), stride=(1, 2), pool_type="sum"),
    dict(kernel=(2, 2), pool_type="lp"),
    dict(global_pool=True, pool_type="max"),
    dict(global_pool=True, pool_type="avg"),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_pooling_matches_jax(case):
    x = np.random.RandomState(2).randn(2, 3, 9, 10).astype(np.float32)
    want = jnn.pooling(jnp.asarray(x), **case)
    got = tnn.pooling(torch.from_numpy(x), **case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_elementwise_and_flatten_ops():
    a, b = torch.randn(2, 3, 4), torch.randn(2, 3, 4)
    torch.testing.assert_close(mx.nd.elemwise_add(a, b), a + b)
    torch.testing.assert_close(mx.nd.broadcast_add(a, b[:1]), a + b[:1])
    assert tuple(mx.nd.Flatten(a).shape) == (2, 12)
    assert tuple(nn.Flatten()(torch.zeros(3, 2, 2, 2)).shape) == (3, 8)


# -- Gluon blocks --------------------------------------------------------------


def _pair(jblock, tblock, x):
    """Initialize both blocks (JAX from its seed, deferred shapes from x),
    carry the JAX weights across, and return the two."""
    mxj.random.seed(3)
    jblock.initialize()
    jblock(mxj.nd.array(x))
    tblock.initialize(ctx=mx.cpu())
    load_numpy_params(tblock, _params(jblock))
    return jblock, tblock


@pytest.mark.parametrize("make", [
    lambda m: m.Conv2D(6, kernel_size=3, strides=2, padding=1),
    lambda m: m.Conv2D(4, kernel_size=(1, 3), use_bias=False, in_channels=3),
    lambda m: m.MaxPool2D(3, 2, 1),
    lambda m: m.AvgPool2D(3, 2, 1, count_include_pad=False),
    lambda m: m.GlobalAvgPool2D(),
    lambda m: m.GlobalMaxPool2D(),
], ids=["conv_deferred", "conv_in_channels", "maxpool", "avgpool", "global_avg", "global_max"])
def test_blocks_match_jax(make):
    x = np.random.RandomState(4).randn(2, 3, 9, 10).astype(np.float32)
    jblock, tblock = _pair(make(mxj.gluon.nn), make(nn), x)
    want = jblock(mxj.nd.array(x)).asnumpy()
    got = tblock(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **OP_TOL)


@pytest.mark.parametrize("make", [
    lambda m: m.Activation("relu"), lambda m: m.Activation("sigmoid"),
    lambda m: m.LeakyReLU(0.1), lambda m: m.PReLU(), lambda m: m.ELU(0.5), lambda m: m.SELU(),
    lambda m: m.GELU(), lambda m: m.Swish(1.5), lambda m: m.SiLU(),
], ids=["relu", "sigmoid", "leaky", "prelu", "elu", "selu", "gelu", "swish", "silu"])
def test_activation_blocks_match_jax(make):
    x = np.random.RandomState(6).randn(2, 3, 4, 5).astype(np.float32)
    jblock, tblock = _pair(make(mxj.gluon.nn), make(nn), x)
    want = jblock(mxj.nd.array(x)).asnumpy()
    got = tblock(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"scale": False, "center": False}, {"momentum": 0.7}])
def test_batchnorm_block_matches_jax(kwargs):
    """Running statistics after two train-mode forwards, then the output on
    the moving statistics in predict mode."""
    rng = np.random.RandomState(5)
    xs = [(rng.randn(3, 4, 5, 6) * 2 + 1).astype(np.float32) for _ in range(2)]
    jblock, tblock = _pair(mxj.gluon.nn.BatchNorm(**kwargs), nn.BatchNorm(**kwargs), xs[0])
    load_numpy_params(tblock, _params(jblock))  # after JAX's materializing forward
    for x in xs:
        with mxj.autograd.train_mode():
            jout = jblock(mxj.nd.array(x)).asnumpy()
        with mx.autograd.train_mode():
            tout = tblock(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)
    for key, want in _params(jblock).items():
        np.testing.assert_allclose(_params(tblock)[key], want, err_msg=key, **OP_TOL)
    with mxj.autograd.predict_mode():
        jout = jblock(mxj.nd.array(xs[0])).asnumpy()
    with mx.autograd.predict_mode():
        tout = tblock(torch.from_numpy(xs[0])).detach().numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)


def test_batchnorm_parameters():
    """Deferred in_channels; the running statistics take no gradient; a
    16-bit cast keeps the four parameters fp32."""
    block = nn.BatchNorm()
    block.initialize(ctx=mx.cpu())
    block.cast("bfloat16")
    with mx.autograd.record():
        out = block(torch.randn(2, 3, 4, 4).bfloat16())
    assert out.dtype == torch.bfloat16
    assert [p.shape for p in block.params.values()] == [(3,)] * 4
    assert {p.dtype for p in block.params.values()} == {"float32"}
    assert (block.running_mean.grad_req, block.running_var.grad_req) == ("null", "null")
    assert block.gamma.grad_req == "write"
    assert nn.BatchNorm(scale=False).gamma.grad_req == "null"


# -- the small ResNet ---------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_small_resnet_v1_logits_and_three_sgd_steps(jax_runs, name):
    thumbnail, size = CASES[name]
    start, jlogits, jsteps, _ = jax_runs[name]
    net = _port_net(start, thumbnail)
    img, labels = (torch.from_numpy(a) for a in _images(size))
    with mx.autograd.predict_mode():
        logits = net(img).detach().numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    for step, (jloss, jparams) in enumerate(jsteps):
        if step:
            load_numpy_params(net, jsteps[step - 1][1])  # in place: the momentum stays
        with mx.autograd.record():
            loss = tnn.streaming_softmax_ce(net(img), labels)
        mx.autograd.backward(loss)
        trainer.step(B)
        np.testing.assert_allclose(loss.detach().numpy(), jloss, err_msg=f"step {step}",
                                   **LOSS_TOL)
        got = _params(net)
        assert got.keys() == jparams.keys()
        for key, want in jparams.items():
            np.testing.assert_allclose(got[key], want, err_msg=f"step {step}: {key}",
                                       **PARAM_TOL)


def test_load_numpy_params_carries_running_stats(jax_runs):
    """Trained running statistics of the JAX net land in the port's."""
    _, _, jsteps, _ = jax_runs["stem7x7"]
    trained = jsteps[-1][1]
    net = _port_net(trained, thumbnail=False)
    keys = [k for k in trained if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 17
    for key in keys:
        assert not np.all(trained[key] == (0.0 if key.endswith("mean") else 1.0))
        np.testing.assert_array_equal(_params(net)[key], trained[key])


def test_small_resnet_v2_forward_matches_jax():
    """ResNetV2 (BottleneckV2, first BN without scale and centre): the
    train-mode forward (batch statistics) and the predict-mode one."""
    jnet = _jax_net(True, 32, version=2)
    net = _port_net(_params(jnet), True, version=2)
    img, _ = _images(32, seed=1)
    for jmode, tmode in ((mxj.autograd.train_mode, mx.autograd.train_mode),
                         (mxj.autograd.predict_mode, mx.autograd.predict_mode)):
        with jmode():
            want = jnet(mxj.nd.array(img)).asnumpy()
        with tmode():
            got = net(torch.from_numpy(img)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_resnet_zoo_structure():
    net = tvision.get_model("resnet50_v1", classes=1000)
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm)]
    assert len(bns) == 53
    body = net.features[4][0].body
    assert body[0].bias is not None and body[6].bias is not None  # BottleneckV1 keeps them
    v2 = tvision.resnet18_v2()
    assert v2.features[0].gamma.grad_req == "null" and v2.features[0].beta.grad_req == "null"
    with pytest.raises(ValueError):
        tvision.get_model("resnet51_v1")


# -- AMP ----------------------------------------------------------------------


def test_amp_bf16_matches_jax(jax_runs):
    """amp.init("bfloat16") on both sides: convolution and Dense run in
    bf16, BatchNorm takes and returns bf16 with fp32 statistics, and the
    predict-mode logits agree within bf16 rounding: each side rounds every
    conv input, weight and output (unit roundoff 2**-8) through 13 layers,
    in different places, so the logits differ by a few percent of their
    largest value.  ``amp.disabled()`` restores fp32."""
    start, jlogits32, _, jnet = jax_runs["thumbnail"]
    img, _ = _images(32)
    for key, p in jnet._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(start[key]))
    net = _port_net(start, True)
    x = torch.from_numpy(img)
    jamp.init("bfloat16")
    mx.amp.init("bfloat16")
    try:
        with mxj.autograd.predict_mode():
            jlogits = jnet(mxj.nd.array(img)).asnumpy().astype(np.float32)
        with mx.autograd.predict_mode():
            logits = net(x)
            with mx.amp.disabled():
                logits32 = net(x)
        assert mx.amp.is_enabled()
        conv = mx.nd.Convolution(x, net.features[0].weight.data(), kernel=(3, 3), pad=(1, 1),
                                 no_bias=True)
        out, mean, var = mx.nd.BatchNorm(conv, torch.ones(8), torch.zeros(8), torch.zeros(8),
                                         torch.ones(8))
    finally:
        jamp.disable()
        mx.amp.disable()
    assert logits.dtype == torch.bfloat16 and conv.dtype == torch.bfloat16
    assert out.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    assert logits32.dtype == torch.float32
    np.testing.assert_allclose(logits32.detach().numpy(), jlogits32, rtol=1e-4, atol=1e-5)
    scale = np.abs(jlogits32).max()
    np.testing.assert_allclose(logits.float().detach().numpy(), jlogits, rtol=0,
                               atol=0.05 * scale)
    np.testing.assert_allclose(logits.float().detach().numpy(), jlogits32, rtol=0,
                               atol=0.05 * scale)


def test_amp_casts_by_list():
    a32, a16 = torch.randn(2, 3), torch.randn(2, 3).bfloat16()
    mx.amp.init("bfloat16")
    try:
        assert mx.nd.FullyConnected(a32, torch.randn(4, 3), no_bias=True).dtype == torch.bfloat16
        assert mx.nd.sum(a16).dtype == torch.float32                   # FP32_OPS
        assert mx.nd.elemwise_add(a32, a16).dtype == torch.float32     # WIDEST_OPS
        assert mx.nd.Activation(a16).dtype == torch.bfloat16           # no list: untouched
        with mx.amp.disabled():
            assert not mx.amp.is_enabled()
            assert mx.nd.FullyConnected(a32, torch.randn(4, 3),
                                        no_bias=True).dtype == torch.float32
        assert mx.amp.is_enabled()
    finally:
        mx.amp.disable()
    with pytest.raises(ValueError):
        mx.amp.init("int8")
