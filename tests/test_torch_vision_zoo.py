"""The transposed convolutions, ReflectionPad2D and the rest of the vision
zoo in the PyTorch port against the JAX package, on the CPU.

``Conv1DTranspose``/``Conv2DTranspose``/``Conv3DTranspose`` (deferred
``in_channels``, ``output_padding``, ``groups``, ``dilation``, bias and an
activation) and ``ReflectionPad2D``: forward, input gradient and parameter
gradients of a weighted sum, the weights carried across from the JAX
initialization by structural key, within 1e-5 (fp32, another summation
order).

One model of each new family at its published input size (224x224,
299x299 for Inception V3), B=1, in predict mode: AlexNet, VGG (11 layers
with BatchNorm, narrow filters), MobileNet V1 and V2 (multiplier 0.25),
SqueezeNet 1.1, DenseNet (narrow: 8 initial features, growth 4, one layer
a block) and Inception V3, with numpy-seeded parameters in both
packages (``twin_nets``: the port finishes the deferred shapes, the JAX
net takes the values, ``convert.load_numpy_params`` carries them across).
Logits within 1e-4 relative to the largest |logit|: fp32 through up to 94
convolutions in another order.

``params_of``, ``seeded``, ``twin_nets`` and ``assert_close_to_scale`` are
the set-up that tests/test_torch_detection.py and test_torch_yolo.py share
with this file.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon.model_zoo import vision as tvision

OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_REL = 1e-4


# -- one set of numpy-seeded parameters in a JAX net and its port twin ---------------

def params_of(net):
    """``{structural key: numpy array}`` of either package's net."""
    return {k: (p.data().asnumpy() if hasattr(p.data(), "asnumpy")
                else p.data().detach().numpy()).copy()
            for k, p in net._collect_params_with_prefix().items()}


def seeded(shapes, seed):
    """He-scaled weights, small biases and shifts, unit-ish scales, running
    variances in [0.5, 1.5]: activations stay O(1) through the depth."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in sorted(shapes.items()):
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif key.endswith(("running_mean", "beta", "bias")):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape, dtype=np.float32) * np.sqrt(2.0 / np.prod(shape[1:]))
        out[key] = np.asarray(v, np.float32)
    return out


def twin_nets(make_port, make_jax, x, seed=5, grads=True):
    """(JAX net, port net) with the same seeded parameters; ``x`` (numpy)
    is the input that finishes the port's deferred shapes.  The JAX net
    takes the values as its parameters' data directly: its own deferred
    initialization would first fill zeros of every shape (one XLA compile
    a shape, seconds for an Inception V3 on a CPU).  With ``grads`` False
    the JAX parameters get no gradient buffers (a forward-only check)."""
    mxj.random.seed(seed)  # the JAX key exists before any trace
    net = make_port()
    net.initialize(ctx=mx.cpu())
    with mx.autograd.predict_mode():
        net(torch.from_numpy(x))
    values = seeded({k: tuple(p.shape) for k, p in net._collect_params_with_prefix().items()},
                    seed)
    jnet = make_jax()
    jparams = jnet._collect_params_with_prefix()
    assert sorted(jparams) == sorted(values)
    for key, p in jparams.items():
        p.shape = values[key].shape
        p._data = mxj.nd.array(values[key])
        if not grads:
            p.grad_req = "null"
        elif p.grad_req != "null":
            p._data.attach_grad(p.grad_req)
    load_numpy_params(net, params_of(jnet))
    return jnet, net


def assert_close_to_scale(got, want, rel, err_msg=""):
    """Elementwise within ``rel`` relative, or ``rel`` times the largest
    |want| absolute: the tolerance of a deep net's outputs, whose rounding
    differences scale with the tensor, not with each entry."""
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()),
                               err_msg=err_msg)


# -- transposed convolutions and ReflectionPad2D --------------------------------

TRANSPOSE_CASES = {
    "1d": (lambda m: m.Conv1DTranspose(4, 3, strides=2, padding=1, output_padding=1),
           (2, 3, 7)),
    "1d_groups_dilation": (lambda m: m.Conv1DTranspose(6, 3, strides=2, dilation=2, groups=3,
                                                       use_bias=False), (2, 6, 5)),
    "2d": (lambda m: m.Conv2DTranspose(5, (3, 4), strides=(2, 3), padding=(1, 2),
                                       output_padding=(1, 2), activation="relu"),
           (2, 3, 6, 5)),
    "2d_groups_dilation": (lambda m: m.Conv2DTranspose(4, 3, strides=2, padding=1,
                                                       dilation=(2, 1), groups=2,
                                                       in_channels=4), (1, 4, 5, 6)),
    "3d": (lambda m: m.Conv3DTranspose(3, 2, strides=2, output_padding=(1, 0, 1)),
           (1, 2, 3, 4, 3)),
}


@pytest.mark.parametrize("name", TRANSPOSE_CASES)
def test_transposed_convolution_forward_and_grads_match_jax(name):
    make, shape = TRANSPOSE_CASES[name]
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    mxj.random.seed(2)
    jblock = make(mxj.gluon.nn)
    jblock.initialize()
    jblock(mxj.nd.array(x))
    tblock = make(nn)
    tblock.initialize(ctx=mx.cpu())
    load_numpy_params(tblock, params_of(jblock))
    assert [p.shape for p in tblock.collect_params().values()] == \
        [p.shape for p in jblock.collect_params().values()]

    jx = mxj.nd.array(x)
    jx.attach_grad()
    with mxj.autograd.record():
        jy = jblock(jx)
        w = mxj.nd.array(rng.randn(*jy.shape).astype(np.float32))
        (jy * w).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    with mx.autograd.record():
        ty = tblock(tx)
        (ty * torch.from_numpy(w.asnumpy().copy())).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **OP_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **OP_TOL)
    jgrads = {k: p.grad().asnumpy() for k, p in jblock._collect_params_with_prefix().items()}
    for key, p in tblock._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.grad().numpy(), jgrads[key], err_msg=key, **OP_TOL)


@pytest.mark.parametrize("padding", [2, (0, 0, 0, 0, 1, 3, 2, 0)], ids=["int", "tuple"])
def test_reflection_pad2d_forward_and_grad_match_jax(padding):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 5, 6).astype(np.float32)
    jx = mxj.nd.array(x)
    jx.attach_grad()
    with mxj.autograd.record():
        jy = mxj.gluon.nn.ReflectionPad2D(padding)(jx)
        w = mxj.nd.array(rng.randn(*jy.shape).astype(np.float32))
        (jy * w).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    with mx.autograd.record():
        ty = nn.ReflectionPad2D(padding)(tx)
        (ty * torch.from_numpy(w.asnumpy().copy())).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy.asnumpy())
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **OP_TOL)


# -- the zoo ------------------------------------------------------------------------

ZOO = {
    "alexnet": (lambda v: v.AlexNet(classes=10), 224),
    "vgg11_bn_narrow": (lambda v: v.VGG([1, 1, 2, 2, 2], [8, 8, 16, 16, 16], classes=10,
                                        batch_norm=True), 224),
    "mobilenet0.25": (lambda v: v.mobilenet0_25(classes=10), 224),
    "mobilenetv2_0.25": (lambda v: v.mobilenet_v2_0_25(classes=10), 224),
    "squeezenet1.1": (lambda v: v.squeezenet1_1(classes=10), 224),
    "densenet_narrow": (lambda v: v.DenseNet(8, 4, [1, 1, 1, 1], classes=10), 224),
    "inceptionv3": (lambda v: v.inception_v3(classes=10), 299),
}


@pytest.mark.parametrize("name", ZOO)
def test_zoo_family_forward_at_published_size_matches_jax(name):
    make, size = ZOO[name]
    x = np.random.RandomState(4).rand(1, 3, size, size).astype(np.float32)
    jnet, net = twin_nets(lambda: make(tvision), lambda: make(jvision), x, grads=False)
    jnet.hybridize()
    with mxj.autograd.predict_mode():
        want = jnet(mxj.nd.array(x)).asnumpy()
    with mx.autograd.predict_mode():
        got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (1, 10)
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    assert_close_to_scale(got, want, LOGIT_REL)


def test_get_model_resolves_all_34_names_as_the_jax_package():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34
    for name in tvision._models:
        assert tvision.get_model is not None and callable(tvision._models[name])
    assert isinstance(tvision.get_model("squeezenet1.0"), tvision.SqueezeNet)
    assert isinstance(tvision.get_model("MobileNetV2_0.5"), tvision.MobileNetV2)
    with pytest.raises(ValueError):
        tvision.get_model("vgg17")
    with pytest.raises(RuntimeError, match="load_numpy_params"):
        tvision.get_model("alexnet", pretrained=True)


@pytest.mark.parametrize("name,batchnorms", [
    ("alexnet", 0), ("vgg16_bn", 13), ("mobilenet1.0", 27), ("mobilenetv2_1.0", 53),
    ("squeezenet1.1", 0), ("densenet121", 121), ("inceptionv3", 94)])
def test_zoo_structure_matches_jax(name, batchnorms):
    """The BatchNorm count (the chip's BN launches a train-mode forward) and
    the structural keys of the full-size nets equal the JAX package's."""
    net = tvision.get_model(name)
    assert sum(isinstance(m, nn.BatchNorm) for m in net.modules()) == batchnorms
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(jvision.get_model(name)._collect_params_with_prefix())
