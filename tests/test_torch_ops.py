"""The PyTorch port's BERT ops against the JAX package's, on the CPU.

Same numpy inputs from a seed through ``incubator_mxnet_tpu.ops`` and
``incubator_mxnet_torch.ops``; fp32 results agree within 2e-5 (JAX runs
its matmuls at "highest" precision, so only the summation order differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops import tensor as jtensor
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops import nn as tnn
from incubator_mxnet_torch.ops import tensor as ttensor

TOL = 2e-5


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("flatten,no_bias", [(False, False), (True, False), (False, True)])
def test_fully_connected(flatten, no_bias):
    x, w, b = _rand(0, 3, 5, 8), _rand(1, 6, 40 if flatten else 8), _rand(2, 6)
    ref = jnn.fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), num_hidden=6,
                              no_bias=no_bias, flatten=flatten)
    out = tnn.fully_connected(*map(torch.from_numpy, (x, w, b)), num_hidden=6,
                              no_bias=no_bias, flatten=flatten)
    _close(out, ref)


def test_embedding():
    ids = np.random.RandomState(3).randint(0, 50, (4, 7)).astype(np.int32)
    w = _rand(4, 50, 16)
    ref = jnn.embedding(jnp.asarray(ids), jnp.asarray(w), input_dim=50, output_dim=16)
    _close(tnn.embedding(torch.from_numpy(ids), torch.from_numpy(w)), ref)


def test_layer_norm():
    x, g, b = _rand(5, 4, 6, 32), _rand(6, 32), _rand(7, 32)
    ref = jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), axis=-1, eps=1e-5)
    _close(tnn.layer_norm(*map(torch.from_numpy, (x, g, b)), axis=-1, eps=1e-5), ref)


def test_layer_norm_large_mean_row_pins_one_pass_variance():
    """Row 4096 ± 0.5: every sum is exact in fp32 whatever its order, and
    E[x²] rounds to E[x]², so the one-pass variance is 0 (output ±0.5/√eps
    ≈ ±158) where a two-pass variance would give 0.25 (output ±1)."""
    x = np.tile(np.array([4096.5, 4095.5], np.float32), 8)[None, :]
    g, b = np.ones(16, np.float32), np.zeros(16, np.float32)
    ref = jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    out = tnn.layer_norm(*map(torch.from_numpy, (x, g, b)))
    _close(out, ref)
    assert out.abs().min().item() > 100


def test_layer_norm_bf16_keeps_input_dtype():
    x = torch.from_numpy(_rand(8, 2, 16)).to(torch.bfloat16)
    out = tnn.layer_norm(x, torch.ones(16), torch.zeros(16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["gelu", "leaky", "elu", "selu", "rrelu"])
def test_leaky_relu(act):
    x = _rand(9, 3, 33) * 3
    ref = jnn.leaky_relu(jnp.asarray(x), act_type=act)
    _close(tnn.leaky_relu(torch.from_numpy(x), act_type=act), ref)


@pytest.mark.parametrize("act", ["tanh", "relu", "sigmoid", "gelu", "softrelu", "softsign",
                                 "silu", "swish", "erf"])
def test_activation(act):
    x = _rand(10, 3, 33) * 3
    ref = jnn.activation(jnp.asarray(x), act_type=act)
    _close(tnn.activation(torch.from_numpy(x), act_type=act), ref)


def test_gather_positions():
    x = _rand(11, 3, 10, 8)
    pos = np.random.RandomState(12).randint(0, 10, (3, 4)).astype(np.int32)
    ref = jnn.gather_positions(jnp.asarray(x), jnp.asarray(pos))
    _close(tnn.gather_positions(torch.from_numpy(x), torch.from_numpy(pos)), ref)


def test_dropout_is_identity_outside_training_and_waits_inside():
    x = torch.from_numpy(_rand(13, 4, 8))
    with mx.autograd.predict_mode():
        assert tnn.dropout(x, p=0.1) is x
    with mx.autograd.train_mode():
        assert tnn.dropout(x, p=0.0) is x
        y = tnn.dropout(x, p=0.1)  # training: drops and rescales
    kept = y != 0
    assert 0 < kept.sum() < x.numel()
    torch.testing.assert_close(y[kept], x[kept] / 0.9, rtol=1e-6, atol=0)


@pytest.mark.parametrize("axis,begin,end", [(1, 0, 1), (0, 1, 3), (-1, 2, None), (1, -3, -1)])
def test_slice_axis(axis, begin, end):
    x = _rand(14, 4, 5, 6)
    ref = jtensor.slice_axis(jnp.asarray(x), axis, begin, end)
    _close(ttensor.slice_axis(torch.from_numpy(x), axis, begin, end), ref)


@pytest.mark.parametrize("shape", [(0, -1), (-1, 0), (0, -3), (-2,), (0, 0, -4, 2, -1), (-3, 0)])
def test_reshape_special_codes(shape):
    x = _rand(15, 2, 3, 4)
    ref = jtensor.reshape(jnp.asarray(x), shape)
    out = ttensor.reshape(torch.from_numpy(x), shape)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


def test_arange_and_zeros_follow_ctx():
    a = ttensor.arange(0, 5, ctx=mx.cpu(), dtype="int32")
    assert a.dtype == torch.int32 and a.tolist() == [0, 1, 2, 3, 4]
    z = ttensor.zeros((2, 3), ctx=mx.cpu(), dtype="bfloat16")
    assert z.dtype == torch.bfloat16 and z.shape == (2, 3) and not z.any()


def test_nd_namespace_reaches_registered_ops():
    assert mx.nd.FullyConnected is tnn.fully_connected
    assert mx.nd.Reshape is ttensor.reshape
    assert mx.nd.contrib.fused_qkv_attention is mx.nd.fused_qkv_attention
    with pytest.raises(AttributeError):
        mx.nd.no_such_op
