"""Neural-network operators that BERT's forward and its pretraining loss
call.

Counterpart of the matching ops in the JAX package's ``ops/nn.py``, with
MXNet's calling conventions (``FullyConnected`` weight ``[out, in]``) and
the same numerics: LayerNorm takes one-pass fp32 statistics and returns the
input dtype, ``LeakyReLU(act_type="gelu")`` is the exact erf form.  Plain
PyTorch, as the JAX package left these ops to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import alias, register


@register("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False, flatten=True):
    """weight is (num_hidden, in_units), as in the reference."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


alias("fully_connected", "FullyConnected")

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # the JAX package's Activation default
    "silu": F.silu,
    "swish": F.silu,
    "erf": torch.erf,
}


@register("Activation")
def activation(data, act_type="relu"):
    return _ACTS[act_type](data)


@register("LeakyReLU")
def leaky_relu(data, act_type="leaky", slope=0.25, lower_bound=0.125, upper_bound=0.334):
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        lam, a = 1.0507009873554805, 1.6732632423543772
        return lam * torch.where(data > 0, data, a * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)  # exact erf form
    if act_type == "rrelu":
        return torch.where(data > 0, data, (lower_bound + upper_bound) / 2 * data)
    raise ValueError(act_type)


@register("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """fp32 statistics, one pass (var = E[x²] − E[x]², clamped at 0, as the
    JAX package computes it), output in the input dtype."""
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = ((x32 * x32).mean(dim=axis, keepdim=True) - mean * mean).clamp_min(0.0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    ax = axis % data.ndim
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.ndim))
    out = out * gamma.float().reshape(bshape) + beta.float().reshape(bshape)
    return out.to(data.dtype)


@register("Dropout")
def dropout(data, p=0.5, mode="training", axes=(), training=None):
    """Identity outside training unless ``mode="always"`` (parity: the
    reference's is_train dispatch).  In training, each element is kept
    with probability exactly 1 − p and scaled by 1/(1 − p); the mask is
    drawn from the port's generator of the data's device
    (``random.get_generator``), never from PyTorch's global one, and is
    shared along ``axes``."""
    if training is None:
        from .. import autograd

        training = autograd.is_training()
    if (not training and mode != "always") or p <= 0:
        return data
    from ..random import get_generator

    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, device=data.device).bernoulli_(
        keep, generator=get_generator(data.device))
    return data * mask.to(data.dtype) / keep


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    """fp32 inside, output in the input dtype; ``length`` masks positions
    at or past each row's length along ``axis`` (they get 0)."""
    x = data.float()
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is None:
        return torch.softmax(x, dim=axis).to(data.dtype)
    ax = axis % x.ndim
    idx = torch.arange(x.shape[ax], device=x.device).reshape((-1,) + (1,) * (x.ndim - 1 - ax))
    mask = idx < length.reshape(tuple(length.shape) + (1,) * (x.ndim - length.ndim))
    out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=axis)
    return torch.where(mask, out, torch.zeros_like(out)).to(data.dtype)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data.float()
    if temperature not in (None, 1.0):
        x = x / temperature
    return torch.log_softmax(x, dim=axis).to(data.dtype)


def streaming_softmax_ce(logits, labels):
    """Per-position cross-entropy ``lse(logits) − logits[label]`` with fp32
    accumulation over the class axis; labels are integers of
    ``logits.shape[:-1]``.  The row max is held constant, as the JAX
    package's ``stop_gradient`` holds it, so the gradient is softmax −
    one-hot in fp32, returned in the logits' dtype."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = m[..., 0].float() + torch.log(torch.exp((logits - m).float()).sum(dim=-1))
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0].float()
    return lse - gold


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed cross-entropy with integer labels (parity: the reference's
    ``softmax_cross_entropy``)."""
    return streaming_softmax_ce(data, label.reshape(data.shape[:-1])).sum()


@register("gather_positions")
def gather_positions(data, positions):
    """[B, S, D] × [B, P] int → [B, P, D]: per-batch sequence-position gather
    (the MLM masked-position path)."""
    return torch.take_along_dim(data, positions.long()[..., None], dim=1)


@register("Embedding")
def embedding(data, weight, input_dim=0, output_dim=0):
    return F.embedding(data.long(), weight)
