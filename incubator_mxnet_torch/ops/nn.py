"""Neural-network operators that BERT and ResNet call.

Counterpart of the matching ops in the JAX package's ``ops/nn.py``, with
MXNet's calling conventions (``FullyConnected`` weight ``[out, in]``,
``Convolution`` NCHW data and OIHW weights) and the same numerics:
LayerNorm and BatchNorm take one-pass fp32 statistics and return the input
dtype, ``LeakyReLU(act_type="gelu")`` is the exact erf form.  Plain
PyTorch, as the JAX package left these ops to XLA, except the train-mode
BatchNorm, which runs the kernels of ``ops/bn.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import bn
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
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.ndim == 1 and data.ndim > 1:
            g = g.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data > 0, data, g * data)
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


def _tuplize(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v if len(v) == n else v + (v[-1],) * (n - len(v))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution")
def convolution(data, weight, bias=None, kernel=(1, 1), stride=None, dilate=None, pad=None,
                num_filter=0, num_group=1, no_bias=False, layout=None):
    """NC(D)HW data, OI(D)HW weights, MXNet's kernel/stride/dilate/pad/
    num_group/no_bias."""
    n = len(kernel)
    return _CONV[n](data, weight, None if no_bias else bias, stride=_tuplize(stride, n),
                    padding=_tuplize(pad if pad is not None else 0, n),
                    dilation=_tuplize(dilate, n), groups=num_group)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling")
def pooling(data, kernel=(2, 2), pool_type="max", global_pool=False, stride=None, pad=None,
            pooling_convention="valid", count_include_pad=True, layout=None):
    """max/avg/sum/lp pooling with MXNet's conventions: ``"valid"`` floors
    the output size, ``"full"`` ceils it by padding the upper edge further
    (with −inf for max, zeros for the sums), and ``count_include_pad``
    decides whether padding counts in an average."""
    n = data.ndim - 2
    spatial = tuple(range(2, data.ndim))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=spatial, keepdim=True)
        kernel, stride, pad = data.shape[2:], (1,) * n, (0,) * n
    else:
        kernel = _tuplize(kernel, n)
        stride = _tuplize(stride if stride is not None else kernel, n)
        pad = _tuplize(pad if pad is not None else 0, n)
    lo_hi = [(p, p) for p in pad]
    if pooling_convention == "full" and not global_pool:
        for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
            size = data.shape[2 + i]
            out_full = -(-(size + 2 * p - k) // s) + 1
            lo_hi[i] = (p, max(p, (out_full - 1) * s + k - size - p))
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(lo_hi, kernel))
    if pool_type == "max":
        if native:
            return _MAX_POOL[n](data, kernel, stride, padding=pad)
        return _MAX_POOL[n](_pad(data, lo_hi, float("-inf")), kernel, stride)
    size = math.prod(kernel)
    if pool_type in ("avg", "sum"):
        if native:
            avg = _AVG_POOL[n](data, kernel, stride, padding=pad,
                               count_include_pad=count_include_pad or pool_type == "sum")
            return avg * size if pool_type == "sum" else avg
        summed = _AVG_POOL[n](_pad(data, lo_hi, 0.0), kernel, stride) * size
        if pool_type == "sum" or count_include_pad:
            return summed if pool_type == "sum" else summed / size
        ones = _pad(torch.ones_like(data), lo_hi, 0.0)
        return summed / (_AVG_POOL[n](ones, kernel, stride) * size)
    if pool_type == "lp":
        return torch.sqrt(_AVG_POOL[n](_pad(data * data, lo_hi, 0.0), kernel, stride) * size)
    raise ValueError(pool_type)


def _pad(data, lo_hi, value):
    flat = []
    for lo, hi in reversed(lo_hi):  # F.pad lists the last dimension first
        flat += [lo, hi]
    return F.pad(data, flat, value=value)


@register("BatchNorm")
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5, momentum=0.9,
               fix_gamma=True, use_global_stats=False, output_mean_var=False, axis=1):
    """Returns ``(out, batch_mean, batch_var)``; the layer owns the running
    statistics' update.  With ``use_global_stats`` the moving statistics
    are used and returned.

    A train-mode 4-D BatchNorm on axis 1 is ``bn.trainable_batch_norm``: the
    hand-written kernels on a CUDA tensor, their plain versions on the CPU.
    Everything else takes the reference formula (fp32 one-pass statistics,
    out in the data's dtype); ``batch_norm.reference_calls`` counts those
    calls."""
    ax = axis % data.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if not use_global_stats and ax == 1 and data.ndim == 4:
        return bn.trainable_batch_norm(data, g, beta, eps=float(eps))
    batch_norm.reference_calls += 1
    reduce_axes = tuple(i for i in range(data.ndim) if i != ax)
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.ndim))
    x32 = data.float()
    if use_global_stats:
        mean, var = moving_mean.float(), moving_var.float()
    else:
        mean = x32.mean(dim=reduce_axes)
        var = torch.clamp_min((x32 * x32).mean(dim=reduce_axes) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    out = ((x32 - mean.reshape(bshape)) * (g.float() * inv).reshape(bshape)
           + beta.float().reshape(bshape))
    return out.to(data.dtype), mean, var


batch_norm.reference_calls = 0
