"""Neural-network operators: the port of the JAX package's ``ops/nn.py``.

Every op of that file, with MXNet's calling conventions
(``FullyConnected`` weight ``[out, in]``, ``Convolution`` NCHW data and
OIHW weights, ``Deconvolution`` weights ``[in, out/group, *kernel]``) and
the same numerics: LayerNorm, GroupNorm, InstanceNorm and BatchNorm take
one-pass fp32 statistics and return the input dtype,
``LeakyReLU(act_type="gelu")`` is the exact erf form.  The legacy loss
heads keep their own gradients: ``SoftmaxOutput`` back-propagates
(softmax − one-hot)·grad_scale with its ``ignore_label`` and
``normalization`` rules and ``LinearRegressionOutput`` (out − label)·
grad_scale, both ignoring the head gradient; ``MakeLoss`` is the identity
there, as in the JAX package.  Plain PyTorch, as the JAX package left
these ops to XLA, except the train-mode BatchNorm, which runs the kernels
of ``ops/bn.py``.
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


def _normalize(x32, axes, eps):
    """(x − mean)·rsqrt(var + eps) over ``axes``, one-pass fp32 variance."""
    mean = x32.mean(dim=axes, keepdim=True)
    var = ((x32 * x32).mean(dim=axes, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x32 - mean) * torch.rsqrt(var + eps)


@register("GroupNorm")
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    n, c = data.shape[0], data.shape[1]
    rest = tuple(data.shape[2:])
    x = data.float().reshape((n, num_groups, c // num_groups) + rest)
    x = _normalize(x, tuple(range(2, x.ndim)), eps).reshape(data.shape)
    bshape = (1, c) + (1,) * len(rest)
    return (x * gamma.float().reshape(bshape) + beta.float().reshape(bshape)).to(data.dtype)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    x = _normalize(data.float(), tuple(range(2, data.ndim)), eps)
    bshape = (1, data.shape[1]) + (1,) * (data.ndim - 2)
    return (x * gamma.float().reshape(bshape) + beta.float().reshape(bshape)).to(data.dtype)


@register("RMSNorm")
def rms_norm(data, gamma, axis=-1, eps=1e-6):
    x32 = data.float()
    ms = (x32 * x32).mean(dim=axis, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * gamma.float()).to(data.dtype)


@register("Dropout")
def dropout(data, p=0.5, mode="training", axes=(), key=None, training=None):
    """Identity outside training unless ``mode="always"`` (parity: the
    reference's is_train dispatch).  In training, each element is kept
    with probability exactly 1 − p and scaled by 1/(1 − p); the mask is
    drawn from ``key`` (a ``torch.Generator``) or else the port's generator
    of the data's device (``random.get_generator``), never from PyTorch's
    global one, and is shared along ``axes``."""
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
        keep, generator=key if key is not None else get_generator(data.device))
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


@register("softmin")
def softmin(data, axis=-1):
    return torch.softmax(-data.float(), dim=axis).to(data.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; backward (p − one-hot)·grad_scale, masked by
    ``ignore_label`` and divided by the ``normalization`` count, whatever
    the head gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore, axis, normalization):
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, axis, normalization)
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, ax, normalization = ctx.attrs
        ax = ax % out.ndim
        lab = label.long()
        classes = torch.arange(out.shape[ax], device=out.device).reshape(
            (-1,) + (1,) * (out.ndim - 1 - ax))
        oh = (lab.unsqueeze(ax) == classes).to(out.dtype)
        grad = (out - oh) * grad_scale
        if use_ignore:
            keep = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(ax)
        if normalization == "batch":
            grad = grad / out.shape[0]
        elif normalization == "valid":
            grad = (grad / torch.clamp_min(keep.sum(), 1.0) if use_ignore
                    else grad / float(lab.numel()))
        return grad, None, None, None, None, None, None


@register("SoftmaxOutput")
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0, use_ignore=False,
                   multi_output=False, normalization="null", **kw):
    """The legacy Module-API loss head: forward softmax (over axis 1 with
    ``multi_output``, else the last), backward scaled (p − one-hot)."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale), float(ignore_label),
                                bool(use_ignore), 1 if multi_output else -1,
                                str(normalization))


alias("Softmax", "SoftmaxOutput")


class _LinearRegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale):
        ctx.save_for_backward(data, label)
        ctx.grad_scale = grad_scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, _head):
        data, label = ctx.saved_tensors
        return (data - label) * ctx.grad_scale, None, None


@register("LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0):
    """Forward the data; backward (data − label)·grad_scale, whatever the
    head gradient."""
    return _LinearRegressionOutput.apply(data, label.reshape(data.shape), grad_scale)


@register("MakeLoss")
def make_loss(data, grad_scale=1.0, normalization="null", valid_thresh=0.0):
    return data * 1.0


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
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32", sparse_grad=False):
    """A gather of rows of ``weight``; ``sparse_grad=True`` raises (row-sparse
    gradients are not ported)."""
    if sparse_grad:
        raise NotImplementedError("Embedding(sparse_grad=True): row-sparse gradients are not "
                                  "ported; the gradient is dense")
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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@register("Deconvolution")
def deconvolution(data, weight, bias=None, kernel=(1, 1), stride=None, dilate=None, pad=None,
                  adj=None, num_filter=0, num_group=1, no_bias=True, target_shape=None):
    """The transposed convolution: output size (in − 1)·stride − 2·pad +
    dilate·(kernel − 1) + adj + 1; with ``target_shape`` the pad is derived
    from it by the reference's rule."""
    n = len(kernel)
    stride = _tuplize(stride, n)
    dilate = _tuplize(dilate, n)
    pad = _tuplize(pad if pad is not None else 0, n)
    adj = _tuplize(adj if adj is not None else 0, n)
    if target_shape:
        keff = [(k - 1) * d + 1 for k, d in zip(kernel, dilate)]
        pad = tuple(((i - 1) * s + ke + a - t) // 2 for i, s, ke, a, t in
                    zip(data.shape[2:], stride, keff, adj, target_shape))
    return _CONV_T[n](data, weight, None if no_bias else bias, stride=stride, padding=pad,
                      output_padding=adj, groups=num_group, dilation=dilate)


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
    group = None if use_global_stats else bn.sync_group()
    if use_global_stats:
        mean, var = moving_mean.float(), moving_var.float()
    elif group is None:
        mean = x32.mean(dim=reduce_axes)
        var = torch.clamp_min((x32 * x32).mean(dim=reduce_axes) - mean * mean, 0.0)
    else:  # every rank's rows (SPMDTrainer at world > 1: ops/bn.py global_batch)
        cnt = x32.numel() // x32.shape[ax] * group.size
        sums = bn.global_sums(torch.stack([x32.sum(dim=reduce_axes),
                                           (x32 * x32).sum(dim=reduce_axes)]), group)
        mean = sums[0] / cnt
        var = torch.clamp_min(sums[1] / cnt - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    out = ((x32 - mean.reshape(bshape)) * (g.float() * inv).reshape(bshape)
           + beta.float().reshape(bshape))
    return out.to(data.dtype), mean, var


batch_norm.reference_calls = 0


@register("UpSampling")
def upsampling(data, scale=2, sample_type="nearest", num_args=1):
    """Nearest or bilinear upsampling of NCHW data by ``scale`` (half-pixel
    centres, as the JAX package resizes).  Nearest is each pixel repeated
    ``scale`` times in H and W, written as a broadcast so that its gradient
    is a sum (deterministic on the card, where ``interpolate``'s backward
    adds with atomics)."""
    if sample_type == "nearest":
        n, c, h, w = data.shape
        s = int(scale)
        return data[:, :, :, None, :, None].expand(n, c, h, s, w, s).reshape(
            n, c, h * s, w * s)
    return F.interpolate(data, scale_factor=scale, mode="bilinear", align_corners=False)


def _steps(data, axis):
    return torch.arange(data.shape[axis], device=data.device)


@register("SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False, value=0.0, axis=0):
    """Positions at or past each sequence's length along the time axis
    (0: [T, B, ...], 1: [B, T, ...]) become ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    rest = (1,) * (data.ndim - 2)
    t = _steps(data, axis)
    if axis == 0:
        mask = t.reshape((-1, 1) + rest) < sequence_length.reshape((1, -1) + rest)
    else:
        mask = t.reshape((1, -1) + rest) < sequence_length.reshape((-1, 1) + rest)
    return torch.where(mask, data, torch.full_like(data, value))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.long() - 1
    if axis == 0:
        return data[last, torch.arange(data.shape[1], device=data.device)]
    return data[torch.arange(data.shape[0], device=data.device), last]


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False, axis=0):
    """Reverse the first ``length`` steps of each sequence along axis 0."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    t = _steps(data, 0).reshape(-1, 1)
    lens = sequence_length.long().reshape(1, -1)
    rev = torch.where(t < lens, lens - 1 - t, t)
    return torch.take_along_dim(data, rev.reshape(rev.shape + (1,) * (data.ndim - 2)), dim=0)
