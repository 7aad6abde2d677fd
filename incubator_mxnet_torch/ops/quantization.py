"""INT8 quantization operators: ``quantize_v2``, ``dequantize``,
``requantize``, ``quantized_fully_connected``, ``quantized_conv`` and the
legacy ``quantize``.

Counterpart of the JAX package's ``ops/quantization.py``: symmetric signed
int8 (scale max|range| / 127, zero point 0), ranges carried beside the
tensors as one-element (min, max) arrays, rounding half to even and a clip
to ±127.  The compute ops multiply int8 by int8 into exact int32 sums and
return float32 (the sums times the two scales, plus a float bias).  Every
division is by a tensor, IEEE-rounded on every device (PyTorch's CUDA
division by a Python number multiplies by its reciprocal, which can move a
rounding to int8).

The int32 sums (``int_matmul``): on a CUDA tensor ``torch._int_mm``, the
int8 GEMM of cuBLAS with int32 out, over zero padding to its shape rules
(more than 16 rows, the other two sizes multiples of 8; zero rows and
columns add nothing); a convolution is that product over its im2col,
unfolded in fp16, which holds every int8 value exactly.  On the CPU the
plain version, ``int_matmul_plain``: the same product in float64, exact
while a sum stays below 2^53 (K · 127² does at every layer's K).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import _tuplize
from .registry import register

__all__ = ["quantize_v2", "dequantize", "requantize", "quantized_fully_connected",
           "quantized_conv", "quantize", "int_matmul", "int_matmul_plain", "int_conv",
           "int_conv_plain"]


def _scale_from_range(min_r, max_r):
    amax = torch.maximum(min_r.abs(), max_r.abs())
    return torch.where(amax > 0, amax / amax.new_tensor(127.0), torch.ones_like(amax))


def _range(value, like):
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


def _to_int8(x, scale):
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


@register("quantize_v2")
def quantize_v2(data, min_calib_range=None, max_calib_range=None, out_type="int8"):
    """float → (int8, min_range, max_range): the calibrated range when one
    is given, else the tensor's own min/max (each widened to hold 0)."""
    if out_type != "int8":
        raise NotImplementedError("quantize_v2 quantizes to int8 (symmetric)")
    x = data.float()
    if min_calib_range is None or max_calib_range is None:
        min_r = torch.minimum(x.min(), _range(0.0, x))
        max_r = torch.maximum(x.max(), _range(0.0, x))
    else:
        min_r, max_r = _range(min_calib_range, x), _range(max_calib_range, x)
    return _to_int8(x, _scale_from_range(min_r, max_r)), min_r.reshape(1), max_r.reshape(1)


@register("dequantize")
def dequantize(data, min_range, max_range, out_type="float32"):
    return data.float() * _scale_from_range(min_range.reshape(()), max_range.reshape(()))


@register("requantize")
def requantize(data, min_range, max_range, min_calib_range=None, max_calib_range=None):
    """int32 sums → int8 with a new range (given, or the values' own)."""
    real = data.float() * _scale_from_range(min_range.reshape(()), max_range.reshape(()))
    if min_calib_range is None or max_calib_range is None:
        min_r = torch.minimum(real.min(), _range(0.0, real))
        max_r = torch.maximum(real.max(), _range(0.0, real))
    else:
        min_r, max_r = _range(min_calib_range, real), _range(max_calib_range, real)
    return _to_int8(real, _scale_from_range(min_r, max_r)), min_r.reshape(1), max_r.reshape(1)


# -- exact int32 sums -------------------------------------------------------------------


def int_matmul_plain(a, w):
    """``a`` [M, K] · ``w`` [N, K]ᵀ in int32, through float64 (exact)."""
    return torch.matmul(a.double(), w.double().t()).to(torch.int32)


def _pad_to(x, dim, size):
    if x.shape[dim] >= size:
        return x
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - dim) + 1] = size - x.shape[dim]
    return F.pad(x, pad)


def int_matmul(a, w):
    """``a`` [M, K] int8 · ``w`` [N, K]ᵀ int8 → int32 [M, N], exact: on a
    CUDA tensor ``torch._int_mm`` over zero padding, on the CPU
    :func:`int_matmul_plain`."""
    if a.device.type != "cuda":
        return int_matmul_plain(a, w)
    m, k = a.shape
    n = w.shape[0]
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_to(_pad_to(a, 1, k8), 0, max(m, 17)).contiguous()
    w = _pad_to(_pad_to(w, 1, k8), 0, n8).contiguous()
    return torch._int_mm(a, w.t())[:m, :n]


def _columns(data, kernel, stride, dilate, pad):
    """im2col rows [B·L, C·kh·kw] of int8 ``data`` (unfolded in fp16, which
    holds every int8 value), and (Ho, Wo)."""
    cols = F.unfold(data.half(), kernel, dilation=dilate, padding=pad, stride=stride)
    b, k, l = cols.shape
    h, w = data.shape[2:]
    ho = (h + 2 * pad[0] - dilate[0] * (kernel[0] - 1) - 1) // stride[0] + 1
    wo = (w + 2 * pad[1] - dilate[1] * (kernel[1] - 1) - 1) // stride[1] + 1
    return cols.transpose(1, 2).reshape(b * l, k).to(torch.int8), (ho, wo)


def _conv_sums(data, weight, stride, dilate, pad, groups):
    b, o = data.shape[0], weight.shape[0]
    kernel = tuple(weight.shape[2:])
    cg, og = data.shape[1] // groups, o // groups
    outs = []
    for g in range(groups):
        cols, (ho, wo) = _columns(data[:, g * cg:(g + 1) * cg], kernel, stride, dilate, pad)
        outs.append(int_matmul(cols, weight[g * og:(g + 1) * og].reshape(og, -1)))
    acc = torch.cat(outs, 1) if groups > 1 else outs[0]
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def int_conv_plain(data, weight, stride, dilate, pad, groups=1):
    """The int32 sums of an int8 2-D convolution through float64 (exact)."""
    return F.conv2d(data.double(), weight.double(), stride=stride, padding=pad,
                    dilation=dilate, groups=groups).to(torch.int32)


def int_conv(data, weight, stride, dilate, pad, groups=1):
    """The int32 sums of an int8 2-D convolution [B, O, Ho, Wo], exact: on
    a CUDA tensor im2col (fp16) and :func:`int_matmul`, on the CPU
    :func:`int_conv_plain`."""
    if data.device.type != "cuda":
        return int_conv_plain(data, weight, stride, dilate, pad, groups)
    return _conv_sums(data, weight, stride, dilate, pad, groups).contiguous()


def _out_scale(min_data, max_data, min_weight, max_weight):
    return (_scale_from_range(min_data.reshape(()), max_data.reshape(()))
            * _scale_from_range(min_weight.reshape(()), max_weight.reshape(())))


@register("quantized_fully_connected")
def quantized_fully_connected(data, weight, bias,
                              min_data, max_data, min_weight, max_weight,
                              num_hidden=0, no_bias=False, flatten=True):
    """int8 × int8 fully connected, exact int32 sums, float32 out (the sums
    times both scales, plus the float bias)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    acc = int_matmul(data.reshape(-1, data.shape[-1]), weight).reshape(*lead, -1)
    out = acc.float() * _out_scale(min_data, max_data, min_weight, max_weight)
    if bias is not None and not no_bias:
        out = out + bias.float()
    return out


@register("quantized_conv")
def quantized_conv(data, weight, bias,
                   min_data, max_data, min_weight, max_weight,
                   kernel=(1, 1), stride=None, dilate=None, pad=None,
                   num_filter=0, num_group=1, no_bias=False, layout=None):
    """int8 NCHW convolution, exact int32 sums, float32 out."""
    n = len(kernel)
    if n != 2:
        raise NotImplementedError("quantized_conv takes 2-D convolutions")
    acc = int_conv(data, weight, _tuplize(stride, n), _tuplize(dilate, n),
                   _tuplize(pad if pad is not None else 0, n), int(num_group))
    out = acc.float() * _out_scale(min_data, max_data, min_weight, max_weight)
    if bias is not None and not no_bias:
        out = out + bias.float().reshape((1, -1) + (1,) * n)
    return out


@register("quantize")
def quantize(data, min_range, max_range, out_type="uint8"):
    """Explicit-range quantize: uint8 affine over [min, max], int8
    symmetric over max(|min|, |max|).  Returns (q, min, max)."""
    x = data.float()
    min_r = torch.as_tensor(min_range, dtype=torch.float32, device=x.device).reshape(())
    max_r = torch.as_tensor(max_range, dtype=torch.float32, device=x.device).reshape(())
    if out_type == "uint8":
        scale = torch.where(max_r > min_r, max_r.new_tensor(255.0) / (max_r - min_r),
                            torch.ones_like(max_r))
        q = torch.round((torch.minimum(torch.maximum(x, min_r), max_r) - min_r) * scale)
        q = q.clamp(0, 255).to(torch.uint8)
    elif out_type == "int8":
        scale = max_r.new_tensor(127.0) / torch.maximum(
            torch.maximum(min_r.abs(), max_r.abs()), max_r.new_tensor(1e-30))
        q = torch.round(x * scale).clamp(-127, 127).to(torch.int8)
    else:
        raise NotImplementedError(f"quantize out_type {out_type!r}")
    return q, min_r.reshape(1), max_r.reshape(1)
