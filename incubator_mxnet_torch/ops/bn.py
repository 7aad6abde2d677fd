"""Train-mode BatchNorm over NCHW conv output: the hand-written kernels
(``bn_stats``, ``bn_apply``, ``bn_apply_res``), their plain PyTorch
versions, and the trainable BatchNorm built on them.

Counterpart of the JAX package's ``ops/pallas_bn.py``.  There, two Pallas
passes over the conv output viewed as ``[N, C, HW]`` served an opt-in
route (``MXNET_TPU_PALLAS_BN=1``): ``bn_stats`` reads x once for the fp32
per-channel (Σx, Σx²), ``bn_apply`` computes ``x·scale + shift`` (plus a
residual) with an optional ReLU in one read and one write.  Here the route
has no switch: every train-mode 4-D BatchNorm on axis 1 of a CUDA tensor
launches the port's kernels, ``ops/csrc/bn.cu``; a CPU tensor takes the
plain versions, which the CPU tests hold against the JAX package.  A CUDA
call the kernels cannot take raises; nothing is copied to make it fit.

Gradients: ``trainable_batch_norm`` is a ``torch.autograd.Function`` whose
forward runs the two passes and whose backward recomputes the reference
formula in plain PyTorch and differentiates it, as the JAX package's
``custom_vjp`` differentiates the same formula with XLA.

Across ranks (``SPMDTrainer`` at world > 1, inside :func:`global_batch`):
the JAX package's data-parallel step is one program over the global
batch, so its batch statistics are the global batch's.  Here each rank
holds its own rows: the per-channel (Σx, Σx²) of ``bn_stats`` are summed
over the ranks before ``bn_apply``, the count is the global one, and the
backward's sums go through :class:`_GlobalSum`, whose gradient is summed
over the ranks too.  With no group nothing changes.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from . import _cuda

__all__ = ["bn_stats", "bn_stats_plain", "bn_apply", "bn_apply_res", "bn_apply_plain",
           "fused_bn_relu", "trainable_batch_norm", "batch_norm_reference", "global_batch",
           "sync_group", "global_sums"]

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_sync = threading.local()


@contextlib.contextmanager
def global_batch(group):
    """Within the scope, train-mode BatchNorm in this thread normalizes by
    the statistics of the rows of every rank of ``group`` (an object with
    ``size`` and an in-place summing ``all_reduce(tensor)``, such as a
    ``parallel.Mesh``); None restores the local statistics."""
    prev = getattr(_sync, "group", None)
    _sync.group = group
    try:
        yield group
    finally:
        _sync.group = prev


def sync_group():
    """The group of the innermost :func:`global_batch` scope, or None."""
    return getattr(_sync, "group", None)


class _GlobalSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``; its gradient is the sum
    of the ranks' gradients (each rank's loss is its rows' part of one
    loss over the global batch)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        group.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.group.all_reduce(g)
        return g, None


def global_sums(sums, group):
    """``sums`` summed over ``group``'s ranks, differentiably."""
    return _GlobalSum.apply(sums, group)
# bn_stats splits N into slabs so that C·S blocks fill the card's 132 SMs a
# few times over; a slab keeps at least one row per group of lanes.
_STATS_BLOCKS = 2112
_THREADS = 256


def bn_stats_plain(x):
    """fp32 ``[C, 2]`` of per-channel (Σx, Σx²) over ``[N, C, HW]``."""
    x32 = x.float()
    return torch.stack([x32.sum(dim=(0, 2)), (x32 * x32).sum(dim=(0, 2))], dim=1)


def bn_apply_plain(x, scale, shift, residual=None, relu=True):
    """``relu?(x·scale[c] + shift[c] [+ residual])`` over ``[N, C, HW]`` in
    fp32, returned in x's dtype."""
    y = x.float() * scale.float()[None, :, None] + shift.float()[None, :, None]
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check_x(fn, x):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: dtype must be float32, float16 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{fn}: x must be 3-D [N, C, HW], got {tuple(x.shape)}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError(f"{fn}: x needs unit stride on HW, got strides {x.stride()}")
    if max(x.shape) >= 2 ** 31:
        raise ValueError(f"{fn}: x of shape {tuple(x.shape)} has a dimension of 2**31 or more")


def _check_channel_vector(fn, name, v, x):
    if (v.dtype != torch.float32 or v.device != x.device or tuple(v.shape) != (x.shape[1],)
            or (v.shape[0] > 1 and v.stride(0) != 1)):
        raise ValueError(f"{fn}: {name} must be a contiguous fp32 [C] = [{x.shape[1]}] "
                         f"on {x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def _stats_slabs(n, c, hw, elem):
    groups = _THREADS // (8 if hw * elem <= 512 else 32)
    return max(1, min(-(-_STATS_BLOCKS // c), n // groups))


def _lib():
    lib = _cuda.load("bn")
    if lib.mx_bn_stats.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mx_bn_stats.argtypes = [i, ptr, ptr, ptr, i, i, i, ll, ll, i, ptr]
        lib.mx_bn_apply.argtypes = [i, ptr, ptr, ptr, ptr, i, i, i, ll, ll, ll, ll, i, ptr]
        lib.mx_bn_apply_res.argtypes = [i, ptr, ptr, ptr, ptr, ptr, i, i, i, ll, ll, ll, ll, i,
                                        ptr]
        for fn in (lib.mx_bn_stats, lib.mx_bn_apply, lib.mx_bn_apply_res):
            fn.restype = ctypes.c_int
    return lib


def _device_of(fn, x):
    """"cpu" for a tensor that takes the plain version (a CPU tensor, or a
    meta tensor in shape inference, which holds no data), "cuda" for one
    that launches the kernel; any other device raises."""
    if x.device.type == "meta":
        return "cpu"
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on CPU or CUDA tensors, got {x.device}")
    return x.device.type


def bn_stats(x):
    """Per-channel fp32 (Σx, Σx²) of ``x`` ``[N, C, HW]`` (any N and C
    strides, unit stride on HW) in one read: fp32 ``[C, 2]``.

    A CPU tensor takes :func:`bn_stats_plain`; a CUDA tensor launches the
    kernel (``bn_stats.launches`` counts the launches) or raises.  The sums
    are deterministic: the same input gives bit-identical sums."""
    if _device_of("bn_stats", x) == "cpu":
        return bn_stats_plain(x)
    _check_x("bn_stats", x)
    n, c, hw = x.shape
    out = torch.empty(c, 2, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out.zero_()
    s = _stats_slabs(n, c, hw, x.element_size())
    part = out if s == 1 else torch.empty(c * s * 2, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().mx_bn_stats(_DTYPE_CODE[x.dtype], x.data_ptr(), part.data_ptr(),
                                out.data_ptr(), n, c, hw, x.stride(0), x.stride(1), s,
                                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_stats launch failed with CUDA error {rc}")
    bn_stats.launches += 1
    return out


bn_stats.launches = 0


def _apply_launch(fn, x, scale, shift, residual, relu):
    _check_x(fn, x)
    _check_channel_vector(fn, "scale", scale, x)
    _check_channel_vector(fn, "shift", shift, x)
    if residual is not None and (residual.device != x.device or residual.dtype != x.dtype
                                 or residual.shape != x.shape
                                 or residual.stride() != x.stride()):
        raise ValueError(f"{fn}: residual must match x's device, dtype, shape and strides; "
                         f"got {residual.dtype} {tuple(residual.shape)} {residual.stride()} "
                         f"on {residual.device} for x {x.dtype} {tuple(x.shape)} "
                         f"{x.stride()} on {x.device}")
    n, c, hw = x.shape
    out = torch.empty(n, c, hw, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out, False
    common = (n, c, hw, x.stride(0), x.stride(1), out.stride(0), out.stride(1), int(bool(relu)),
              torch.cuda.current_stream(x.device).cuda_stream)
    lib = _lib()
    with torch.cuda.device(x.device):
        if residual is None:
            rc = lib.mx_bn_apply(_DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
                                 shift.data_ptr(), out.data_ptr(), *common)
        else:
            rc = lib.mx_bn_apply_res(_DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
                                     shift.data_ptr(), residual.data_ptr(), out.data_ptr(),
                                     *common)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {rc}")
    return out, True


def bn_apply(x, scale, shift, residual=None, relu=True):
    """One pass ``relu?(x·scale + shift [+ residual])`` over ``x``
    ``[N, C, HW]`` with fp32 per-channel ``scale``/``shift`` ``[C]``; the
    output is a new contiguous ``[N, C, HW]`` in x's dtype.  With a
    residual this is :func:`bn_apply_res`.

    A CPU tensor takes :func:`bn_apply_plain`; a CUDA tensor launches the
    kernel (``bn_apply.launches`` counts the launches) or raises."""
    if residual is not None:
        return bn_apply_res(x, scale, shift, residual, relu)
    if _device_of("bn_apply", x) == "cpu":
        return bn_apply_plain(x, scale, shift, None, relu)
    out, launched = _apply_launch("bn_apply", x, scale, shift, None, relu)
    bn_apply.launches += launched
    return out


def bn_apply_res(x, scale, shift, residual, relu=True):
    """:func:`bn_apply` with ``residual`` (x's shape, dtype and strides)
    added before the ReLU; ``bn_apply_res.launches`` counts the launches."""
    if _device_of("bn_apply_res", x) == "cpu":
        return bn_apply_plain(x, scale, shift, residual, relu)
    out, launched = _apply_launch("bn_apply_res", x, scale, shift, residual, relu)
    bn_apply_res.launches += launched
    return out


bn_apply.launches = 0
bn_apply_res.launches = 0


def _as_rows(x_nchw):
    """The ``[N, C, H·W]`` form of an NCHW tensor: on the card a free view
    (the kernels read strides and are never handed a copy), on the CPU any
    reshape."""
    n, c, h, w = x_nchw.shape
    if x_nchw.device.type == "cuda":
        return x_nchw.view(n, c, h * w)
    return x_nchw.reshape(n, c, h * w)


def fused_bn_relu(x_nchw, gamma, beta, eps=1e-5, residual=None, relu=True, group=None):
    """Train-mode BatchNorm (+residual, +ReLU) over NCHW conv output through
    the two passes: returns ``(out, batch_mean, batch_var)``, out in x's
    dtype, mean and var fp32 with var = max(E[x²] − E[x]², 0) (biased).
    With ``group`` the statistics are those of every rank's rows."""
    n, c, h, w = x_nchw.shape
    x = _as_rows(x_nchw)
    stats = bn_stats(x)
    cnt = float(n * h * w)
    if group is not None:
        group.all_reduce(stats)
        cnt *= group.size
    mean = stats[:, 0] / cnt
    var = torch.clamp_min(stats[:, 1] / cnt - mean * mean, 0.0)
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    res = None if residual is None else _as_rows(residual)
    out = bn_apply(x, scale, shift, residual=res, relu=relu)
    return out.view(n, c, h, w), mean, var


def batch_norm_reference(x, gamma, beta, eps=1e-5, group=None):
    """The reference formula over NCHW: fp32 one-pass statistics, out in x's
    dtype; returns ``(out, mean, var)``.  Differentiable.  With ``group``
    the statistics are those of every rank's rows."""
    x32 = x.float()
    axes = (0, 2, 3)
    if group is None:
        mean = x32.mean(dim=axes)
        var = torch.clamp_min((x32 * x32).mean(dim=axes) - mean * mean, 0.0)
    else:
        cnt = x32.numel() // x32.shape[1] * group.size
        sums = global_sums(torch.stack([x32.sum(dim=axes), (x32 * x32).sum(dim=axes)]), group)
        mean = sums[0] / cnt
        var = torch.clamp_min(sums[1] / cnt - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps) * gamma.float()
    out = ((x32 - mean[None, :, None, None]) * inv[None, :, None, None]
           + beta.float()[None, :, None, None])
    return out.to(x.dtype), mean, var


class _TrainableBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        out, mean, var = fused_bn_relu(x, gamma, beta, eps=eps, relu=False, group=group)
        ctx.eps, ctx.group = eps, group
        ctx.save_for_backward(x, gamma, beta)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        with torch.profiler.record_function("mx.bn_backward"):
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            with torch.enable_grad():
                outs = batch_norm_reference(*inputs, eps=ctx.eps, group=ctx.group)
                pairs = [(o, g) for o, g in zip(outs, (dout, dmean, dvar)) if o.requires_grad]
                torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
            return tuple(t.grad for t in inputs) + (None, None)


def trainable_batch_norm(x_nchw, gamma, beta, eps=1e-5):
    """Train-mode NCHW BatchNorm: the two kernels forward (the plain versions
    on the CPU), the reference formula's gradient backward.  Returns
    ``(out, batch_mean, batch_var)``, each differentiable in x, gamma and
    beta; inside :func:`global_batch` over every rank's rows."""
    return _TrainableBN.apply(x_nchw, gamma, beta, float(eps), sync_group())
