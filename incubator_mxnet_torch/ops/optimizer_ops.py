"""Optimizer updates (parity: MXNet's ``sgd_update``, ``sgd_mom_update``,
``adam_update`` and their multi-precision ``mp_*`` variants).

Counterpart of the JAX package's ``ops/optimizer_ops.py``, which computes
these in XLA; here they are plain PyTorch, in place: the weight, the
optimizer state and the fp32 master copy are updated where they lie,
under ``torch.no_grad()``, so a step allocates only temporaries.  The
arithmetic follows the JAX package's order, with the scalar
hyperparameters rounded to fp32 as it rounds them.

Gradient clipping honours both no-clip sentinels: MXNet's public ops
clip only when ``clip >= 0`` (its default -1 means none; 0 clamps to
zero), and the optimizers pass +inf for none.

A whole parameter group is updated by ``group_apply`` (the JAX package's
``group_apply``: one jitted dispatch there): one launch of the
hand-written multi-tensor kernel per chunk on the card
(``ops/multi_tensor.py``), the loop of these per-tensor ops
(``group_apply_plain``) on the CPU.  The ``*_step`` adapters name the
variant; the public ``multi_*`` / ``preloaded_multi_*`` ops and the
Trainer's fused step (``optimizer/fused.py``) compose them.  Every op is
registered in ``nd``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import multi_tensor
from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "mp_sgd_update",
           "mp_sgd_mom_update", "mp_adam_update", "sgd_step", "sgd_mom_step", "mp_sgd_step",
           "mp_sgd_mom_step", "adam_step", "mp_adam_step", "group_apply", "group_apply_plain",
           "group_rows",
           "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
           "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
           "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
           "preloaded_multi_mp_sgd_mom_update"]


def _f32(x):
    """A Python float holding ``x`` rounded to fp32, as the JAX package
    passes its hyperparameters."""
    return float(np.float32(x))


def _gclip(g, clip):
    clip = _f32(clip)
    if 0 <= clip < math.inf:
        g = g.clamp(-clip, clip)
    return g


def _prep(grad, rescale, clip, wd, weight):
    g = _gclip(grad.float() * _f32(rescale), clip)
    return g + _f32(wd) * weight.float()


def _adam_moments(g, mean, var, beta1, beta2):
    b1, b2 = np.float32(beta1), np.float32(beta2)
    mean.mul_(float(b1)).add_(float(np.float32(1) - b1) * g)
    var.mul_(float(b2)).add_(float(np.float32(1) - b2) * torch.square(g))


def _adam_lr(lr, beta1, beta2, t):
    """lr · sqrt(1 − beta2^t) / (1 − beta1^t), in fp32."""
    one, t = np.float32(1), np.float32(t)
    coef1 = one - np.float32(beta1) ** t
    coef2 = one - np.float32(beta2) ** t
    return float(np.float32(lr) * np.sqrt(coef2) / coef1)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def sgd_update(weight, grad, lr, wd, rescale, clip):
    g = _prep(grad, rescale, clip, wd, weight)
    weight.copy_(weight.float() - _f32(lr) * g)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, wd, rescale, clip, momentum):
    g = _prep(grad, rescale, clip, wd, weight)
    mom.mul_(_f32(momentum)).sub_(_f32(lr) * g)
    weight.copy_(weight.float() + mom)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, wd, rescale, clip, beta1, beta2, eps, t):
    g = _prep(grad, rescale, clip, wd, weight)
    _adam_moments(g, mean, var, beta1, beta2)
    upd = _adam_lr(lr, beta1, beta2, t) * mean / (torch.sqrt(var) + _f32(eps))
    weight.copy_(weight.float() - upd)


# -- multi-precision: a 16-bit weight with its fp32 master copy ------------


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd, rescale, clip):
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    weight32.sub_(_f32(lr) * g)
    weight.copy_(weight32)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, wd, rescale, clip, momentum):
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    mom.mul_(_f32(momentum)).sub_(_f32(lr) * g)
    weight32.add_(mom)
    weight.copy_(weight32)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def mp_adam_update(weight, grad, mean, var, weight32, lr, wd, rescale, clip, beta1, beta2,
                   eps, t):
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    _adam_moments(g, mean, var, beta1, beta2)
    weight32.sub_(_adam_lr(lr, beta1, beta2, t) * mean / (torch.sqrt(var) + _f32(eps)))
    weight.copy_(weight32)


# -- a whole group: the step adapters and group_apply ------------------------
# An adapter updates one tensor in place with the per-tensor op of its
# variant: ``step(w, g, states, lr, wd, t, S)``, ``states`` the tensor's
# fp32 states in the op's order and ``S`` the group's scalars.  The kernel
# runs the same variant (``step.variant``) over a whole chunk.


def _variant(name):
    def deco(fn):
        fn.variant = name
        return fn
    return deco


@_variant("sgd")
def sgd_step(w, g, st, lr, wd, t, S):
    sgd_update(w, g, lr, wd, S["rescale"], S["clip"])


@_variant("sgd_mom")
def sgd_mom_step(w, g, st, lr, wd, t, S):
    sgd_mom_update(w, g, st[0], lr, wd, S["rescale"], S["clip"], S["momentum"])


@_variant("mp_sgd")
def mp_sgd_step(w, g, st, lr, wd, t, S):
    mp_sgd_update(w, g, st[0], lr, wd, S["rescale"], S["clip"])


@_variant("mp_sgd_mom")
def mp_sgd_mom_step(w, g, st, lr, wd, t, S):
    mp_sgd_mom_update(w, g, st[0], st[1], lr, wd, S["rescale"], S["clip"], S["momentum"])


@_variant("adam")
def adam_step(w, g, st, lr, wd, t, S):
    adam_update(w, g, st[0], st[1], lr, wd, S["rescale"], S["clip"], S["beta1"], S["beta2"],
                S["epsilon"], t)


@_variant("mp_adam")
def mp_adam_step(w, g, st, lr, wd, t, S):
    mp_adam_update(w, g, st[0], st[1], st[2], lr, wd, S["rescale"], S["clip"], S["beta1"],
                   S["beta2"], S["epsilon"], t)


def _host_values(x):
    return x.tolist() if isinstance(x, torch.Tensor) else list(x)


def group_apply_plain(step, weights, grads, states, lrs, wds, ts, scalars):
    """The plain version of :func:`group_apply`: ``step`` on each tensor in
    turn, the per-tensor ops in place."""
    for w, g, st, lr, wd, t in zip(weights, grads, states, _host_values(lrs),
                                   _host_values(wds), ts):
        step(w, g, tuple(st), lr, wd, t, scalars)
    return weights, states


def _rates(step, lrs, ts, scalars):
    """Adam's bias-corrected rate of each tensor, as ``_adam_lr`` computes it
    for the per-tensor op (0 for the SGD variants)."""
    if step.variant not in ("adam", "mp_adam"):
        return [0.0] * len(ts)
    b1, b2, memo = scalars["beta1"], scalars["beta2"], {}
    out = []
    for lr, t in zip(lrs, ts):
        if (lr, t) not in memo:
            memo[lr, t] = _adam_lr(lr, b1, b2, t)
        out.append(memo[lr, t])
    return out


def group_rows(step, lrs, wds, ts, scalars):
    """The fp32 values the multi-tensor kernel reads from device memory
    for a group updated by ``step`` (``multi_tensor.rows``: each chunk's lr,
    wd and Adam rate rows, then the scalars), computed on the host as
    :func:`group_apply` computes them."""
    lrs, wds = _host_values(lrs), _host_values(wds)
    return multi_tensor.rows(lrs, wds, _rates(step, lrs, ts, scalars), scalars)


def group_apply(step, weights, grads, states, lrs, wds, ts, scalars, donate=False, *,
                device_rows=None):
    """Apply a step adapter (``sgd_step`` ... ``mp_adam_step``) to a whole
    parameter group in place.  ``states`` holds each tensor's tuple of fp32
    states, ``lrs``/``wds``/``ts`` one value per tensor (``lrs``/``wds``
    may be tensors, read on the host), ``scalars`` the group's
    hyperparameters (rescale, clip, momentum, beta1, beta2, epsilon).

    On the CPU this is :func:`group_apply_plain`; a CUDA group launches the
    multi-tensor kernel once per chunk of up to 256 tensors
    (``multi_tensor.multi_tensor_update.launches`` counts) or raises.  The
    kernel reads the values from device memory: those of
    :func:`group_rows`, copied there on the launch stream, or, where a
    caller passes ``device_rows`` (a CUDA graph's buffer that it fills
    before each replay), those.  ``donate`` is the reference's: there it
    lets XLA reuse the weight and state buffers; here every group is
    updated in place whatever its value, which is what donation buys.
    Returns ``(weights, states)``, the same tensors, updated."""
    weights = list(weights)
    if not weights:
        return weights, list(states)
    dev = weights[0].device
    if dev.type == "cpu":
        return group_apply_plain(step, weights, grads, states, lrs, wds, ts, scalars)
    if dev.type != "cuda":
        raise ValueError(f"group_apply runs on CPU or CUDA tensors, got {dev}")
    lrs, wds = _host_values(lrs), _host_values(wds)
    return multi_tensor.multi_tensor_update(step.variant, weights, grads,
                                            [tuple(s) for s in states], lrs, wds,
                                            _rates(step, lrs, ts, scalars), scalars,
                                            device_rows=device_rows)


# -- the public grouped ops (MXNet's multi_sgd_update and kin) ---------------
# In place, as the per-tensor ops; each returns the updated tensors as the
# JAX package's ops return their new arrays.  ``clip_gradient`` keeps the
# reference's sentinel: ``< 0`` means no clipping, 0 clamps to zero.


def _sgd_scalars(rescale_grad, clip_gradient, momentum=None):
    S = {"rescale": rescale_grad, "clip": clip_gradient}
    if momentum is not None:
        S["momentum"] = momentum
    return S


@register(differentiable=False, wrap_ndarray=False)
def multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0, clip_gradient=-1.0):
    weights = list(weights)
    group_apply(sgd_step, weights, grads, [()] * len(weights), lrs, wds, [0] * len(weights),
                _sgd_scalars(rescale_grad, clip_gradient))
    return weights


@register(differentiable=False, wrap_ndarray=False)
def multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0):
    weights, moms = list(weights), list(moms)
    group_apply(sgd_mom_step, weights, grads, [(m,) for m in moms], lrs, wds,
                [0] * len(weights), _sgd_scalars(rescale_grad, clip_gradient, momentum))
    return weights, moms


@register(differentiable=False, wrap_ndarray=False)
def multi_mp_sgd_update(weights, grads, weights32, lrs, wds, rescale_grad=1.0,
                        clip_gradient=-1.0):
    weights, weights32 = list(weights), list(weights32)
    group_apply(mp_sgd_step, weights, grads, [(w,) for w in weights32], lrs, wds,
                [0] * len(weights), _sgd_scalars(rescale_grad, clip_gradient))
    return weights, weights32


@register(differentiable=False, wrap_ndarray=False)
def multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs, wds, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0):
    weights, moms, weights32 = list(weights), list(moms), list(weights32)
    group_apply(mp_sgd_mom_step, weights, grads, list(zip(moms, weights32)), lrs, wds,
                [0] * len(weights), _sgd_scalars(rescale_grad, clip_gradient, momentum))
    return weights, moms, weights32


# The preloaded variants take lrs and wds as tensors, one value per weight
# (MXNet keeps them on the device; group_apply reads them on the host).


@register(differentiable=False, wrap_ndarray=False)
def preloaded_multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0, clip_gradient=-1.0):
    return multi_sgd_update(weights, grads, lrs, wds, rescale_grad, clip_gradient)


@register(differentiable=False, wrap_ndarray=False)
def preloaded_multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    return multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum, rescale_grad,
                                clip_gradient)


@register(differentiable=False, wrap_ndarray=False)
def preloaded_multi_mp_sgd_update(weights, grads, weights32, lrs, wds, rescale_grad=1.0,
                                  clip_gradient=-1.0):
    return multi_mp_sgd_update(weights, grads, weights32, lrs, wds, rescale_grad,
                               clip_gradient)


@register(differentiable=False, wrap_ndarray=False)
def preloaded_multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs, wds, momentum=0.0,
                                      rescale_grad=1.0, clip_gradient=-1.0):
    return multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs, wds, momentum,
                                   rescale_grad, clip_gradient)
