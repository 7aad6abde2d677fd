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
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "mp_sgd_update",
           "mp_sgd_mom_update", "mp_adam_update"]


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


@torch.no_grad()
def sgd_update(weight, grad, lr, wd, rescale, clip):
    g = _prep(grad, rescale, clip, wd, weight)
    weight.copy_(weight.float() - _f32(lr) * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, wd, rescale, clip, momentum):
    g = _prep(grad, rescale, clip, wd, weight)
    mom.mul_(_f32(momentum)).sub_(_f32(lr) * g)
    weight.copy_(weight.float() + mom)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, wd, rescale, clip, beta1, beta2, eps, t):
    g = _prep(grad, rescale, clip, wd, weight)
    _adam_moments(g, mean, var, beta1, beta2)
    upd = _adam_lr(lr, beta1, beta2, t) * mean / (torch.sqrt(var) + _f32(eps))
    weight.copy_(weight.float() - upd)


# -- multi-precision: a 16-bit weight with its fp32 master copy ------------


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd, rescale, clip):
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    weight32.sub_(_f32(lr) * g)
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, wd, rescale, clip, momentum):
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    mom.mul_(_f32(momentum)).sub_(_f32(lr) * g)
    weight32.add_(mom)
    weight.copy_(weight32)


@torch.no_grad()
def mp_adam_update(weight, grad, mean, var, weight32, lr, wd, rescale, clip, beta1, beta2,
                   eps, t):
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    _adam_moments(g, mean, var, beta1, beta2)
    weight32.sub_(_adam_lr(lr, beta1, beta2, t) * mean / (torch.sqrt(var) + _f32(eps)))
    weight.copy_(weight32)
