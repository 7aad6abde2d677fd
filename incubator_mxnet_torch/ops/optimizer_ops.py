"""Optimizer updates (parity: MXNet's ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``nag_mom_update``, ``adamw_update``, ``rmsprop_update``,
``lamb_update_phase1``/``phase2`` and the rest of the JAX package's update
ops, their multi-precision ``mp_*`` and lazy variants, and the grouped
``multi_*`` ops).

Counterpart of the JAX package's ``ops/optimizer_ops.py``, which computes
these in XLA; here they are plain PyTorch, in place: the weight, the
optimizer state and the fp32 master copy are updated where they lie,
under ``torch.no_grad()``, so a step allocates only temporaries.  The
arithmetic follows the JAX package's order, with the scalar
hyperparameters rounded to fp32 as it rounds them.

Gradient clipping honours both no-clip sentinels: MXNet's public ops
clip only when ``clip >= 0`` (its default -1 means none; 0 clamps to
zero), and the optimizers pass +inf for none.  An op that the JAX
package writes as a division by a per-tensor scalar which the
multi-tensor kernel must match bit for bit (AdamW's bias corrections)
multiplies by its fp32 reciprocal instead, which PyTorch computes the
same way on the CPU and the card; the others divide, as the JAX package
does.  The ``*_lazy_update`` ops keep rows whose gradient is all zero as
they are (the JAX package's dense stand-in for row_sparse gradients).

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
           "mp_sgd_mom_update", "mp_adam_update", "sgd_lazy_update", "sgd_mom_lazy_update",
           "mp_sgd_mom_lazy_update", "adam_lazy_update", "nag_mom_update", "mp_nag_mom_update",
           "adamw_update", "rmsprop_update", "rmspropalex_update", "adagrad_update",
           "adadelta_update", "ftrl_update", "signum_update", "lamb_update_phase1",
           "lamb_update_phase2", "nadam_update", "ftml_update", "sgld_update", "dcasgd_update",
           "adamax_update", "group_adagrad_update", "multi_sum_sq", "multi_lars", "all_finite",
           "sgd_step", "sgd_mom_step", "mp_sgd_step",
           "mp_sgd_mom_step", "adam_step", "mp_adam_step", "nag_mom_step", "mp_nag_mom_step",
           "adamw_step", "rmsprop_step", "rmspropalex_step", "lamb_step", "group_apply",
           "group_apply_plain", "group_rows",
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


# -- lazy updates: rows whose gradient is all zero stay as they are ------------


def _row_active(grad):
    """Mask of the rows the gradient touches (any non-zero element), shaped
    to broadcast over the row; a 1-D gradient's rows are its elements."""
    nz = grad != 0
    if grad.dim() > 1:
        nz = nz.flatten(1).any(1).reshape((-1,) + (1,) * (grad.dim() - 1))
    return nz


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def sgd_lazy_update(weight, grad, lr, wd, rescale, clip):
    a = _row_active(grad)
    g = _prep(grad, rescale, clip, wd, weight)
    new_w = (weight.float() - _f32(lr) * g).to(weight.dtype)
    weight.copy_(torch.where(a, new_w, weight))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def sgd_mom_lazy_update(weight, grad, mom, lr, wd, rescale, clip, momentum):
    a = _row_active(grad)
    g = _prep(grad, rescale, clip, wd, weight)
    new_mom = _f32(momentum) * mom - _f32(lr) * g
    new_w = (weight.float() + new_mom).to(weight.dtype)
    weight.copy_(torch.where(a, new_w, weight))
    mom.copy_(torch.where(a, new_mom, mom))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def mp_sgd_mom_lazy_update(weight, grad, mom, weight32, lr, wd, rescale, clip, momentum):
    a = _row_active(grad)
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    new_mom = _f32(momentum) * mom - _f32(lr) * g
    new_w32 = weight32 + new_mom
    weight.copy_(torch.where(a, new_w32.to(weight.dtype), weight))
    mom.copy_(torch.where(a, new_mom, mom))
    weight32.copy_(torch.where(a, new_w32, weight32))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def adam_lazy_update(weight, grad, mean, var, lr, wd, rescale, clip, beta1, beta2, eps, t):
    a = _row_active(grad)
    g = _prep(grad, rescale, clip, wd, weight)
    b1, b2 = np.float32(beta1), np.float32(beta2)
    new_mean = float(b1) * mean + float(np.float32(1) - b1) * g
    new_var = float(b2) * var + float(np.float32(1) - b2) * torch.square(g)
    upd = _adam_lr(lr, beta1, beta2, t) * new_mean / (torch.sqrt(new_var) + _f32(eps))
    weight.copy_(torch.where(a, (weight.float() - upd).to(weight.dtype), weight))
    mean.copy_(torch.where(a, new_mean, mean))
    var.copy_(torch.where(a, new_var, var))


# -- the other update ops of the JAX package ---------------------------------


def _one_minus(x):
    return float(np.float32(1) - np.float32(x))


def _bias(beta, t):
    """1 − beta^t in fp32."""
    return np.float32(1) - np.float32(beta) ** np.float32(t)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr, wd, rescale, clip, momentum):
    g = _prep(grad, rescale, clip, wd, weight)
    m = _f32(momentum)
    mom.mul_(m).add_(g)
    weight.copy_(weight.float() - _f32(lr) * (m * mom + g))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def mp_nag_mom_update(weight, grad, mom, weight32, lr, wd, rescale, clip, momentum):
    g = _gclip(grad.float() * _f32(rescale), clip) + _f32(wd) * weight32
    m = _f32(momentum)
    mom.mul_(m).add_(g)
    weight32.sub_(_f32(lr) * (m * mom + g))
    weight.copy_(weight32)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr, wd, eta, rescale, clip, beta1, beta2, eps, t):
    w32 = weight.float()
    g = _gclip(grad.float() * _f32(rescale), clip)
    _adam_moments(g, mean, var, beta1, beta2)
    inv1, inv2 = (float(np.float32(1) / _bias(b, t)) for b in (beta1, beta2))
    upd = (mean * inv1) / (torch.sqrt(var * inv2) + _f32(eps)) + _f32(wd) * w32
    weight.copy_(w32 - float(np.float32(eta) * np.float32(lr)) * upd)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def rmsprop_update(weight, grad, n, lr, wd, rescale, clip, rho, eps):
    g = _prep(grad, rescale, clip, wd, weight)
    n.mul_(_f32(rho)).add_(_one_minus(rho) * torch.square(g))
    weight.copy_(weight.float() - _f32(lr) * g / torch.sqrt(n + _f32(eps)))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_avg, delta, lr, wd, rescale, clip, rho, momentum,
                       eps):
    g = _prep(grad, rescale, clip, wd, weight)
    r, c = _f32(rho), _one_minus(rho)
    n.mul_(r).add_(c * torch.square(g))
    g_avg.mul_(r).add_(c * g)
    delta.mul_(_f32(momentum)).sub_(
        _f32(lr) * g / torch.sqrt(n - torch.square(g_avg) + _f32(eps)))
    weight.copy_(weight.float() + delta)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def adagrad_update(weight, grad, history, lr, wd, rescale, clip, eps):
    g = _prep(grad, rescale, clip, wd, weight)
    history.add_(torch.square(g))
    weight.copy_(weight.float() - _f32(lr) * g / (torch.sqrt(history) + _f32(eps)))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def adadelta_update(weight, grad, acc_g, acc_delta, wd, rescale, clip, rho, eps):
    g = _prep(grad, rescale, clip, wd, weight)
    r, c, e = _f32(rho), _one_minus(rho), _f32(eps)
    acc_g.mul_(r).add_(c * torch.square(g))
    delta = torch.sqrt(acc_delta + e) / torch.sqrt(acc_g + e) * g
    acc_delta.mul_(r).add_(c * torch.square(delta))
    weight.copy_(weight.float() - delta)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr, wd, rescale, clip, lamda1, beta):
    g = _gclip(grad.float() * _f32(rescale), clip)
    w32 = weight.float()
    lr, l1 = _f32(lr), _f32(lamda1)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    z.add_(g).sub_(sigma * w32)
    new_w = torch.where(z.abs() <= l1, torch.zeros_like(z),
                        -(z - torch.sign(z) * l1)
                        / ((_f32(beta) + torch.sqrt(new_n)) / lr + _f32(wd)))
    n.copy_(new_n)
    weight.copy_(new_w)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def signum_update(weight, grad, mom, lr, wd, rescale, clip, momentum, wd_lh):
    g = _gclip(grad.float() * _f32(rescale), clip)
    w32 = weight.float()
    mom.mul_(_f32(momentum)).sub_(_one_minus(momentum) * (g + _f32(wd) * w32))
    keep = float(np.float32(1) - np.float32(lr) * np.float32(wd_lh))
    weight.copy_(keep * w32 + _f32(lr) * torch.sign(mom))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, wd, rescale, clip, beta1, beta2, eps, t,
                       bias_correction):
    """LAMB's moments, in place, and its direction r (returned, fp32)."""
    g = _gclip(grad.float() * _f32(rescale), clip)
    _adam_moments(g, mean, var, beta1, beta2)
    m, v = mean, var
    if bias_correction:
        m, v = mean / float(_bias(beta1, t)), var / float(_bias(beta2, t))
    return m / (torch.sqrt(v) + _f32(eps)) + _f32(wd) * weight.float()


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def lamb_update_phase2(weight, r, lr, lower_bound, upper_bound):
    """LAMB's layerwise trust ratio ‖w‖/‖r‖ (1 where either norm is 0,
    clipped to [lower_bound, upper_bound]) and the weight, in place."""
    w32 = weight.float()
    w_norm = torch.linalg.vector_norm(w32)
    r_norm = torch.linalg.vector_norm(r)
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    ratio = ratio.clamp(_f32(lower_bound), _f32(upper_bound))
    weight.copy_(w32 - (_f32(lr) * ratio) * r)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def nadam_update(weight, grad, mean, var, m_schedule, lr, wd, rescale, clip, beta1, beta2, eps,
                 t, schedule_decay):
    """Nesterov Adam; ``m_schedule`` is the 0-d fp32 state holding the
    running product of the momentum schedule, updated in place."""
    g = _prep(grad, rescale, clip, wd, weight)
    f = np.float32
    b1, t, sd = f(beta1), f(t), f(schedule_decay)
    m_t = b1 * (f(1) - f(0.5) * f(0.96) ** (t * sd))
    m_t1 = b1 * (f(1) - f(0.5) * f(0.96) ** ((t + f(1)) * sd))
    new_schedule = m_schedule * float(m_t)
    schedule_next = new_schedule * float(m_t1)
    _adam_moments(g, mean, var, beta1, beta2)
    g_hat = g / (1.0 - new_schedule)
    m_hat = mean / (1.0 - schedule_next)
    v_hat = var / float(_bias(beta2, t))
    upd = _f32(lr) * (float(f(1) - m_t) * g_hat + float(m_t1) * m_hat) / (
        torch.sqrt(v_hat) + _f32(eps))
    m_schedule.copy_(new_schedule)
    weight.copy_(weight.float() - upd)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def ftml_update(weight, grad, d, v, z, lr, wd, rescale, clip, beta1, beta2, eps, t):
    g = _prep(grad, rescale, clip, wd, weight)
    b1, b2 = _f32(beta1), _f32(beta2)
    v.mul_(b2).add_(_one_minus(beta2) * torch.square(g))
    d_t = float(_bias(beta1, t) / np.float32(lr)) * (
        torch.sqrt(v / float(_bias(beta2, t))) + _f32(eps))
    sigma = d_t - b1 * d
    z.mul_(b1).add_(_one_minus(beta1) * g).sub_(sigma * weight.float())
    d.copy_(d_t)
    weight.copy_(-z / d_t)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def sgld_update(weight, grad, lr, wd, rescale, clip, noise):
    """SGD plus N(0, lr) noise; ``noise`` (standard normal, the weight's
    shape) is an argument, as in the JAX package."""
    g = _prep(grad, rescale, clip, wd, weight)
    lr32 = np.float32(lr)
    weight.copy_(weight.float() - float(np.float32(0.5) * lr32) * g
                 + float(np.sqrt(lr32)) * noise.float())


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def dcasgd_update(weight, grad, mom, prev_weight, lr, wd, rescale, clip, momentum, lamda):
    """Delay-compensated SGD; ``prev_weight`` (fp32) becomes the new
    weight."""
    g = _gclip(grad.float() * _f32(rescale), clip)
    w32 = weight.float()
    comp = g + _f32(wd) * w32 + _f32(lamda) * torch.square(g) * (w32 - prev_weight)
    mom.mul_(_f32(momentum)).sub_(_f32(lr) * comp)
    prev_weight.copy_(w32 + mom)
    weight.copy_(prev_weight)


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def adamax_update(weight, grad, mean, inf_norm, lr, wd, rescale, clip, beta1, beta2):
    g = _prep(grad, rescale, clip, wd, weight)
    mean.mul_(_f32(beta1)).add_(_one_minus(beta1) * g)
    torch.maximum(_f32(beta2) * inf_norm, g.abs(), out=inf_norm)
    weight.copy_(weight.float() - _f32(lr) * mean / (inf_norm + _f32(1e-8)))


@register(differentiable=False, wrap_ndarray=False)
@torch.no_grad()
def group_adagrad_update(weight, grad, history, lr, rescale, clip, eps):
    """AdaGrad with one statistic a row: ``history`` has the weight's first
    dimension and ones after it."""
    g = _gclip(grad.float() * _f32(rescale), clip)
    sq = torch.square(g)
    if g.dim() > 1:
        sq = sq.mean(dim=tuple(range(1, g.dim())), keepdim=True)
    history.add_(sq)
    weight.copy_(weight.float() - _f32(lr) * g / (torch.sqrt(history) + _f32(eps)))


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


@_variant("nag_mom")
def nag_mom_step(w, g, st, lr, wd, t, S):
    nag_mom_update(w, g, st[0], lr, wd, S["rescale"], S["clip"], S["momentum"])


@_variant("mp_nag_mom")
def mp_nag_mom_step(w, g, st, lr, wd, t, S):
    mp_nag_mom_update(w, g, st[0], st[1], lr, wd, S["rescale"], S["clip"], S["momentum"])


@_variant("adamw")
def adamw_step(w, g, st, lr, wd, t, S):
    adamw_update(w, g, st[0], st[1], lr, wd, S["eta"], S["rescale"], S["clip"], S["beta1"],
                 S["beta2"], S["epsilon"], t)


@_variant("rmsprop")
def rmsprop_step(w, g, st, lr, wd, t, S):
    rmsprop_update(w, g, st[0], lr, wd, S["rescale"], S["clip"], S["rho"], S["epsilon"])


@_variant("rmspropalex")
def rmspropalex_step(w, g, st, lr, wd, t, S):
    rmspropalex_update(w, g, st[0], st[1], st[2], lr, wd, S["rescale"], S["clip"], S["rho"],
                       S["momentum"], S["epsilon"])


@_variant("lamb")
def lamb_step(w, g, st, lr, wd, t, S):
    """LAMB in a group: phase 1, then phase 2 with this tensor's own trust
    ratio, as the per-tensor path computes it."""
    r = lamb_update_phase1(w, g, st[0], st[1], wd, S["rescale"], S["clip"], S["beta1"],
                           S["beta2"], S["epsilon"], t, S["bias_correction"] != 0)
    lamb_update_phase2(w, r, lr, S["lower_bound"], S["upper_bound"])


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
    """The per-tensor coefficients (c1, c2) the kernel reads beside lr and
    wd, each a list: Adam's bias-corrected rate as ``_adam_lr`` computes it
    for the per-tensor op (c1); AdamW's fp32 reciprocals of 1 − β1^t and
    1 − β2^t, as ``adamw_update`` multiplies by them; LAMB's 1 − β1^t and
    1 − β2^t (1 without bias correction); zeros for the other variants."""
    v = step.variant
    zeros = [0.0] * len(ts)
    if v in ("adam", "mp_adam"):
        b1, b2, memo = scalars["beta1"], scalars["beta2"], {}
        out = []
        for lr, t in zip(lrs, ts):
            if (lr, t) not in memo:
                memo[lr, t] = _adam_lr(lr, b1, b2, t)
            out.append(memo[lr, t])
        return out, zeros
    if v == "adamw":
        return ([float(np.float32(1) / _bias(scalars["beta1"], t)) for t in ts],
                [float(np.float32(1) / _bias(scalars["beta2"], t)) for t in ts])
    if v == "lamb":
        if scalars["bias_correction"] == 0:
            return [1.0] * len(ts), [1.0] * len(ts)
        return ([float(_bias(scalars["beta1"], t)) for t in ts],
                [float(_bias(scalars["beta2"], t)) for t in ts])
    return zeros, list(zeros)


def group_rows(step, lrs, wds, ts, scalars):
    """The fp32 values the multi-tensor kernel reads from device memory
    for a group updated by ``step`` (``multi_tensor.rows``: each chunk's lr,
    wd, c1 and c2 rows, then the scalars), computed on the host as
    :func:`group_apply` computes them."""
    lrs, wds = _host_values(lrs), _host_values(wds)
    return multi_tensor.rows(lrs, wds, *_rates(step, lrs, ts, scalars), scalars)


def group_apply(step, weights, grads, states, lrs, wds, ts, scalars, donate=False, *,
                device_rows=None, scratch=None):
    """Apply a step adapter (``sgd_step`` ... ``lamb_step``) to a whole
    parameter group in place.  ``states`` holds each tensor's tuple of fp32
    states, ``lrs``/``wds``/``ts`` one value per tensor (``lrs``/``wds``
    may be tensors, read on the host), ``scalars`` the group's
    hyperparameters (rescale, clip, momentum, beta1, beta2, epsilon, rho,
    eta, the LAMB bounds and bias_correction).

    On the CPU this is :func:`group_apply_plain`; a CUDA group launches the
    multi-tensor kernel once per chunk of up to 256 tensors
    (``multi_tensor.multi_tensor_update.launches`` counts; LAMB twice a
    chunk, on ``multi_tensor.multi_tensor_lamb.launches``, with
    ``scratch`` its partial norms' buffer when the caller owns one) or
    raises.  The
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
                                            *_rates(step, lrs, ts, scalars), scalars,
                                            device_rows=device_rows, scratch=scratch)


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



# -- norms and the overflow check ----------------------------------------------


def _sum_sq_finite(arrays):
    """(sum of squares, non-finite count) of each array: on CUDA tensors one
    launch of the multi-tensor finite pass a chunk; on the CPU its plain
    version."""
    arrays = [a if a.is_contiguous() else a.contiguous() for a in arrays]
    if arrays and all(a.device.type == "cuda" for a in arrays):
        return multi_tensor.sum_sq_finite(arrays)
    if any(a.device.type != "cpu" for a in arrays):
        raise ValueError("multi_sum_sq/all_finite run on CPU tensors or on CUDA tensors of one "
                         f"device, got {sorted({str(a.device) for a in arrays})}")
    return sum_sq_finite_plain(arrays)


def sum_sq_finite_plain(arrays):
    """The plain version of the finite pass: per tensor its fp32 sum of
    squares and its count of non-finite elements."""
    if not arrays:
        return torch.zeros(0), torch.zeros(0, dtype=torch.int32)
    sq = torch.stack([torch.square(a.float()).sum() for a in arrays])
    bad = torch.stack([(~torch.isfinite(a)).sum().to(torch.int32) for a in arrays])
    return sq, bad


@register(differentiable=False, wrap_ndarray=False)
def multi_sum_sq(*arrays):
    """Per-tensor sum of squares in fp32, one value an array (the input of
    ``multi_lars``)."""
    return _sum_sq_finite(list(arrays))[0]


@register(differentiable=False, wrap_ndarray=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8, rescale_grad=1.0):
    """LARS layerwise rates from the sums of squares."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * _f32(rescale_grad)
    ratio = _f32(eta) * w_norm / (g_norm + wds * w_norm + _f32(eps))
    return torch.where(w_norm > 0, lrs * torch.where(g_norm > 0, ratio, torch.ones_like(ratio)),
                       lrs)


@register(differentiable=False, wrap_ndarray=False)
def all_finite(*arrays):
    """A 0-d bool tensor: whether every element of every array is finite
    (the finite pass's non-finite counts, all zero)."""
    if not arrays:
        return torch.tensor(True)
    return (_sum_sq_finite(list(arrays))[1] == 0).all()


from .registry import alias as _alias  # noqa: E402

_alias("multi_all_finite", "all_finite")
