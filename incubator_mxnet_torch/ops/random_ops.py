"""Random-sampling operators: the port of the JAX package's
``ops/random_ops.py``.

``_random_*`` draw a tensor of ``shape`` with scalar parameters on ``ctx``
(default: the current context); ``_sample_*`` draw one batch of ``shape``
per entry of the parameter tensors, so the output's shape is
``params.shape + shape`` on the parameters' device.  Every draw comes
from ``key``, a ``torch.Generator`` (the JAX package's explicit PRNG key),
or else from ``random.get_generator`` of the output's device, never from
PyTorch's global generator.  Gamma draws are fp32 (``torch._standard_gamma``)
before any cast; the negative binomials are gamma–Poisson mixtures, as in
the JAX package.
"""
from __future__ import annotations

import math

import torch

from ..base import as_torch_dtype
from .registry import register
from .tensor import _device

__all__ = []


def _gen(key, device):
    if key is not None:
        return key
    from ..random import get_generator

    return get_generator(device)


def _shape_tuple(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws of alpha's shape (an fp32 tensor)."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


# -- _random_*: tensor-shaped draws with scalar parameters -------------------------


@register("_random_uniform", differentiable=False)
def _random_uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", key=None, ctx=None):
    dev = _device(ctx)
    out = torch.empty(_shape_tuple(shape), dtype=as_torch_dtype(dtype), device=dev)
    return out.uniform_(low, high, generator=_gen(key, dev))


@register("_random_normal", differentiable=False)
def _random_normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", key=None, ctx=None):
    dev = _device(ctx)
    out = torch.empty(_shape_tuple(shape), dtype=as_torch_dtype(dtype), device=dev)
    return out.normal_(loc, scale, generator=_gen(key, dev))


@register("_random_gamma", differentiable=False)
def _random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", key=None, ctx=None):
    dev = _device(ctx)
    a = torch.full(_shape_tuple(shape), float(alpha), device=dev)
    return (beta * _gamma(a, _gen(key, dev))).to(as_torch_dtype(dtype))


@register("_random_exponential", differentiable=False)
def _random_exponential(lam=1.0, shape=(1,), dtype="float32", key=None, ctx=None):
    dev = _device(ctx)
    out = torch.empty(_shape_tuple(shape), device=dev).exponential_(1.0, generator=_gen(key, dev))
    return (out / lam).to(as_torch_dtype(dtype))


@register("_random_poisson", differentiable=False)
def _random_poisson(lam=1.0, shape=(1,), dtype="float32", key=None, ctx=None):
    dev = _device(ctx)
    rate = torch.full(_shape_tuple(shape), float(lam), device=dev)
    return _poisson(rate, _gen(key, dev)).to(as_torch_dtype(dtype))


@register("_random_negative_binomial", differentiable=False)
def _random_negative_binomial(k=1, p=0.5, shape=(1,), dtype="float32", key=None, ctx=None):
    """Failures before the k-th success: Poisson(Gamma(k, (1 − p)/p))."""
    dev = _device(ctx)
    gen = _gen(key, dev)
    lam = _gamma(torch.full(_shape_tuple(shape), float(k), device=dev), gen) * ((1.0 - p) / p)
    return _poisson(lam, gen).to(as_torch_dtype(dtype))


@register("_random_generalized_negative_binomial", differentiable=False)
def _random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,), dtype="float32",
                                          key=None, ctx=None):
    """Poisson with a Gamma(1/alpha, mu·alpha) rate; alpha ≤ 0 is
    Poisson(mu)."""
    dev = _device(ctx)
    gen = _gen(key, dev)
    shape = _shape_tuple(shape)
    if alpha <= 0:
        return _poisson(torch.full(shape, float(mu), device=dev), gen).to(as_torch_dtype(dtype))
    lam = _gamma(torch.full(shape, 1.0 / alpha, device=dev), gen) * (mu * alpha)
    return _poisson(lam, gen).to(as_torch_dtype(dtype))


@register("_random_randint", differentiable=False)
def _random_randint(low=0, high=1, shape=(1,), dtype="int32", key=None, ctx=None):
    dev = _device(ctx)
    return torch.randint(int(low), int(high), _shape_tuple(shape), generator=_gen(key, dev),
                         dtype=as_torch_dtype(dtype), device=dev)


# -- _sample_*: one draw batch per entry of the parameter tensors ----------------------


def _multi(params, shape):
    """The parameters broadcast to one shape, each with trailing axes to
    broadcast against the draw shape ``common + shape``; the draw shape;
    the device."""
    tensors = [p for p in params if isinstance(p, torch.Tensor)]
    dev = tensors[0].device
    params = [p if isinstance(p, torch.Tensor) else torch.tensor(p, device=dev) for p in params]
    common = torch.broadcast_shapes(*[p.shape for p in params])
    full = tuple(common) + _shape_tuple(shape)
    extra = (1,) * (len(full) - len(common))
    return [p.broadcast_to(common).reshape(tuple(common) + extra) for p in params], full, dev


def _float_dtype(dtype, like):
    return as_torch_dtype(dtype) if dtype else like.dtype


@register("_sample_uniform", differentiable=False)
def _sample_uniform(low, high, shape=(), dtype=None, key=None):
    (lo, hi), full, dev = _multi([low, high], shape)
    u = torch.empty(full, dtype=_float_dtype(dtype, lo), device=dev).uniform_(
        generator=_gen(key, dev))
    return lo + u * (hi - lo)


@register("_sample_normal", differentiable=False)
def _sample_normal(mu, sigma, shape=(), dtype=None, key=None):
    (m, s), full, dev = _multi([mu, sigma], shape)
    z = torch.empty(full, dtype=_float_dtype(dtype, m), device=dev).normal_(
        generator=_gen(key, dev))
    return m + s * z


@register("_sample_gamma", differentiable=False)
def _sample_gamma(alpha, beta, shape=(), dtype=None, key=None):
    (a, b), full, dev = _multi([alpha, beta], shape)
    g = _gamma(a.float().expand(full).contiguous(), _gen(key, dev))
    return (g * b).to(_float_dtype(dtype, a))


@register("_sample_exponential", differentiable=False)
def _sample_exponential(lam, shape=(), dtype=None, key=None):
    (rate,), full, dev = _multi([lam], shape)
    e = torch.empty(full, device=dev).exponential_(1.0, generator=_gen(key, dev))
    return (e / rate).to(_float_dtype(dtype, rate))


@register("_sample_poisson", differentiable=False)
def _sample_poisson(lam, shape=(), dtype="float32", key=None):
    (rate,), full, dev = _multi([lam], shape)
    return _poisson(rate.float().expand(full).contiguous(), _gen(key, dev)).to(
        as_torch_dtype(dtype))


@register("_sample_negative_binomial", differentiable=False)
def _sample_negative_binomial(k, p, shape=(), dtype="float32", key=None):
    (kb, pb), full, dev = _multi([k, p], shape)
    gen = _gen(key, dev)
    lam = _gamma(kb.float().expand(full).contiguous(), gen) * ((1.0 - pb) / pb)
    return _poisson(lam.float(), gen).to(as_torch_dtype(dtype))


@register("_sample_generalized_negative_binomial", differentiable=False)
def _sample_generalized_negative_binomial(mu, alpha, shape=(), dtype="float32", key=None):
    (mub, ab), full, dev = _multi([mu, alpha], shape)
    gen = _gen(key, dev)
    safe = torch.clamp_min(ab.float(), 1e-12)
    lam = _gamma((1.0 / safe).expand(full).contiguous(), gen) * (mub * safe)
    lam = torch.where(ab <= 0, mub.float().expand(full), lam)  # alpha = 0: Poisson(mu)
    return _poisson(lam.float(), gen).to(as_torch_dtype(dtype))


@register("_sample_multinomial", differentiable=False)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32", key=None):
    """Categorical draws from the (unnormalized) probability rows
    ``data[..., k]``: ``data.shape[:-1] + shape`` samples, and with
    ``get_prob`` the log of each drawn entry's probability."""
    batch = tuple(data.shape[:-1])
    full = batch + _shape_tuple(shape)
    n = math.prod(_shape_tuple(shape))
    rows = data.reshape(-1, data.shape[-1]).float()
    draws = torch.multinomial(rows, n, replacement=True, generator=_gen(key, data.device))
    samples = draws.reshape(full).to(as_torch_dtype(dtype))
    if not get_prob:
        return samples
    logp = torch.log(torch.clamp_min(rows, 1e-37)).to(data.dtype)
    logp = torch.take_along_dim(logp, draws, dim=-1).reshape(full)
    return samples, logp


@register("_random_uniform_like", differentiable=False)
def _random_uniform_like(data, low=0.0, high=1.0, key=None):
    return torch.empty_like(data).uniform_(low, high, generator=_gen(key, data.device))


@register("_random_normal_like", differentiable=False)
def _random_normal_like(data, loc=0.0, scale=1.0, key=None):
    return torch.empty_like(data).normal_(loc, scale, generator=_gen(key, data.device))


@register("shuffle", differentiable=False)
def shuffle(data, key=None):
    """A random permutation along the first axis."""
    perm = torch.randperm(data.shape[0], generator=_gen(key, data.device), device=data.device)
    return data[perm]
