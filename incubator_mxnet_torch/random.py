"""``mx.random``: MXNet's seed API and samplers over explicit ``torch.Generator``s.

Counterpart of the JAX package's ``random.py``.  The reference keeps one
RNG state per device; so does the port: one ``torch.Generator`` per device,
made on first use from the last ``seed()``.  Every draw in the port names
its generator, so PyTorch's global RNG is never read.  A CUDA graph of the
step fold (``gluon/step_fold.py``) registers its device's generator, so
each replay draws fresh numbers and advances it as an eager step does;
``seed()`` makes new generators, and a fold captures anew for them.

The samplers take the JAX package's signatures and return NDArrays: they
draw on ``ctx``, by default the current context (the card unless a
``with mx.cpu():`` says otherwise), or into ``out=``'s device; dtypes are
names (``"float32"``) or dtypes.  They run the ``_random_*`` ops of
``ops/random_ops.py``.  ``_uniform`` and ``_normal`` are the tensor-valued
helpers the initializers fill parameters with.
"""
from __future__ import annotations

import threading

import torch

from .base import as_torch_dtype

__all__ = ["seed", "get_generator", "uniform", "normal", "randn", "randint", "multinomial",
           "shuffle", "gamma", "exponential", "poisson", "negative_binomial",
           "generalized_negative_binomial"]

_lock = threading.Lock()
_state = {"seed": 0, "generators": {}}


def _device(ctx):
    from .context import Context

    dev = ctx.device if isinstance(ctx, Context) else torch.device(ctx)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state, ctx="all"):
    """Parity: ``mx.random.seed``: every device's generator restarts from
    ``seed_state``.  ``ctx`` is accepted, as in the JAX package, and every
    device restarts whatever it names."""
    with _lock:
        _state["seed"] = int(seed_state)
        _state["generators"].clear()


def get_generator(device):
    """The generator of ``device`` (a Context, ``torch.device`` or string)."""
    dev = _device(device)
    with _lock:
        gen = _state["generators"].get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_state["seed"])
            _state["generators"][dev] = gen
        return gen


# -- tensor helpers of the initializers ----------------------------------------------


def _uniform(low, high, shape, device, dtype=torch.float32):
    dev = _device(device)
    out = torch.empty(shape, dtype=dtype, device=dev)
    return out.uniform_(low, high, generator=get_generator(dev))


def _normal(loc, scale, shape, device, dtype=torch.float32):
    dev = _device(device)
    out = torch.empty(shape, dtype=dtype, device=dev)
    return out.normal_(loc, scale, generator=get_generator(dev))


# -- mx.random samplers (NDArrays) ----------------------------------------------------


def _ctx(ctx, out=None):
    from .context import current_context

    if ctx is not None:
        return ctx
    return out.context if out is not None else current_context()


def _result(data, ctx, out=None):
    from .ndarray.ndarray import _wrap

    if out is not None:
        out._data = data.to(out.context.device)
        out._version += 1
        return out
    return _wrap(data, ctx)


def _ops():
    from .ops import random_ops

    return random_ops


def uniform(low=0, high=1, shape=(1,), dtype="float32", ctx=None, out=None):
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_uniform(low, high, shape, dtype, ctx=ctx), ctx, out)


def normal(loc=0, scale=1, shape=(1,), dtype="float32", ctx=None, out=None):
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_normal(loc, scale, shape, dtype, ctx=ctx), ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape or (1,), dtype=dtype, ctx=ctx)


def randint(low, high=None, shape=(1,), dtype="int32", ctx=None, out=None):
    if high is None:
        low, high = 0, low
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_randint(low, high, shape, dtype, ctx=ctx), ctx, out)


def _tensor_arg(data, ctx):
    from .ndarray.ndarray import NDArray, array

    if isinstance(data, NDArray):
        return data._data
    if isinstance(data, torch.Tensor):
        return data
    return array(data, ctx=_ctx(ctx))._data


def multinomial(data, shape=(1,), get_prob=False, dtype="int32", ctx=None):
    """Category draws from probability rows: ``shape`` draws from a 1-D
    ``data``, ``(rows, n)`` from a 2-D one (n the product of ``shape``);
    with ``get_prob`` also the log-probabilities of the draws."""
    probs = _tensor_arg(data, ctx)
    if isinstance(shape, int):
        shape = (shape,)
    n = 1
    for s in shape:
        n *= s
    gen = get_generator(probs.device)
    rows = probs.reshape(-1, probs.shape[-1]).float()
    draws = torch.multinomial(rows, n, replacement=True, generator=gen)
    samples = draws.reshape(shape) if probs.ndim == 1 else draws
    dev = ctx.device if ctx is not None else probs.device
    out = _result(samples.to(device=dev, dtype=as_torch_dtype(dtype)), ctx)
    if get_prob:
        logp = torch.take_along_dim(torch.log(torch.clamp_min(rows, 1e-30)), draws, dim=-1)
        return out, _result(logp.reshape(samples.shape).to(dev), ctx)
    return out


def shuffle(data, out=None):
    """``data`` permuted along its first axis."""
    t = _tensor_arg(data, None)
    perm = torch.randperm(t.shape[0], generator=get_generator(t.device), device=t.device)
    return _result(t[perm], None, out)


def gamma(alpha=1, beta=1, shape=(1,), dtype="float32", ctx=None, out=None):
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_gamma(alpha, beta, shape, dtype, ctx=ctx), ctx, out)


def exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_exponential(1.0 / scale, shape, dtype, ctx=ctx), ctx, out)


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_poisson(lam, shape, dtype, ctx=ctx), ctx, out)


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    """Failures before the k-th success with success probability p."""
    if not 0 < p <= 1:
        raise ValueError(f"negative_binomial requires 0 < p <= 1, got {p}")
    if k <= 0:
        raise ValueError(f"negative_binomial requires k > 0, got {k}")
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_negative_binomial(k, p, shape, dtype, ctx=ctx), ctx, out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,), dtype="float32", ctx=None,
                                  out=None):
    if mu <= 0 or alpha < 0:
        raise ValueError(
            f"generalized_negative_binomial requires mu > 0 and alpha >= 0, "
            f"got mu={mu}, alpha={alpha}")
    ctx = _ctx(ctx, out)
    return _result(_ops()._random_generalized_negative_binomial(mu, alpha, shape, dtype,
                                                                ctx=ctx), ctx, out)
