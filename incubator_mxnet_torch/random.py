"""Random number handling: MXNet's seed API over explicit ``torch.Generator``s.

Counterpart of the JAX package's ``random.py``.  The reference keeps one
RNG state per device; so does the port: one ``torch.Generator`` per device,
made on first use from the last ``seed()``.  Every draw in the port names
its generator, so PyTorch's global RNG is never read.  A CUDA graph of the
step fold (``gluon/step_fold.py``) registers its device's generator, so
each replay draws fresh numbers and advances it as an eager step does;
``seed()`` makes new generators, and a fold captures anew for them.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "get_generator", "uniform", "normal"]

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


def uniform(low=0.0, high=1.0, shape=(1,), dtype=torch.float32, ctx="cpu"):
    dev = _device(ctx)
    out = torch.empty(shape, dtype=dtype, device=dev)
    return out.uniform_(low, high, generator=get_generator(dev))


def normal(loc=0.0, scale=1.0, shape=(1,), dtype=torch.float32, ctx="cpu"):
    dev = _device(ctx)
    out = torch.empty(shape, dtype=dtype, device=dev)
    return out.normal_(loc, scale, generator=get_generator(dev))
