"""``mx.amp`` — automatic mixed precision (parity:
[U:python/mxnet/contrib/amp/amp.py]).

Counterpart of the JAX package's ``amp/amp.py``.  One hook casts the float
inputs of every op reached through ``nd`` (and so through every Block's
``F``) by the lists of ``lists.py``: down to the target dtype for
TARGET_OPS, up to fp32 for FP32_OPS, to the widest float dtype present for
WIDEST_OPS.  The hook sits in ``ops/registry.py``'s namespace lookup, where
the port's Blocks reach ops, as the JAX package's sits in its op dispatch.
Like that hook it casts positional inputs only; parameters stay fp32 and
their casts are part of the graph, so gradients come back in fp32.

``LossScaler``, ``scale_loss``, ``init_trainer``, ``unscale`` and the
``convert_*`` functions (fp16 loss scaling, Symbol conversion) are not
ported yet.
"""
from __future__ import annotations

import torch

from ..base import as_torch_dtype
from ..ops import registry
from . import lists

__all__ = ["init", "is_enabled", "disable", "disabled"]


class _AmpPolicy:
    def __init__(self, target_dtype):
        self.target = as_torch_dtype(target_dtype)

    @staticmethod
    def _cast(args, dtype):
        return tuple(a.to(dtype) if isinstance(a, torch.Tensor) and a.is_floating_point()
                     and a.dtype != dtype else a for a in args)

    def cast_inputs(self, names, args):
        """``args`` cast for the op filed under ``names``."""
        if names & lists.TARGET_OPS:
            return self._cast(args, self.target)
        if names & lists.FP32_OPS:
            return self._cast(args, torch.float32)
        if names & lists.WIDEST_OPS:
            floats = {a.dtype for a in args
                      if isinstance(a, torch.Tensor) and a.is_floating_point()}
            if len(floats) > 1:
                return self._cast(args, max(floats, key=lambda d: d.itemsize))
        return args

    def wrap(self, op):
        """``op.fn``, or a function that casts its inputs first when one of
        the lists names the op."""
        names = {op.name, *op.aliases}
        if not names & (lists.TARGET_OPS | lists.FP32_OPS | lists.WIDEST_OPS):
            return op.fn

        def cast_then_call(*args, **kwargs):
            return op.fn(*self.cast_inputs(names, args), **kwargs)

        return cast_then_call


def init(target_dtype="bfloat16"):
    """Enable AMP for every op reached through ``nd`` (parity:
    ``amp.init()``).  Idempotent."""
    if str(target_dtype) not in ("bfloat16", "float16"):
        raise ValueError(f"AMP target dtype must be bfloat16 or float16, got {target_dtype!r}")
    registry._amp = _AmpPolicy(str(target_dtype))


def is_enabled():
    return registry._amp is not None


def disable():
    registry._amp = None


class disabled:
    """``with amp.disabled():`` suspends the hook and restores the previous
    policy on exit."""

    def __enter__(self):
        self._prev = registry._amp
        registry._amp = None
        return self

    def __exit__(self, *exc):
        registry._amp = self._prev
        return False
