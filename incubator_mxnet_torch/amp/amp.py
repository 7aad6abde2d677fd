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

``convert_symbol`` and ``convert_model`` are the offline Symbol pass of
the serving tier (``InferenceServer(amp_dtype=...)``).  ``LossScaler``,
``scale_loss``, ``init_trainer``, ``unscale`` and ``convert_hybrid_block``
(fp16 loss scaling) wait in ROADMAP §1 item 3.
"""
from __future__ import annotations

import torch

from ..base import as_torch_dtype
from ..ops import registry
from . import lists

__all__ = ["init", "is_enabled", "disable", "disabled", "convert_symbol", "convert_model"]


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


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, excluded_sym_names=(), **kwargs):
    """Offline AMP graph conversion (parity: ``amp.convert_symbol`` — the
    reference's nnvm ``low_precision_pass``): rewrite the Symbol DAG,
    inserting ``amp_cast`` nodes so TARGET_OPS consume the low-precision
    dtype and FP32_OPS consume float32.  ``amp_cast`` passes integer
    tensors through unchanged, so index inputs (Embedding/labels) are
    safe, and returns a tensor already in the dtype as it is."""
    from ..symbol.symbol import Symbol, _Node

    lp16 = set(target_dtype_ops) if target_dtype_ops is not None else set(lists.TARGET_OPS)
    fp32 = set(fp32_ops) if fp32_ops is not None else set(lists.FP32_OPS)
    excluded = set(excluded_sym_names)

    mapping = {}
    for node in sym._topo():
        if node.op is None:
            mapping[id(node)] = node
            continue
        new_inputs = [(mapping[id(n)], i) for n, i in node.inputs]
        cast_to = None
        if node.op in lp16 and node.name not in excluded:
            cast_to = target_dtype
        elif node.op in fp32 and node.name not in excluded:
            cast_to = "float32"
        if cast_to is not None:
            new_inputs = [(_Node("amp_cast", f"{node.name}_in{j}_amp_cast", [(src, idx)],
                                 {"dtype": cast_to}), 0)
                          for j, (src, idx) in enumerate(new_inputs)]
        mapping[id(node)] = _Node(node.op, node.name, new_inputs, dict(node.attrs))
    return Symbol([(mapping[id(n)], i) for n, i in sym._outputs])


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  excluded_sym_names=(), **kwargs):
    """Parity: ``amp.convert_model`` — convert the graph with
    :func:`convert_symbol` and cast float parameters to the target dtype,
    EXCEPT parameters feeding FP32-listed ops directly (they stay fp32, as
    the reference's cast_optional_params=False default does).  The cast is
    ``Tensor.to``, on the parameter's device (numpy has no bf16 on every
    machine the port runs on)."""
    from ..ndarray.ndarray import NDArray, _wrap

    out_sym = convert_symbol(sym, target_dtype=target_dtype,
                             excluded_sym_names=excluded_sym_names, **kwargs)
    lp16 = (set(kwargs["target_dtype_ops"])
            if kwargs.get("target_dtype_ops") is not None else set(lists.TARGET_OPS))
    excluded = set(excluded_sym_names)
    # cast ONLY parameters consumed by effective-lp16, non-excluded nodes
    # — and never one that ALSO feeds an fp32/excluded consumer
    castable, pinned = set(), set()
    for node in sym._topo():
        if node.op is None:
            continue
        eff_lp16 = node.op in lp16 and node.name not in excluded
        for src, _ in node.inputs:
            if src.op is None:
                (castable if eff_lp16 else pinned).add(src.name)
    castable -= pinned
    target = as_torch_dtype(str(target_dtype))

    def cast_dict(d):
        out = {}
        for k, v in (d or {}).items():
            t = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            cast = t.is_floating_point() and k in castable
            out[k] = _wrap(t.detach().to(target) if cast else t.detach().clone())
        return out

    return out_sym, cast_dict(arg_params), cast_dict(aux_params)
