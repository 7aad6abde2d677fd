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
the serving tier (``InferenceServer(amp_dtype=...)``).

Dynamic loss scaling for fp16 (``LossScaler``, ``scale_loss``,
``init_trainer``, ``unscale``): the loss is multiplied by the scale before
the backward, and the wrapped ``Trainer.step`` folds ``1/scale`` into
``trainer._scale`` (so into ``rescale_grad``) or, when a gradient is not
finite, skips the update (no weight, state or update count moves), halves
the scale and leaves the gradients as they are; ``scale_window`` finite
steps in a row double it.  The overflow check reads one count of
non-finite elements for all the gradients from the card: one launch of the
multi-tensor finite pass per chunk of up to 256 gradients of one dtype
(``ops/multi_tensor.py`` ``sum_sq_finite``), the counts summed on the card,
one host sync a step.  It reads counts, not sums of squares: a large finite
gradient can square to inf.
"""
from __future__ import annotations

import torch

from ..base import as_torch_dtype, invalidate_jit_caches
from ..ops import registry
from . import lists

__all__ = ["init", "is_enabled", "disable", "disabled", "convert_symbol", "convert_model",
           "LossScaler", "scale_loss", "init_trainer", "unscale", "convert_hybrid_block",
           "list_lp16_ops", "list_fp32_ops"]


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
    invalidate_jit_caches()  # programs built before trace the old dispatch


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


def _grad_of(p):
    """The gradient tensor of a Parameter, an NDArray with an attached
    gradient, or a tensor (its ``.grad``); None where there is none."""
    from ..gluon.parameter import Parameter

    if isinstance(p, Parameter):
        return p._grad if p.grad_req != "null" else None
    g = getattr(p, "_grad", None)
    if g is not None:
        return getattr(g, "_data", g)
    return p.grad if isinstance(p, torch.Tensor) else None


def _nonfinite_count(grads):
    """The number of non-finite elements in ``grads`` (tensors), as a 0-d
    int64 tensor on their device: on the card the multi-tensor finite pass
    (one launch a chunk of up to 256 tensors of one dtype per device) and
    a sum of its counts, on the CPU its plain version."""
    from ..ops import optimizer_ops as K

    by_device = {}
    for g in grads:
        by_device.setdefault(g.device, []).append(g)
    counts = [K._sum_sq_finite(gs)[1].sum(dtype=torch.int64) for gs in by_device.values()]
    if not counts:
        return torch.zeros((), dtype=torch.int64)
    total = counts[0]
    for c in counts[1:]:
        total = total + c.to(total.device)
    return total


class LossScaler:
    """Dynamic loss scaling (parity: MXNet's ``amp.LossScaler``): halve the
    scale (not below 1) and skip the update on overflow, double it after
    ``scale_window`` finite steps in a row."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0, scale_window=2000):
        self.loss_scale = float(init_scale)
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient holds a non-finite element.  Takes Gluon
        Parameters, NDArrays with attached gradients or tensors; one count
        read from the card for all of them."""
        grads = [g for g in (_grad_of(p) for p in params) if g is not None]
        if not grads:
            return False
        return bool(_nonfinite_count(grads).item() != 0)

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: autograd.backward(scaled)``
    (parity: ``amp.scale_loss``): the loss (or each of a list) times the
    trainer's loss scale; a trainer without ``init_trainer`` gets the loss
    back as it is."""

    def __init__(self, loss, trainer):
        self._loss = loss
        self._trainer = trainer

    def __enter__(self):
        scaler = getattr(self._trainer, "_amp_loss_scaler", None)
        if scaler is None:
            return self._loss
        if isinstance(self._loss, (list, tuple)):
            return [l * scaler.loss_scale for l in self._loss]
        return self._loss * scaler.loss_scale

    def __exit__(self, *a):
        return False


def init_trainer(trainer):
    """Attach a dynamic :class:`LossScaler` to a Gluon Trainer and wrap its
    ``step`` (parity: ``amp.init_trainer``): a step whose gradients are all
    finite runs with ``trainer._scale`` divided by the loss scale for that
    call (``Trainer.step`` reads it into ``rescale_grad``), unless
    :func:`unscale` already divided the gradients; a step with a non-finite
    gradient updates nothing.  Either way the scaler then updates the scale.
    Idempotent: a second call returns the trainer as it is."""
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return trainer
    scaler = LossScaler()
    trainer._amp_loss_scaler = scaler
    orig_step = trainer.step

    def step(batch_size, ignore_stale_grad=False):
        params = [p for p in trainer._params if p.grad_req != "null"]
        overflow = scaler.has_overflow(params)
        if not overflow:
            if getattr(trainer, "_amp_unscaled", False):
                trainer._amp_unscaled = False
                orig_step(batch_size, ignore_stale_grad)
            else:
                saved = trainer._scale
                trainer._scale = saved / scaler.loss_scale
                try:
                    orig_step(batch_size, ignore_stale_grad)
                finally:
                    trainer._scale = saved
        else:
            trainer._amp_unscaled = False
        scaler.update_scale(overflow)

    trainer.step = step
    return trainer


@torch.no_grad()
def unscale(trainer):
    """Divide the current gradients by the loss scale in place (to clip them
    before ``step``); the wrapped step then does not divide again."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    for p in trainer._params:
        if p.grad_req != "null" and p._grad is not None:
            p._grad.div_(scaler.loss_scale)
    trainer._amp_unscaled = True


def convert_hybrid_block(block, target_dtype="bfloat16"):
    """Cast the block's floating-point parameters to ``target_dtype`` in
    place and return the block (parity: ``amp.convert_hybrid_block``, the
    JAX package's form); combine with :func:`init` for the op lists."""
    for p in block.collect_params().values():
        if p._data is not None and not p._data.is_floating_point():
            continue
        p.cast(target_dtype)
    return block


def list_lp16_ops(target_dtype="bfloat16"):
    """The ops AMP runs in the low-precision target dtype."""
    return sorted(lists.TARGET_OPS)


def list_fp32_ops(target_dtype="bfloat16"):
    """The ops AMP runs in fp32."""
    return sorted(lists.FP32_OPS)
