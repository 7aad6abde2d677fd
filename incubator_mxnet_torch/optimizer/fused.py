"""The fused whole-group optimizer step: the Trainer's update path.

Counterpart of the JAX package's ``optimizer/fused.py``.  Parameters are
grouped by (step adapter, weight dtype, device) with ``plan_groups``, and
each group is updated by ``ops/optimizer_ops.group_apply`` in chunks of up
to ``optimizer.aggregate_num`` parameters: on the card one launch of the
hand-written multi-tensor kernel per chunk, in place, instead of some
seventeen PyTorch ops per tensor.  ``aggregate_num`` <= 1 (or
``MXNET_OPTIMIZER_AGGREGATION=0``) keeps the per-tensor loop.  An
optimizer with no fused variant, or a subclass, takes the per-tensor path:
``fused_update`` returns those items to the caller.  The fused optimizers
are the JAX package's: SGD, NAG, Adam, AdamW, RMSProp (both forms) and
LAMB (two launches a chunk: its trust ratio needs each tensor's norms
first).  RMSProp and LAMB under ``multi_precision`` take the per-tensor
path, and AdamW under it takes Adam's ``mp_adam`` variant, as in the JAX
package; so does a ``row_sparse`` parameter of SGD, Adam or AdamW with
``lazy_update``: its lazy update touches only the rows its gradient has.

Each chunk's update counts in the profiler's declared counters
``fused_step_call`` (group updates), ``fused_step_params`` (parameters they
updated) and ``fused_step_fallback_params`` (parameters left to the loop),
as in the JAX package; ``fused_update.calls``, ``.params`` and
``.fallback_params`` read them.  With the profiler armed each chunk is a
``fused.group_apply`` span (host time of the step's telemetry).
"""
from __future__ import annotations

import functools
from time import perf_counter as _perf

from .. import profiler as _profiler
from ..ops import optimizer_ops as K
from .optimizer import LAMB, NAG, SGD, Adam, AdamW, RMSProp

__all__ = ["fused_update", "plan_groups", "supports"]


def _select(opt, index, weight, state):
    """The step adapter of one (optimizer, parameter, state) and the flat
    tuple of its state tensors, or None when the parameter takes the
    per-tensor path.  Exact-type checks: a subclass that overrides
    ``update`` must not inherit a fused kernel it no longer matches."""
    t = type(opt)
    mp = opt._use_mp(weight)
    if opt._lazy_for(index):
        return None  # a lazy row_sparse parameter: its per-tensor lazy update
    if t is SGD:
        if mp:
            mom, w32 = state
            return (K.mp_sgd_step, (w32,)) if mom is None else (K.mp_sgd_mom_step, (mom, w32))
        return (K.sgd_step, ()) if state is None else (K.sgd_mom_step, (state,))
    if t is NAG:
        if mp:
            inner, w32 = state
            # the base _update_mp runs sgd_update on the master copy
            return ((K.mp_sgd_step, (w32,)) if opt.momentum == 0.0
                    else (K.mp_nag_mom_step, (inner, w32)))
        return (K.sgd_step, ()) if state is None else (K.nag_mom_step, (state,))
    if t in (Adam, AdamW):
        if mp:
            # AdamW inherits Adam's _update_mp (mp_adam_update) on the
            # per-tensor path; the fused path matches it
            (mean, var), w32 = state
            return K.mp_adam_step, (mean, var, w32)
        mean, var = state
        return (K.adamw_step if t is AdamW else K.adam_step), (mean, var)
    if t is RMSProp:
        if mp:
            return None  # the base _update_mp: per-tensor path
        return ((K.rmspropalex_step, tuple(state)) if opt.centered
                else (K.rmsprop_step, (state,)))
    if t is LAMB:
        if mp:
            return None
        mean, var = state
        return K.lamb_step, (mean, var)
    return None


def supports(opt):
    """Whether this optimizer has fused group updates at all."""
    return type(opt) in (SGD, NAG, Adam, AdamW, RMSProp, LAMB)


def _scalars(opt):
    S = {"rescale": opt.rescale_grad, "clip": opt.clip_gradient}
    t = type(opt)
    if t in (SGD, NAG):
        S["momentum"] = opt.momentum
    elif t is RMSProp:
        S["rho"], S["epsilon"] = opt.rho, opt.epsilon
        if opt.centered:
            S["momentum"] = opt.momentum
    elif t is LAMB:
        S["beta1"], S["beta2"], S["epsilon"] = opt.beta1, opt.beta2, opt.epsilon
        S["lower_bound"], S["upper_bound"] = opt.lower_bound, opt.upper_bound
        S["bias_correction"] = 1.0 if opt.bias_correction else 0.0
    else:
        S["beta1"], S["beta2"], S["epsilon"] = opt.beta1, opt.beta2, opt.epsilon
        if t is AdamW:
            S["eta"] = opt.eta
    return S


def plan_groups(optimizer, items, states):
    """Map ``(index, weight, grad)`` items onto their step adapters, grouped
    by ``(adapter, dtype, device)``.  Returns ``(groups, rest)``: ``groups``
    an insertion-ordered dict ``key -> [(i, w, g, flat)]`` (``flat`` the
    adapter's state tensors, those of ``states[i]``), ``rest`` the items
    with no fused update.  The dtype is named as the JAX package names it
    (``"bfloat16"``)."""
    groups, rest = {}, []
    for item in items:
        i, w, g = item
        sel = _select(optimizer, i, w, states[i])
        if sel is None:
            rest.append(item)
            continue
        step, flat = sel
        key = (step, str(w.dtype).replace("torch.", ""), str(w.device))
        groups.setdefault(key, []).append((i, w, g, flat))
    return groups, rest


def _fused_update(optimizer, items, states):
    """Update every ``(index, weight, grad)`` of ``items`` that has a fused
    variant, a group at a time in chunks of ``optimizer.aggregate_num``;
    returns the items the caller must update per tensor.  ``states`` maps
    index -> the state the per-tensor path uses: the same tensors are
    updated in place, so the two paths can take turns mid-training."""
    agg = int(getattr(optimizer, "aggregate_num", 0) or 0)
    if agg <= 1 or not items:
        return items
    groups, rest = plan_groups(optimizer, items, states)
    if groups:
        scalars = _scalars(optimizer)
        for (step, _, _), members in groups.items():
            for a in range(0, len(members), agg):
                chunk = members[a:a + agg]
                # bump every count first, then read lr and wd, then t: as
                # the JAX package's fused step (and the reference's
                # aggregate path) does
                for i, _, _, _ in chunk:
                    optimizer._update_count(i)
                lrs = [optimizer._get_lr(i) for i, _, _, _ in chunk]
                wds = [optimizer._get_wd(i) for i, _, _, _ in chunk]
                ts = [optimizer._index_update_count[i] for i, _, _, _ in chunk]
                t0 = _perf() if _profiler._active else None
                K.group_apply(step, [w for _, w, _, _ in chunk], [g for _, _, g, _ in chunk],
                              [flat for _, _, _, flat in chunk], lrs, wds, ts, scalars)
                if t0 is not None:
                    _profiler.record_span("fused.group_apply", "optimizer", t0,
                                          args={"params": len(chunk)})
                _profiler.incr("fused_step_call")
                _profiler.incr("fused_step_params", len(chunk))
    if rest:
        _profiler.incr("fused_step_fallback_params", len(rest))
    return rest


class _CountedUpdate:
    """``fused_update``: the function, with its counts as read-only views of
    the profiler's declared counters (``calls`` is ``fused_step_call``,
    ``params`` ``fused_step_params``, ``fallback_params``
    ``fused_step_fallback_params``)."""

    _VIEWS = {"calls": "fused_step_call", "params": "fused_step_params",
              "fallback_params": "fused_step_fallback_params"}

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._fn = fn

    def __call__(self, optimizer, items, states):
        return self._fn(optimizer, items, states)

    def __getattr__(self, name):
        counter = type(self)._VIEWS.get(name)
        if counter is None:
            raise AttributeError(name)
        return _profiler.counters()[counter]


fused_update = _CountedUpdate(_fused_update)
