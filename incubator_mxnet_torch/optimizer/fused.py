"""The fused whole-group optimizer step: the Trainer's update path.

Counterpart of the JAX package's ``optimizer/fused.py``.  Parameters are
grouped by (step adapter, weight dtype, device) with ``plan_groups``, and
each group is updated by ``ops/optimizer_ops.group_apply`` in chunks of up
to ``optimizer.aggregate_num`` parameters: on the card one launch of the
hand-written multi-tensor kernel per chunk, in place, instead of some
seventeen PyTorch ops per tensor.  ``aggregate_num`` <= 1 (or
``MXNET_OPTIMIZER_AGGREGATION=0``) keeps the per-tensor loop.  An
optimizer with no fused variant, or a subclass, takes the per-tensor path:
``fused_update`` returns those items to the caller.  ``_select`` names the
optimizers the port has; NAG, AdamW, RMSProp and LAMB join it with their
optimizers.

The counters ``fused_update.calls`` (group updates), ``fused_update.params``
(parameters they updated) and ``fused_update.fallback_params`` (parameters
left to the loop) stand where the JAX package counts ``fused_step_call``,
``fused_step_params`` and ``fused_step_fallback_params`` in its profiler.
"""
from __future__ import annotations

from ..ops import optimizer_ops as K
from .optimizer import SGD, Adam

__all__ = ["fused_update", "plan_groups", "supports"]


def _select(opt, index, weight, state):
    """The step adapter of one (optimizer, parameter, state) and the flat
    tuple of its state tensors, or None when the parameter takes the
    per-tensor path.  Exact-type checks: a subclass that overrides
    ``update`` must not inherit a fused kernel it no longer matches."""
    t = type(opt)
    mp = opt._use_mp(weight)
    if t is SGD:
        if mp:
            mom, w32 = state
            return (K.mp_sgd_step, (w32,)) if mom is None else (K.mp_sgd_mom_step, (mom, w32))
        return (K.sgd_step, ()) if state is None else (K.sgd_mom_step, (state,))
    if t is Adam:
        if mp:
            (mean, var), w32 = state
            return K.mp_adam_step, (mean, var, w32)
        mean, var = state
        return K.adam_step, (mean, var)
    return None


def supports(opt):
    """Whether this optimizer has fused group updates at all."""
    return type(opt) in (SGD, Adam)


def _scalars(opt):
    S = {"rescale": opt.rescale_grad, "clip": opt.clip_gradient}
    if type(opt) is SGD:
        S["momentum"] = opt.momentum
    else:
        S["beta1"], S["beta2"], S["epsilon"] = opt.beta1, opt.beta2, opt.epsilon
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


def fused_update(optimizer, items, states):
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
                K.group_apply(step, [w for _, w, _, _ in chunk], [g for _, _, g, _ in chunk],
                              [flat for _, _, _, flat in chunk], lrs, wds, ts, scalars)
                fused_update.calls += 1
                fused_update.params += len(chunk)
    fused_update.fallback_params += len(rest)
    return rest


fused_update.calls = 0
fused_update.params = 0
fused_update.fallback_params = 0
