"""Control-flow operators: ``foreach``, ``while_loop`` and ``cond``
(``mx.nd.contrib.foreach`` / ``while_loop`` / ``cond``).

Counterpart of the JAX package's ``ops/control_flow.py``, with its
signatures and results.  The body is a Python callable over the caller's
arrays (NDArrays or tensors), run once a step; under
``autograd.record()`` every step records on PyTorch's graph, so gradients
reach the explicit ``data``/``init_states``/``loop_vars`` and every array
the body closes over, in eager mode as in the reference (the JAX package's
eager ``foreach`` gives closed-over arrays no gradient; its hybridized
step does).

* ``foreach`` stacks the per-step outputs on axis 0.
* ``while_loop`` needs ``max_iterations`` and runs that many steps under an
  active mask: the loop variables freeze after the first false condition,
  output rows past the last executed step are zeros.  No step reads the
  condition on the host, so the loop can run inside a CUDA-graph capture.
  As in the JAX package, a loop with no per-step outputs, outside
  ``record()``, stops at the first false condition instead (one host read
  of the condition a step).
* ``cond`` reads ``pred`` on the host and runs one branch: a host sync, so
  it cannot run inside a CUDA-graph capture (the step fold refuses it).
"""
from __future__ import annotations

import torch

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    if x is None:
        return [], False
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _tensor(x):
    from ..ndarray.ndarray import NDArray

    return x._data if isinstance(x, NDArray) else x


def _apply(fn, *arrays):
    """``fn`` of the arrays' tensors: for NDArrays through ``invoke`` (on
    the graph inside ``record()``, an NDArray back), else on tensors."""
    from ..ndarray.ndarray import NDArray, invoke

    if any(isinstance(a, NDArray) for a in arrays):
        return invoke(fn, list(arrays), {})
    return fn(*arrays)


def _stack(rows):
    return _apply(lambda *r: torch.stack(r, 0), *rows)


def foreach(body, data, init_states):
    """``body(data_slice, states) -> (out, new_states)`` over axis 0 of
    ``data``; returns ``(outputs, final_states)``, the outputs stacked on
    axis 0."""
    data_list, multi_data = _as_list(data)
    states, multi_state = _as_list(init_states)
    steps = []
    for i in range(data_list[0].shape[0]):
        d = [x[i] for x in data_list]
        out, new_states = body(d if multi_data else d[0],
                               states if multi_state else (states[0] if states else []))
        steps.append(_as_list(out)[0])
        states = _as_list(new_states)[0]
    outs = [_stack([s[k] for s in steps]) for k in range(len(steps[0]))] if steps else []
    return (outs if len(outs) != 1 else outs[0],
            states if multi_state else (states[0] if states else []))


def _pred(c):
    return _tensor(c).to(torch.bool).reshape(())


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """``while cond_fn(*loop_vars): out, loop_vars = func(*loop_vars)``, at
    most ``max_iterations`` steps (required).  Returns ``(outputs,
    final_loop_vars)``; output rows past the executed steps are zeros."""
    from .. import autograd

    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    var_list, multi_var = _as_list(loop_vars)
    n = int(max_iterations)
    if n <= 0:
        return [], (var_list if multi_var else var_list[0])
    c = cond_fn(*var_list)
    out, new_vars = func(*var_list)
    outs, new = _as_list(out)[0], _as_list(new_vars)[0]
    if not outs and not autograd.is_recording():
        # no per-step outputs, no tape: stop at the first false condition
        if bool(_pred(c)):
            var_list = new
            for _ in range(n - 1):
                if not bool(_pred(cond_fn(*var_list))):
                    break
                var_list = _as_list(func(*var_list)[1])[0]
        return [], (var_list if multi_var else var_list[0])
    active = None
    rows = []
    for step in range(n):
        if step:
            c = cond_fn(*var_list)
            out, new_vars = func(*var_list)
            outs, new = _as_list(out)[0], _as_list(new_vars)[0]
        p = _pred(c) if active is None else active & _pred(c)
        var_list = [_apply(lambda a, b, p=p: torch.where(p, a, b), nv, v)
                    for nv, v in zip(new, var_list)]
        rows.append([_apply(lambda o, p=p: torch.where(p, o, torch.zeros_like(o)), o)
                     for o in outs])
        active = p
    stacked = [_stack([r[k] for r in rows]) for k in range(len(rows[0]))]
    return (stacked if len(stacked) != 1 else stacked[0],
            var_list if multi_var else var_list[0])


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` else ``else_func()``; the branches take
    no arguments and close over their operands.  ``pred`` is read on the
    host (a sync)."""
    outs = _as_list((then_func if bool(_pred(pred)) else else_func)())[0]
    return outs if len(outs) != 1 else outs[0]
