"""``mx.operator``: user-defined operators in Python.

Counterpart of the JAX package's ``operator.py`` (``CustomOp``,
``CustomOpProp``, ``register``, invoked as ``nd.Custom(..., op_type=name)``).
The user's ``forward`` runs inline on tensors; under ``mx.autograd.record()``
the call is one ``torch.autograd.Function`` whose backward calls the user's
``backward``, with recording paused in both as ``autograd.Function`` pauses
it.  A ``CustomOp`` may launch its own kernels, such as an ``mx.rtc``
kernel, and choose its plain version on CPU tensors.

Auxiliary states are fresh zeros on every call, as in the JAX package's
eager ``nd.Custom`` (the reference keeps them only in a bound executor's
``aux_states``; a stateful op keeps its state on the ``CustomOp``).

In a symbol graph ``sym.Custom(data..., op_type=name, **params)`` is the
registered op ``Custom`` (``cacheable=False``): at bind time the graph's
shape and type passes take its outputs from the prop's ``infer_shape`` and
``infer_type`` on ``meta`` tensors, never running the user's ``forward``
(a kernel cannot launch on them); an executor's plan calls it on the
device tensors, ``is_train`` from the executor.  PyTorch runs the plan
eagerly, so there is no host round trip (the JAX package's graph calls back
to the host because XLA traces it).
"""
from __future__ import annotations

import torch

from . import autograd
from .base import as_torch_dtype
from .ops.registry import register as _register

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]

_PROPS = {}


class CustomOp:
    """User forward/backward over lists of tensors (parity: ``mx.operator.
    CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into the preallocated ``dst`` as ``req`` says:
        ``write``/``inplace`` copy, ``add`` accumulates, ``null`` skips."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            if src is not dst:
                dst.copy_(torch.as_tensor(src))
        elif req == "add":
            dst.add_(torch.as_tensor(src).to(dst.dtype))
        else:
            raise ValueError(f"unknown req {req!r}")


class CustomOpProp:
    """Shape and type inference and the operator factory (parity:
    ``CustomOpProp``).  Types are ``torch.dtype``s; MXNet's names are taken
    too."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Decorator registering a CustomOpProp under ``op_type=reg_name``."""

    def deco(prop_cls):
        _PROPS[reg_name] = prop_cls
        return prop_cls

    return deco


def get_prop(op_type):
    try:
        return _PROPS[op_type]
    except KeyError:
        raise KeyError(
            f"custom op {op_type!r} is not registered; use "
            "@mx.operator.register(name) on a CustomOpProp") from None


class _Custom(torch.autograd.Function):
    """One recorded custom-op call: the user's forward, and the user's
    backward as its gradient."""

    @staticmethod
    def forward(ctx, op, need_top_grad, outs, aux, is_train, *inputs):
        with autograd.pause(train_mode=is_train):
            op.forward(is_train, ["write"] * len(outs), list(inputs), outs, aux)
        ctx.op, ctx.need_top_grad, ctx.aux, ctx.n_in = op, need_top_grad, aux, len(inputs)
        ctx.save_for_backward(*inputs, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cotangents):
        saved = ctx.saved_tensors
        inputs, outs = list(saved[:ctx.n_in]), list(saved[ctx.n_in:])
        if ctx.need_top_grad:  # an output no loss reaches gets a zero cotangent
            out_grad = [torch.zeros_like(o) if g is None else g
                        for g, o in zip(cotangents, outs)]
        else:
            out_grad = [None] * len(outs)
        in_grad = [torch.zeros_like(a) for a in inputs]
        with autograd.pause():
            ctx.op.backward(["write"] * len(inputs), out_grad, inputs, outs, in_grad, ctx.aux)
        return (None, None, None, None, None, *in_grad)


def _invoke_custom(op_type, inputs, kwargs):
    prop = get_prop(op_type)(**kwargs)
    arg_shapes, out_shapes, aux_shapes = prop.infer_shape([list(a.shape) for a in inputs])
    in_types = [a.dtype for a in inputs]
    _, out_types, aux_types = prop.infer_type(in_types)
    op = prop.create_operator(None, arg_shapes, in_types)
    device = inputs[0].device if inputs else None
    aux = [torch.zeros(tuple(s), dtype=as_torch_dtype(t), device=device)
           for s, t in zip(aux_shapes, aux_types)]
    outs = [torch.empty(tuple(s), dtype=as_torch_dtype(t), device=device)
            for s, t in zip(out_shapes, out_types)]  # the forward writes them (req "write")
    is_train = autograd.is_training() or autograd.is_recording()
    if autograd.is_recording() and any(a.requires_grad for a in inputs):
        outs = list(_Custom.apply(op, prop.need_top_grad_, outs, aux, is_train, *inputs))
    else:
        with autograd.pause(train_mode=is_train):
            op.forward(is_train, ["write"] * len(outs), list(inputs), outs, aux)
    return outs[0] if len(outs) == 1 else outs


def nd_custom(*args, op_type=None, **kwargs):
    """``nd.Custom(data..., op_type='name', **params)`` (parity), under
    ``mx.nd``'s currency rule: NDArray inputs give NDArray outputs."""
    if op_type is None:
        raise ValueError("nd.Custom requires op_type=")
    from .ndarray.ndarray import NDArray, _wrap_out

    wrap = any(isinstance(a, NDArray) for a in args)
    inputs = [a._data if isinstance(a, NDArray) else
              a if isinstance(a, torch.Tensor) else torch.as_tensor(a) for a in args]
    out = _invoke_custom(op_type, inputs, kwargs)
    return _wrap_out(out) if wrap else out


def _custom_entry(*raw, op_type=None, **kwargs):
    """The registry's ``Custom`` (what a graph's node calls): on ``meta``
    tensors (the bind-time shape and type passes) the outputs the prop
    infers, else the user's op on the tensors (``nd.Custom``'s path)."""
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    if any(a.is_meta for a in raw):
        prop = get_prop(op_type)(**kwargs)
        _, out_shapes, _ = prop.infer_shape([list(a.shape) for a in raw])
        _, out_types, _ = prop.infer_type([a.dtype for a in raw])
        outs = tuple(torch.empty(tuple(s), dtype=as_torch_dtype(t), device="meta")
                     for s, t in zip(out_shapes, out_types))
        return outs if len(outs) > 1 else outs[0]
    out = _invoke_custom(op_type, list(raw), kwargs)
    return tuple(out) if isinstance(out, list) else out


# cacheable=False: the body runs the user's CustomOp.forward, arbitrary
# stateful Python
_register("Custom", differentiable=False, cacheable=False)(_custom_entry)
