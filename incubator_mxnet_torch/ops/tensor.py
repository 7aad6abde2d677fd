"""Tensor creation, shape, elementwise and reduction ops that BERT, ResNet
and the Gluon losses call.

Counterpart of the matching ops in the JAX package's ``ops/tensor.py``
(``reshape``, ``Flatten``, ``slice_axis``, ``pick``, the ``broadcast_*``
arithmetic and its ``elemwise_*`` aliases, ``relu``, ``sigmoid``,
``square``, ``sum``/``mean`` with MXNet's ``axis``/``keepdims``/``exclude``) and
``ndarray/ndarray.py`` (``zeros``, ``arange``), including MXNet's special
reshape codes.
"""
from __future__ import annotations

import torch

from ..base import as_torch_dtype
from .registry import alias, register


def _device(ctx):
    from ..context import Context, current_context

    if ctx is None:
        ctx = current_context()
    return ctx.device if isinstance(ctx, Context) else torch.device(ctx)


@register("zeros")
def zeros(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(tuple(shape), dtype=as_torch_dtype(dtype), device=_device(ctx))


@register("arange")
def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, device=_device(ctx)).to(as_torch_dtype(dtype))
    if repeat != 1:
        out = out.repeat_interleave(repeat)
    return out


def _infer_mx_reshape(src, target, reverse=False):
    """MXNet reshape codes 0 (copy), -1 (infer), -2 (copy rest), -3 (merge
    two), -4 (split one); the same rules as the reference's Reshape."""
    src = list(src)
    target = list(target)
    if reverse:
        src, target = src[::-1], target[::-1]
    out = []
    i = j = 0
    while j < len(target):
        t = target[j]
        if t > 0:
            out.append(t)
            i += 1
        elif t == 0:
            if i >= len(src):
                raise ValueError("reshape 0 refers past input rank")
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            if i + 1 >= len(src):
                raise ValueError("reshape -3 needs two input dims")
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d = src[i]
            a, b = target[j + 1], target[j + 2]
            if a == -1 and b == -1:
                raise ValueError("reshape -4 with two -1s")
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            if a * b != d:
                raise ValueError(f"reshape -4 split {d} != {a}*{b}")
            out.extend([a, b])
            i += 1
            j += 2
        else:
            raise ValueError(f"invalid reshape code {t}")
        j += 1
    total = 1
    for d in src:
        total *= d
    known = 1
    neg = 0
    for d in out:
        if d == -1:
            neg += 1
        else:
            known *= d
    if neg > 1:
        raise ValueError("more than one -1 in reshape")
    if neg == 1:
        out = [total // known if d == -1 else d for d in out]
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("reshape")
def reshape(x, shape, reverse=False):
    return x.reshape(_infer_mx_reshape(x.shape, shape, reverse))


alias("Reshape", "reshape")


@register("slice_axis")
def slice_axis(x, axis, begin, end):
    return x[(slice(None),) * (axis % x.ndim) + (slice(begin, end),)]


@register("flatten")
def flatten(x):
    """To 2-D keeping the batch axis (a 0-d input becomes [1, 1])."""
    if x.ndim == 0:
        return x.reshape(1, 1)
    return x.reshape(x.shape[0], -1)


alias("Flatten", "flatten")


@register("broadcast_add")
def broadcast_add(lhs, rhs):
    return torch.add(lhs, rhs)


@register("broadcast_sub")
def broadcast_sub(lhs, rhs):
    return torch.sub(lhs, rhs)


@register("broadcast_mul")
def broadcast_mul(lhs, rhs):
    return torch.mul(lhs, rhs)


@register("broadcast_div")
def broadcast_div(lhs, rhs):
    return torch.div(lhs, rhs)


alias("elemwise_add", "broadcast_add")
alias("elemwise_sub", "broadcast_sub")
alias("elemwise_mul", "broadcast_mul")
alias("elemwise_div", "broadcast_div")
alias("add", "broadcast_add")


@register("relu")
def relu(x):
    return torch.relu(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("square")
def square(x):
    return torch.square(x)


def _norm_axis(x, axis, exclude=False):
    """MXNet's reduction axes: int, tuple or None (all); ``exclude`` takes
    every other axis."""
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % x.ndim for a in axis)
    if exclude:
        axis = tuple(i for i in range(x.ndim) if i not in axis)
    return axis


def _make_reduce(name, fn):
    def red(x, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(x, axis, exclude)
        if ax is None:
            out = fn(x)
            return out.reshape((1,) * x.ndim) if keepdims else out
        if not ax:  # no axis left to reduce (exclude of every axis)
            return x
        return fn(x, dim=ax, keepdim=keepdims)

    red.__name__ = name
    register(name)(red)


_make_reduce("sum", torch.sum)
_make_reduce("mean", torch.mean)


@register("pick")
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """x's entries at ``index`` along ``axis`` (indices clipped to range,
    MXNet's default mode)."""
    idx = index.long().clamp(0, x.shape[axis] - 1).unsqueeze(axis)
    out = torch.take_along_dim(x, idx, dim=axis)
    return out if keepdims else out.squeeze(axis)
