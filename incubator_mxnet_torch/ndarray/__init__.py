"""``mx.nd``: NDArray and every registered op.

Counterpart of the JAX package's ``ndarray/__init__.py``.  Each registered
op is reachable as ``nd.<name>`` (wrappers made on first access), under
one rule, the currency rule: when any array argument is an ``NDArray``
(in lists too), the wrapper unwraps the arguments, calls the op (through
``amp.init()``'s casts) and wraps every tensor output as an NDArray on the
output's device, with an optional ``out=``; when every array argument is a
``torch.Tensor`` it returns what the op returns, so code written on
tensors is unchanged.  Raw ops (``wrap_ndarray=False``: the multi-tensor
updates) unwrap NDArrays inside their list arguments and give their own
structure back with NDArrays in it.  ``nd.Custom`` is
``operator.nd_custom``, which applies the same rule; the legacy
``nd.random_<name>`` and ``nd.sample_<name>`` resolve to ``mx.random``;
``nd.sparse`` holds the sparse storage types and ``nd.cast_storage``
converts between them.
"""
from __future__ import annotations

import torch

from ..ops import registry as _registry
from .ndarray import (NDArray, _has_nd, _rewrap_nested, _run, _unwrap_nested, _wrap_out,
                      arange, array, empty, full, invoke, ones, waitall, zeros)
from .utils import load, save
from . import contrib  # noqa: F401
from . import random  # noqa: F401
from . import sparse  # noqa: F401
from .sparse import cast_storage  # noqa: F401  (mx.nd.cast_storage)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange", "invoke",
           "waitall", "save", "load", "random", "contrib", "sparse", "cast_storage"]

_WRAPPER_CACHE = {}


def _copy_out(res, out):
    """``out=``: the result's values in ``out`` (an NDArray takes the new
    buffer, a tensor is written in place); returns ``out``."""
    if isinstance(res, (list, tuple)):
        raise ValueError("out= unsupported for multi-output ops")
    if isinstance(out, NDArray):
        out._data = res._data if isinstance(res, NDArray) else res
        out._version += 1
    else:
        with torch.no_grad():
            out.copy_(res._data if isinstance(res, NDArray) else res)
    return out


def _make_wrapper(op, name):
    if not op.wrap_ndarray:
        def raw_wrapper(*args, **kwargs):
            fn = _registry.resolve(op)
            if not (_has_nd(args) or _has_nd(kwargs.values())):
                return fn(*args, **kwargs)
            args = _unwrap_nested(args)
            kwargs = {k: _unwrap_nested(v) for k, v in kwargs.items()}
            return _rewrap_nested(fn(*args, **kwargs))

        wrapper = raw_wrapper
    else:
        def wrapper(*args, out=None, **kwargs):
            fn = _registry.resolve(op)
            if not (_has_nd(args) or _has_nd(kwargs.values()) or isinstance(out, NDArray)):
                res = fn(*args, **kwargs)
                return res if out is None else _copy_out(res, out)
            args = _unwrap_nested(args)
            kwargs = {k: _unwrap_nested(v) for k, v in kwargs.items()}
            res = _wrap_out(_run(fn, args, kwargs, op.differentiable))
            return res if out is None else _copy_out(res, out)

    wrapper.__name__ = name
    wrapper.__qualname__ = f"nd.{name}"
    wrapper.__doc__ = op.fn.__doc__
    return wrapper


def _wrapper(name):
    """The wrapper of the registered op ``name`` (one object per name)."""
    w = _WRAPPER_CACHE.get(name)
    if w is None:
        w = _WRAPPER_CACHE[name] = _make_wrapper(_registry.get_op(name), name)
    return w


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name == "Custom":  # the user's backward, not an op of the registry
        from ..operator import nd_custom
        return nd_custom
    for legacy in ("random_", "sample_"):
        if name.startswith(legacy):
            fn = getattr(random, name[len(legacy):], None)
            if fn is not None:
                return fn
    try:
        return _wrapper(name)
    except KeyError:
        raise AttributeError(f"module 'nd' has no operator {name!r}") from None


def __dir__():
    return sorted(set(globals()) | set(_registry.list_ops()))
