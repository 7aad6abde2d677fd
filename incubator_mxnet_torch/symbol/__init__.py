"""``mx.sym`` / ``mx.symbol`` namespace.

Counterpart of the JAX package's ``symbol/__init__.py``.  Op wrappers are
made on attribute access from the same op registry as ``mx.nd`` (parity:
the reference generates both namespaces from the one C op registry —
[U:python/mxnet/symbol/register.py]).  A name the JAX package registers
and the port does not yet raises ``AttributeError`` naming the ROADMAP
queue it waits in.
"""
from __future__ import annotations

from ..ops import registry as _registry
from .symbol import (
    Symbol,
    Variable,
    var,
    Group,
    load,
    load_json,
    zeros,
    ones,
    _make_sym_op,
    _bind_fluent_methods,
    _missing_op,
)

_bind_fluent_methods()  # registry is fully populated by the ..ops import

from . import contrib  # noqa: E402  (mx.sym.contrib namespace)

__all__ = [
    "Symbol",
    "Variable",
    "var",
    "Group",
    "load",
    "load_json",
    "zeros",
    "ones",
]


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    try:
        _registry.get_op(name)
    except KeyError:
        raise _missing_op(name) from None
    w = _make_sym_op(name)
    globals()[name] = w
    return w


def __dir__():
    return sorted(set(list(globals()) + _registry.list_ops()))
