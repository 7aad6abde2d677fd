"""``mx.name`` — symbol naming discipline.

Parity target: [U:python/mxnet/name.py] (``NameManager``/``Prefix``).
Auto-generated symbol names flow through the innermost active
``NameManager``; ``Prefix`` prepends a fixed prefix to every name created
inside its scope (the idiom checkpoint compatibility depends on: the same
network built under ``with mx.name.Prefix('stage1_')`` produces
``stage1_fc0_weight`` argument names every run).

Counterpart of the JAX package's ``name.py``.  Naming is front-end
bookkeeping: names become the argument names of a bound executor and the
keys of saved checkpoints.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "name_stack"):
        _tls.name_stack = []
    return _tls.name_stack


class NameManager:
    """Scoped generator of unique symbol names.

    ``get(name, hint)`` returns ``name`` when the user supplied one,
    otherwise ``f"{hint}{n}"`` with a per-manager counter.  Instances are
    context managers; the innermost active one is used by ``mx.sym``.
    """

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        _stack().pop()
        return False


class Prefix(NameManager):
    """Prepend ``prefix`` to every name created in scope (explicit names
    included — matching the reference, where ``Prefix('p_')`` renames
    ``sym.Variable`` results too when routed through the manager)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


class _Default(NameManager):
    """Module-level fallback: shares the legacy thread-local counters so
    ``symbol._reset_naming()`` keeps working for tests."""

    def get(self, name, hint):
        if name:
            return name
        from .symbol.symbol import _auto_name
        return _auto_name(hint)


_DEFAULT = _Default()


def current():
    """The innermost active NameManager (or the process default)."""
    s = _stack()
    return s[-1] if s else _DEFAULT
