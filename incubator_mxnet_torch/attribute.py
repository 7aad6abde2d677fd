"""``mx.AttrScope`` — scoped symbol attributes.

Parity target: [U:python/mxnet/attribute.py].  Every symbol created inside
``with mx.AttrScope(ctx_group='dev1', lr_mult='0.1'):`` carries those
attributes; ``Symbol.attr(key)`` / ``Symbol.attr_dict()`` read them back.
The reference uses this for ``group2ctx`` model-parallel placement and
per-parameter optimizer multipliers.

Counterpart of the JAX package's ``attribute.py``.  Attributes ride the
Symbol DAG as metadata only.  Static op kwargs live in the same per-node
dict under their bare names, so scope attributes are stored dunder-wrapped
(``ctx_group`` → ``__ctx_group__``): the executor strips dunder keys
before calling the op, and the JSON round-trips them.  The port runs one
card, so ``ctx_group`` places nothing; the attribute is kept so reference
graphs keep their metadata through import and export.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_tls = threading.local()

# Keys whose dunder form collides with internal graph metadata
# (__shape__/__dtype__/__init__/__input_names__ in symbol.py) — user attrs
# may not use them, or they would silently corrupt shape/type inference.
_RESERVED = frozenset({"shape", "dtype", "init", "input_names"})


def _check_key(k, where):
    base = k.strip("_")
    if base in _RESERVED:
        raise ValueError(
            f"{where} key {k!r} is reserved for internal graph metadata "
            f"(reserved: {sorted(_RESERVED)})")


def _stack():
    if not hasattr(_tls, "attr_stack"):
        _tls.attr_stack = []
    return _tls.attr_stack


class AttrScope:
    """Context manager holding attributes to attach to symbols created in
    scope.  Nesting merges scopes; the innermost value wins, and explicit
    per-symbol attributes win over any scope."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            _check_key(k, "AttrScope")
            if not isinstance(v, str):
                raise ValueError(
                    "AttrScope values must be strings (parity with the "
                    f"reference attribute system); got {type(v).__name__}")
        self._attr = kwargs

    def get(self, attr=None):
        """Merge this scope's attributes with ``attr`` (``attr`` wins)."""
        if not self._attr:
            return dict(attr or {})
        merged = dict(self._attr)
        merged.update(attr or {})
        return merged

    def __enter__(self):
        s = _stack()
        merged = dict(s[-1]._attr) if s else {}
        merged.update(self._attr)
        scope = AttrScope.__new__(AttrScope)
        scope._attr = merged
        s.append(scope)
        return scope

    def __exit__(self, exc_type, exc, tb):
        _stack().pop()
        return False


_EMPTY = AttrScope()


def current():
    """The innermost active AttrScope (or an empty one)."""
    s = _stack()
    return s[-1] if s else _EMPTY
