"""``mx.sym.contrib`` namespace (parity: [U:python/mxnet/contrib/symbol.py]).

Counterpart of the JAX package's ``symbol/contrib.py``.  Same name
resolution as ``nd.contrib``: ops registered with a ``contrib_``/``_contrib_``
prefix are reachable without it, and every top-level op is also visible.
Control-flow ops (foreach/while_loop/cond) take subgraph callables and live
on the nd side only — under Symbol, use the op graph directly.
"""
from __future__ import annotations

from ..ops import registry as _registry
from .symbol import _QUEUE_OF, _make_sym_op, _missing_op

_CACHE = {}


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name in _CACHE:
        return _CACHE[name]
    candidates = (f"contrib_{name}", f"_contrib_{name}", name)
    for candidate in candidates:
        try:
            _registry.get_op(candidate)
        except KeyError:
            continue
        w = _make_sym_op(candidate)
        _CACHE[name] = w
        return w
    queued = next((c for c in candidates if c in _QUEUE_OF), name)
    raise _missing_op(queued, "sym.contrib")


def __dir__():
    names = set()
    for n in _registry.list_ops():
        names.add(n)
        for pre in ("contrib_", "_contrib_"):
            if n.startswith(pre):
                names.add(n[len(pre):])
    return sorted(names)
