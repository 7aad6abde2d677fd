"""``mx.nd.contrib``: contrib ops by their short names.

Counterpart of the JAX package's ``ndarray/contrib.py``: ``nd.contrib.<name>``
finds the op registered as ``contrib_<name>``, ``_contrib_<name>`` or
``<name>``, with ``mx.nd``'s wrapper (the same object as ``nd.<that name>``).
The control-flow ops ``foreach``, ``while_loop`` and ``cond`` take
callables, not arrays, and are ``ops/control_flow.py``'s functions.
"""
from __future__ import annotations

from ..ops import control_flow as _control_flow
from ..ops import registry as _registry


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name in _control_flow.__all__:
        return getattr(_control_flow, name)
    from . import _wrapper

    for candidate in (f"contrib_{name}", f"_contrib_{name}", name):
        try:
            _registry.get_op(candidate)
        except KeyError:
            continue
        return _wrapper(candidate)
    raise AttributeError(f"nd.contrib has no op {name!r}")
