"""``mx.nd.contrib``: contrib ops by their short names.

Counterpart of the JAX package's ``ndarray/contrib.py``: ``nd.contrib.<name>``
finds the op registered as ``contrib_<name>``, ``_contrib_<name>`` or
``<name>``, with ``mx.nd``'s wrapper (the same object as ``nd.<that name>``).
The control-flow ops ``foreach``, ``while_loop`` and ``cond`` are not
ported yet and raise.
"""
from __future__ import annotations

from ..ops import registry as _registry

_CONTROL_FLOW = ("foreach", "while_loop", "cond")


def _not_ported(name):
    def control_flow(*args, **kwargs):
        raise NotImplementedError(
            f"nd.contrib.{name} needs the control-flow ops (ops/control_flow.py), which "
            "the port has not ported yet")

    control_flow.__name__ = name
    return control_flow


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name in _CONTROL_FLOW:
        return _not_ported(name)
    from . import _wrapper

    for candidate in (f"contrib_{name}", f"_contrib_{name}", name):
        try:
            _registry.get_op(candidate)
        except KeyError:
            continue
        return _wrapper(candidate)
    raise AttributeError(f"nd.contrib has no op {name!r}")
