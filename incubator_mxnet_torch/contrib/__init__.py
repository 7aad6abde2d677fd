"""``mx.contrib`` (parity: [U:python/mxnet/contrib/]): ``amp`` (the
top-level module, at the reference's import path) and ``quantization``
(``quantize_net``).  ``onnx``, ``text`` and ``svrg_optimization`` wait in
ROADMAP §1 item 11.4, and their names raise, naming it."""
from .. import amp  # noqa: F401  (the reference's path: mx.contrib.amp)
from . import quantization  # noqa: F401

__all__ = ["amp", "quantization"]

_QUEUED = ("onnx", "text", "svrg_optimization")


def __getattr__(name):
    if name in _QUEUED:
        raise AttributeError(f"mx.contrib.{name} is not ported yet: it waits in ROADMAP "
                             "§1 item 11.4")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
