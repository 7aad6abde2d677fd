"""``gluon.contrib`` (parity: [U:python/mxnet/gluon/contrib/]): the port has
its ``rnn`` cells; ``estimator`` and ``nn`` wait in ROADMAP §1 item 11.4,
and their names raise, naming it."""
from . import rnn

__all__ = ["rnn"]

_QUEUED = ("estimator", "Estimator", "nn")


def __getattr__(name):
    if name in _QUEUED:
        raise AttributeError(f"mx.gluon.contrib.{name} is not ported yet: it waits in ROADMAP "
                             "§1 item 11.4")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
