"""Device contexts: ``mx.cpu()`` and ``mx.gpu()`` over ``torch.device``.

Counterpart of the JAX package's ``context.py``.  The port runs on the
card unless the caller asks for the CPU: ``current_context()`` defaults to
``gpu(0)``, and resolving a GPU context on a machine without one raises
instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context", "current_device",
           "num_gpus"]

_tls = threading.local()


class Context:
    """A device context (parity: ``mxnet.context.Context``); ``device``
    names the ``torch.device`` it stands for (``cpu_pinned``: the CPU)."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if device_type not in ("cpu", "gpu", "cpu_pinned"):
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device(self):
        """The ``torch.device``; a GPU context raises when no card is there."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if self.device_id >= n:
            raise MXNetError(
                f"{self} requested but this machine has {n} CUDA device(s); "
                "pass ctx=mx.cpu() to run on the CPU")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def empty_cache(self):
        """Release the cached blocks of PyTorch's allocator on this card
        (parity: ``Context.empty_cache``); on the CPU a garbage
        collection."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.device):
                torch.cuda.empty_cache()
        else:
            import gc

            gc.collect()


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """The CPU context of page-locked memory (parity: ``mx.cpu_pinned``)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def current_context():
    """The innermost ``with ctx:`` context, else ``gpu(0)``."""
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)


def current_device():
    return current_context()


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
