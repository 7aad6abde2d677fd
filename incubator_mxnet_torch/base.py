"""Error types and the dtype table of the PyTorch port.

Counterpart of the JAX package's ``base.py``: MXNet's dtype names map onto
``torch.dtype`` here instead of numpy/JAX dtypes.
"""
from __future__ import annotations

import weakref

import numpy as _np
import torch

__all__ = [
    "MXNetError",
    "DeferredInitializationError",
    "as_torch_dtype",
    "dtype_name",
    "register_jit_cache_owner",
    "invalidate_jit_caches",
]


class MXNetError(RuntimeError):
    """Framework-level error (parity: MXNetError in the reference)."""


class DeferredInitializationError(MXNetError):
    """Raised when a Parameter's value is accessed before shape inference
    completed."""


_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _settle_cpu_log():
    """Call PyTorch's CPU ``log`` once, on this thread, at a size of one
    chunk.  PyTorch hands a float ``log`` on the CPU to MKL in chunks of
    2048 elements across its OpenMP pool; when the first call of a process
    came from several workers at once, the chunks of one or two of them
    came back off by up to 4e-5 relative (5 processes in 280, that first
    call only; ``exp``, ``tanh`` and ``sqrt`` never, in 100).  After one
    call from a single thread, 0 in 500."""
    torch.log(torch.ones(8))


_settle_cpu_log()


def as_torch_dtype(dtype):
    """Normalize a user dtype (MXNet name | numpy dtype | torch.dtype) to a
    ``torch.dtype``; the counterpart of ``_as_np_dtype``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype):
    """MXNet's name for a dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return _NAMES[as_torch_dtype(dtype)]


# Objects holding built programs (captured graphs, plans) that a change of
# the op dispatch (``amp.init``) makes stale; held weakly.
_jit_cache_owners = weakref.WeakSet()


def register_jit_cache_owner(obj):
    """Register ``obj`` (with an ``_invalidate_jit_cache()`` method) for
    :func:`invalidate_jit_caches`."""
    _jit_cache_owners.add(obj)


def invalidate_jit_caches():
    """Drop every registered owner's built programs: the next call builds
    anew under the current dispatch."""
    for obj in list(_jit_cache_owners):
        obj._invalidate_jit_cache()
