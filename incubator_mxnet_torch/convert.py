"""Carry weights into the port by structural key.

``load_numpy_params(block, arrays)`` takes ``{key: array}`` (numpy arrays,
tensors or NDArrays) keyed as
``Block._collect_params_with_prefix()`` keys parameters in both packages
(``bert.encoder.layer0.attention.qkv.weight``), so the global name-prefix
counters of the two need not agree.  Weights keep MXNet's ``[out, in]``
layout.  The caller builds the dict (from the JAX package, a checkpoint,
anything); values are brought to the host as numpy arrays first.
"""
from __future__ import annotations

import numpy as np
import torch

from . import initializer

__all__ = ["load_numpy_params"]


def load_numpy_params(block, arrays, ctx=None):
    """Materialize and fill every parameter of ``block`` from ``arrays``.

    Raises ``KeyError`` on a missing or an extra key and ``ValueError`` on a
    shape mismatch, before any parameter is touched.  A parameter that was
    never initialized is materialized on ``ctx`` (default: the current
    context); one already initialized or deferred keeps its device.  Values
    are cast to each parameter's dtype."""
    params = block._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {missing}, extra {extra}")
    values = {}
    for key, param in params.items():
        arr = arrays[key]
        arr = getattr(arr, "_data", arr)  # an NDArray's tensor
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().float().cpu() if arr.dtype == torch.bfloat16 else arr.detach().cpu()
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch counterpart
            arr = arr.astype(np.float32)
        want = param.shape
        if want is None or len(want) != arr.ndim or any(
                w not in (0, n) for w, n in zip(want, arr.shape)):
            raise ValueError(f"{key}: shape {arr.shape} does not fit parameter shape {want}")
        values[key] = arr
    for key, param in params.items():
        if param._data is None and param._deferred_init is None:
            param.initialize(init=initializer.Zero(), ctx=ctx)
        param.set_data(values[key])
