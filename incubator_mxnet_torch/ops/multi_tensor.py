"""The fused whole-group optimizer update: the hand-written multi-tensor
kernel's wrapper (``multi_tensor_update``) and the table it hands the
kernel.

Counterpart of the one jitted XLA dispatch of the JAX package's
``ops/optimizer_ops.py`` ``group_apply``.  One launch of
``ops/csrc/multi_tensor.cu`` updates a chunk of up to 256 tensors (its
table is one launch parameter) in place with one variant (``VARIANTS``);
its plain version is the loop of the per-tensor ops, ``optimizer_ops.group_apply_plain``, which
``group_apply`` takes for a group on the CPU.  A CUDA group launches the
kernel or raises.

The table, built on the host (``table``): per tensor the pointers of the
weight, its gradient and its fp32 states and its size, which the C entry
cuts into blocks and hands the kernel as a launch parameter.  The values
that change from step to step are not in it: the kernel reads them from
device memory, ``rows`` of fp32 values per chunk (each tensor's lr, wd
and Adam's bias-corrected rate, then the group's scalars rounded to fp32,
with ``clip`` -1 for both no-clip sentinels, a negative clip or +inf).  An
eager call stages them through pinned memory and copies them to the card
on the launch stream; a caller that captures the launches in a CUDA graph
(``gluon/step_fold.py``) hands over a device buffer of its own, which it
refreshes before every replay.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _cuda

__all__ = ["VARIANTS", "CAPACITY", "table", "rows", "multi_tensor_update"]

# variant: (kernel code, fp32 state arrays per tensor)
VARIANTS = {"sgd": (0, 0), "sgd_mom": (1, 1), "mp_sgd": (2, 1), "mp_sgd_mom": (3, 2),
            "adam": (4, 2), "mp_adam": (5, 3)}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SLOTS = 5  # pointer rows of the table: weight, grad, three states
CAPACITY = 256  # tensors one launch takes: MAX_TENSORS of multi_tensor.cu
_SCALARS = 8


def _lib():
    lib = _cuda.load("multi_tensor")
    if lib.mx_multi_tensor.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.mx_multi_tensor.argtypes = [i, i, i] + [ptr] * 4
        lib.mx_multi_tensor.restype = i
        lib.mx_multi_tensor_capacity.restype = i
        lib.mx_multi_tensor_values.argtypes = [i]
        lib.mx_multi_tensor_values.restype = i
        if (lib.mx_multi_tensor_capacity() != CAPACITY
                or lib.mx_multi_tensor_values(1) != 3 + _SCALARS):
            raise RuntimeError("multi_tensor.cu's capacity or value layout differs from "
                               "ops/multi_tensor.py's")
    return lib


def _scalars(S):
    """The group's scalars as the kernel takes them, each rounded to fp32."""
    f = np.float32
    clip = f(S.get("clip", -1.0))
    b1, b2 = f(S.get("beta1", 0.0)), f(S.get("beta2", 0.0))
    return np.array([S["rescale"], clip if 0 <= clip < math.inf else -1.0,
                     S.get("momentum", 0.0), b1, f(1) - b1, b2, f(1) - b2,
                     S.get("epsilon", 0.0)], dtype=np.float32)


def _chunk_rows(lrs, wds, lrts, scalars):
    return np.concatenate([np.asarray(lrs, dtype=np.float32), np.asarray(wds, dtype=np.float32),
                           np.asarray(lrts, dtype=np.float32), _scalars(scalars)])


def rows(lrs, wds, lrts, scalars):
    """The fp32 values the kernel reads from device memory for a whole
    group, chunk after chunk of ``CAPACITY`` tensors: each chunk's ``lr``,
    ``wd`` and ``lrt`` rows, then the group's eight scalars (3n + 8 values a
    chunk of n)."""
    lrs, wds, lrts = list(lrs), list(wds), list(lrts)
    return np.concatenate([_chunk_rows(lrs[a:a + CAPACITY], wds[a:a + CAPACITY],
                                       lrts[a:a + CAPACITY], scalars)
                           for a in range(0, len(lrs), CAPACITY)])


def table(variant, weights, grads, states, lrs, wds, lrts, scalars):
    """The kernel's table of one chunk, as numpy arrays: ``ptrs`` [5, n]
    (weight, grad, states; 0 where the variant has fewer) and ``numel`` [n],
    the launch parameter; ``lr``, ``wd``, ``lrt`` [n] fp32 and ``scalars``
    [8] fp32, and ``rows``, the 3n + 8 values of those four in the order the
    kernel reads them from device memory.  Raises when the chunk is not one
    the kernel takes: tensors on more than one device,
    weights of more than one dtype or of one it has no instance for, a
    gradient or state that does not match its weight, a tensor that is not
    contiguous, the wrong number of states."""
    if variant not in VARIANTS:
        raise ValueError(f"multi_tensor: unknown variant {variant!r}")
    nstates = VARIANTS[variant][1]
    n = len(weights)
    if not (len(grads) == len(states) == len(lrs) == len(wds) == len(lrts) == n):
        raise ValueError("multi_tensor: weights, grads, states, lrs, wds and lrts differ in "
                         "length")
    if n == 0:
        raise ValueError("multi_tensor: an empty chunk")
    dev, dtype = weights[0].device, weights[0].dtype
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"multi_tensor: weight dtype {dtype} is not float32, float16 or "
                         f"bfloat16")
    ptrs = np.zeros((_SLOTS, n), dtype=np.uint64)
    numel = np.empty(n, dtype=np.int64)
    for i, (w, g, st) in enumerate(zip(weights, grads, states)):
        if len(st) != nstates:
            raise ValueError(f"multi_tensor: {variant} takes {nstates} states a tensor, "
                             f"tensor {i} has {len(st)}")
        if w.device != dev or w.dtype != dtype:
            raise ValueError(f"multi_tensor: one chunk holds one device and one dtype; tensor "
                             f"{i} is {w.dtype} on {w.device}, tensor 0 {dtype} on {dev}")
        if g.device != dev or g.dtype != dtype or g.numel() != w.numel():
            raise ValueError(f"multi_tensor: gradient {i} ({g.dtype}, {g.numel()} elements on "
                             f"{g.device}) does not match its weight ({dtype}, {w.numel()} on "
                             f"{dev})")
        for s in st:
            if s.device != dev or s.dtype != torch.float32 or s.numel() != w.numel():
                raise ValueError(f"multi_tensor: a state of tensor {i} ({s.dtype}, "
                                 f"{s.numel()} elements on {s.device}) is not fp32 of its "
                                 f"weight's size on {dev}")
        for x in (w, g, *st):
            if not x.is_contiguous():
                raise ValueError(f"multi_tensor: tensor {i} has a non-contiguous operand "
                                 f"(strides {x.stride()})")
        ptrs[0, i], ptrs[1, i] = w.data_ptr(), g.data_ptr()
        for k, s in enumerate(st):
            ptrs[2 + k, i] = s.data_ptr()
        numel[i] = w.numel()
    lr, wd, lrt = (np.asarray(x, dtype=np.float32) for x in (lrs, wds, lrts))
    return {"ptrs": ptrs, "numel": numel, "lr": lr, "wd": wd, "lrt": lrt,
            "scalars": _scalars(scalars), "rows": _chunk_rows(lr, wd, lrt, scalars)}


def multi_tensor_update(variant, weights, grads, states, lrs, wds, lrts, scalars,
                        device_rows=None):
    """Update a group of CUDA tensors in place: one launch of the kernel per
    chunk of ``CAPACITY`` tensors.  ``states[i]`` is tensor i's tuple of
    fp32 states in the variant's order; ``lrs``/``wds``/``lrts`` (Adam's
    bias-corrected rates) one float per tensor; ``scalars`` the group's dict
    (rescale, clip, momentum, beta1, beta2, epsilon).

    The kernel reads those values from device memory: by default they are
    laid out by :func:`rows`, staged in pinned memory and copied to the card
    on the launch stream (no synchronization).  ``device_rows``, a
    contiguous fp32 CUDA tensor of ``len(rows(...))`` values, is read
    instead, and then ``lrs``/``wds``/``lrts``/``scalars`` are not: a caller
    that captures the launch in a CUDA graph fills it before each replay.
    ``multi_tensor_update.launches`` counts the launches,
    ``launches_by_variant`` splits them."""
    weights = list(weights)
    dev = weights[0].device if weights else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"multi_tensor_update runs on CUDA tensors, got {dev}")
    grads, states, lrs, wds, lrts = (list(x) for x in (grads, states, lrs, wds, lrts))
    lib = _lib()
    code = VARIANTS[variant][0] if variant in VARIANTS else -1
    need = len(weights) * 3 + -(-len(weights) // CAPACITY) * _SCALARS
    if device_rows is None:
        host = torch.from_numpy(rows(lrs, wds, lrts, scalars)).pin_memory()
        device_rows = host.to(dev, non_blocking=True)
    elif (device_rows.device != dev or device_rows.dtype != torch.float32
          or device_rows.numel() != need or not device_rows.is_contiguous()):
        raise ValueError(f"multi_tensor_update: device_rows must be {need} contiguous fp32 "
                         f"values on {dev}, got {device_rows.dtype} "
                         f"{tuple(device_rows.shape)} on {device_rows.device}")
    offset = 0
    for a in range(0, len(weights), CAPACITY):
        z = slice(a, a + CAPACITY)
        t = table(variant, weights[z], grads[z], states[z], lrs[z], wds[z], lrts[z], scalars)
        vals = device_rows.data_ptr() + 4 * offset
        offset += len(t["rows"])
        if not t["numel"].any():
            continue  # every tensor empty: nothing to launch
        with torch.cuda.device(dev):
            rc = lib.mx_multi_tensor(
                code, _DTYPE_CODE[weights[0].dtype], len(t["numel"]), t["ptrs"].ctypes.data,
                t["numel"].ctypes.data, vals, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"multi_tensor_update launch failed with CUDA error {rc}")
        multi_tensor_update.launches += 1
        multi_tensor_update.launches_by_variant[variant] = (
            multi_tensor_update.launches_by_variant.get(variant, 0) + 1)
    return weights, states


multi_tensor_update.launches = 0
multi_tensor_update.launches_by_variant = {}
