"""The fused whole-group optimizer update: the hand-written multi-tensor
kernel's wrappers (``multi_tensor_update``, ``multi_tensor_lamb``,
``sum_sq_finite``) and the table they hand the kernels.

Counterpart of the one jitted XLA dispatch of the JAX package's
``ops/optimizer_ops.py`` ``group_apply``.  One launch of
``ops/csrc/multi_tensor.cu`` updates a chunk of up to 256 tensors (its
table is one launch parameter) in place with one variant (``VARIANTS``);
its plain version is the loop of the per-tensor ops, ``optimizer_ops.group_apply_plain``, which
``group_apply`` takes for a group on the CPU.  A CUDA group launches the
kernel or raises.  LAMB (``multi_tensor_lamb``) is two launches a chunk:
the moments and each block's partial norms, then the trust ratio and the
weight.  ``sum_sq_finite`` is one launch a chunk that writes per tensor
the sum of squares and the count of non-finite elements
(``multi_sum_sq``, ``all_finite`` and ``amp.LossScaler.has_overflow`` on
the card).

The table, built on the host (``table``): per tensor the pointers of the
weight, its gradient and its fp32 states and its size, which the C entry
cuts into blocks and hands the kernel as a launch parameter.  The values
that change from step to step are not in it: the kernel reads them from
device memory, ``rows`` of fp32 values per chunk (each tensor's lr, wd
and two coefficients c1 and c2, then the group's sixteen scalars rounded
to fp32, with ``clip`` -1 for both no-clip sentinels, a negative clip or
+inf).  The coefficients: Adam's bias-corrected rate as c1; for AdamW the
fp32 reciprocals of its two bias corrections, for LAMB the corrections
themselves (``optimizer_ops._rates``).  An
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

__all__ = ["VARIANTS", "CAPACITY", "ROWS", "SCALARS", "table", "rows", "multi_tensor_update",
           "multi_tensor_lamb", "sum_sq_finite"]

# variant: (kernel code, fp32 state arrays per tensor); lamb has its own entry
VARIANTS = {"sgd": (0, 0), "sgd_mom": (1, 1), "mp_sgd": (2, 1), "mp_sgd_mom": (3, 2),
            "adam": (4, 2), "mp_adam": (5, 3), "nag_mom": (6, 1), "mp_nag_mom": (7, 2),
            "adamw": (8, 2), "rmsprop": (9, 1), "rmspropalex": (10, 3), "lamb": (11, 2)}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SLOTS = 5  # pointer rows of the table: weight, grad, three states
CAPACITY = 256  # tensors one launch takes: MAX_TENSORS of multi_tensor.cu
ROWS = 4  # values a tensor: lr, wd, c1, c2
SCALARS = 16


def _lib():
    lib = _cuda.load("multi_tensor")
    if lib.mx_multi_tensor.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mx_multi_tensor.argtypes = [i, i, i] + [ptr] * 4
        lib.mx_multi_tensor.restype = i
        lib.mx_multi_tensor_lamb.argtypes = [i, i] + [ptr] * 4 + [ll, ptr]
        lib.mx_multi_tensor_lamb.restype = i
        lib.mx_multi_tensor_finite.argtypes = [i, i] + [ptr] * 3 + [ll] + [ptr] * 3
        lib.mx_multi_tensor_finite.restype = i
        lib.mx_multi_tensor_capacity.restype = i
        lib.mx_multi_tensor_chunk.restype = i
        lib.mx_multi_tensor_values.argtypes = [i]
        lib.mx_multi_tensor_values.restype = i
        if (lib.mx_multi_tensor_capacity() != CAPACITY
                or lib.mx_multi_tensor_values(1) != ROWS + SCALARS):
            raise RuntimeError("multi_tensor.cu's capacity or value layout differs from "
                               "ops/multi_tensor.py's")
    return lib


def _scalars(S):
    """The group's scalars as the kernel takes them, each rounded to fp32:
    rescale, clip (-1: none), momentum, beta1, 1 - beta1, beta2, 1 - beta2,
    epsilon, rho, 1 - rho, eta, lower bound, upper bound, three zeros."""
    f = np.float32
    clip = f(S.get("clip", -1.0))
    b1, b2, rho = f(S.get("beta1", 0.0)), f(S.get("beta2", 0.0)), f(S.get("rho", 0.0))
    return np.array([S["rescale"], clip if 0 <= clip < math.inf else -1.0,
                     S.get("momentum", 0.0), b1, f(1) - b1, b2, f(1) - b2,
                     S.get("epsilon", 0.0), rho, f(1) - rho, S.get("eta", 0.0),
                     S.get("lower_bound", 0.0), S.get("upper_bound", 0.0), 0.0, 0.0, 0.0],
                    dtype=np.float32)


def _chunk_rows(lrs, wds, c1s, c2s, scalars):
    return np.concatenate([np.asarray(x, dtype=np.float32) for x in (lrs, wds, c1s, c2s)]
                          + [_scalars(scalars)])


def rows(lrs, wds, c1s, c2s, scalars):
    """The fp32 values the kernel reads from device memory for a whole
    group, chunk after chunk of ``CAPACITY`` tensors: each chunk's ``lr``,
    ``wd``, ``c1`` and ``c2`` rows, then the group's sixteen scalars
    (4n + 16 values a chunk of n)."""
    lrs, wds, c1s, c2s = list(lrs), list(wds), list(c1s), list(c2s)
    return np.concatenate([_chunk_rows(*(x[a:a + CAPACITY] for x in (lrs, wds, c1s, c2s)),
                                       scalars)
                           for a in range(0, len(lrs), CAPACITY)])


def table(variant, weights, grads, states, lrs, wds, c1s, c2s, scalars):
    """The kernel's table of one chunk, as numpy arrays: ``ptrs`` [5, n]
    (weight, grad, states; 0 where the variant has fewer) and ``numel`` [n],
    the launch parameter; ``lr``, ``wd``, ``c1``, ``c2`` [n] fp32 and
    ``scalars`` [16] fp32, and ``rows``, the 4n + 16 values of those five in
    the order the kernel reads them from device memory.  Raises when the chunk is not one
    the kernel takes: tensors on more than one device,
    weights of more than one dtype or of one it has no instance for, a
    gradient or state that does not match its weight, a tensor that is not
    contiguous, the wrong number of states."""
    if variant not in VARIANTS:
        raise ValueError(f"multi_tensor: unknown variant {variant!r}")
    nstates = VARIANTS[variant][1]
    n = len(weights)
    if not (len(grads) == len(states) == len(lrs) == len(wds) == len(c1s) == len(c2s) == n):
        raise ValueError("multi_tensor: weights, grads, states, lrs, wds, c1s and c2s differ "
                         "in length")
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
    lr, wd, c1, c2 = (np.asarray(x, dtype=np.float32) for x in (lrs, wds, c1s, c2s))
    return {"ptrs": ptrs, "numel": numel, "dtype": dtype, "lr": lr, "wd": wd, "c1": c1,
            "c2": c2, "scalars": _scalars(scalars),
            "rows": _chunk_rows(lr, wd, c1, c2, scalars)}


def _staged(dev, n, host_rows, device_rows):
    """The device buffer of a group's values: ``host_rows`` copied to the
    card through pinned memory on the current stream, or the caller's
    ``device_rows`` after checking that it holds ``n`` tensors' values."""
    need = n * ROWS + -(-n // CAPACITY) * SCALARS
    if device_rows is None:
        return torch.from_numpy(host_rows()).pin_memory().to(dev, non_blocking=True)
    if (device_rows.device != dev or device_rows.dtype != torch.float32
            or device_rows.numel() != need or not device_rows.is_contiguous()):
        raise ValueError(f"multi_tensor: device_rows must be {need} contiguous fp32 values on "
                         f"{dev}, got {device_rows.dtype} {tuple(device_rows.shape)} on "
                         f"{device_rows.device}")
    return device_rows


def _cuda_device(name, tensors):
    dev = tensors[0].device if tensors else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    return dev


def _chunks(name, variant, weights, grads, states, lrs, wds, c1s, c2s, scalars, device_rows):
    """``(device, chunks)`` for a launch over a CUDA group: ``chunks``
    yields, chunk after chunk of ``CAPACITY`` tensors, the chunk's
    :func:`table` and the device address of its values (``device_rows``,
    or the group's rows staged on the card), skipping chunks of empty
    tensors."""
    weights, grads, states, lrs, wds, c1s, c2s = (
        list(x) for x in (weights, grads, states, lrs, wds, c1s, c2s))
    dev = _cuda_device(name, weights)
    device_rows = _staged(dev, len(weights), lambda: rows(lrs, wds, c1s, c2s, scalars),
                          device_rows)

    def each():
        offset = 0
        for a in range(0, len(weights), CAPACITY):
            z = slice(a, a + CAPACITY)
            t = table(variant, weights[z], grads[z], states[z], lrs[z], wds[z], c1s[z],
                      c2s[z], scalars)
            vals = device_rows.data_ptr() + 4 * offset
            offset += len(t["rows"])
            if t["numel"].any():  # else every tensor is empty: nothing to launch
                yield t, vals

    return dev, each()


def blocks(numel):
    """The blocks a launch over tensors of these sizes runs: each tensor is
    cut into ``CHUNK``-element slices (the scratch of LAMB and of the finite
    pass is sized by them)."""
    chunk = _lib().mx_multi_tensor_chunk()
    return sum(-(-int(m) // chunk) for m in numel)


def multi_tensor_update(variant, weights, grads, states, lrs, wds, c1s, c2s, scalars,
                        device_rows=None, scratch=None):
    """Update a group of CUDA tensors in place: one launch of the kernel per
    chunk of ``CAPACITY`` tensors (two for ``"lamb"``, see
    :func:`multi_tensor_lamb`, which takes ``scratch``).  ``states[i]`` is
    tensor i's tuple of fp32 states in the variant's order;
    ``lrs``/``wds``/``c1s``/``c2s`` one float per tensor; ``scalars`` the
    group's dict (rescale, clip, momentum, beta1, beta2, epsilon, rho, eta,
    lower_bound, upper_bound).

    The kernel reads those values from device memory: by default they are
    laid out by :func:`rows`, staged in pinned memory and copied to the card
    on the launch stream (no synchronization).  ``device_rows``, a
    contiguous fp32 CUDA tensor of ``len(rows(...))`` values, is read
    instead, and then ``lrs``/``wds``/``c1s``/``c2s``/``scalars`` are not: a
    caller that captures the launch in a CUDA graph fills it before each
    replay.  ``multi_tensor_update.launches`` counts the launches of the
    elementwise variants, ``launches_by_variant`` splits them."""
    if variant == "lamb":
        return multi_tensor_lamb(weights, grads, states, lrs, wds, c1s, c2s, scalars,
                                 device_rows=device_rows, scratch=scratch)
    dev, chunks = _chunks("multi_tensor_update", variant, weights, grads, states, lrs, wds,
                          c1s, c2s, scalars, device_rows)
    lib = _lib()
    code = VARIANTS[variant][0] if variant in VARIANTS else -1
    for t, vals in chunks:
        with torch.cuda.device(dev):
            rc = lib.mx_multi_tensor(
                code, _DTYPE_CODE[t["dtype"]], len(t["numel"]), t["ptrs"].ctypes.data,
                t["numel"].ctypes.data, vals, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"multi_tensor_update launch failed with CUDA error {rc}")
        multi_tensor_update.launches += 1
        multi_tensor_update.launches_by_variant[variant] = (
            multi_tensor_update.launches_by_variant.get(variant, 0) + 1)
    return weights, states


multi_tensor_update.launches = 0
multi_tensor_update.launches_by_variant = {}


def lamb_scratch(weights):
    """A scratch buffer for :func:`multi_tensor_lamb` over ``weights``: 8
    bytes (two fp32 partial sums) a block of the largest chunk."""
    weights = list(weights)
    need = max(blocks([w.numel() for w in weights[a:a + CAPACITY]])
               for a in range(0, len(weights), CAPACITY))
    return torch.empty(2 * max(need, 1), dtype=torch.float32, device=weights[0].device)


def multi_tensor_lamb(weights, grads, states, lrs, wds, c1s, c2s, scalars, device_rows=None,
                      scratch=None):
    """LAMB over a group of CUDA tensors in place: per chunk of ``CAPACITY``
    tensors two launches, pass 1 (the moments and each block's partial sums
    of w² and r²) and pass 2 (each tensor's trust ratio from its partials,
    summed in a fixed order, and the weight).  ``states[i]`` is (mean, var);
    ``c1s``/``c2s`` the bias corrections 1 − β^t (1 without them);
    ``scalars`` also hold lower_bound and upper_bound.  ``device_rows`` as in
    :func:`multi_tensor_update`; ``scratch`` is the partials' buffer
    (:func:`lamb_scratch`), which a caller that captures the launches in a
    CUDA graph owns; without it each call takes one from PyTorch's caching
    allocator.  ``multi_tensor_lamb.launches`` counts both passes."""
    dev, chunks = _chunks("multi_tensor_lamb", "lamb", weights, grads, states, lrs, wds, c1s,
                          c2s, scalars, device_rows)
    if scratch is None:
        scratch = lamb_scratch(weights)
    if scratch.device != dev or not scratch.is_contiguous():
        raise ValueError(f"multi_tensor_lamb: scratch must be contiguous on {dev}")
    lib = _lib()
    for t, vals in chunks:
        with torch.cuda.device(dev):
            rc = lib.mx_multi_tensor_lamb(
                _DTYPE_CODE[t["dtype"]], len(t["numel"]), t["ptrs"].ctypes.data,
                t["numel"].ctypes.data, vals, scratch.data_ptr(),
                scratch.numel() * scratch.element_size(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"multi_tensor_lamb launch failed with CUDA error {rc}")
        multi_tensor_lamb.launches += 2
    return weights, states


multi_tensor_lamb.launches = 0


def sum_sq_finite(tensors):
    """Per tensor of a list of CUDA tensors (fp32, fp16 or bf16, contiguous,
    any mix): the fp32 sum of squares and the int32 count of non-finite
    elements, as two CUDA tensors of ``len(tensors)`` values.  One launch a
    chunk of up to ``CAPACITY`` tensors of one dtype (``sum_sq_finite.launches``);
    the card is not synchronised.  A non-finite element makes its tensor's
    sum non-finite too; read the count to tell a large finite gradient,
    whose square may overflow, from an overflowed one."""
    tensors = list(tensors)
    dev = _cuda_device("sum_sq_finite", tensors)
    lib = _lib()
    n = len(tensors)
    sq = torch.empty(n, dtype=torch.float32, device=dev)
    bad = torch.empty(n, dtype=torch.int32, device=dev)
    by_dtype = {}
    for i, x in enumerate(tensors):
        if x.device != dev or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
            raise ValueError(f"sum_sq_finite: tensor {i} ({x.dtype} on {x.device}) is not a "
                             f"contiguous float32, float16 or bfloat16 tensor on {dev}")
        by_dtype.setdefault(x.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        for a in range(0, len(idx), CAPACITY):
            chunk = idx[a:a + CAPACITY]
            numel = np.array([tensors[i].numel() for i in chunk], dtype=np.int64)
            if not numel.any():
                sq[chunk] = 0.0
                bad[chunk] = 0
                continue
            ptrs = np.array([tensors[i].data_ptr() for i in chunk], dtype=np.uint64)
            nblocks = blocks(numel)
            scratch = torch.empty(2 * nblocks + len(chunk), dtype=torch.int32, device=dev)
            contiguous = chunk == list(range(chunk[0], chunk[0] + len(chunk)))
            out_sq = sq[chunk[0]:chunk[0] + len(chunk)] if contiguous else torch.empty(
                len(chunk), dtype=torch.float32, device=dev)
            out_bad = bad[chunk[0]:chunk[0] + len(chunk)] if contiguous else torch.empty(
                len(chunk), dtype=torch.int32, device=dev)
            with torch.cuda.device(dev):
                rc = lib.mx_multi_tensor_finite(
                    _DTYPE_CODE[dtype], len(chunk), ptrs.ctypes.data, numel.ctypes.data,
                    scratch.data_ptr(), scratch.numel() * 4, out_sq.data_ptr(),
                    out_bad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"sum_sq_finite launch failed with CUDA error {rc}")
            sum_sq_finite.launches += 1
            if not contiguous:
                sq[chunk] = out_sq
                bad[chunk] = out_bad
    return sq, bad


sum_sq_finite.launches = 0
