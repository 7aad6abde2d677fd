"""Scaled-dot-product attention: the hand-written flash-attention kernels
(forward, and the dq and dk/dv backward passes) and their plain PyTorch
versions.

Counterpart of the JAX package's ``ops/attention.py``.  There, Pallas
kernels (``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) served
long sequences on the TPU and XLA the rest.  Here every attention call on
a CUDA tensor launches the port's own kernels, ``ops/csrc/flash_fwd.cu``,
``flash_bwd.cu`` and ``flash_wide.cu``, whatever the sequence length; a
tensor on the CPU takes the plain versions, which the CPU tests hold
against the JAX package.  There is no other route: a CUDA call a kernel cannot take
raises.

Layouts: the kernels read q/k/v (and o, do) through batch, head and
sequence strides (unit stride on Dh), so ``fused_qkv_attention`` hands
them the ``[B, S, 3, H, Dh]`` view of the QKV projection with no copy,
o lands in ``[B, S, H, Dh]`` for the output projection, and the backward
writes dq, dk and dv straight into the three slices of one
``[B, S, 3, H, Dh]`` gradient.

Operands: the wrappers take what the JAX functions take, any head dim.
A head dim the kernels have no instance for (48, 80, 160, ...) is
zero-padded to the next one they have (zero columns add nothing to q·kᵀ,
to rowsum(do∘o) or to any product), with the scale of the true head dim,
and the outputs are sliced back.  The widest 16-bit instance of
``flash_fwd.cu`` and ``flash_bwd.cu``, 256, runs each kernel as two
launches of a 128-column slab of its outputs, each reducing over the whole
head (the sources say why).  Every kernel reads its operands by TMA, in
boxes of rows, so an operand that repeats one row along its sequence
(stride 0) goes to the kernels contiguous.  A head dim above 256 goes to
``ops/csrc/flash_wide.cu`` (padded to a multiple of 64), whose launches
count on their own wrappers (``flash_wide_fwd``, ``flash_wide_bwd_dq``,
``flash_wide_bwd_dkv``).  In bf16 and fp16 all three passes are TMA-fed
warpgroup-MMA kernels on 64-row tiles: the forward's two consumer
warpgroups split the head's columns and swap partial scores; the dq pass
keeps a query tile's q and do in shared memory, its warpgroups swap p and
dp − delta and split the columns of dq; the dk/dv pass gives each key
tile two items (a slab of dk and dv each).  Before either backward pass,
one launch a call computes delta = rowsum(do∘o) once a query row into a
buffer the wrapper allocates; it counts on the dq pass when the call runs
it, else on the dk/dv pass (``_dq_launches``, ``_dkv_launches``).  Above
512 columns the same kernels stream their operands through their rings
box by box and make each slab of the outputs a work item of its own, so
every head dim runs on them.  In fp32 the three passes run every product
on the tensor cores in split TF32 (hi·hi′ + hi·lo′ + lo·hi′, which keeps
fp32 accuracy), on TMA rings and two consumer warpgroups.

fp32: every fp32 call, forward and backward, at every head dim, runs on
``flash_wide.cu``, on operands padded to a multiple of 64 columns (16, 32
and 48 to 64, 80 to 128, 160 to 192).  The forward is one launch: up to
128 columns ``flash_wide_fwd_f32_rows`` (128-row items, each consumer
warpgroup 64 rows over the whole head), wider ``flash_wide_fwd_f32``.
The backward is one delta launch, then the split-TF32 dq pass
(``flash_wide_bwd_dq_f32``) and dk/dv pass (``flash_wide_bwd_dkv_f32``).
The launches still count on the wrappers of the caller's head dim:
``flash_fwd``, ``flash_bwd_dq`` (the delta launch too) and
``flash_bwd_dkv`` up to 256, the ``flash_wide_*`` ones above.  The 16-bit
passes up to 256 stay on ``flash_fwd.cu`` and ``flash_bwd.cu``.

Gradients: one ``torch.autograd.Function`` (``_FlashAttention``) holds
the forward, which saves o and the per-row log-sum-exp when an input
requires a gradient, and the backward, ``flash_bwd``: one call of the
C entry point, which runs the dq and the dk/dv kernel on one set of
tensor maps.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda
from .registry import register

__all__ = ["flash_fwd", "flash_fwd_plain", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_plain", "flash_wide_fwd", "flash_wide_bwd_dq", "flash_wide_bwd_dkv",
           "flash_attention", "attention_reference",
           "attention_reference_bshd", "fused_attention", "fused_qkv_attention",
           "fused_kv_attention"]

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128, 256)
# Devices whose tensors take the plain versions: the CPU, and ``meta``
# (shape inference: a meta tensor holds no data, so it has only the plain
# version's shapes and dtypes to give).  A CUDA tensor launches a kernel.
_PLAIN_DEVICES = ("cpu", "meta")
_SLAB = 128  # output columns of one launch: a wider instance makes one launch a slab
_WIDE_STEP = 64  # flash_wide.cu takes head dims above 256 in multiples of this


def _is_wide(width, dtype=None):
    """Whether a pass at the instance ``width`` in ``dtype`` runs on
    flash_wide.cu: a head above 256 in every dtype, and every fp32 pass
    (forward or backward) at every width.  With no dtype, the 16-bit rule:
    above 256 (the launch counters' rule, which follows the caller's head
    dim whatever the dtype)."""
    return width > _HEAD_DIMS[-1] or dtype == torch.float32


def _launches(width, dtype=None):
    """Launches of one kernel pass at the instance ``width`` in ``dtype``
    (with no dtype, the 16-bit count): one on flash_wide.cu, whose slabs
    are blocks of one launch, else one a 128-column slab (two at Dh
    129-256)."""
    return 1 if _is_wide(width, dtype) else max(1, width // _SLAB)


def _has_delta_pass(width, dtype):
    """Whether a backward call at ``width`` in ``dtype`` launches
    flash_wide.cu's delta pass (a head above 256 in every dtype, and every
    fp32 call): once a call, before whichever of its passes the call runs,
    both of which read it."""
    return _is_wide(width, dtype)


def _dq_launches(width, dtype):
    """Launches counted on the dq pass of a backward call that runs it: its
    kernel's, and the delta pass's where there is one."""
    return _launches(width, dtype) + int(_has_delta_pass(width, dtype))


def _dkv_launches(width, dtype, with_dq=False):
    """Launches counted on the dk/dv pass of a backward call: its kernel's,
    and the delta pass's where there is one and the call runs no dq pass
    (``with_dq``), which counts it otherwise.  So a call on flash_wide.cu
    that runs both passes counts 2 + 1: three launches, delta once."""
    return _launches(width, dtype) + int(_has_delta_pass(width, dtype) and not with_dq)


def flash_fwd_plain(q, k, v, causal=False, scale=None, with_lse=False):
    """softmax(q·kᵀ·scale)·v on [..., S, Dh] tensors, with the kernel's
    dtype policy: scores and softmax in fp32, p cast to v's dtype before
    p·v, products accumulated in fp32, o in q's dtype.  A row that sees no
    key gets o = 0 and lse = 0.  Returns ``(o, lse)``, lse ``[B·H, Sq]``
    fp32 (or None)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    m = (s.amax(dim=-1, keepdim=True) if s.shape[-1]
         else s.new_full(s.shape[:-1] + (1,), float("-inf")))
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul((p / l).to(v.dtype).float(), v.float()).to(q.dtype)
    lse = (m + torch.log(l)).reshape(-1, s.shape[-2]) if with_lse else None
    return o, lse


def flash_bwd_plain(q, k, v, o, do, lse, causal=False, scale=None):
    """Gradients (dq, dk, dv) of ``o = softmax(q·kᵀ·scale)·v`` on
    [..., S, Dh] tensors, from the forward's o and lse (``[B·H, Sq]`` fp32,
    or any shape of q's rows), with the kernels' algebra and dtype policy:
    p = exp(s − lse) in fp32 (0 where masked), delta = rowsum(do∘o) in fp32
    from the stored o, p cast to do's dtype before pᵀ·do, ds = p∘(dp −
    delta) cast to q's dtype before ds·k and dsᵀ·q, fp32 accumulation, dq
    and dk times ``scale``, gradients in the inputs' dtypes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.reshape(q.shape[:-1]).unsqueeze(-1))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides_bhs(x, bshd):
    """(batch, head, sequence) element strides of a 4-D operand."""
    st = x.stride()
    return (st[0], st[2], st[1]) if bshd else (st[0], st[1], st[2])


def _check_cuda_operands(fn, q, k, v, bshd, like_k=(), **like_q):
    """What the kernels take: 4-D operands on q's device, of q's dtype (one
    of three), head dim 16/32/64/128/256 or a multiple of 64 above 256 (any
    multiple of 64 in fp32), unit stride on Dh,
    16-byte aligned rows; ``like_q`` names further operands of q's shape
    (o, do, dq...), ``like_k`` (name, tensor) pairs of k's shape (dk,
    dv)."""
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), *like_q.items(), *like_k):
        if x.device != dev:
            raise ValueError(f"{fn}: {name} is on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise ValueError(f"{fn}: {name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{fn}: {name} must be 4-D, got {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} needs unit stride on Dh, got {x.stride()}")
        nbytes = x.element_size()
        shape_bhs = (x.shape[0], x.shape[2], x.shape[1]) if bshd else x.shape[:3]
        for n, s in zip(shape_bhs, _strides_bhs(x, bshd)):
            if n > 1 and (s * nbytes) % 16:
                raise ValueError(
                    f"{fn}: {name} strides {x.stride()} are not 16-byte multiples")
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: unsupported dtype {q.dtype}")
    d = q.shape[-1]
    taken = d in _HEAD_DIMS or (_is_wide(d, q.dtype) and d % _WIDE_STEP == 0)
    if not taken or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{fn}: head dim must be one of {_HEAD_DIMS} or a multiple of "
                         f"{_WIDE_STEP} above {_HEAD_DIMS[-1]}, and equal for q, k, v; got "
                         f"{q.shape[-1]}, {k.shape[-1]}, {v.shape[-1]}")
    if k.shape != v.shape:
        raise ValueError(f"{fn}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    bh_q = (q.shape[0], q.shape[2] if bshd else q.shape[1])
    bh_k = (k.shape[0], k.shape[2] if bshd else k.shape[1])
    if bh_q != bh_k:
        raise ValueError(f"{fn}: batch/heads of q {bh_q} and k {bh_k} differ")
    for name, x in like_q.items():
        if x.shape != q.shape:
            raise ValueError(f"{fn}: {name} {tuple(x.shape)} differs from q {tuple(q.shape)}")
    for name, x in like_k:
        if x.shape != k.shape:
            raise ValueError(f"{fn}: {name} {tuple(x.shape)} differs from k {tuple(k.shape)}")


def _kernel_width(fn, q, k, v):
    """The head dim the kernels run for the caller's: the caller's own when
    the kernels have an instance for it, else the next one they have (the
    operands are zero-padded to it); on flash_wide.cu (above 256, and every
    fp32 pass), the next multiple of 64.  Raises for unequal head dims."""
    d = q.shape[-1]
    if k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{fn}: head dim must be equal for q, k, v; got {d}, "
                         f"{k.shape[-1]}, {v.shape[-1]}")
    if _is_wide(d, q.dtype):
        return -(-d // _WIDE_STEP) * _WIDE_STEP
    return next(w for w in _HEAD_DIMS if w >= d)


def _pad_head(x, width):
    """``x`` zero-padded along its last (head) dim to ``width`` columns; x
    itself when it has them."""
    return x if x.shape[-1] == width else torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _rows_readable(x, bshd):
    """``x`` as the TMA-fed kernels read it: TMA reads rows in boxes and
    cannot repeat one, so an operand whose sequence stride is 0 (one row
    expanded over S > 1) comes back contiguous; any other comes back as
    it is."""
    if x.dim() != 4:
        return x
    n, st = (x.shape[1], x.stride(1)) if bshd else (x.shape[2], x.stride(2))
    return x.contiguous() if n > 1 and st == 0 else x


def _kernel_operands(width, bshd, *xs):
    """The operands as the kernels take them: padded to ``width``, with no
    repeated rows, since every kernel, fp32 ones too, reads them by TMA."""
    return [_rows_readable(_pad_head(x, width), bshd) for x in xs]


def _entry(width=64, dtype=torch.bfloat16):
    """The forward's C entry for the instance ``width`` in ``dtype``:
    flash_wide.cu's above 256 and for every fp32 call."""
    fn = (_cuda.load("flash_wide").mx_flash_wide_fwd if _is_wide(width, dtype)
          else _cuda.load("flash_fwd").mx_flash_fwd)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_entry(width=64, dtype=torch.bfloat16):
    """The backward's C entry for the instance ``width`` in ``dtype``:
    flash_wide.cu's (above 256, and every fp32 call) takes one more
    pointer, the delta buffer, after lse."""
    wide = _is_wide(width, dtype)
    fn = (_cuda.load("flash_wide").mx_flash_wide_bwd if wide
          else _cuda.load("flash_bwd").mx_flash_bwd)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (10 if wide else 9) + [
            ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                                 ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_fwd(q, k, v, causal=False, scale=None, with_lse=False, layout="bhsd"):
    """Flash-attention forward.  ``layout="bhsd"``: q ``[B, H, Sq, Dh]``,
    k/v ``[B, H, Sk, Dh]``; ``"bshd"``: ``[B, S, H, Dh]``.  Any batch, head
    and sequence strides; o comes back in the same layout, in q's dtype.
    Returns ``(o, lse)`` with lse ``[B·H, Sq]`` fp32, or None.

    A CPU (or meta) tensor takes :func:`flash_fwd_plain`; a CUDA tensor
    launches the kernel or raises.  ``flash_fwd.launches`` counts the launches up to Dh
    256 (in bf16 and fp16 flash_fwd.cu's, two at Dh 129-256, one a slab;
    in fp32 flash_wide.cu's one split-TF32 launch), above 256
    ``flash_wide_fwd.launches`` counts its one.  On the card a head dim
    the kernel has no instance for comes back as a slice of the padded o."""
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"layout must be 'bhsd' or 'bshd', got {layout!r}")
    bshd = layout == "bshd"
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type in _PLAIN_DEVICES:
        if not bshd:
            return flash_fwd_plain(q, k, v, causal, scale, with_lse)
        o, lse = flash_fwd_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal, scale, with_lse)
        return o.transpose(1, 2), lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CPU or CUDA tensors, got {q.device}")
    d_caller = q.shape[-1]
    q, k, v = _kernel_operands(_kernel_width("flash_fwd", q, k, v), bshd, q, k, v)
    _check_cuda_operands("flash_fwd", q, k, v, bshd)
    b, d = q.shape[0], q.shape[3]
    h, sq = (q.shape[2], q.shape[1]) if bshd else (q.shape[1], q.shape[2])
    sk = k.shape[1] if bshd else k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_longlong * 12)(*(_strides_bhs(q, bshd) + _strides_bhs(k, bshd)
                                        + _strides_bhs(v, bshd) + _strides_bhs(o, bshd)))
    with torch.cuda.device(q.device):
        rc = _entry(d, q.dtype)(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), lse.data_ptr() if with_lse else None,
                       b, h, sq, sk, d, strides, float(scale), int(bool(causal)),
                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {rc}")
    _fwd_counter(d_caller).launches += _launches(d, q.dtype)
    return o[..., :d_caller] if d != d_caller else o, lse


def flash_wide_fwd(q, k, v, causal=False, scale=None, with_lse=False, layout="bhsd"):
    """:func:`flash_fwd` at a head dim above 256, which it routes to the
    ``flash_wide_fwd`` kernel (``flash_wide_fwd.launches`` counts)."""
    if q.shape[-1] <= _HEAD_DIMS[-1]:
        raise ValueError(f"flash_wide_fwd takes head dims above {_HEAD_DIMS[-1]}, got "
                         f"{q.shape[-1]}")
    return flash_fwd(q, k, v, causal, scale, with_lse, layout)


flash_fwd.launches = 0
flash_wide_fwd.launches = 0


def _bwd_launch(q, k, v, o, do, lse, dq, dk, dv, causal, scale, bshd):
    """One ctypes call of ``mx_flash_bwd`` (16-bit up to Dh 256) or
    ``mx_flash_wide_bwd`` (above 256, and every fp32 call): the dq pass when
    ``dq`` is given, the dk/dv pass when ``dk``/``dv`` are, both from one
    set of tensor maps.  A padded head dim runs on padded buffers that are
    then copied, sliced, into the given ones; a call on flash_wide.cu gets
    an fp32 buffer for delta, which one launch fills before the passes.
    Returns the launches counted on the dq pass and on the dk/dv pass
    (``_dq_launches``, ``_dkv_launches``), 0 for a pass not asked for."""
    d, dtype = q.shape[-1], q.dtype
    width = _kernel_width("flash_bwd", q, k, v)
    q, k, v, o, do = _kernel_operands(width, bshd, q, k, v, o, do)
    wanted = (dq, dk, dv)
    if width != d:
        dq, dk, dv = (None if g is None else _new_like(x) for g, x in zip(wanted, (q, k, v)))
    _check_cuda_operands("flash_bwd", q, k, v, bshd,
                         like_k=() if dk is None else (("dk", dk), ("dv", dv)),
                         o=o, do=do, **({} if dq is None else {"dq": dq}))
    b = q.shape[0]
    h, sq = (q.shape[2], q.shape[1]) if bshd else (q.shape[1], q.shape[2])
    sk = k.shape[1] if bshd else k.shape[2]
    if (lse.dtype != torch.float32 or lse.device != q.device
            or tuple(lse.shape) != (b * h, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_bwd: lse must be contiguous fp32 [B·H, Sq] = "
                         f"{(b * h, sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    ops = (q, k, v, o, do, dq if dq is not None else q,
           dk if dk is not None else k, dv if dv is not None else v)
    strides = (ctypes.c_longlong * 24)(*(st for x in ops for st in _strides_bhs(x, bshd)))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    delta = (torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
             if _has_delta_pass(width, dtype) else None)
    scratch = (ptr(delta),) if _is_wide(width, dtype) else ()
    with torch.cuda.device(q.device):
        rc = _bwd_entry(width, dtype)(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), do.data_ptr(), lse.data_ptr(), *scratch, ptr(dq),
                               ptr(dk), ptr(dv), b, h, sq, sk, width, strides, float(scale),
                               int(bool(causal)),
                               torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd launch failed with CUDA error {rc}")
    if width != d:
        for dst, g in zip(wanted, (dq, dk, dv)):
            if dst is not None:
                dst.copy_(g[..., :d])
    return (0 if dq is None else _dq_launches(width, dtype),
            0 if dk is None else _dkv_launches(width, dtype, with_dq=dq is not None))


def _bwd_args(q, layout, scale):
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"layout must be 'bhsd' or 'bshd', got {layout!r}")
    if q.device.type not in _PLAIN_DEVICES + ("cuda",):
        raise ValueError(f"flash_bwd runs on CPU or CUDA tensors, got {q.device}")
    return layout == "bshd", 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _bwd_plain(q, k, v, o, do, lse, causal, scale, bshd):
    """flash_bwd_plain in the caller's layout."""
    t = (lambda x: x.transpose(1, 2)) if bshd else (lambda x: x)
    return [t(g) for g in flash_bwd_plain(t(q), t(k), t(v), t(o), t(do), lse, causal, scale)]


def _into(dst, src):
    return src if dst is None else dst.copy_(src)


def _new_like(x):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def flash_bwd_dq(q, k, v, o, do, lse, causal=False, scale=None, layout="bhsd", dq=None):
    """The dq pass of :func:`flash_bwd`; writes into ``dq`` when given and
    returns dq.  A CPU tensor takes :func:`flash_bwd_plain`; a CUDA tensor
    launches the dq kernel (``flash_bwd_dq.launches`` counts, above Dh 256
    ``flash_wide_bwd_dq.launches``: on flash_wide.cu, above 256 and in fp32
    at every width, two, the delta pass and the split-TF32 or wgmma kernel)
    or raises."""
    bshd, scale = _bwd_args(q, layout, scale)
    if q.device.type in _PLAIN_DEVICES:
        return _into(dq, _bwd_plain(q, k, v, o, do, lse, causal, scale, bshd)[0])
    dq = _new_like(q) if dq is None else dq
    n, _ = _bwd_launch(q, k, v, o, do, lse, dq, None, None, causal, scale, bshd)
    _bwd_counters(q.shape[-1])[0].launches += n
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, causal=False, scale=None, layout="bhsd",
                  dk=None, dv=None):
    """The dk/dv pass of :func:`flash_bwd`; writes into ``dk``/``dv`` when
    given and returns (dk, dv).  A CPU tensor takes
    :func:`flash_bwd_plain`; a CUDA tensor launches the dk/dv kernel
    (``flash_bwd_dkv.launches`` counts, above Dh 256
    ``flash_wide_bwd_dkv.launches``: on flash_wide.cu, above 256 and in
    fp32 at every width, two, the delta pass and the kernel, as this call
    runs no dq pass) or raises."""
    if (dk is None) != (dv is None):
        raise ValueError("flash_bwd_dkv: give both dk and dv or neither")
    bshd, scale = _bwd_args(q, layout, scale)
    if q.device.type in _PLAIN_DEVICES:
        _, gk, gv = _bwd_plain(q, k, v, o, do, lse, causal, scale, bshd)
        return _into(dk, gk), _into(dv, gv)
    if dk is None:
        dk, dv = _new_like(k), _new_like(v)
    _, n = _bwd_launch(q, k, v, o, do, lse, None, dk, dv, causal, scale, bshd)
    _bwd_counters(q.shape[-1])[1].launches += n
    return dk, dv


def flash_wide_bwd_dq(q, k, v, o, do, lse, causal=False, scale=None, layout="bhsd", dq=None):
    """:func:`flash_bwd_dq` at a head dim above 256: the ``flash_wide_bwd_dq``
    kernel (``flash_wide_bwd_dq.launches`` counts, the delta pass too)."""
    if q.shape[-1] <= _HEAD_DIMS[-1]:
        raise ValueError(f"flash_wide_bwd_dq takes head dims above {_HEAD_DIMS[-1]}, got "
                         f"{q.shape[-1]}")
    return flash_bwd_dq(q, k, v, o, do, lse, causal, scale, layout, dq)


def flash_wide_bwd_dkv(q, k, v, o, do, lse, causal=False, scale=None, layout="bhsd",
                       dk=None, dv=None):
    """:func:`flash_bwd_dkv` at a head dim above 256: the
    ``flash_wide_bwd_dkv`` kernel (``flash_wide_bwd_dkv.launches`` counts,
    the delta pass too)."""
    if q.shape[-1] <= _HEAD_DIMS[-1]:
        raise ValueError(f"flash_wide_bwd_dkv takes head dims above {_HEAD_DIMS[-1]}, got "
                         f"{q.shape[-1]}")
    return flash_bwd_dkv(q, k, v, o, do, lse, causal, scale, layout, dk, dv)


def _fwd_counter(d):
    """The wrapper whose ``launches`` count the forward kernel of the
    caller's head dim ``d``, whatever kernel runs: an fp32 call up to 256
    runs flash_wide.cu's and counts on ``flash_fwd``."""
    return flash_wide_fwd if _is_wide(d) else flash_fwd


def _bwd_counters(d):
    """The (dq, dk/dv) wrappers whose ``launches`` count the backward
    kernels of the caller's head dim ``d``, whatever kernels run: an fp32
    call up to 256 runs flash_wide.cu's and counts on ``flash_bwd_dq`` and
    ``flash_bwd_dkv``."""
    if _is_wide(d):
        return flash_wide_bwd_dq, flash_wide_bwd_dkv
    return flash_bwd_dq, flash_bwd_dkv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_wide_bwd_dq.launches = 0
flash_wide_bwd_dkv.launches = 0


def flash_bwd(q, k, v, o, do, lse, causal=False, scale=None, layout="bhsd", out=None):
    """Flash-attention backward: ``(dq, dk, dv)`` from the forward's inputs,
    its output o, the output gradient do (o's layout) and its lse
    (``[B·H, Sq]`` fp32).  ``out`` = (dq, dk, dv) tensors to write into, in
    any strides the kernels take (the three slices of one
    ``[B, S, 3, H, Dh]`` gradient, say).

    A CPU tensor takes :func:`flash_bwd_plain` (once, for all three); a
    CUDA tensor launches the two kernels, the dq pass then the dk/dv pass,
    in one call, or raises.  In bf16 and fp16 up to Dh 256 they are
    flash_bwd.cu's (``flash_bwd_dq.launches`` and ``flash_bwd_dkv.launches``
    each count one, two at Dh 129-256); above 256, and in fp32 at every
    width, flash_wide.cu's delta launch, then its dq and dk/dv kernels
    (split TF32 in fp32): one each, and the delta launch on the dq counter
    of the caller's head dim (``flash_bwd_dq`` up to 256, else
    ``flash_wide_bwd_dq``), three launches in all."""
    dq, dk, dv = out if out is not None else (None, None, None)
    bshd, scale = _bwd_args(q, layout, scale)
    if q.device.type in _PLAIN_DEVICES:
        grads = _bwd_plain(q, k, v, o, do, lse, causal, scale, bshd)
        return tuple(_into(dst, g) for dst, g in zip((dq, dk, dv), grads))
    dq, dk, dv = (_new_like(x) if g is None else g for g, x in zip((dq, dk, dv), (q, k, v)))
    launched = _bwd_launch(q, k, v, o, do, lse, dq, dk, dv, causal, scale, bshd)
    for counter, n in zip(_bwd_counters(q.shape[-1]), launched):
        counter.launches += n
    return dq, dk, dv


def _views(tensors, spec):
    """q, k, v as views of ``tensors``: each spec entry is (index, slot),
    slot None for the tensor itself, else its [:, :, slot] slice (the
    packed [B, S, n, H, Dh] projection outputs)."""
    return tuple(tensors[i] if slot is None else tensors[i][:, :, slot] for i, slot in spec)


class _FlashAttention(torch.autograd.Function):
    """Attention over q, k, v taken as views of the packed inputs
    (``_views``), so the backward writes each input's gradient whole:
    dq, dk and dv land in the slices of one ``[B, S, 3, H, Dh]`` tensor
    for the fused QKV projection, with no stack copy."""

    @staticmethod
    def forward(ctx, spec, causal, scale, layout, *inputs):
        q, k, v = _views(inputs, spec)
        o, lse = flash_fwd(q, k, v, causal, scale, with_lse=True, layout=layout)
        ctx.spec, ctx.causal, ctx.scale, ctx.layout = spec, causal, scale, layout
        ctx.save_for_backward(*inputs, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        *inputs, o, lse = ctx.saved_tensors
        if torch.is_grad_enabled():  # create_graph: the gradients must be differentiable
            return (None, None, None, None, *_differentiable_grads(ctx, inputs, do))
        grads = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in inputs]
        flash_bwd(*_views(inputs, ctx.spec), o, do.contiguous(), lse, ctx.causal, ctx.scale,
                  ctx.layout, out=_views(grads, ctx.spec))
        return (None, None, None, None, *grads)


def _differentiable_grads(ctx, inputs, do):
    """The inputs' gradients as a graph over the inputs and ``do``, for a
    backward with ``create_graph``: on the CPU the plain attention
    recomputed and differentiated by PyTorch, so a second derivative is
    exact; the kernels have no double backward, so on the card this
    raises rather than return gradients that a second derivative would
    read as constants."""
    if inputs[0].device.type not in _PLAIN_DEVICES:
        raise RuntimeError(
            "attention: the flash kernels (flash_fwd/flash_bwd) have no double backward, so a "
            "gradient through them cannot be differentiated again (create_graph=True); run "
            "the higher-order gradient on CPU tensors, where attention takes its plain version")
    q, k, v = _views(inputs, ctx.spec)
    t = (lambda x: x.transpose(1, 2)) if ctx.layout == "bshd" else (lambda x: x)  # noqa: E731
    o = t(flash_fwd_plain(t(q), t(k), t(v), ctx.causal, ctx.scale)[0])
    grads = torch.autograd.grad(o, inputs, do, create_graph=True, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def _attend(spec, inputs, causal, scale, layout):
    """o of attention over the views ``spec`` of ``inputs``: through
    ``_FlashAttention`` when a gradient is wanted, straight to
    ``flash_fwd`` (no lse) when not."""
    if scale is None:
        scale = 1.0 / math.sqrt(inputs[0].shape[-1])
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _FlashAttention.apply(spec, causal, float(scale), layout, *inputs)
    return flash_fwd(*_views(inputs, spec), causal, scale, layout=layout)[0]


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain attention on [B, H, S, D] (or [BH, S, D]), output in v's dtype;
    the counterpart of the JAX package's ``attention_reference``."""
    return flash_fwd_plain(q, k, v, causal, scale)[0].to(v.dtype)


def attention_reference_bshd(q, k, v, causal=False, scale=None):
    """Plain attention over [B, S, H, Dh] operands."""
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(attention_reference(t(q), t(k), t(v), causal, scale))


def flash_attention(q, k, v, causal=False, scale=None):
    """Fused attention on [B, H, S, D] tensors; differentiable."""
    return _attend(((0, None), (1, None), (2, None)), (q, k, v), causal, scale, "bhsd")


@register("fused_attention")
def fused_attention(q, k, v, num_heads=1, causal=False, scale=None):
    """[B, S, D] form: split heads → flash attention → merge."""
    b, s, d = q.shape
    h = num_heads
    if d % h:
        raise ValueError(f"feature dim {d} not divisible by num_heads {h}")

    def split(x):
        return x.reshape(b, x.shape[1], h, d // h)

    return _attend(((0, None), (1, None), (2, None)), (split(q), split(k), split(v)),
                   causal, scale, "bshd").reshape(b, s, d)


@register("fused_qkv_attention")
def fused_qkv_attention(qkv, num_heads=1, causal=False, scale=None):
    """Self-attention straight from the fused QKV projection [B, S, 3·D]:
    the q/k/v and head split is the free view [B, S, 3, H, Dh]."""
    b, s, d3 = qkv.shape
    h = num_heads
    d = d3 // 3
    if d % h or d3 % 3:
        raise ValueError(f"qkv dim {d3} not divisible into 3 heads×{h}")
    x = qkv.reshape(b, s, 3, h, d // h)
    return _attend(((0, 0), (0, 1), (0, 2)), (x,), causal, scale, "bshd").reshape(b, s, d)


@register("fused_kv_attention")
def fused_kv_attention(q, kv, num_heads=1, causal=False, scale=None):
    """Cross-attention: q [B, Sq, D], kv [B, Sk, 2·D] from the fused KV
    projection of the memory."""
    b, sq, d = q.shape
    h = num_heads
    if d % h or kv.shape[-1] != 2 * d:
        raise ValueError(f"kv dim {kv.shape[-1]} must be 2×{d}, heads {h}")
    dh = d // h
    x = kv.reshape(b, kv.shape[1], 2, h, dh)
    out = _attend(((0, None), (1, 0), (1, 1)), (q.reshape(b, sq, h, dh), x), causal, scale,
                  "bshd")
    return out.reshape(b, sq, d)


# -- interleaved_matmul_* ------------------------------------------------------------
# The fused multi-head attention ops of GluonNLP 0.x (the reference's
# contrib/transformer.cc): projections [S, B, H·3·Dh] (self-attention, q, k
# and v interleaved a head) or [S, B, H·2·Dh] (encoder-decoder k and v);
# scores [B·H, Sq, Sk].  Plain products, as the JAX package leaves them to
# XLA: q, k, v and the attention in fp32, one rounding to the input dtype.


def _deinterleave(proj, heads, parts):
    s, b, hpd = proj.shape
    if hpd % (heads * parts):
        raise ValueError(f"interleaved projection width {hpd} is not divisible by "
                         f"heads({heads})×{parts}")
    x = proj.reshape(s, b, heads, parts, hpd // (heads * parts))
    return tuple(x[:, :, :, i] for i in range(parts))  # each [S, B, H, Dh]


def _scores(q, k, dtype):
    s = torch.einsum("qbhd,kbhd->bhqk", q.float() * (1.0 / math.sqrt(q.shape[-1])), k.float())
    b, h, sq, sk = s.shape
    return s.reshape(b * h, sq, sk).to(dtype)


def _context(v, attention, dtype):
    sk, b, h, dh = v.shape
    att = attention.reshape(b, h, -1, sk)
    out = torch.einsum("bhqk,kbhd->qbhd", att.float(), v.float())
    return out.reshape(out.shape[0], b, h * dh).to(dtype)


@register("_contrib_interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """scores [B·H, Sq, Sk] = Q·Kᵀ/√Dh from the interleaved projection."""
    q, k, _ = _deinterleave(queries_keys_values, heads, 3)
    return _scores(q, k, queries_keys_values.dtype)


@register("_contrib_interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads=1):
    """context [S, B, H·Dh] = attention · V, V from the interleaved
    projection, attention [B·H, Sq, Sk]."""
    _, _, v = _deinterleave(queries_keys_values, heads, 3)
    return _context(v, attention, queries_keys_values.dtype)


@register("_contrib_interleaved_matmul_encdec_qk")
def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """Cross-attention scores from Q [Sq, B, H·Dh] and the interleaved
    KV [Sk, B, H·2·Dh]."""
    sq, b, hd = queries.shape
    if hd % heads:
        raise ValueError(f"query width {hd} not divisible by heads({heads})")
    k, _ = _deinterleave(keys_values, heads, 2)
    return _scores(queries.reshape(sq, b, heads, hd // heads), k, queries.dtype)


@register("_contrib_interleaved_matmul_encdec_valatt")
def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    _, v = _deinterleave(keys_values, heads, 2)
    return _context(v, attention, keys_values.dtype)
