#!/usr/bin/env python3
"""Drive the PyTorch port (``incubator_mxnet_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny BERT and ResNet on the CPU plain path

Phases, each printing JSON lines; no phase's failure is caught:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compile every kernel of the paths from ``ops/csrc`` and the
   user source ``RTC_SOURCE`` (one nvcc per source, all at once) with
   ``-Xptxas -v`` and report registers, shared memory and spills, and the
   user kernels' registers and local memory as the driver loaded them; a
   spill fails the phase;
3. kernel_vs_plain, kernel_vs_plain_bwd, kernel_vs_plain_bn,
   kernel_vs_plain_rtc: each kernel against its plain PyTorch version on
   the card, at the main paths' shapes and the edge cases (for the
   attention kernels also their persistent schedules' and the operand
   domain the wrappers take: scales, expanded k/v, a sequence of stride 0,
   padded head dims), each against a stated bound (and flash_fwd,
   flash_bwd and bn_stats against themselves: two runs must be
   bit-identical), and the refusals of the attention wrappers and the rtc
   launcher; any miss exits non-zero after the phase;
4. slice: BERT-base (12 layers, 768 units, vocab 30522, bf16, random
   weights from a seed) answers inference requests through
   ``net(token_ids, token_types, masked_positions)``; the kernels' launch
   counts are read around exactly this run, and one small batch is held
   against the port's fp32 run of the same weights on the CPU;
5. train: BERT-base pretraining steps (bf16 parameters, fp32 Adam masters,
   dropout 0.1, the MLM loss of bench.py) through ``autograd.record``,
   ``autograd.backward`` and ``gluon.Trainer.step``; launch counts around
   exactly one step, finite and falling losses; then the card's bf16
   gradients against the port's fp32 gradients on the CPU, per parameter;
   rtc_train: the same net, weights and Trainer with every FFN activation
   the user's ``rtc_gelu`` CustomOp (user kernels compiled by ``mx.rtc``):
   its gradients against the same CPU ones and beside the built-in GELU's,
   then steps with the launches counted around exactly one (12 gelu_fwd,
   12 gelu_bwd);
6. resnet_train: ResNet-50 v1 training steps as bench.py's bench_resnet50
   takes them (B=256, 224x224 synthetic images, AMP bf16 with fp32
   parameters, SGD lr 0.1 momentum 0.9 wd 1e-4, the streaming softmax
   cross-entropy) through ``autograd.record``, ``autograd.backward`` and
   ``gluon.Trainer.step``; launch counts around exactly one step (53
   bn_stats, 53 bn_apply, 0 bn_apply_res, no BatchNorm reference call),
   finite losses, moved running statistics; then, at B=16, the card's fp32
   and AMP gradients against the port's fp32 gradients on the CPU, per
   parameter, beside the CPU's own sensitivity;
7. times: each kernel, its plain version and the library call at the main
   paths' shapes (the attention kernels also at the S=512 request, and by
   CUDA-graph replay), the kernel's bound; BERT forward and training-step time,
   the ResNet-50 step's time, img/s, peak memory and its split; the
   BERT step with the user's GELU beside the built-in one; a
   torch.profiler breakdown of device time by kernel family for one BERT
   forward, one BERT training step and one ResNet-50 step.

The last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed on a CUDA card.  The rehearsal runs the slice, train, rtc_train,
ResNet and timing phases on the CPU at a tiny size, with the kernels' plain
versions, and never prints it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import incubator_mxnet_torch as mx  # noqa: E402
from incubator_mxnet_torch.convert import load_numpy_params  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import bert as bert_zoo  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import vision  # noqa: E402
from incubator_mxnet_torch.gluon.nn.transformer import PositionwiseFFN  # noqa: E402
from incubator_mxnet_torch.ops import _cuda  # noqa: E402
from incubator_mxnet_torch.ops import attention as att  # noqa: E402
from incubator_mxnet_torch.ops import bn  # noqa: E402
from incubator_mxnet_torch.ops import nn as ops_nn  # noqa: E402
from incubator_mxnet_torch.ops.nn import streaming_softmax_ce  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

# Kernel vs plain: the largest absolute difference allowed.
# 16-bit forward: p rounds to the 16-bit type unnormalized in the kernel and
# normalized in the plain version (relative errors of one unit roundoff
# that average out over the keys), and o rounds once more; so the two
# differ by about one ulp of |o|: the bound is FWD_ULPS ulps of the case's
# largest |o_ref| (causal rows near the start see few keys and reach
# |o| ~ 4-5, where one bf16 ulp is 2**-5).
# 16-bit backward: the same fp32 algebra with p and ds rounded to the
# 16-bit type at the same places on both sides; only fp32 summation order
# differs, which can flip a rounding of p or ds and moves the rounded
# gradient by about one ulp: BWD_ULPS ulps of the largest |grad_ref| of
# that gradient.  A wrong mask, tile or layout moves gradients by their own
# size.  fp32: the same fp32 arithmetic in another summation order
# (backward relative to the largest |grad_ref|, through exp and the
# dp - delta cancellation).
FWD_ULPS = 2
BWD_ULPS = 2
FP32_FWD_BOUND = 2e-5
FP32_BWD_REL = 1e-4
# End to end through fused_qkv_attention's autograd against the plain
# forward and backward: o and lse also come from different forwards, so
# delta = rowsum(do * o) moves by up to the forward's 2 ulps of o.
E2E_ULPS = 8
LSE_BOUND = 1e-4  # fp32 log-sum-exp of scores of |s| < ~10, other sum order
# BERT-base bf16 on the card vs the port's fp32 run on the CPU, as a share
# of the largest fp32 logit: bf16 roundings compounded through 12 post-LN
# layers.  A wrong layout or mask gives errors of the order of the logits.
SLICE_REL_BOUND = 1e-1
# Training gradients, bf16 on the card vs fp32 on the CPU, same weights,
# dropout off: relative L2 error per parameter.  bf16 keeps 8 significant
# bits (unit roundoff 2**-8); one step rounds each activation and each
# gradient at ~20 ops a layer through 12 post-LN layers forward and back,
# some 500 roundings on a path, which add up as a random walk to ~5 % and
# can align in the first layers and the embeddings.  A wrong mask, layout
# or gradient kernel leaves errors of order 100 %.
GRAD_REL_BOUND = 0.15

BERT_BASE = dict(vocab_size=30522, max_length=512, dropout=0.1)
TINY_BERT = dict(vocab_size=128, units=32, hidden_size=64, num_layers=2, num_heads=2,
                 max_length=64, dropout=0.1)
# BatchNorm kernels against their plain versions.  bn_stats: both sides sum
# in fp32 in different orders; the kernel's longest sequential run is one
# lane's share of a row, L ~ 400 terms at the stem, so the difference walks
# like sqrt(L)·u ~ 1.2e-6 of Σ|x| (u = 2**-24), and the worst case
# (L + log2 M)·u is 2.4e-5: the bound is STATS_REL of Σ|x| for Σx and of
# Σx² for Σx², per channel.  bn_apply(_res): the same fp32 arithmetic,
# rounded once to the output type; the kernel fuses x·scale + shift into one
# fma and the plain version rounds the product first, so the fp32 values
# differ by up to two fp32 roundings of the largest term, which can move the
# rounded output by one ulp: the bound per element is one ulp of the output
# type at the plain result plus two fp32 ulps of |x·scale| + |shift| + |res|.
STATS_REL = 1e-5
# ResNet-50 gradients on the card against fp32 on the CPU, same weights,
# B=16, BatchNorm in training.  A batch-normalized ReLU network in training
# is chaotic: its gradients, and their sensitivity to any perturbation,
# grow with depth (the mean-field result for BatchNorm networks).  The
# phase measures that sensitivity on the CPU in the same run, as two
# yardsticks: the change of the fp32 gradients when every weight moves by
# 1e-6 relative (some ten fp32 roundings), and when the weights are rounded
# to bf16.  So:
# * fp32 on the card (AMP off, TF32 off) differs from the CPU by summation
#   order and algorithm, about one fp32 rounding per op: less than the 1e-6
#   yardstick, which moves gradients by a few percent.  The bound is 0.3,
#   several times that; a wrong BN kernel moves the batch statistics by
#   their own size and the gradients by order 1 (100 %).  The logits: 1e-3,
#   against 1e-4 or less from such a perturbation.
# * AMP bf16 rounds every activation and weight (u = 2**-8), a perturbation
#   the bf16 yardstick shows to decorrelate the gradients (order 1).  No
#   bound below that can hold, so the AMP run is held only to finite
#   gradients within 2 of the reference's norm (what two unrelated vectors
#   of equal norm give at most) and reported beside its yardstick.
RESNET_FP32_GRAD_REL_BOUND = 0.3
RESNET_FP32_LOGIT_REL_BOUND = 1e-3
RESNET_AMP_GRAD_REL_BOUND = 2.0

RESNET_B = 256
TINY_RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10,
                   thumbnail=True)
KERNELS = ("flash_fwd", "flash_bwd", "bn")  # sources under incubator_mxnet_torch/ops/csrc

# -- user kernels (mx.rtc + mx.operator.CustomOp) -----------------------------
# What a user of the framework writes: CUDA source handed to mx.rtc at
# runtime (the kernels of tests/test_rtc.py, and an erf GELU pair), and a
# CustomOp that puts the GELU pair under autograd.  The rtc_train phase
# swaps it into every PositionwiseFFN of the slice-2 BERT-base.
RTC_SOURCE = r"""
#include <cuda_bf16.h>
#include <stdint.h>

// Parameters: the inputs, then one pointer per declared output.
extern "C" __global__ void scale_add(const float* x, const float* y, long long n, float* out) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out[i] = 2.0f * x[i] + y[i];
}

// One (8, 128) tile per block, as the Pallas version's grid of blocks.
extern "C" __global__ void saxpy_block(const float* x, const float* y, float* out) {
    const long long base = (long long)blockIdx.x * 8 * 128;
    for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x)
        out[base + i] = 0.5f * x[base + i] + y[base + i];
}

// Min and max of n values in one block of 256 threads: a shared-memory tree.
extern "C" __global__ void minmax(const float* x, int n, float* lo, float* hi) {
    __shared__ float smin[256], smax[256];
    const int t = threadIdx.x;
    float a = __int_as_float(0x7f800000), b = -a;
    for (int i = t; i < n; i += blockDim.x) {
        a = fminf(a, x[i]);
        b = fmaxf(b, x[i]);
    }
    smin[t] = a;
    smax[t] = b;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (t < s) {
            smin[t] = fminf(smin[t], smin[t + s]);
            smax[t] = fmaxf(smax[t], smax[t + s]);
        }
        __syncthreads();
    }
    if (t == 0) {
        *lo = smin[0];
        *hi = smax[0];
    }
}

extern "C" __global__ void twice(const float* x, long long n, float* out) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out[i] = 2.0f * x[i];
}

// Not extern "C": C++ mangles the name, and a lookup of "not_extern_c" fails.
__global__ void not_extern_c(float* out) { *out = 1.0f; }

// erf GELU and its gradient times dy, in fp32 as PyTorch's own CUDA GELU
// computes them, rounded once to the I/O type.  A grid-stride loop of
// 16-byte packs where x and the output are 16-byte aligned, then scalars.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float& o) { o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16& o) { o = __float2bfloat16(v); }

__device__ __forceinline__ float gelu(float x) {
    return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float x, float dy) {
    const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
    const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
    return dy * (cdf + x * pdf);
}

template <typename T, int V>
struct alignas(16) Pack { T v[V]; };

template <typename T>
__device__ void gelu_fwd_impl(const T* __restrict__ x, long long n, T* __restrict__ y) {
    constexpr int V = 16 / sizeof(T);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    const long long packs = aligned ? n / V : 0;
    for (long long i = tid; i < packs; i += stride) {
        const Pack<T, V> a = reinterpret_cast<const Pack<T, V>*>(x)[i];
        Pack<T, V> b;
#pragma unroll
        for (int j = 0; j < V; ++j) store(gelu(to_f32(a.v[j])), b.v[j]);
        reinterpret_cast<Pack<T, V>*>(y)[i] = b;
    }
    for (long long i = packs * V + tid; i < n; i += stride) store(gelu(to_f32(x[i])), y[i]);
}

template <typename T>
__device__ void gelu_bwd_impl(const T* __restrict__ x, const T* __restrict__ dy, long long n,
                              T* __restrict__ dx) {
    constexpr int V = 16 / sizeof(T);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                           reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
    const long long packs = aligned ? n / V : 0;
    for (long long i = tid; i < packs; i += stride) {
        const Pack<T, V> a = reinterpret_cast<const Pack<T, V>*>(x)[i];
        const Pack<T, V> g = reinterpret_cast<const Pack<T, V>*>(dy)[i];
        Pack<T, V> b;
#pragma unroll
        for (int j = 0; j < V; ++j) store(gelu_grad(to_f32(a.v[j]), to_f32(g.v[j])), b.v[j]);
        reinterpret_cast<Pack<T, V>*>(dx)[i] = b;
    }
    for (long long i = packs * V + tid; i < n; i += stride)
        store(gelu_grad(to_f32(x[i]), to_f32(dy[i])), dx[i]);
}

extern "C" __global__ void gelu_fwd_bf16(const __nv_bfloat16* x, long long n, __nv_bfloat16* y) {
    gelu_fwd_impl(x, n, y);
}
extern "C" __global__ void gelu_fwd_f32(const float* x, long long n, float* y) {
    gelu_fwd_impl(x, n, y);
}
extern "C" __global__ void gelu_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                                         long long n, __nv_bfloat16* dx) {
    gelu_bwd_impl(x, dy, n, dx);
}
extern "C" __global__ void gelu_bwd_f32(const float* x, const float* dy, long long n, float* dx) {
    gelu_bwd_impl(x, dy, n, dx);
}
"""
RTC = mx.rtc.CudaModule(RTC_SOURCE)
GELU_THREADS = 256
GELU_MAX_BLOCKS = 132 * 16  # a grid-stride loop: 16 blocks of 256 threads per SM


def gelu_plain(x):
    """The plain version of gelu_fwd: fp32 erf GELU, rounded once."""
    x32 = x.float()
    return (x32 * 0.5 * (1.0 + torch.erf(x32 * 0.7071067811865476))).to(x.dtype)


def gelu_bwd_plain(x, dy):
    """The plain version of gelu_bwd: dy · GELU'(x) in fp32, rounded once."""
    x32 = x.float()
    cdf = 0.5 * (1.0 + torch.erf(x32 * 0.7071067811865476))
    pdf = torch.exp(-0.5 * x32 * x32) * 0.3989422804014327
    return (dy.float() * (cdf + x32 * pdf)).to(x.dtype)


class UserKernel:
    """A GELU kernel of RTC_SOURCE as the user's op launches it: the bf16 or
    fp32 instance by the input's dtype, over the input's element count.
    ``get_kernel`` declares the output's shape, so there is one ``Kernel``
    per shape and dtype; ``launches`` sums theirs."""

    SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

    def __init__(self, stem):
        self.stem, self.kernels, self._base = stem, {}, 0

    def __call__(self, *tensors):
        x = tensors[0]
        key = (tuple(x.shape), x.dtype)
        k = self.kernels.get(key)
        if k is None:
            blocks = max(1, min(-(-x.numel() // (8 * GELU_THREADS)), GELU_MAX_BLOCKS))
            k = self.kernels[key] = RTC.get_kernel(
                f"{self.stem}_{self.SUFFIX[x.dtype]}", out_shapes=[key[0]], out_dtypes=[x.dtype],
                grid=(blocks,), block=(GELU_THREADS,))
        return k.launch([*tensors, x.numel()])

    @property
    def launches(self):
        return self._base + sum(k.launches for k in self.kernels.values())

    @launches.setter
    def launches(self, n):
        for k in self.kernels.values():
            k.launches = 0
        self._base = n


GELU_FWD, GELU_BWD = UserKernel("gelu_fwd"), UserKernel("gelu_bwd")


@mx.operator.register("rtc_gelu")
class RtcGeluProp(mx.operator.CustomOpProp):
    def create_operator(self, ctx, in_shapes, in_dtypes):
        return RtcGelu()


class RtcGelu(mx.operator.CustomOp):
    """erf GELU: the user's kernels on CUDA tensors, the plain version on
    CPU tensors (``plain_calls`` counts those)."""

    plain_calls = 0

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0]
        if x.is_cuda:
            y = GELU_FWD(x)
        else:
            RtcGelu.plain_calls += 1
            y = gelu_plain(x)
        self.assign(out_data[0], req[0], y)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        x, dy = in_data[0], out_grad[0]
        if x.is_cuda:
            dx = GELU_BWD(x, dy.contiguous())
        else:
            RtcGelu.plain_calls += 1
            dx = gelu_bwd_plain(x, dy)
        self.assign(in_grad[0], req[0], dx)


class RtcGeluFFN(PositionwiseFFN):
    """PositionwiseFFN whose activation is the user's ``rtc_gelu`` op."""

    def forward(self, x):
        h = mx.nd.Custom(self.ffn_1(x), op_type="rtc_gelu")
        if self._dropout is not None:
            h = self._dropout(h)
        return self.ffn_2(h)


@contextlib.contextmanager
def rtc_gelu_ffn(net):
    """Inside the scope every PositionwiseFFN of ``net`` runs RtcGeluFFN's
    forward, with its own parameters; yields their number."""
    cells = [m for m in net.modules() if type(m) is PositionwiseFFN]
    for m in cells:
        m.__class__ = RtcGeluFFN
    try:
        yield len(cells)
    finally:
        for m in cells:
            m.__class__ = PositionwiseFFN


ENTRIES = {"flash_fwd": att.flash_fwd, "flash_bwd_dq": att.flash_bwd_dq,
           "flash_bwd_dkv": att.flash_bwd_dkv, "bn_stats": bn.bn_stats,
           "bn_apply": bn.bn_apply, "bn_apply_res": bn.bn_apply_res,
           "rtc_gelu_fwd": GELU_FWD, "rtc_gelu_bwd": GELU_BWD}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def kernel_counts():
    return {name: fn.launches for name, fn in ENTRIES.items()}


def reset_kernel_counts():
    for fn in ENTRIES.values():
        fn.launches = 0


def set_kernel_counts(counts):
    for name, fn in ENTRIES.items():
        fn.launches = counts[name]


def ulp(x, dtype):
    """The spacing of ``dtype``'s values at |x| (x > 0)."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    return 2.0 ** (math.frexp(x)[1] - 1 - mant) if x > 0 else 0.0


# -- phase 1 ----------------------------------------------------------------


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


# -- phase 2 ----------------------------------------------------------------


def _ptxas_report(log):
    kernels, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = {"entry": m.group(1)}
            kernels.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(s.group(1)) if s else 0
    return kernels


def phase_build():
    """One nvcc per source, all started together; fails on a spill."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        rtc = pool.submit(_cuda.build_cubin, RTC_SOURCE)
        builds = dict(zip(KERNELS, pool.map(_cuda.build, KERNELS)))
        builds["rtc"] = rtc.result()
    spills = []
    for name, (_, log, seconds) in builds.items():
        entries = _ptxas_report(log)
        for k in entries:
            emit("build", kernel=name, **k)
            if k.get("spill_stores", 0) or k.get("spill_loads", 0):
                spills.append(k["entry"])
        emit("build", kernel=name, seconds=seconds, entries=len(entries))
    emit("build", wall_seconds=time.perf_counter() - t0, spills=spills)
    if spills:
        sys.exit(1)
    att._entry()  # load all three once, outside any timing
    att._bwd_entry()
    bn._lib()
    for name in sorted(RTC._kernels):  # the user's kernels, as the driver loaded them
        emit("build", kernel="rtc", function=name, **RTC.attributes(name, 0))


# -- phase 3 ----------------------------------------------------------------


def _randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def _case_inputs(case, gen, device):
    b, sq, sk, h, d, dtype = (case[k] for k in ("b", "sq", "sk", "h", "d", "dtype"))
    if case.get("layout") == "qkv":  # the [B, S, 3, H, Dh] projection output
        x = _randn((b, sq, 3, h, d), dtype, gen, device)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2], "bshd"
    # k and v of one batch entry or one head expanded (stride 0) over the
    # rest; or q of one row expanded over the sequence
    expand = case.get("expand")
    kv = (1 if expand == "b" else b, 1 if expand == "h" else h, sk, d)
    return (_randn((b, h, 1 if expand == "s" else sq, d), dtype, gen, device).expand(b, h, sq, d),
            _randn(kv, dtype, gen, device).expand(b, h, sk, d),
            _randn(kv, dtype, gen, device).expand(b, h, sk, d), "bhsd")


MAIN = dict(b=64, sq=128, sk=128, h=12, d=64, dtype=torch.bfloat16, causal=False)
KERNEL_CASES = [
    dict(MAIN, name="main"),
    dict(MAIN, name="main_causal", causal=True),
    dict(MAIN, name="fp32", dtype=torch.float32),
    dict(MAIN, name="seq512", b=8, sq=512, sk=512),
    dict(MAIN, name="unaligned_s200", b=4, sq=200, sk=200),
    dict(MAIN, name="unaligned_s200_causal", b=4, sq=200, sk=200, causal=True),
    dict(MAIN, name="cross_sq77_sk200", b=4, sq=77, sk=200),
    dict(MAIN, name="with_lse", lse=True),
    dict(MAIN, name="causal_with_lse", b=4, sq=200, sk=200, causal=True, lse=True),
    dict(MAIN, name="qkv_bshd_view", layout="qkv"),
    dict(MAIN, name="fp16", b=8, dtype=torch.float16),
    dict(MAIN, name="dh16", b=8, h=4, d=16),
    dict(MAIN, name="dh32", b=8, h=4, d=32),
    dict(MAIN, name="dh128", b=8, h=4, d=128),
    dict(MAIN, name="fp32_dh128_causal", b=2, h=4, d=128, sq=200, sk=200,
         dtype=torch.float32, causal=True),
]
# The 16-bit kernel's persistent schedule (128-row work items walked with a
# static stride over a grid of one block per SM, K/V through a ring of TMA
# stages): cases that exercise its bookkeeping.
SCHEDULE_CASES = [
    # 804 items over the grid: several rounds per block and a remainder, so
    # the ring's stages and parities wrap across work items
    dict(MAIN, name="items_over_grid_b67", b=67),
    # one work item: one block, the others of a grid never launched
    dict(MAIN, name="single_item", b=1, h=1),
    # fewer query rows than one consumer warpgroup's 64: the second
    # consumer's rows are all TMA zero fill and its store is skipped
    dict(MAIN, name="sq40", b=4, sq=40, sk=40),
    # eight K/V tiles an item, the last a 104-key tail, causal: many ring
    # stages per item, the masked diagonal and tail tiles, lse
    dict(MAIN, name="sk1000_causal_with_lse", b=2, h=4, sq=1000, sk=1000, causal=True,
         lse=True),
    # the inference request shape: four K/V stages per item, lse
    dict(MAIN, name="seq512_with_lse", b=8, sq=512, sk=512, lse=True),
]
# Options and operands the 16-bit path takes beyond the main paths'.
OPERAND_CASES = [
    # a scale other than 1/sqrt(Dh) over a causal tail, with lse
    dict(MAIN, name="scale_0.3_causal_tail", b=4, sq=200, sk=200, causal=True, lse=True,
         scale=0.3),
    # a negative scale turns the order of the scores around: the row max
    # must be taken of the scaled scores, and masked keys stay at -inf
    dict(MAIN, name="scale_-0.3_causal_tail", b=4, sq=200, sk=200, causal=True, lse=True,
         scale=-0.3),
    # scale 0: equal weights over the visible keys, masked keys still none
    dict(MAIN, name="scale_0_causal_tail", b=4, sq=200, sk=200, causal=True, lse=True,
         scale=0.0),
    # k and v expanded over the batch and over the heads (stride 0): the
    # tensor maps hold extent 1 there and the producer reads coordinate 0
    dict(MAIN, name="kv_expanded_over_batch", b=4, sq=200, sk=200, expand="b"),
    dict(MAIN, name="kv_expanded_over_heads_causal", b=4, sq=200, sk=200, causal=True,
         expand="h"),
]
# The operand domain the wrappers take beyond the kernels' own: q repeating
# one row along the sequence (stride 0; the wrapper hands it to the 16-bit
# kernels contiguous), and head dims with no kernel instance (zero-padded
# to the next one, sliced back).  (Repeated keys would make every visible
# key score alike, and dq = scale·Σ ds·k exactly 0: a bound in ulps of the
# largest |dq| says nothing there.)
DOMAIN_CASES = [
    dict(MAIN, name="q_seq_stride0_causal", b=4, sq=200, sk=200, causal=True, expand="s"),
    dict(MAIN, name="dh48", b=4, h=4, sq=200, sk=200, d=48),
    dict(MAIN, name="dh80_causal", b=4, h=4, sq=200, sk=200, d=80, causal=True),
]


def phase_kernel_vs_plain(device):
    gen = torch.Generator(device=device).manual_seed(1234)
    misses, main_err = [], None
    for case in KERNEL_CASES + SCHEDULE_CASES + OPERAND_CASES + DOMAIN_CASES:
        q, k, v, layout = _case_inputs(case, gen, device)
        want_lse, scale = case.get("lse", False), case.get("scale")
        with torch.no_grad():
            o, lse = att.flash_fwd(q, k, v, case["causal"], scale, want_lse, layout)
            torch.cuda.synchronize()
            t = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
            o_ref, lse_ref = att.flash_fwd_plain(t(q), t(k), t(v), case["causal"], scale,
                                                 want_lse)
        err = (t(o).float() - o_ref.float()).abs().max().item()
        ref_max = o_ref.float().abs().max().item()
        bound = (FP32_FWD_BOUND if case["dtype"] == torch.float32
                 else FWD_ULPS * ulp(ref_max, case["dtype"]))
        ok = math.isfinite(err) and err <= bound
        rec = dict(case=case["name"], dtype=str(case["dtype"]).replace("torch.", ""),
                   shape=dict(b=case["b"], h=case["h"], sq=case["sq"], sk=case["sk"], d=case["d"]),
                   causal=case["causal"], layout=layout, max_abs_err=err,
                   ref_max_abs=ref_max, bound=bound,
                   **{key: case[key] for key in ("scale", "expand") if key in case})
        if want_lse:
            lerr = (lse - lse_ref).abs().max().item()
            rec.update(lse_max_abs_err=lerr, lse_bound=LSE_BOUND)
            ok = ok and math.isfinite(lerr) and lerr <= LSE_BOUND
        rec["ok"] = ok
        emit("kernel_vs_plain", **rec)
        if not ok:
            misses.append(case["name"])
        if case["name"] == "qkv_bshd_view":
            main_err = err
    # The schedule is static (no atomics, fixed item order): two runs of the
    # main case give the same bits, o and lse.
    q, k, v, layout = _case_inputs(MAIN, gen, device)
    with torch.no_grad():
        runs = [att.flash_fwd(q, k, v, False, None, True, layout) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    emit("kernel_vs_plain", case="main_repeat_bitwise", identical=same, ok=same)
    if not same:
        misses.append("main_repeat_bitwise")
    # A head dim above the widest instance is refused before any launch.
    wide = torch.zeros(1, 1, 8, 256, dtype=torch.bfloat16, device=device)
    before = att.flash_fwd.launches
    refused = (_raises(lambda: att.flash_fwd(wide, wide, wide), ValueError, "head dim")
               and att.flash_fwd.launches == before)
    emit("kernel_vs_plain", case="dh256_refused", ok=refused)
    if not refused:
        misses.append("dh256_refused")
    if misses:
        emit("kernel_vs_plain", failed=misses)
        sys.exit(1)
    return main_err


def _bwd_bound(ref, dtype, ulps=BWD_ULPS):
    ref_max = ref.float().abs().max().item()
    if dtype == torch.float32:
        return ref_max, FP32_BWD_REL * ref_max
    return ref_max, ulps * ulp(ref_max, dtype)


BWD_CASES = (KERNEL_CASES + SCHEDULE_CASES + OPERAND_CASES + DOMAIN_CASES
             + [dict(MAIN, name="dqkv_buffer", layout="qkv", dqkv=True),
                dict(MAIN, name="autograd_fused_qkv", layout="qkv", e2e=True)])


def _bwd_case(case, gen, device):
    """(name -> (got, ref, bound, ref_max)) for dq, dk, dv of one case."""
    b, sq, h, d, dtype, causal = (case[k] for k in ("b", "sq", "h", "d", "dtype", "causal"))
    if case.get("e2e"):  # the [B, S, 3·H·Dh] QKV projection output
        qkv = _randn((b, sq, 3 * h * d), dtype, gen, device).requires_grad_()
        x = qkv.detach().reshape(b, sq, 3, h, d)
        q, k, v, layout = x[:, :, 0], x[:, :, 1], x[:, :, 2], "bshd"
    else:
        q, k, v, layout = _case_inputs(case, gen, device)
    t = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
    do = _randn((b, sq, h, d) if layout == "bshd" else (b, h, sq, d), dtype, gen, device)
    if case.get("e2e"):
        out = att.fused_qkv_attention(qkv, num_heads=h, causal=causal)
        out.backward(do.reshape(b, sq, h * d))
        got = qkv.grad.reshape(b, sq, 3, h, d)
        got = (got[:, :, 0], got[:, :, 1], got[:, :, 2])
        o_ref, lse_ref = att.flash_fwd_plain(t(q), t(k), t(v), causal, None, True)
        ref = att.flash_bwd_plain(t(q), t(k), t(v), o_ref, t(do), lse_ref, causal)
        ulps = E2E_ULPS
    else:
        scale = case.get("scale")
        with torch.no_grad():
            o, lse = att.flash_fwd(q, k, v, causal, scale, True, layout)
            out = None
            if case.get("dqkv"):
                dqkv = torch.empty(b, sq, 3, h, d, dtype=dtype, device=device)
                out = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
            got = att.flash_bwd(q, k, v, o, do, lse, causal, scale, layout, out=out)
            if out is not None and any(g.data_ptr() != w.data_ptr() for g, w in zip(got, out)):
                raise AssertionError("flash_bwd did not write into the given buffers")
            ref = att.flash_bwd_plain(t(q), t(k), t(v), t(o), t(do), lse, causal, scale)
        ulps = BWD_ULPS
    torch.cuda.synchronize()
    res = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        ref_max, bound = _bwd_bound(r, dtype, ulps)
        res[name] = ((t(g).float() - r.float()).abs().max().item(), bound, ref_max)
    return res


def phase_kernel_vs_plain_bwd(device):
    """Returns the max abs error of dq and of dk/dv at the main path's
    layout (the [B, S, 3, H, Dh] gradient buffer)."""
    gen = torch.Generator(device=device).manual_seed(4321)
    misses, main_errs = [], None
    for case in BWD_CASES:
        res = _bwd_case(case, gen, device)
        ok = all(math.isfinite(e) and e <= bound for e, bound, _ in res.values())
        emit("kernel_vs_plain_bwd", case=case["name"],
             dtype=str(case["dtype"]).replace("torch.", ""),
             shape=dict(b=case["b"], h=case["h"], sq=case["sq"], sk=case["sk"], d=case["d"]),
             causal=case["causal"],
             **{key: case[key] for key in ("scale", "expand") if key in case},
             **{f"{n}_max_abs_err": e for n, (e, _, _) in res.items()},
             **{f"{n}_ref_max_abs": m for n, (_, _, m) in res.items()},
             **{f"{n}_bound": bound for n, (_, bound, _) in res.items()}, ok=ok)
        if not ok:
            misses.append(case["name"])
        if case["name"] == "dqkv_buffer":
            main_errs = {"flash_bwd_dq": res["dq"][0],
                         "flash_bwd_dkv": max(res["dk"][0], res["dv"][0])}
    # The schedule is static (no atomics, fixed item order): two runs of the
    # main case give the same bits, dq, dk and dv.
    q, k, v, layout = _case_inputs(dict(MAIN, layout="qkv"), gen, device)
    do = _randn(q.shape, MAIN["dtype"], gen, device)
    with torch.no_grad():
        o, lse = att.flash_fwd(q, k, v, False, None, True, layout)
        runs = [att.flash_bwd(q, k, v, o, do, lse, False, None, layout) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    emit("kernel_vs_plain_bwd", case="main_repeat_bitwise", identical=same, ok=same)
    if not same:
        misses.append("main_repeat_bitwise")
    # A thread that has made no CUDA call yet (as autograd's backward thread
    # or a server's worker) gets the same bits from both kernels.
    got = {}

    def fresh_thread():
        with torch.no_grad():
            got["fwd"] = att.flash_fwd(q, k, v, False, None, True, layout)
            got["bwd"] = att.flash_bwd(q, k, v, o, do, lse, False, None, layout)
        torch.cuda.synchronize()

    worker = threading.Thread(target=fresh_thread)
    worker.start()
    worker.join()
    same = ("bwd" in got and all(torch.equal(a, b) for a, b in zip(got["bwd"], runs[0]))
            and torch.equal(got["fwd"][0], o) and torch.equal(got["fwd"][1], lse))
    emit("kernel_vs_plain_bwd", case="fresh_thread_bitwise", identical=same, ok=same)
    if not same:
        misses.append("fresh_thread_bitwise")
    if misses:
        emit("kernel_vs_plain_bwd", failed=misses)
        sys.exit(1)
    return main_errs


# BatchNorm inputs of ResNet-50 v1 at 224x224: (C, H·W) of the 53 layers.
RESNET_BN_SHAPES = ((64, 12544), (64, 3136), (256, 3136), (128, 784), (512, 784), (256, 196),
                    (1024, 196), (512, 49), (2048, 49))
BN_MAIN = [dict(name=f"c{c}_hw{hw}", n=RESNET_B, c=c, hw=hw, dtype=torch.bfloat16, main=True)
           for c, hw in RESNET_BN_SHAPES]
BN_CASES = BN_MAIN + [
    dict(name="fp32_c256_hw3136", n=RESNET_B, c=256, hw=3136, dtype=torch.float32),
    dict(name="fp32_c2048_hw49", n=RESNET_B, c=2048, hw=49, dtype=torch.float32),
    dict(name="fp16_c64_hw3136", n=32, c=64, hw=3136, dtype=torch.float16),
    dict(name="n1", n=1, c=64, hw=3136, dtype=torch.bfloat16),
    dict(name="c1", n=RESNET_B, c=1, hw=196, dtype=torch.bfloat16),
    dict(name="hw1", n=RESNET_B, c=2048, hw=1, dtype=torch.bfloat16),
    dict(name="odd_hw33", n=8, c=12, hw=33, dtype=torch.bfloat16),
    dict(name="odd_hw45_fp32", n=3, c=12, hw=45, dtype=torch.float32),
    dict(name="view_c_stride", n=16, c=64, hw=49, dtype=torch.bfloat16, view="c"),
    dict(name="view_n_stride", n=16, c=256, hw=196, dtype=torch.bfloat16, view="n"),
]


def _bn_input(case, gen, device):
    """x of the case, with a non-zero mean as conv output has; ``view``
    "c" takes every other channel of a wider tensor (C stride 2·HW), "n"
    channels 1..C of a wider one (N stride (C+3)·HW)."""
    n, c, hw, dtype = case["n"], case["c"], case["hw"], case["dtype"]
    view = case.get("view")
    wide = {"c": 2 * c, "n": c + 3}.get(view, c)
    x = (2 * torch.randn((n, wide, hw), generator=gen, device=device) + 0.5).to(dtype)
    return {"c": x[:, ::2], "n": x[:, 1:c + 1]}.get(view, x)


def _ulps(t, dtype):
    """Elementwise spacing of ``dtype``'s values at |t|."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 1 - mant)


def _bn_case(case, gen, device):
    x = _bn_input(case, gen, device)
    res = _bn_input(case, gen, device)
    c = case["c"]
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    shift = torch.randn(c, generator=gen, device=device)
    got, again = bn.bn_stats(x), bn.bn_stats(x)
    torch.cuda.synchronize()
    ref = bn.bn_stats_plain(x)
    x32 = x.float()
    abs_sum = x32.abs().sum(dim=(0, 2))
    rec = dict(case=case["name"], dtype=str(case["dtype"]).replace("torch.", ""),
               shape=dict(n=case["n"], c=c, hw=case["hw"]), strides=list(x.stride()),
               stats_deterministic=torch.equal(got, again),
               stats_max_abs_err=(got - ref).abs().max().item(),
               sum_err_over_bound=((got[:, 0] - ref[:, 0]).abs()
                                   / (STATS_REL * abs_sum)).max().item(),
               sumsq_err_over_bound=((got[:, 1] - ref[:, 1]).abs()
                                     / (STATS_REL * ref[:, 1])).max().item())
    prod = (x32 * scale[None, :, None]).abs() + shift.abs()[None, :, None]
    errs = {}
    for relu in (False, True):
        for r in (None, res):
            out = bn.bn_apply(x, scale, shift, residual=r, relu=relu)
            torch.cuda.synchronize()
            want = bn.bn_apply_plain(x, scale, shift, r, relu)
            terms = prod if r is None else prod + r.float().abs()
            bound = _ulps(want, x.dtype) + 2 * _ulps(terms, torch.float32)
            diff = (out.float() - want.float()).abs()
            key = ("bn_apply_res" if r is not None else "bn_apply") + ("_relu" if relu else "")
            errs[key] = (diff.max().item(), (diff / bound).max().item())
    rec.update({f"{k}_max_abs_err": e for k, (e, _) in errs.items()})
    rec.update({f"{k}_err_over_bound": q for k, (_, q) in errs.items()})
    ok = (rec["stats_deterministic"] and rec["sum_err_over_bound"] <= 1
          and rec["sumsq_err_over_bound"] <= 1 and all(q <= 1 for _, q in errs.values()))
    for v in rec.values():
        ok = ok and (not isinstance(v, float) or math.isfinite(v))
    rec["ok"] = ok
    return rec, errs


def phase_kernel_vs_plain_bn(device):
    """Returns the max abs error of each BN kernel over the nine ResNet-50
    shapes (bn_apply without ReLU, as the path calls it)."""
    gen = torch.Generator(device=device).manual_seed(2468)
    misses, main = [], {"bn_stats": 0.0, "bn_apply": 0.0, "bn_apply_res": 0.0}
    with torch.no_grad():
        for case in BN_CASES:
            rec, errs = _bn_case(case, gen, device)
            emit("kernel_vs_plain_bn", stats_bound_rel=STATS_REL, **rec)
            if not rec["ok"]:
                misses.append(case["name"])
            if case.get("main"):
                main["bn_stats"] = max(main["bn_stats"], rec["stats_max_abs_err"])
                main["bn_apply"] = max(main["bn_apply"], errs["bn_apply"][0])
                main["bn_apply_res"] = max(main["bn_apply_res"], errs["bn_apply_res"][0],
                                           errs["bn_apply_res_relu"][0])
    if misses:
        emit("kernel_vs_plain_bn", failed=misses)
        sys.exit(1)
    return main


# The user's kernels against their plain versions.  scale_add, saxpy_block
# and twice: 2x and 0.5x are exact in fp32, so the result is one rounding of
# the exact value on both sides (nvcc contracts 2x + y into an fma, PyTorch
# rounds the exact 2x + y once); the bound is one fp32 ulp of the plain
# result.  minmax: exact.  GELU: both sides compute in fp32 and round once
# to the output type, so they differ by at most one output ulp of the plain
# result, plus what the fp32 arithmetic can move before the rounding: a few
# fp32 roundings of the terms, and erff's error (2 fp32 ulps of erf's value
# near ±1) where 1 + erf cancels in the negative tail.  GELU_FP32_TERM · |x|
# (forward) and GELU_FP32_TERM · |dy|·(1 + |x|) (backward) hold those, with
# GELU_FP32_TERM = 2**-21, four fp32 ulps at 1.  A wrong index, pack or
# rounding moves values by their own size.
GELU_FP32_TERM = 2.0 ** -21
GELU_MAIN = (64, 128, 3072)  # the FFN activation of the BERT-base step: [B, S, 4·768]
GELU_CASES = [
    dict(name="main", shape=GELU_MAIN, dtype=torch.bfloat16, main=True),
    dict(name="ragged_1000003", shape=(1_000_003,), dtype=torch.bfloat16),
    dict(name="fp32_main", shape=GELU_MAIN, dtype=torch.float32),
    dict(name="fp32_ragged_1000003", shape=(1_000_003,), dtype=torch.float32),
    dict(name="offset_2_bytes", shape=(1_000_004,), dtype=torch.bfloat16, offset=1),
]


def _gelu_case(case, gen, device):
    x = 2 * torch.randn(case["shape"], generator=gen, device=device)
    dy = torch.randn(case["shape"], generator=gen, device=device)
    x, dy = x.to(case["dtype"]), dy.to(case["dtype"])
    if case.get("offset"):  # contiguous, not 16-byte aligned: the scalar loop
        x, dy = x[case["offset"]:], dy[case["offset"]:]
    y, dx = GELU_FWD(x), GELU_BWD(x, dy)
    torch.cuda.synchronize()
    x32, dy32 = x.float(), dy.float()
    rec, errs = dict(case=case["name"], shape=list(x.shape),
                     dtype=str(case["dtype"]).replace("torch.", "")), {}
    for name, got, want, term in (
            ("gelu_fwd", y, gelu_plain(x), GELU_FP32_TERM * x32.abs()),
            ("gelu_bwd", dx, gelu_bwd_plain(x, dy),
             GELU_FP32_TERM * dy32.abs() * (1 + x32.abs()))):
        diff = (got.float() - want.float()).abs()
        out_ulp = _ulps(want, case["dtype"])
        errs[name] = diff.max().item()
        rec.update({f"{name}_max_abs_err": errs[name],
                    f"{name}_max_err_ulps": (diff / out_ulp).max().item(),
                    f"{name}_err_over_bound": (diff / (out_ulp + term)).max().item()})
    rec["ok"] = all(math.isfinite(rec[f"{n}_max_abs_err"]) and rec[f"{n}_err_over_bound"] <= 1
                    for n in ("gelu_fwd", "gelu_bwd"))
    return rec, errs


def _raises(fn, exc, match):
    """Whether ``fn()`` raises ``exc`` with ``match`` in its message."""
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def phase_kernel_vs_plain_rtc(device):
    """The user's kernels of RTC_SOURCE against their plain versions on the
    card, and the launcher's refusals; returns the GELU kernels' max abs
    error at the path's shape."""
    gen = torch.Generator(device=device).manual_seed(1357)
    misses, main = [], {}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, y = rand(16, 128), rand(16, 128)
    xb, yb = rand(32, 128), rand(32, 128)
    x4 = rand(4, 8)
    elementwise = (
        ("scale_add", RTC.get_kernel("scale_add", out_shapes=[(16, 128)], grid=(4,),
                                     block=(256,)).launch([x, y, x.numel()]), 2 * x + y),
        ("saxpy_block", RTC.get_kernel("saxpy_block", out_shapes=[(8 * 4, 128)], grid=(4,),
                                       block=(128,)).launch([xb, yb]), 0.5 * xb + yb),
        ("twice", RTC.get_kernel("twice", out_shapes=[(4, 8)], grid=(1,),
                                 block=(32,)).launch([x4, x4.numel()]), 2 * x4))
    torch.cuda.synchronize()
    for name, got, want in elementwise:
        diff = (got - want).abs()
        ok = bool((diff <= _ulps(want, torch.float32)).all().item())
        emit("kernel_vs_plain_rtc", case=name, shape=list(got.shape), dtype="float32",
             max_abs_err=diff.max().item(), bound="1 fp32 ulp of the plain result", ok=ok)
        if not ok:
            misses.append(name)
    xm = rand(32, 32)
    lo, hi = RTC.get_kernel("minmax", out_shapes=[(1, 1), (1, 1)], grid=(1,),
                            block=(256,)).launch([xm, xm.numel()])
    torch.cuda.synchronize()
    ok = lo.item() == xm.min().item() and hi.item() == xm.max().item()
    emit("kernel_vs_plain_rtc", case="minmax", shape=[32, 32], lo=lo.item(), hi=hi.item(),
         bound="exact", ok=ok)
    if not ok:
        misses.append("minmax")

    for case in GELU_CASES:
        rec, errs = _gelu_case(case, gen, device)
        emit("kernel_vs_plain_rtc", fp32_term=GELU_FP32_TERM, **rec)
        if not rec["ok"]:
            misses.append(case["name"])
        if case.get("main"):
            main = {"rtc_gelu_fwd": errs["gelu_fwd"], "rtc_gelu_bwd": errs["gelu_bwd"]}

    # refusals, each before any launch
    k = RTC.get_kernel("gelu_fwd_bf16", out_shapes=[(64,)], out_dtypes=["bfloat16"], grid=(1,),
                       block=(32,))
    xg = rand(64).bfloat16()
    wide = rand(8, 16).bfloat16()
    lost = RTC.get_kernel("not_extern_c", out_shapes=[(1,)], signature="float* out",
                          grid=(1,), block=(1,))
    refusals = {
        "dtype_mismatch": _raises(lambda: k.launch([xg.float(), 64]), ValueError, "bfloat16"),
        "wrong_arg_count": _raises(lambda: k.launch([xg]), ValueError, "takes 2 arguments"),
        "non_contiguous": _raises(lambda: GELU_FWD(wide[:, ::2]), ValueError, "contiguous"),
        "cpu_tensor": _raises(lambda: k.launch([xg.cpu(), 64]), RuntimeError, "CUDA tensors"),
        "missing_extern_c": _raises(lambda: lost.launch([], ctx=mx.gpu(0)), RuntimeError,
                                    'extern "C"'),
    }
    torch.cuda.synchronize()
    ok = all(refusals.values()) and k.launches == 0 and lost.launches == 0
    emit("kernel_vs_plain_rtc", case="refusals", raised=refusals, launches=k.launches + lost.launches,
         ok=ok)
    if not ok:
        misses.append("refusals")
    if misses:
        emit("kernel_vs_plain_rtc", failed=misses)
        sys.exit(1)
    return main


# -- phase 4 ----------------------------------------------------------------


def _requests(batches, vocab, gen, device):
    out = []
    for b, s, p in batches:
        ids = torch.randint(0, vocab, (b, s), generator=gen, device=device, dtype=torch.int32)
        types = torch.randint(0, 2, (b, s), generator=gen, device=device, dtype=torch.int32)
        pos = torch.randint(0, s, (b, p), generator=gen, device=device, dtype=torch.int32)
        out.append((ids, types, pos))
    return out


def _build_net(cfg, ctx, dtype):
    mx.random.seed(0)
    if "units" in cfg:
        base = bert_zoo.BERTModel(**cfg)
    else:
        base = bert_zoo.bert_base(**cfg)
    net = bert_zoo.BERTForPretrain(base, vocab_size=cfg["vocab_size"])
    net.initialize(ctx=ctx)
    if dtype != "float32":
        net.cast(dtype)
    return net


def phase_slice(rehearsal):
    """Returns (net, main_batch, forwards) for the timing phase."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    net = _build_net(cfg, None if not rehearsal else ctx, "bfloat16")
    gen = torch.Generator(device=device).manual_seed(7)
    batches = [(64, 128, 20)] * 3 + [(8, 512, 80)]
    if rehearsal:
        batches = [(4, 16, 3)] * 3 + [(2, 64, 8)]
    reqs = _requests(batches, cfg["vocab_size"], gen, device)

    reset_kernel_counts()
    outs = []
    with mx.autograd.predict_mode():
        for ids, types, pos in reqs:
            outs.append(net(ids, types, pos))
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = kernel_counts()

    for (b, s, p), (mlm, nsp) in zip(batches, outs):
        shapes_ok = (tuple(mlm.shape) == (b, p, cfg["vocab_size"]) and tuple(nsp.shape) == (b, 2))
        finite = bool(torch.isfinite(mlm).all().item() and torch.isfinite(nsp).all().item())
        emit("slice", request=dict(b=b, s=s, p=p), mlm_shape=list(mlm.shape),
             nsp_shape=list(nsp.shape), dtype=str(mlm.dtype).replace("torch.", ""),
             shapes_ok=shapes_ok, finite=finite)
        if not (shapes_ok and finite):
            sys.exit(1)
    want = 0 if rehearsal else num_layers * len(reqs)
    emit("slice", launches=counts, expected_flash_fwd=want, forwards=len(reqs))
    if counts != {n: want if n == "flash_fwd" else 0 for n in ENTRIES}:
        sys.exit(1)

    # the same weights, fp32, through the port on the CPU
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref_net = _build_net(cfg, mx.cpu(), "float32")
    load_numpy_params(ref_net, arrays)
    small = _requests([(2, 128 if not rehearsal else 16, 20 if not rehearsal else 3)],
                      cfg["vocab_size"], gen, device)[0]
    with mx.autograd.predict_mode():
        got = net(*small)
        ref = ref_net(*(x.cpu() for x in small))
    for name, g, r in zip(("mlm_logits", "nsp_logits"), got, ref):
        err = (g.float().cpu() - r).abs().max().item()
        scale = r.abs().max().item()
        rel = err / scale
        ok = math.isfinite(rel) and rel <= SLICE_REL_BOUND
        emit("slice_vs_cpu_fp32", output=name, max_abs_err=err, ref_max_abs=scale,
             rel_err=rel, bound=SLICE_REL_BOUND, ok=ok)
        if not ok:
            sys.exit(1)
    return net, reqs[0], counts


# -- phase 5 ----------------------------------------------------------------


def _train_batch(cfg, b, s, p, gen, device):
    ids, types, pos = _requests([(b, s, p)], cfg["vocab_size"], gen, device)[0]
    labels = torch.randint(0, cfg["vocab_size"], (b, p), generator=gen, device=device,
                           dtype=torch.int32)
    return ids, types, pos, labels


def train_step(net, trainer, batch, train_mode=True):
    """One pretraining step as a user writes it (the loss of bench.py's
    ``mlm_loss``); returns the per-sample loss."""
    ids, types, pos, labels = batch
    with mx.autograd.record(train_mode=train_mode):
        mlm, _ = net(ids, types, pos)
        loss = streaming_softmax_ce(mlm, labels).mean(-1)
    mx.autograd.backward(loss)
    if trainer is not None:
        trainer.step(ids.shape[0])
    return loss


def phase_train(rehearsal):
    """BERT-base pretraining steps on one fixed device-resident batch;
    returns (net, trainer, batch, counts of one step)."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    num_layers = cfg.get("num_layers", 12)
    b, s, p = (4, 16, 3) if rehearsal else (64, 128, 20)
    net = _build_net(cfg, ctx, "bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4, "multi_precision": True})
    batch = _train_batch(cfg, b, s, p, torch.Generator(device=device).manual_seed(11), device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    losses = [train_step(net, trainer, batch).mean().item() for _ in range(2)]  # warm-up
    reset_kernel_counts()
    losses.append(train_step(net, trainer, batch).mean().item())  # syncs on .item()
    counts = kernel_counts()
    losses += [train_step(net, trainer, batch).mean().item() for _ in range(9)]
    sync()
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    want = {n: num_layers if n in FLASH and not rehearsal else 0 for n in ENTRIES}
    emit("train", model="BERTForPretrain(bert_base) bf16, Adam multi_precision, dropout 0.1"
         if not rehearsal else "tiny BERT bf16 (CPU rehearsal)", b=b, s=s, p=p,
         losses=losses, finite=finite, falling=falling, launches_one_step=counts,
         expected=want)
    if not (finite and falling) or counts != want:
        sys.exit(1)
    return net, trainer, batch, counts


def _rel_l2(grads, ref):
    """{key: |g − r| / |r|} per parameter."""
    out = {}
    for key, r in ref.items():
        rn, dn = r.norm().item(), (grads[key] - r).norm().item()
        out[key] = dn / rn if rn > 0 else (0.0 if dn == 0 else math.inf)
    return out


def _card_grads(net):
    return {k: p.grad().detach().float().cpu().clone()
            for k, p in net._collect_params_with_prefix().items()}


def phase_train_vs_cpu(net, rehearsal):
    """The card's bf16 gradients against the port's fp32 gradients on the
    CPU, same weights, dropout off; relative L2 error per parameter.
    Returns (batch, the CPU's gradients, the card's gradients)."""
    cfg = TINY_BERT if rehearsal else BERT_BASE
    device = next(iter(net.collect_params().values())).data().device
    gen = torch.Generator(device=device).manual_seed(13)
    batch = _train_batch(cfg, 2, 16 if rehearsal else 128, 3 if rehearsal else 20, gen, device)
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    ref_net = _build_net(cfg, mx.cpu(), "float32")
    load_numpy_params(ref_net, arrays)
    train_step(net, None, batch, train_mode=False)
    train_step(ref_net, None, tuple(x.cpu() for x in batch), train_mode=False)
    got = _card_grads(net)
    ref = {k: p.grad() for k, p in ref_net._collect_params_with_prefix().items()}
    if not _grad_check("train_vs_cpu_fp32", got, ref):
        sys.exit(1)
    return batch, ref, got


def _grad_check(phase, got, ref, **extra):
    """Emit the per-parameter relative L2 errors of ``got`` against ``ref``
    and whether each is within GRAD_REL_BOUND."""
    rels = _rel_l2(got, ref)
    worst = sorted(((rel, k) for k, rel in rels.items()), reverse=True)
    bad = [k for k, rel in rels.items() if not (math.isfinite(rel) and rel <= GRAD_REL_BOUND)]
    emit(phase, b=2, params=len(worst), bound=GRAD_REL_BOUND,
         worst=[[k, rel] for rel, k in worst[:6]], median_rel=worst[len(worst) // 2][0],
         failed=bad, ok=not bad, **extra)
    return not bad


def phase_rtc_train(net, trainer, train_batch, vs_cpu, rehearsal):
    """The slice-2 BERT-base step with each FFN activation the user's
    ``rtc_gelu`` CustomOp (``gelu_fwd`` forward, ``gelu_bwd`` backward, on
    the net's own weights and Trainer).  First the gradients of the batch
    and weights of ``train_vs_cpu`` (``vs_cpu`` = (batch, CPU fp32
    gradients, the card's built-in-GELU gradients)) against the CPU's,
    within GRAD_REL_BOUND, and beside the built-in step's; then training
    steps, with the launches counted around exactly one.  Returns those
    counts."""
    batch, ref, builtin = vs_cpu
    num_layers = (TINY_BERT if rehearsal else BERT_BASE).get("num_layers", 12)
    with rtc_gelu_ffn(net) as n_ffn:
        train_step(net, None, batch, train_mode=False)
        got = _card_grads(net)
        vs_builtin = _rel_l2(got, builtin)
        ok = _grad_check("rtc_train_vs_cpu_fp32", got, ref, ffn_swapped=n_ffn,
                         vs_card_builtin_gelu_median_rel=sorted(vs_builtin.values())[
                             len(vs_builtin) // 2],
                         vs_card_builtin_gelu_max_rel=max(vs_builtin.values()))
        if not ok or n_ffn != num_layers:
            sys.exit(1)
        losses = [train_step(net, trainer, train_batch).mean().item() for _ in range(2)]
        reset_kernel_counts()
        RtcGelu.plain_calls = 0
        losses.append(train_step(net, trainer, train_batch).mean().item())  # syncs on .item()
        counts, plain_calls = kernel_counts(), RtcGelu.plain_calls
        losses += [train_step(net, trainer, train_batch).mean().item() for _ in range(3)]
    finite = all(math.isfinite(x) for x in losses)
    falling = losses[-1] < losses[0]
    on_card = {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rtc_gelu_fwd", "rtc_gelu_bwd"}
    want = {n: num_layers if n in on_card and not rehearsal else 0 for n in ENTRIES}
    want_plain = 2 * num_layers if rehearsal else 0
    b, s, p = train_batch[0].shape[0], train_batch[0].shape[1], train_batch[2].shape[1]
    emit("rtc_train", model="BERTForPretrain(bert_base) bf16, Adam multi_precision, dropout "
         "0.1, FFN activation = the user's rtc_gelu CustomOp" if not rehearsal
         else "tiny BERT bf16 (CPU rehearsal), FFN activation = rtc_gelu", b=b, s=s, p=p,
         losses=losses, finite=finite, falling=falling, launches_one_step=counts,
         expected=want, plain_gelu_calls_one_step=plain_calls, expected_plain=want_plain)
    if not (finite and falling) or counts != want or plain_calls != want_plain:
        sys.exit(1)
    return counts


# -- phase 6 ----------------------------------------------------------------


def _build_resnet(rehearsal, ctx, seed):
    mx.random.seed(seed)
    if rehearsal:
        cfg = dict(TINY_RESNET)
        net = vision.ResNetV1(vision.BottleneckV1, cfg.pop("layers"), cfg.pop("channels"), **cfg)
    else:
        net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=ctx)
    size = 32 if rehearsal else 224
    with mx.autograd.predict_mode():  # finish the deferred shapes, as bench.py does
        net(torch.zeros(2, 3, size, size, device=ctx.device))
    return net


def _image_batch(rehearsal, b, gen, device):
    size, classes = (32, TINY_RESNET["classes"]) if rehearsal else (224, 1000)
    img = torch.rand((b, 3, size, size), generator=gen, device=device)
    labels = torch.randint(0, classes, (b,), generator=gen, device=device, dtype=torch.int32)
    return img, labels


def resnet_step(net, trainer, batch, train_mode=True):
    """One step as bench.py's bench_resnet50 takes it: the per-sample
    streaming softmax cross-entropy, backward, SGD; returns the loss."""
    img, labels = batch
    with mx.autograd.record(train_mode=train_mode):
        loss = streaming_softmax_ce(net(img), labels)
    mx.autograd.backward(loss)
    if trainer is not None:
        trainer.step(img.shape[0])
    return loss


def phase_resnet_train(rehearsal):
    """ResNet-50 v1 training steps (AMP bf16, fp32 parameters, SGD-momentum)
    on one device-resident synthetic batch; returns (net, trainer, batch,
    launch counts of one step, the step's BatchNorm input shapes)."""
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    device = ctx.device
    b = 2 if rehearsal else RESNET_B
    mx.amp.init("bfloat16")
    net = _build_resnet(rehearsal, ctx, 0)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    batch = _image_batch(rehearsal, b, torch.Generator(device=device).manual_seed(21), device)
    blocks = [m for m in net.modules() if isinstance(m, mx.gluon.nn.BatchNorm)]
    before = [(m.running_mean.data().clone(), m.running_var.data().clone()) for m in blocks]

    losses = [resnet_step(net, trainer, batch).mean().item() for _ in range(2)]  # warm-up
    shapes = {}

    def record_shape(_, args):
        key = (args[0].shape[1], args[0].shape[2] * args[0].shape[3])
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record_shape) for m in blocks]
    reset_kernel_counts()
    ops_nn.batch_norm.reference_calls = 0
    losses.append(resnet_step(net, trainer, batch).mean().item())  # syncs on .item()
    counts = kernel_counts()
    reference_calls = ops_nn.batch_norm.reference_calls
    for h in hooks:
        h.remove()
    losses += [resnet_step(net, trainer, batch).mean().item() for _ in range(9)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    moved = sum(not (torch.equal(m.running_mean.data(), m0) and torch.equal(m.running_var.data(), v0))
                for m, (m0, v0) in zip(blocks, before))
    finite = all(math.isfinite(x) for x in losses)
    n_bn = len(blocks)
    want = {n: n_bn if n in ("bn_stats", "bn_apply") and not rehearsal else 0 for n in ENTRIES}
    emit("resnet_train", model="resnet50_v1(classes=1000), AMP bf16, fp32 parameters, SGD "
         "lr 0.1 momentum 0.9 wd 1e-4" if not rehearsal else "tiny ResNetV1 (CPU rehearsal)",
         b=b, batchnorm_layers=n_bn, losses=losses, finite=finite,
         running_stats_moved=f"{moved}/{n_bn}", launches_one_step=counts, expected=want,
         batchnorm_reference_calls=reference_calls,
         bn_shapes_one_step=[[c, hw, k] for (c, hw), k in sorted(shapes.items())])
    if not finite or counts != want or reference_calls != 0 or moved != n_bn:
        sys.exit(1)
    mx.amp.disable()
    return net, trainer, batch, counts, shapes


def _resnet_grads(net, batch, amp):
    """Logits and per-parameter fp32 gradients of one training-mode
    forward and backward (no update), with or without AMP bf16."""
    if amp:
        mx.amp.init("bfloat16")
    img, labels = batch
    with mx.autograd.record():
        logits = net(img)
        loss = streaming_softmax_ce(logits, labels)
    mx.autograd.backward(loss)
    mx.amp.disable()
    grads = {k: p.grad().detach().float().cpu().clone()
             for k, p in net._collect_params_with_prefix().items() if p.grad_req != "null"}
    return logits.detach().float().cpu(), grads


def _feeds_batchnorm(key, params):
    """A convolution bias followed by BatchNorm in the same container
    (BottleneckV1's body.0 and body.6): in training the BN subtracts each
    channel's batch mean, so the bias's exact gradient is zero and what
    either side computes is rounding noise, with no relative error."""
    *path, idx, leaf = key.split(".")
    return leaf == "bias" and idx.isdigit() and ".".join(path + [str(int(idx) + 1), "beta"]) in params


def _rel_errors(grads, ref):
    return _rel_l2(grads, {k: r for k, r in ref.items() if not _feeds_batchnorm(k, ref)})


def _grad_report(name, logits, grads, ref_logits, ref, bound, logit_bound, **extra):
    rels = _rel_errors(grads, ref)
    extra["zero_gradient_biases_max_abs"] = max(
        [grads[k].abs().max().item() for k in ref if _feeds_batchnorm(k, ref)], default=0.0)
    logit_rel = ((logits - ref_logits).norm() / ref_logits.norm()).item()
    bad = [k for k, rel in rels.items() if not (math.isfinite(rel) and rel <= bound)]
    ok = not bad and math.isfinite(logit_rel) and logit_rel <= logit_bound
    worst = sorted(((rel, k) for k, rel in rels.items()), reverse=True)
    emit("resnet_train_vs_cpu_fp32", compare=name, params=len(rels), bound=bound,
         logits_rel_err=logit_rel, logits_bound=logit_bound,
         worst=[[k, rel] for rel, k in worst[:6]], median_rel=worst[len(worst) // 2][0],
         failed=bad, ok=ok, **extra)
    return ok, worst[len(worst) // 2][0]


def phase_resnet_train_vs_cpu(rehearsal):
    """The card's gradients against the port's fp32 gradients on the CPU:
    the same ResNet-50 weights (a fresh net from seed 1), B=16 at 224x224,
    BatchNorm in training; relative L2 error per parameter and of the
    logits.  Held to its bound: the card's fp32 run (AMP off, TF32 off).
    Held only to order 1: the card's AMP bf16 run.  Each is reported beside
    a yardstick, the CPU's own fp32 gradients with the weights moved by
    1e-6 relative or rounded to bf16 (see RESNET_FP32_GRAD_REL_BOUND)."""
    ctx = mx.cpu() if rehearsal else mx.gpu(0)
    b = 2 if rehearsal else 16
    net = _build_resnet(rehearsal, ctx, 1)
    batch = _image_batch(rehearsal, b, torch.Generator(device=ctx.device).manual_seed(23),
                         ctx.device)
    arrays = {k: p.data().detach().float().cpu().numpy()
              for k, p in net._collect_params_with_prefix().items()}
    amp_logits, amp_grads = _resnet_grads(net, batch, amp=True)
    card_logits, card_grads = _resnet_grads(net, batch, amp=False)
    ref_net = _build_resnet(rehearsal, mx.cpu(), 1)
    cpu_batch = tuple(x.cpu() for x in batch)
    load_numpy_params(ref_net, arrays)
    ref_logits, ref = _resnet_grads(ref_net, cpu_batch, amp=False)
    noise = torch.Generator().manual_seed(29)
    yardsticks = {}
    for name, moved in (
            ("cpu_fp32_perturbed_1e-6", lambda w: w * (1 + 1e-6 * torch.randn(
                w.shape, generator=noise, dtype=torch.float64).numpy()).astype(w.dtype)),
            ("cpu_fp32_bf16_weights", lambda w: torch.from_numpy(w).bfloat16().float().numpy())):
        load_numpy_params(ref_net, {k: moved(a) for k, a in arrays.items()})
        y_logits, y_grads = _resnet_grads(ref_net, cpu_batch, amp=False)
        _, yardsticks[name] = _grad_report(name, y_logits, y_grads, ref_logits, ref, math.inf,
                                           math.inf, note="yardstick: the CPU's fp32 run "
                                           "with moved weights")
    ok32, _ = _grad_report("card_fp32", card_logits, card_grads, ref_logits, ref,
                           RESNET_FP32_GRAD_REL_BOUND, RESNET_FP32_LOGIT_REL_BOUND, b=b,
                           yardstick_median_rel=yardsticks["cpu_fp32_perturbed_1e-6"])
    ok_amp, _ = _grad_report("card_amp_bf16", amp_logits, amp_grads, ref_logits, ref,
                             RESNET_AMP_GRAD_REL_BOUND, RESNET_AMP_GRAD_REL_BOUND, b=b,
                             yardstick_median_rel=yardsticks["cpu_fp32_bf16_weights"])
    if not (ok32 and ok_amp):
        sys.exit(1)


# -- phase 7 ----------------------------------------------------------------


def _time(fn, arg_sets, iters, uniform=False):
    """Per call of ``fn``, cycling through ``arg_sets`` (several input sets,
    so a call does not find the last one's inputs in the 50 MB L2):
    ``(device_ms, call_ms, kernels_us, records)``.  device_ms is the time of
    the kernels the calls launched (torch.profiler's CUDA trace, summed and
    divided by ``iters``), the kernel's time; call_ms is the wall time
    between CUDA events around the calls, which also holds host time where
    the host issues calls slower than the card runs them; kernels_us splits
    device time by kernel name, and records counts each name's records in
    the trace.  A trace with no device record is taken again, and with
    ``uniform`` (every call launches the same kernels) so is one whose
    counts are not multiples of ``iters``: at most three times in all, and
    then the timing fails."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        kernels, records = {}, {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = ev.name[:90]
                kernels[name] = kernels.get(name, 0.0) + ev.time_range.elapsed_us() / iters
                records[name] = records.get(name, 0) + 1
        if records and (not uniform or all(n % iters == 0 for n in records.values())):
            break
    else:
        raise RuntimeError(f"_time: the trace of {iters} calls lost records in three "
                           f"tries: {records}")
    return sum(kernels.values()) * 1e-3, call_ms, kernels, records


def _graph_ms(fn, arg_sets, calls=40, replays=5):
    """Device ms per call of ``fn`` by a second method: ``calls`` calls,
    cycling through ``arg_sets``, captured in one CUDA graph and replayed
    ``replays`` times between CUDA events.  No host work and no profiler
    come between the kernels; the graph's own gaps between launches count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _kernel_family(name):
    if name.startswith(("gelu_fwd_", "gelu_bwd_")):  # the user's kernels of RTC_SOURCE
        return "rtc_" + name[:8]
    for fam in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "bn_stats", "bn_apply"):
        if fam in name:
            return fam
    if re.search(r"conv|cudnn|fprop|dgrad|wgrad|nchw|nhwc", name, re.I):
        return "convolution"
    if re.search(r"gemm|nvjet|xmma|cutlass|cublas", name, re.I):
        return "matmul"
    return "other"


def phase_profile(what, fn, smi):
    """Where one call of ``fn``'s device time goes, by kernel family, from
    torch.profiler's CUDA trace; 'not measured' if it shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # BatchNorm's backward is plain PyTorch inside record_function
    # ("mx.bn_backward"), which the trace also shows as a range on the
    # device: kernels that start inside one of those ranges form the
    # bn_backward_plain family, and the ranges themselves are no kernels.
    device = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    bn_ranges = [(ev.time_range.start, ev.time_range.end) for ev in device
                 if ev.name == "mx.bn_backward"]
    by_family = {}
    for ev in device:
        if ev.name.startswith("mx."):
            continue
        fam = ("bn_backward_plain" if any(a <= ev.time_range.start < b for a, b in bn_ranges)
               else _kernel_family(ev.name))
        kernels = by_family.setdefault(fam, {})
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    families = {fam: sum(k.values()) for fam, k in by_family.items()}
    total_us = sum(families.values())
    if total_us == 0:
        emit("profile", what=what, device_time="not measured", card=smi)
        return
    top = {fam: [[n[:90], us] for n, us in sorted(k.items(), key=lambda kv: -kv[1])[:3]]
           for fam, k in by_family.items()}
    emit("profile", what=what, wall_us=wall_us, device_us=total_us,
         device_busy_share=total_us / wall_us, families_us=families,
         top_kernels_us_by_family=top, card=smi)


def _bound(nbytes, flops, dtype=torch.bfloat16):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _fwd_row(views, bhsd_sets, smi):
    """flash_fwd, its plain version and SDPA on the same [B, S, H, Dh] views,
    timed in one run; emits the row and returns it."""
    b, s, h, d = views[0][0].shape
    kernel = lambda q, k, v: att.flash_fwd(q, k, v, layout="bshd")  # noqa: E731
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        kernel_ms, call_ms, _, records = _time(kernel, views, 200, uniform=True)
        plain_ms, _, _, _ = _time(lambda q, k, v: att.flash_fwd_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), views, 20)
        library_ms, _, lib_kernels, lib_records = _time(sdpa, bhsd_sets, 200, uniform=True)
        graph_ms, lib_graph_ms = _graph_ms(kernel, views), _graph_ms(sdpa, bhsd_sets)
    nbytes = 4 * b * s * h * d * 2              # q, k, v read once, o written once
    flops = 4 * b * h * s * s * d               # q·kᵀ and p·v
    bound_ms, bound_by = _bound(nbytes, flops)
    emit("times", kernel="flash_fwd", shape=dict(b=b, s=s, h=h, d=d, dtype="bfloat16"),
         ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
         library="SDPA", library_kernels_us=lib_kernels, records=records,
         library_records=lib_records, graph_ms=graph_ms, library_graph_ms=lib_graph_ms,
         bound_ms=bound_ms, bound_by=bound_by,
         bytes=nbytes, flops=flops, share_of_bound=bound_ms / kernel_ms,
         achieved_bytes_per_s=nbytes / (kernel_ms * 1e-3), card=smi)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _times_fwd(views, bhsd_sets, smi):
    """The main row (the training and inference batch) and a row at the
    S=512 request shape, each beside SDPA in the same run; returns the
    main row."""
    row = _fwd_row(views, bhsd_sets, smi)
    device = views[0][0].device
    gen = torch.Generator(device=device).manual_seed(98)
    b, s, h, d = 8, 512, MAIN["h"], MAIN["d"]  # the S=512 request of the slice phase
    long_views = [(x[:, :, 0], x[:, :, 1], x[:, :, 2])
                  for x in (_randn((b, s, 3, h, d), torch.bfloat16, gen, device)
                            for _ in range(4))]  # 75 MB: beyond the 50 MB L2
    _fwd_row(long_views, [tuple(t.transpose(1, 2).contiguous() for t in v) for v in long_views],
             smi)
    return row


def _bwd_row(b, s, gen, smi):
    """Both backward kernels at [B, S, 12, 64] bf16 (the [B, S, 3, H, Dh]
    views of the main path), each alone and as the one ``flash_bwd`` call
    the path makes, beside the plain version and SDPA's backward in the
    same run; emits the rows and returns {kernel: row}.  The plain version
    and the library's backward compute dq, dk and dv together, so both
    rows carry the same; the library's is SDPA's, the device time of SDPA
    forward+backward less that of SDPA forward, timed only.  ``graph_ms``
    times each by CUDA-graph replay as well; ``call_ms`` is the CUDA-event
    time per call, which holds the wrapper's host cost where the host
    issues calls slower than the card runs them, beside that of the
    parent's two calls (``flash_bwd_dq`` then ``flash_bwd_dkv``)."""
    h, d = MAIN["h"], MAIN["d"]
    device = torch.device("cuda", 0)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    sets = []
    with torch.no_grad():
        for _ in range(4):  # > 200 MB: beyond the 50 MB L2
            x = _randn((b, s, 3, h, d), torch.bfloat16, gen, device)
            q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
            do = _randn((b, s, h, d), torch.bfloat16, gen, device)
            o, lse = att.flash_fwd(q, k, v, with_lse=True, layout="bshd")
            sets.append((q, k, v, o, do, lse))
        dq = lambda *a: att.flash_bwd_dq(*a, layout="bshd")  # noqa: E731
        dkv = lambda *a: att.flash_bwd_dkv(*a, layout="bshd")  # noqa: E731
        pair = lambda *a: att.flash_bwd(*a, layout="bshd")  # noqa: E731

        def two_calls(*a):
            dq(*a)
            dkv(*a)

        dq_ms, dq_call_ms, _, dq_records = _time(dq, sets, 200, uniform=True)
        dkv_ms, dkv_call_ms, _, dkv_records = _time(dkv, sets, 200, uniform=True)
        pair_ms, pair_call_ms, pair_kernels, _ = _time(pair, sets, 200, uniform=True)
        two_call_ms = _time(two_calls, sets, 200, uniform=True)[1]
        graph = {name: _graph_ms(fn, sets) for name, fn in
                 (("flash_bwd_dq", dq), ("flash_bwd_dkv", dkv), ("pair", pair))}
        plain_ms, _, _, _ = _time(lambda q, k, v, o, do, lse: att.flash_bwd_plain(
            t(q), t(k), t(v), t(o), t(do), lse), sets, 20)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(t(x).contiguous().requires_grad_() for x in st[:3]) + (t(st[4]).contiguous(),)
                for st in sets]

    def fwd_bwd(q, k, v, do):
        torch.autograd.grad(sdpa(q, k, v), (q, k, v), do)

    def fwd(q, k, v, do):  # the training forward, as inside fwd_bwd
        sdpa(q, k, v)

    lib_fb_ms, lib_fb_call_ms, lib_kernels, _ = _time(fwd_bwd, lib_sets, 100)
    lib_f_ms, _, _, _ = _time(fwd, lib_sets, 100)
    library_ms = lib_fb_ms - lib_f_ms
    library_graph_ms = _graph_ms(fwd_bwd, lib_sets) - _graph_ms(fwd, lib_sets)

    n = b * s * h * d * 2        # bytes of one [B, S, H, Dh] bf16 operand
    lse_bytes = b * h * s * 4
    shape = dict(b=b, s=s, h=h, d=d, dtype="bfloat16")
    out = {}
    for name, ms, call_ms, records, nbytes, flops in (
            ("flash_bwd_dq", dq_ms, dq_call_ms, dq_records, 6 * n + lse_bytes,
             6 * b * h * s * s * d),
            ("flash_bwd_dkv", dkv_ms, dkv_call_ms, dkv_records, 7 * n + lse_bytes,
             8 * b * h * s * s * d)):
        bound_ms, bound_by = _bound(nbytes, flops)
        emit("times", kernel=name, shape=shape, ms=ms, call_ms=call_ms,
             graph_ms=graph[name], records=records, plain_ms=plain_ms, library_ms=library_ms,
             library="SDPA backward (fwd+bwd - fwd)", library_graph_ms=library_graph_ms,
             library_fwd_bwd_ms=lib_fb_ms, library_fwd_ms=lib_f_ms,
             library_fwd_bwd_call_ms=lib_fb_call_ms, library_kernels_us=lib_kernels,
             bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
             share_of_bound=bound_ms / ms, achieved_bytes_per_s=nbytes / (ms * 1e-3), card=smi)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, graph_ms=graph[name], call_ms=call_ms)
    pair_bound = out["flash_bwd_dq"]["bound_ms"] + out["flash_bwd_dkv"]["bound_ms"]
    emit("times", kernel="flash_bwd (dq and dk/dv passes, one call)", shape=shape, ms=pair_ms,
         kernels_us=pair_kernels, call_ms=pair_call_ms, parent_two_calls_call_ms=two_call_ms,
         graph_ms=graph["pair"], library_ms=library_ms, library_graph_ms=library_graph_ms,
         vs_library=pair_ms / library_ms, graph_vs_library=graph["pair"] / library_graph_ms,
         bound_ms=pair_bound, share_of_bound=pair_bound / pair_ms, card=smi)
    return out


def _times_bwd(gen, smi):
    """The backward rows at the main path's shape (B=64, S=128), returned,
    and at the S=512 request shape (B=8)."""
    rows = _bwd_row(MAIN["b"], MAIN["sq"], gen, smi)
    _bwd_row(8, 512, gen, smi)
    return rows


def _times_bn(shapes, smi):
    """Each BN kernel, its plain version and the library call at the nine
    ResNet-50 shapes (N=256, bf16), and their sums over one training step's
    launches (``shapes`` = {(C, HW): launches in one step}).  The library
    calls, timed only: ``torch.batch_norm_stats`` (mean and inverse std
    from one read) for bn_stats, ``torch.batch_norm_elemt`` with mean 0 and
    inverse std 1 (so x·scale + shift) for bn_apply; bn_apply_res has no
    one-call counterpart."""
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(77)
    names = ("bn_stats", "bn_apply", "bn_apply_res")
    step = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for k in names}
    for c, hw in RESNET_BN_SHAPES:
        n = RESNET_B
        nbytes_x = n * c * hw * 2
        sets = []
        for _ in range(max(2, -(-160_000_000 // nbytes_x))):  # the sets exceed the 50 MB L2
            x = _bn_input(dict(n=n, c=c, hw=hw, dtype=torch.bfloat16), gen, device)
            sets.append((x, torch.rand(c, generator=gen, device=device) + 0.5,
                         torch.randn(c, generator=gen, device=device),
                         _bn_input(dict(n=n, c=c, hw=hw, dtype=torch.bfloat16), gen, device)))
        zeros, ones = torch.zeros(c, device=device), torch.ones(c, device=device)
        stats_sets = [(x,) for x, _, _, _ in sets]
        apply_sets = [(x, sc, sh) for x, sc, sh, _ in sets]
        with torch.no_grad():
            rows = {
                "bn_stats": (_time(bn.bn_stats, stats_sets, 20),
                             _time(bn.bn_stats_plain, stats_sets, 5),
                             _time(lambda x: torch.batch_norm_stats(x, 1e-5), stats_sets, 20),
                             nbytes_x + c * 8, 3 * n * c * hw),
                "bn_apply": (_time(lambda *a: bn.bn_apply(*a, relu=False), apply_sets, 20),
                             _time(lambda *a: bn.bn_apply_plain(*a, relu=False), apply_sets, 5),
                             _time(lambda x, sc, sh: torch.batch_norm_elemt(
                                 x, sc, sh, zeros, ones, 1e-5), apply_sets, 20),
                             2 * nbytes_x + c * 8, 2 * n * c * hw),
                "bn_apply_res": (_time(lambda *a: bn.bn_apply_res(*a, relu=True), sets, 20),
                                 _time(lambda *a: bn.bn_apply_plain(*a, relu=True), sets, 5),
                                 None, 3 * nbytes_x + c * 8, 3 * n * c * hw)}
        for name, (kern, plain, lib, nbytes, flops) in rows.items():
            bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
            emit("times", kernel=name, shape=dict(n=n, c=c, hw=hw, dtype="bfloat16"),
                 ms=kern[0], call_ms=kern[1], plain_ms=plain[0],
                 library_ms=None if lib is None else lib[0],
                 library={"bn_stats": "torch.batch_norm_stats",
                          "bn_apply": "torch.batch_norm_elemt"}.get(name),
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                 share_of_bound=bound_ms / kern[0],
                 achieved_bytes_per_s=nbytes / (kern[0] * 1e-3), card=smi)
            k = shapes.get((c, hw), 0)
            step[name]["ms"] += k * kern[0]
            step[name]["plain_ms"] += k * plain[0]
            step[name]["library_ms"] = (None if lib is None
                                        else step[name]["library_ms"] + k * lib[0])
            step[name]["bound_ms"] += k * bound_ms
            step[name]["bound_by"] = bound_by
        del sets, stats_sets, apply_sets
    for name, row in step.items():
        emit("times", kernel=name, per="one ResNet-50 step: its BatchNorm launches at their "
             "shapes", launches=sum(shapes.values()), **row,
             share_of_bound=row["bound_ms"] / row["ms"], card=smi)
    return step


def _times_gelu(smi):
    """The two user GELU kernels at the path's shape ([64, 128, 3072] bf16),
    their plain versions and the library calls (``F.gelu`` and
    ``aten.gelu_backward``, timed only), and the sums over one BERT step's
    12 launches of each.  ``call_ms`` is the launcher's cost per call as the
    user's op makes it (UserKernel, ``Kernel.launch``: checks, output
    allocation, ctypes marshalling, ``cuLaunchKernel``) where it exceeds the
    kernel's."""
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(4242)
    n = math.prod(GELU_MAIN)
    sets = [tuple(torch.randn(GELU_MAIN, generator=gen, device=device).bfloat16()
                  for _ in range(2)) for _ in range(4)]  # 400 MB: beyond the 50 MB L2
    fwd_sets = [(x,) for x, _ in sets]
    with torch.no_grad():
        rows = {
            "rtc_gelu_fwd": (_time(GELU_FWD, fwd_sets, 200), _time(gelu_plain, fwd_sets, 20),
                             _time(torch.nn.functional.gelu, fwd_sets, 200), "F.gelu",
                             4 * n, 20 * n),
            "rtc_gelu_bwd": (_time(GELU_BWD, sets, 200), _time(gelu_bwd_plain, sets, 20),
                             _time(lambda x, dy: torch.ops.aten.gelu_backward(dy, x), sets, 200),
                             "torch.ops.aten.gelu_backward", 6 * n, 30 * n)}
        host = {"rtc_gelu_fwd": (_host_ms(GELU_FWD, fwd_sets), _host_ms(torch.nn.functional.gelu,
                                                                       fwd_sets)),
                "rtc_gelu_bwd": (_host_ms(GELU_BWD, sets), _host_ms(
                    lambda x, dy: torch.ops.aten.gelu_backward(dy, x), sets))}
    out = {}
    for name, (kern, plain, lib, lib_name, nbytes, flops) in rows.items():
        bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
        emit("times", kernel=name, shape=dict(n=n, dims=list(GELU_MAIN), dtype="bfloat16"),
             ms=kern[0], call_ms=kern[1], host_ms=host[name][0],
             library_host_ms=host[name][1], plain_ms=plain[0], library_ms=lib[0],
             library=lib_name, library_kernels_us=lib[2], bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, flops=flops, share_of_bound=bound_ms / kern[0],
             achieved_bytes_per_s=nbytes / (kern[0] * 1e-3), step_ms_12_launches=12 * kern[0],
             card=smi)
        out[name] = dict(ms=kern[0], call_ms=kern[1], host_ms=host[name][0],
                         plain_ms=plain[0], library_ms=lib[0], bound_ms=bound_ms,
                         bound_by=bound_by)
    return out


def _host_ms(fn, arg_sets, iters=100):
    """Host time per call of ``fn``: the loop issues ``iters`` calls and
    returns before the card has run them (the queue holds far more than
    ``iters`` launches), so the clock sees the caller's own cost."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def _time_train_step(tnet, trainer, batch, iters):
    """Mean wall ms of ``iters`` training steps after one warm-up."""
    train_step(tnet, trainer, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        train_step(tnet, trainer, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _resnet_step_phases(net, trainer, batch, iters):
    """Mean wall ms of the ResNet step's three parts, each closed by a
    synchronize (as _step_phases does for BERT)."""
    img, labels = batch
    spent = {"forward_and_loss": 0.0, "backward": 0.0, "trainer_step": 0.0}
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = streaming_softmax_ce(net(img), labels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mx.autograd.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(img.shape[0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2)):
            spent[key] += dt * 1e3 / iters
    return spent


def _times_resnet(resnet, smi):
    """The ResNet-50 training step: step ms, img/s, peak memory, its split,
    and a torch.profiler breakdown of its device time."""
    net, trainer, batch = resnet
    b = batch[0].shape[0]
    mx.amp.init("bfloat16")
    iters = 10
    torch.cuda.reset_peak_memory_stats()
    resnet_step(net, trainer, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        resnet_step(net, trainer, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    emit("times", train_step="resnet50_v1 AMP bf16, fp32 parameters, SGD momentum", b=b,
         image=224, step_ms=step_s * 1e3, img_per_s=b / step_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         cudnn_benchmark=torch.backends.cudnn.benchmark, card=smi)
    emit("times", resnet_train_step_phases_ms=_resnet_step_phases(net, trainer, batch, 3),
         card=smi)
    phase_profile(f"train step: resnet50_v1 AMP bf16 B={b} 224x224, SGD momentum",
                  lambda: resnet_step(net, trainer, batch), smi)
    mx.amp.disable()


def _step_phases(net, trainer, batch, iters):
    """Mean wall ms of the training step's three parts (forward with the
    loss, backward, Trainer.step), each closed by a synchronize, so each
    holds its host dispatch and the device work it queued."""
    ids, types, pos, labels = batch
    spent = {"forward_and_loss": 0.0, "backward": 0.0, "trainer_step": 0.0}
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            mlm, _ = net(ids, types, pos)
            loss = streaming_softmax_ce(mlm, labels).mean(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mx.autograd.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(ids.shape[0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2)):
            spent[key] += dt * 1e3 / iters
    return spent


def phase_times(net, main_req, train, resnet, bn_shapes, counts, errs, smi):
    """``train`` and ``resnet`` = (net, trainer, batch) of the BERT and
    ResNet-50 training paths; ``bn_shapes`` = {(C, HW): launches in one
    ResNet-50 step}; ``counts`` = {path: launch counts}; ``errs`` =
    {kernel: max abs error at the main paths' layouts and shapes}."""
    device = torch.device("cuda", 0)
    b, s, h, d = MAIN["b"], MAIN["sq"], MAIN["h"], MAIN["d"]
    gen = torch.Generator(device=device).manual_seed(99)
    qkv_sets = [_randn((b, s, 3, h, d), torch.bfloat16, gen, device) for _ in range(4)]
    views = [(x[:, :, 0], x[:, :, 1], x[:, :, 2]) for x in qkv_sets]
    bhsd_sets = [tuple(t.transpose(1, 2).contiguous() for t in v) for v in views]

    before = kernel_counts()
    rows = {"flash_fwd": _times_fwd(views, bhsd_sets, smi)}
    del qkv_sets, views, bhsd_sets
    rows.update(_times_bwd(gen, smi))
    rows.update(_times_bn(bn_shapes, smi))
    rows.update(_times_gelu(smi))

    iters = 10
    torch.cuda.reset_peak_memory_stats()
    with mx.autograd.predict_mode():
        net(*main_req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            net(*main_req)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / iters
    emit("times", forward="BERTForPretrain(bert_base) bf16", b=b, s=s, p=main_req[2].shape[1],
         forward_ms=fwd_s * 1e3, samples_per_s=b / fwd_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)

    tnet, trainer, batch = train
    tb = batch[0].shape[0]
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_train_step(tnet, trainer, batch, iters)
    emit("times", train_step="BERTForPretrain(bert_base) bf16, Adam multi_precision, "
         "dropout 0.1", b=tb, s=batch[0].shape[1], p=batch[2].shape[1],
         step_ms=step_ms, samples_per_s=tb / step_ms * 1e3,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)
    emit("times", train_step_phases_ms=_step_phases(tnet, trainer, batch, 5), card=smi)
    # The host-bound step drifts within a run: built-in and rtc in turns
    # (built-in, rtc, rtc, built-in), each the mean of `iters` steps.
    turns = {"builtin": [], "rtc": []}
    for which in ("builtin", "rtc", "rtc", "builtin"):
        with rtc_gelu_ffn(tnet) if which == "rtc" else contextlib.nullcontext():
            turns[which].append(_time_train_step(tnet, trainer, batch, iters))
    rtc_ms, builtin_ms = (sum(turns[k]) / 2 for k in ("rtc", "builtin"))
    emit("times", train_step="the same, built-in GELU and the user's rtc_gelu CustomOp in "
         "turns (built-in, rtc, rtc, built-in)", b=tb, turns_ms=turns, rtc_step_ms=rtc_ms,
         rtc_samples_per_s=tb / rtc_ms * 1e3, builtin_step_ms=builtin_ms,
         builtin_samples_per_s=tb / builtin_ms * 1e3, card=smi)

    with mx.autograd.predict_mode():
        phase_profile("forward: BERTForPretrain(bert_base) bf16 B=64 S=128 P=20",
                      lambda: net(*main_req), smi)
    phase_profile("train step: BERTForPretrain(bert_base) bf16 B=64 S=128 P=20, Adam mp",
                  lambda: train_step(tnet, trainer, batch), smi)
    with rtc_gelu_ffn(tnet):
        phase_profile("train step: the same, FFN activation = the user's rtc_gelu CustomOp",
                      lambda: train_step(tnet, trainer, batch), smi)
    _times_resnet(resnet, smi)
    set_kernel_counts(before)  # timed and profiled launches are not the main paths'

    csrc = "incubator_mxnet_torch/ops/csrc/"
    sources = {"flash_fwd": (csrc + "flash_fwd.cu", "incubator_mxnet_tpu/ops/attention.py:85"),
               "flash_bwd_dq": (csrc + "flash_bwd.cu",
                                "incubator_mxnet_tpu/ops/attention.py:203"),
               "flash_bwd_dkv": (csrc + "flash_bwd.cu",
                                 "incubator_mxnet_tpu/ops/attention.py:248"),
               "bn_stats": (csrc + "bn.cu", "incubator_mxnet_tpu/ops/pallas_bn.py:33"),
               "bn_apply": (csrc + "bn.cu", "incubator_mxnet_tpu/ops/pallas_bn.py:67"),
               "bn_apply_res": (csrc + "bn.cu", "incubator_mxnet_tpu/ops/pallas_bn.py:75"),
               "rtc_gelu_fwd": ("chip_smoke.py", "incubator_mxnet_tpu/rtc.py:48"),
               "rtc_gelu_bwd": ("chip_smoke.py", "incubator_mxnet_tpu/rtc.py:48")}
    main_path = {"flash_fwd": "inference", "flash_bwd_dq": "train_step",
                 "flash_bwd_dkv": "train_step", "bn_stats": "resnet_train_step",
                 "bn_apply": "resnet_train_step", "bn_apply_res": "resnet_train_step",
                 "rtc_gelu_fwd": "rtc_train_step", "rtc_gelu_bwd": "rtc_train_step"}
    kernels = []
    for name, (src, replaces) in sources.items():
        path = main_path[name]
        row = rows[name]
        per = {}
        if name.startswith("bn_"):
            per = {"per": "one ResNet-50 step (B=256): ms, plain_ms, bound_ms and library_ms "
                          "sum the step's 53 BatchNorm shapes"}
        elif name.startswith("rtc_"):
            per = {"per": "one launch at [64, 128, 3072] bf16 (12 a step)",
                   "call_ms": row["call_ms"], "host_ms": row["host_ms"],
                   "compiled_by": "incubator_mxnet_torch/rtc.py (RTC_SOURCE, nvcc cubin, "
                                  "CUDA driver launch)"}
        headers = ([str(h.relative_to(Path(__file__).resolve().parent))
                    for h in _cuda.includes(Path(__file__).resolve().parent / src)]
                   if src.endswith(".cu") else [])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "headers": headers,
            "replaces": replaces, "launches": counts[path][name],
            "launches_by_path": {p: c[name] for p, c in counts.items()},
            "max_abs_err": errs[name], "max_err": errs[name], "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{key: row[key] for key in ("graph_ms", "call_ms") if key in row}, **per})
    print(json.dumps({"kernels": kernels}), flush=True)


def rehearse_times(net, main_req, train, resnet):
    """CPU stand-in for phase 7: host times of the plain paths, labelled as
    CPU numbers, never as the card's."""
    t0 = time.perf_counter()
    with mx.autograd.predict_mode():
        net(*main_req)
    t1 = time.perf_counter()
    train_step(*train)
    t2 = time.perf_counter()
    mx.amp.init("bfloat16")
    resnet_step(*resnet)
    mx.amp.disable()
    emit("times", device="cpu", note="CPU rehearsal: host time, not a device metric",
         forward_host_ms=(t1 - t0) * 1e3, train_step_host_ms=(t2 - t1) * 1e3,
         resnet_train_step_host_ms=(time.perf_counter() - t2) * 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 4-7 on the CPU at a tiny size; never prints ok")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cpu_rehearsal:
        net, main_req, _ = phase_slice(rehearsal=True)
        tnet, trainer, batch, _ = phase_train(rehearsal=True)
        vs_cpu = phase_train_vs_cpu(tnet, rehearsal=True)
        phase_rtc_train(tnet, trainer, batch, vs_cpu, rehearsal=True)
        del vs_cpu
        rnet, rtrainer, rbatch, _, _ = phase_resnet_train(rehearsal=True)
        phase_resnet_train_vs_cpu(rehearsal=True)
        rehearse_times(net, main_req, (tnet, trainer, batch), (rnet, rtrainer, rbatch))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on the card",
              file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    errs = {"flash_fwd": phase_kernel_vs_plain(device)}
    errs.update(phase_kernel_vs_plain_bwd(device))
    errs.update(phase_kernel_vs_plain_bn(device))
    errs.update(phase_kernel_vs_plain_rtc(device))
    net, main_req, infer_counts = phase_slice(rehearsal=False)
    tnet, trainer, batch, train_counts = phase_train(rehearsal=False)
    vs_cpu = phase_train_vs_cpu(tnet, rehearsal=False)
    rtc_counts = phase_rtc_train(tnet, trainer, batch, vs_cpu, rehearsal=False)
    del vs_cpu
    rnet, rtrainer, rbatch, resnet_counts, bn_shapes = phase_resnet_train(rehearsal=False)
    phase_resnet_train_vs_cpu(rehearsal=False)
    phase_times(net, main_req, (tnet, trainer, batch), (rnet, rtrainer, rbatch), bn_shapes,
                {"inference": infer_counts, "train_step": train_counts,
                 "resnet_train_step": resnet_counts, "rtc_train_step": rtc_counts}, errs, smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
