// The fused whole-group optimizer update for NVIDIA Hopper (sm_90a), with a
// plain C entry point loaded through ctypes by
// incubator_mxnet_torch/ops/multi_tensor.py.
//
// Replaces: no Pallas kernel.  The JAX package updates a parameter group in
// ONE jitted XLA dispatch (ops/optimizer_ops.py group_apply, the Trainer's
// optimizer/fused.py fused_update); this is that dispatch's counterpart: one
// launch updates a chunk of up to MAX_TENSORS tensors with one elementwise
// variant (sgd, sgd_mom, mp_sgd, mp_sgd_mom, adam, mp_adam, nag_mom,
// mp_nag_mom, adamw, rmsprop, rmspropalex), in place.  The weight is fp32,
// fp16 or bf16, its gradient of the same type; optimizer states and fp32
// master weights are fp32.
//
// Two more entries share the table:
// * LAMB (ops/optimizer_ops.py lamb_step, the JAX lamb_update_phase1/2):
//   two launches a chunk.  Pass 1 updates m and v, forms
//   r = m^/(sqrt(v^) + eps) + wd*w in fp32 and writes each block's partial
//   sums of w^2 and r^2 to a scratch buffer; it does not write w.  Pass 2:
//   each block sums its tensor's partials in a fixed order (no atomics, so
//   the ratio is the same bits every run), forms the trust ratio (1 where
//   either norm is 0, clipped to [lower, upper]), recomputes r from the new
//   m and v and the unchanged w with pass 1's arithmetic, and writes
//   w - lr*ratio*r.
// * The finite pass (multi_sum_sq, all_finite, amp.LossScaler.has_overflow):
//   one launch writes per tensor the sum of x^2 and the count of non-finite
//   elements.  Each block writes its partials; the last block of a tensor to
//   finish (a ticket counter per tensor, reset by that block) sums them in a
//   fixed order, so the result does not depend on which block ends last.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  It does a few flops
// per element against 20-28 bytes moved (mp_adam: a 16-bit gradient read,
// mean, var and the master read and written, the 16-bit weight written:
// 28 B an element, 3.74 GB for BERT-base's 133.5 M parameters, 1.12 ms).
// The design moves each byte once, with every SM busy:
// * The chunk's pointers and sizes and the prefix sums of its block counts
//   are one kernel parameter block (__grid_constant__, up to 32 KB on
//   Hopper with CUDA 12.1+), so a 23.4 M-element embedding shares a launch
//   with a 768-element bias.
// * The values that change from step to step (each tensor's lr, wd and
//   Adam rate, and the group's eight scalars, rescale = scale/batch_size
//   among them) are read from device memory (the table holds the pointer),
//   which the host refreshes before each step: so a launch captured in a
//   CUDA graph reads each replay's values, not those of the step it was
//   captured in.  Each block loads its tensor's values once.
// * Block b finds its tensor by a binary search of the prefix sums and
//   takes the b-th CHUNK-element slice of it; every tensor is cut into
//   CHUNK-element slices, so a large tensor spreads over the whole card.
// * Each thread moves 8 elements a step: one 16-byte vector of a 16-bit
//   array, two of an fp32 one.  A tensor with any pointer not 16-byte
//   aligned (a view at an odd offset) takes the scalar loop, as does the
//   last (numel mod 8) of an aligned one.
//
// Arithmetic: the plain per-tensor ops' (optimizer_ops.py: the gradient
// rescaled, clipped, plus wd·weight; then Adam's moments; then the
// update), in fp32, each operation rounded on its own: __fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn are never contracted into
// an fma, and IEEE division and square root are what PyTorch's kernels
// compute.  So the kernel is bit-equal to the plain loop run on the card.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

static_assert(CUDART_VERSION >= 12010,
              "the table is a launch parameter of 12 KB: CUDA 12.1+ takes up to 32 KB");
constexpr int MAX_TENSORS = 256;  // 12.3 KB of launch parameters
constexpr int THREADS = 256;
constexpr int VEC = 8;                     // elements a thread moves per step
constexpr int CHUNK = THREADS * VEC * 8;  // elements of one block: 16,384
constexpr int STATES = 3;

enum Variant {
  SGD = 0, SGD_MOM = 1, MP_SGD = 2, MP_SGD_MOM = 3, ADAM = 4, MP_ADAM = 5,
  NAG_MOM = 6, MP_NAG_MOM = 7, ADAMW = 8, RMSPROP = 9, RMSPROPALEX = 10, LAMB = 11
};

struct Table {
  void* w[MAX_TENSORS];
  const void* g[MAX_TENSORS];
  float* s[STATES][MAX_TENSORS];  // sgd_mom, nag_mom: mom; mp_sgd: w32;
                                  // mp_sgd_mom, mp_nag_mom: mom, w32;
                                  // adam, adamw, lamb: mean, var; mp_adam: mean, var, w32;
                                  // rmsprop: n; rmspropalex: n, g_avg, delta
  long long numel[MAX_TENSORS];
  int start[MAX_TENSORS + 1];     // start[i]: the first block of tensor i
  int n;
  const float* vals;              // device: lr[n], wd[n], c1[n], c2[n], then the scalars
};

constexpr int ROWS = 4;  // values a tensor: lr, wd, c1, c2
constexpr int SCALARS = 16;

// One tensor's values and the group's scalars, as a block loads them.  c1
// and c2 are per-tensor coefficients: adam and mp_adam: c1 the
// bias-corrected rate lr*sqrt(1 - beta2^t)/(1 - beta1^t); adamw: the fp32
// reciprocals of 1 - beta1^t and 1 - beta2^t; lamb: 1 - beta1^t and
// 1 - beta2^t themselves (1 without bias correction).
struct Hyper {
  float lr, wd, c1, c2;
  float rescale, clip;  // clip < 0: no clipping
  float momentum, beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
  float rho, one_minus_rho, eta, lower, upper;
};

__device__ __forceinline__ Hyper load_hyper(const Table& t, int i) {
  const float* v = t.vals;
  const float* sc = v + ROWS * t.n;
  Hyper h;
  h.lr = v[i];
  h.wd = v[t.n + i];
  h.c1 = v[2 * t.n + i];
  h.c2 = v[3 * t.n + i];
  h.rescale = sc[0];
  h.clip = sc[1];
  h.momentum = sc[2];
  h.beta1 = sc[3];
  h.one_minus_beta1 = sc[4];
  h.beta2 = sc[5];
  h.one_minus_beta2 = sc[6];
  h.eps = sc[7];
  h.rho = sc[8];
  h.one_minus_rho = sc[9];
  h.eta = sc[10];
  h.lower = sc[11];
  h.upper = sc[12];
  return h;
}

// MXNet's clip, as torch.clamp computes it: NaN stays NaN.
__device__ __forceinline__ float clip_to(float g, float c) {
  return isnan(g) ? g : fminf(fmaxf(g, -c), c);
}

// rescale·g, clipped.
__device__ __forceinline__ float rescaled(float g, const Hyper& h) {
  const float x = __fmul_rn(g, h.rescale);
  return h.clip >= 0.f ? clip_to(x, h.clip) : x;
}

// rescale·g, clipped, plus wd·w (w the weight or its fp32 master copy).
__device__ __forceinline__ float prep(float g, float w, const Hyper& h) {
  return __fadd_rn(rescaled(g, h), __fmul_rn(h.wd, w));
}

// Adam's moments of x, in place.
__device__ __forceinline__ void moments(float x, float& m, float& v, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.beta1), __fmul_rn(h.one_minus_beta1, x));
  v = __fadd_rn(__fmul_rn(v, h.beta2), __fmul_rn(h.one_minus_beta2, __fmul_rn(x, x)));
}

// One element: w the weight as fp32 (in and out), s its states.
template <int V>
__device__ __forceinline__ void update(float& w, float g, float (&s)[STATES], const Hyper& h) {
  constexpr bool MP = V == MP_SGD || V == MP_SGD_MOM || V == MP_ADAM || V == MP_NAG_MOM;
  constexpr int MASTER = V == MP_SGD ? 0 : V == MP_SGD_MOM || V == MP_NAG_MOM ? 1 : 2;
  float& w32 = MP ? s[MASTER] : w;
  if (V == ADAMW) {  // decoupled weight decay: wd is not in the moments
    const float x = rescaled(g, h);
    moments(x, s[0], s[1], h);
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(s[1], h.c2)), h.eps);
    const float upd = __fadd_rn(__fdiv_rn(__fmul_rn(s[0], h.c1), den), __fmul_rn(h.wd, w32));
    w32 = __fsub_rn(w32, __fmul_rn(__fmul_rn(h.eta, h.lr), upd));
    return;
  }
  const float x = prep(g, w32, h);
  if (V == SGD || V == MP_SGD) {
    w32 = __fsub_rn(w32, __fmul_rn(h.lr, x));
  } else if (V == SGD_MOM || V == MP_SGD_MOM) {
    s[0] = __fsub_rn(__fmul_rn(s[0], h.momentum), __fmul_rn(h.lr, x));
    w32 = __fadd_rn(w32, s[0]);
  } else if (V == NAG_MOM || V == MP_NAG_MOM) {
    s[0] = __fadd_rn(__fmul_rn(s[0], h.momentum), x);
    const float upd = __fadd_rn(__fmul_rn(h.momentum, s[0]), x);
    w32 = __fsub_rn(w32, __fmul_rn(h.lr, upd));
  } else if (V == RMSPROP) {
    s[0] = __fadd_rn(__fmul_rn(s[0], h.rho), __fmul_rn(h.one_minus_rho, __fmul_rn(x, x)));
    w32 = __fsub_rn(w32, __fdiv_rn(__fmul_rn(h.lr, x), __fsqrt_rn(__fadd_rn(s[0], h.eps))));
  } else if (V == RMSPROPALEX) {
    s[0] = __fadd_rn(__fmul_rn(s[0], h.rho), __fmul_rn(h.one_minus_rho, __fmul_rn(x, x)));
    s[1] = __fadd_rn(__fmul_rn(s[1], h.rho), __fmul_rn(h.one_minus_rho, x));
    const float den = __fsqrt_rn(__fadd_rn(__fsub_rn(s[0], __fmul_rn(s[1], s[1])), h.eps));
    s[2] = __fsub_rn(__fmul_rn(s[2], h.momentum), __fdiv_rn(__fmul_rn(h.lr, x), den));
    w32 = __fadd_rn(w32, s[2]);
  } else {  // ADAM, MP_ADAM
    moments(x, s[0], s[1], h);
    const float upd = __fdiv_rn(__fmul_rn(h.c1, s[0]), __fadd_rn(__fsqrt_rn(s[1]), h.eps));
    w32 = __fsub_rn(w32, upd);
  }
  if (MP) w = w32;
}

template <int V>
struct Arity {  // fp32 state arrays of the variant
  static constexpr int value = V == SGD ? 0
                               : V == SGD_MOM || V == MP_SGD || V == NAG_MOM || V == RMSPROP ? 1
                               : V == MP_ADAM || V == RMSPROPALEX ? 3 : 2;
};

template <typename W>
__device__ __forceinline__ float to_f(W x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename W>
__device__ __forceinline__ W from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 elements at p (16-byte aligned) as floats, and back.
template <typename W>
__device__ __forceinline__ void load8(const W* p, float (&x)[VEC]) {
  if constexpr (sizeof(W) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const W* e = reinterpret_cast<const W*>(&v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = to_f<W>(e[k]);
  }
}

template <typename W>
__device__ __forceinline__ void store8(W* p, const float (&x)[VEC]) {
  if constexpr (sizeof(W) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    uint4 v;
    W* e = reinterpret_cast<W*>(&v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_f<W>(x[k]);
    *reinterpret_cast<uint4*>(p) = v;
  }
}

// The tensor of block b: the last whose first block is at or before b.
__device__ __forceinline__ int tensor_of(const Table& t, int b) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int V, typename W>
__global__ void __launch_bounds__(THREADS)
    multi_tensor_update(const __grid_constant__ Table t) {
  constexpr int NS = Arity<V>::value;
  const int b = blockIdx.x;
  const int i = tensor_of(t, b);
  const long long begin = (long long)(b - t.start[i]) * CHUNK;
  const long long end = min(begin + (long long)CHUNK, t.numel[i]);
  W* const w = static_cast<W*>(t.w[i]);
  const W* const g = static_cast<const W*>(t.g[i]);
  float* s[STATES];
#pragma unroll
  for (int k = 0; k < STATES; ++k) s[k] = t.s[k][i];
  const Hyper h = load_hyper(t, i);

  uintptr_t bits = reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g);
#pragma unroll
  for (int k = 0; k < NS; ++k) bits |= reinterpret_cast<uintptr_t>(s[k]);
  long long tail = begin;  // the first element of the scalar loop
  if ((bits & 15) == 0) {
    // begin is a multiple of VEC: every vector below is 16-byte aligned
    const long long vend = begin + (end - begin) / VEC * VEC;
    for (long long e = begin + threadIdx.x * VEC; e < vend; e += THREADS * VEC) {
      float wv[VEC], gv[VEC], sv[STATES][VEC];
      load8<W>(w + e, wv);
      load8<W>(g + e, gv);
#pragma unroll
      for (int k = 0; k < NS; ++k) load8<float>(s[k] + e, sv[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float st[STATES];
#pragma unroll
        for (int k = 0; k < NS; ++k) st[k] = sv[k][j];
        update<V>(wv[j], gv[j], st, h);
#pragma unroll
        for (int k = 0; k < NS; ++k) sv[k][j] = st[k];
      }
      store8<W>(w + e, wv);
#pragma unroll
      for (int k = 0; k < NS; ++k) store8<float>(s[k] + e, sv[k]);
    }
    tail = vend;
  }
  for (long long e = tail + threadIdx.x; e < end; e += THREADS) {
    float wv = to_f<W>(w[e]), st[STATES];
#pragma unroll
    for (int k = 0; k < NS; ++k) st[k] = s[k][e];
    update<V>(wv, to_f<W>(g[e]), st, h);
    w[e] = from_f<W>(wv);
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k][e] = st[k];
  }
}

// The sums of a and b over the block, in a fixed order (each warp by
// shuffles, then the warps one after another): every thread gets them.
template <typename A, typename B>
__device__ __forceinline__ void block_sum2(A& a, B& b) {
  __shared__ A sa[THREADS / 32];
  __shared__ B sb[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // a previous call's readers are done with sa, sb
  if ((threadIdx.x & 31) == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = sa[0];
  b = sb[0];
#pragma unroll
  for (int k = 1; k < THREADS / 32; ++k) {
    a += sa[k];
    b += sb[k];
  }
}

// LAMB's direction r of one element from the new moments: the JAX
// lamb_update_phase1's m^/(sqrt(v^) + eps) + wd*w, c1 and c2 the bias
// corrections (1 without them).
__device__ __forceinline__ float lamb_r(float w, float m, float v, const Hyper& h) {
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps);
  return __fadd_rn(__fdiv_rn(__fdiv_rn(m, h.c1), den), __fmul_rn(h.wd, w));
}

// LAMB pass 1: the moments, and each block's sums of w^2 and r^2.
template <typename W>
__global__ void __launch_bounds__(THREADS)
    lamb_pass1(const __grid_constant__ Table t, float2* partial) {
  const int b = blockIdx.x;
  const int i = tensor_of(t, b);
  const long long begin = (long long)(b - t.start[i]) * CHUNK;
  const long long end = min(begin + (long long)CHUNK, t.numel[i]);
  const W* const w = static_cast<const W*>(t.w[i]);
  const W* const g = static_cast<const W*>(t.g[i]);
  float* const mean = t.s[0][i];
  float* const var = t.s[1][i];
  const Hyper h = load_hyper(t, i);
  float ww = 0.f, rr = 0.f;
  for (long long e = begin + threadIdx.x; e < end; e += THREADS) {
    const float x = to_f<W>(w[e]);
    float m = mean[e], v = var[e];
    moments(rescaled(to_f<W>(g[e]), h), m, v, h);
    mean[e] = m;
    var[e] = v;
    const float r = lamb_r(x, m, v, h);
    ww = __fadd_rn(ww, __fmul_rn(x, x));
    rr = __fadd_rn(rr, __fmul_rn(r, r));
  }
  block_sum2(ww, rr);
  if (threadIdx.x == 0) partial[b] = make_float2(ww, rr);
}

// LAMB pass 2: the tensor's norms from pass 1's partials, the trust ratio,
// and the weight.
template <typename W>
__global__ void __launch_bounds__(THREADS)
    lamb_pass2(const __grid_constant__ Table t, const float2* partial) {
  const int b = blockIdx.x;
  const int i = tensor_of(t, b);
  double ww = 0.0, rr = 0.0;
  for (int k = t.start[i] + threadIdx.x; k < t.start[i + 1]; k += THREADS) {
    const float2 p = partial[k];
    ww += p.x;
    rr += p.y;
  }
  block_sum2(ww, rr);
  const Hyper h = load_hyper(t, i);
  const float wn = __fsqrt_rn((float)ww), rn = __fsqrt_rn((float)rr);
  float ratio = wn > 0.f && rn > 0.f ? __fdiv_rn(wn, rn) : 1.f;
  ratio = fminf(fmaxf(ratio, h.lower), h.upper);
  const float step = __fmul_rn(h.lr, ratio);
  const long long begin = (long long)(b - t.start[i]) * CHUNK;
  const long long end = min(begin + (long long)CHUNK, t.numel[i]);
  W* const w = static_cast<W*>(t.w[i]);
  const float* const mean = t.s[0][i];
  const float* const var = t.s[1][i];
  for (long long e = begin + threadIdx.x; e < end; e += THREADS) {
    const float x = to_f<W>(w[e]);
    w[e] = from_f<W>(__fsub_rn(x, __fmul_rn(step, lamb_r(x, mean[e], var[e], h))));
  }
}

// The finite pass: per tensor the sum of x^2 (fp32 squares, summed in fp32
// within a block and in fp64 across blocks) and the count of non-finite
// elements.
struct FiniteOut {
  float* block_sq;     // [blocks]
  int* block_bad;      // [blocks]
  unsigned* tickets;   // [n], zero at launch; the last block of a tensor resets its own
  float* sq;           // [n]
  int* bad;            // [n]
};

template <typename W>
__global__ void __launch_bounds__(THREADS)
    finite_pass(const __grid_constant__ Table t, const FiniteOut o) {
  const int b = blockIdx.x;
  if (b == 0) {  // tensors with no element have no block
    for (int j = threadIdx.x; j < t.n; j += THREADS) {
      if (t.numel[j] == 0) {
        o.sq[j] = 0.f;
        o.bad[j] = 0;
      }
    }
  }
  const int i = tensor_of(t, b);
  const long long begin = (long long)(b - t.start[i]) * CHUNK;
  const long long end = min(begin + (long long)CHUNK, t.numel[i]);
  const W* const x = static_cast<const W*>(t.w[i]);
  float sq = 0.f;
  int bad = 0;
  for (long long e = begin + threadIdx.x; e < end; e += THREADS) {
    const float v = to_f<W>(x[e]);
    sq = __fadd_rn(sq, __fmul_rn(v, v));
    bad += !isfinite(v);
  }
  block_sum2(sq, bad);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    o.block_sq[b] = sq;
    o.block_bad[b] = bad;
    __threadfence();  // the partials are visible before the ticket is
    last = atomicAdd(&o.tickets[i], 1u) == (unsigned)(t.start[i + 1] - t.start[i] - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double total = 0.0;
  long long nbad = 0;
  for (int k = t.start[i] + threadIdx.x; k < t.start[i + 1]; k += THREADS) {
    total += __ldcg(o.block_sq + k);
    nbad += __ldcg(o.block_bad + k);
  }
  block_sum2(total, nbad);
  if (threadIdx.x == 0) {
    o.sq[i] = (float)total;
    o.bad[i] = (int)nbad;
    o.tickets[i] = 0u;
  }
}

template <int V>
cudaError_t launch_variant(int dtype, const Table& t, int blocks, cudaStream_t stream) {
  switch (dtype) {
    case 0: multi_tensor_update<V, float><<<blocks, THREADS, 0, stream>>>(t); break;
    case 1: multi_tensor_update<V, __half><<<blocks, THREADS, 0, stream>>>(t); break;
    case 2: multi_tensor_update<V, __nv_bfloat16><<<blocks, THREADS, 0, stream>>>(t); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_lamb(const Table& t, int blocks, float2* partial, cudaStream_t stream) {
  lamb_pass1<W><<<blocks, THREADS, 0, stream>>>(t, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lamb_pass2<W><<<blocks, THREADS, 0, stream>>>(t, partial);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_finite(const Table& t, int blocks, const FiniteOut& o, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(o.tickets, 0, sizeof(unsigned) * t.n, stream);
  if (err != cudaSuccess) return err;
  finite_pass<W><<<blocks, THREADS, 0, stream>>>(t, o);
  return cudaGetLastError();
}

// The table of a chunk of n tensors from the host's pointers and sizes;
// the number of blocks, or -1 for a chunk the kernels cannot take.
long long build_table(Table& t, int n, void* const* ptrs, const long long* numel,
                      const float* vals) {
  if (n < 1 || n > MAX_TENSORS) return -1;
  t.n = n;
  t.vals = vals;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0) return -1;
    t.w[i] = ptrs[i];
    t.g[i] = ptrs[n + i];
    for (int k = 0; k < STATES; ++k) t.s[k][i] = static_cast<float*>(ptrs[(2 + k) * n + i]);
    t.numel[i] = numel[i];
    t.start[i] = (int)blocks;
    blocks += (numel[i] + CHUNK - 1) / CHUNK;
    if (blocks > INT_MAX) return -1;  // beyond one grid
  }
  t.start[n] = (int)blocks;
  return blocks;
}

}  // namespace

// The kernel's capacity: the tensors one launch takes.
extern "C" int mx_multi_tensor_capacity() { return MAX_TENSORS; }

// The elements of one block: a tensor of numel elements takes
// ceil(numel / chunk) blocks (the scratch of the LAMB and finite passes is
// sized by them).
extern "C" int mx_multi_tensor_chunk() { return CHUNK; }

// The fp32 values a chunk of n tensors reads from device memory.
extern "C" int mx_multi_tensor_values(int n) { return ROWS * n + SCALARS; }

// variant: 0 sgd, 1 sgd_mom, 2 mp_sgd, 3 mp_sgd_mom, 4 adam, 5 mp_adam,
// 6 nag_mom, 7 mp_nag_mom, 8 adamw, 9 rmsprop, 10 rmspropalex (lamb has its
// own entry).  dtype of the weights and gradients: 0 float32, 1 float16,
// 2 bfloat16.  n tensors (1..capacity): ptrs holds 5 rows of n pointers
// (weight, grad, then up to three fp32 states, null where the variant has
// fewer), numel their sizes (host memory, read here).  vals: DEVICE memory
// of 4n + 16 fp32 values, read by the kernel when it runs: lr, wd, c1 and c2
// (the Hyper struct's per-tensor coefficients) n values each, then the
// scalars rescale, clip (< 0: none), momentum, beta1, 1 - beta1, beta2,
// 1 - beta2, epsilon, rho, 1 - rho, eta, lower bound, upper bound and
// three unused.  Returns the cudaError_t of the launch (0 on success,
// cudaErrorInvalidValue for a chunk it cannot take); launches nothing when
// every tensor is empty; never synchronises.
extern "C" int mx_multi_tensor(int variant, int dtype, int n, void* const* ptrs,
                               const long long* numel, const float* vals, void* stream) {
  Table t;
  const long long blocks = build_table(t, n, ptrs, numel, vals);
  if (blocks < 0 || vals == nullptr) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case SGD: return (int)launch_variant<SGD>(dtype, t, (int)blocks, s);
    case SGD_MOM: return (int)launch_variant<SGD_MOM>(dtype, t, (int)blocks, s);
    case MP_SGD: return (int)launch_variant<MP_SGD>(dtype, t, (int)blocks, s);
    case MP_SGD_MOM: return (int)launch_variant<MP_SGD_MOM>(dtype, t, (int)blocks, s);
    case ADAM: return (int)launch_variant<ADAM>(dtype, t, (int)blocks, s);
    case MP_ADAM: return (int)launch_variant<MP_ADAM>(dtype, t, (int)blocks, s);
    case NAG_MOM: return (int)launch_variant<NAG_MOM>(dtype, t, (int)blocks, s);
    case MP_NAG_MOM: return (int)launch_variant<MP_NAG_MOM>(dtype, t, (int)blocks, s);
    case ADAMW: return (int)launch_variant<ADAMW>(dtype, t, (int)blocks, s);
    case RMSPROP: return (int)launch_variant<RMSPROP>(dtype, t, (int)blocks, s);
    case RMSPROPALEX: return (int)launch_variant<RMSPROPALEX>(dtype, t, (int)blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// LAMB over a chunk: two launches (pass 1, pass 2) on the stream.  ptrs,
// numel, vals as for mx_multi_tensor (states: mean, var).  scratch: device
// memory of scratch_bytes, at least 8 bytes a block.
extern "C" int mx_multi_tensor_lamb(int dtype, int n, void* const* ptrs, const long long* numel,
                                    const float* vals, void* scratch, long long scratch_bytes,
                                    void* stream) {
  Table t;
  const long long blocks = build_table(t, n, ptrs, numel, vals);
  if (blocks < 0 || vals == nullptr || scratch_bytes < blocks * (long long)sizeof(float2))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  float2* partial = static_cast<float2*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_lamb<float>(t, (int)blocks, partial, s);
    case 1: return (int)launch_lamb<__half>(t, (int)blocks, partial, s);
    case 2: return (int)launch_lamb<__nv_bfloat16>(t, (int)blocks, partial, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The finite pass over n tensors of one dtype (ptrs: one row of n
// pointers): sq[i] the sum of squares of tensor i, bad[i] its count of
// non-finite elements (device memory, n each).  scratch: device memory of
// scratch_bytes, at least 8 bytes a block and 4 a tensor.  One launch
// (after a memset of the tickets) on the stream.
extern "C" int mx_multi_tensor_finite(int dtype, int n, void* const* ptrs,
                                      const long long* numel, void* scratch,
                                      long long scratch_bytes, float* sq, int* bad,
                                      void* stream) {
  if (n < 1 || n > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  void* rows[5 * MAX_TENSORS] = {};
  for (int i = 0; i < n; ++i) rows[i] = ptrs[i];
  Table t;
  const long long blocks = build_table(t, n, rows, numel, nullptr);
  if (blocks < 0 || scratch_bytes < blocks * 8 + 4LL * n) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  FiniteOut o;
  o.block_sq = static_cast<float*>(scratch);
  o.block_bad = reinterpret_cast<int*>(o.block_sq + blocks);
  o.tickets = reinterpret_cast<unsigned*>(o.block_bad + blocks);
  o.sq = sq;
  o.bad = bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_finite<float>(t, (int)blocks, o, s);
    case 1: return (int)launch_finite<__half>(t, (int)blocks, o, s);
    case 2: return (int)launch_finite<__nv_bfloat16>(t, (int)blocks, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
