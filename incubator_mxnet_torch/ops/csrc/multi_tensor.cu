// The fused whole-group optimizer update for NVIDIA Hopper (sm_90a), with a
// plain C entry point loaded through ctypes by
// incubator_mxnet_torch/ops/multi_tensor.py.
//
// Replaces: no Pallas kernel.  The JAX package updates a parameter group in
// ONE jitted XLA dispatch (ops/optimizer_ops.py group_apply, the Trainer's
// optimizer/fused.py fused_update); this is that dispatch's counterpart: one
// launch updates a chunk of up to MAX_TENSORS tensors with one variant (sgd,
// sgd_mom, mp_sgd, mp_sgd_mom, adam, mp_adam), in place.  The weight is
// fp32, fp16 or bf16, its gradient of the same type; optimizer states and
// fp32 master weights are fp32.
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

enum Variant { SGD = 0, SGD_MOM = 1, MP_SGD = 2, MP_SGD_MOM = 3, ADAM = 4, MP_ADAM = 5 };

struct Table {
  void* w[MAX_TENSORS];
  const void* g[MAX_TENSORS];
  float* s[STATES][MAX_TENSORS];  // sgd_mom: mom; mp_sgd: w32; mp_sgd_mom: mom, w32;
                                  // adam: mean, var; mp_adam: mean, var, w32
  long long numel[MAX_TENSORS];
  int start[MAX_TENSORS + 1];     // start[i]: the first block of tensor i
  int n;
  const float* vals;              // device: lr[n], wd[n], lrt[n], then the 8 scalars
};

constexpr int SCALARS = 8;

// One tensor's values and the group's scalars, as a block loads them.
struct Hyper {
  float lr, wd, lrt;
  float rescale, clip;  // clip < 0: no clipping
  float momentum, beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

__device__ __forceinline__ Hyper load_hyper(const Table& t, int i) {
  const float* v = t.vals;
  const float* sc = v + 3 * t.n;
  Hyper h;
  h.lr = v[i];
  h.wd = v[t.n + i];
  h.lrt = v[2 * t.n + i];
  h.rescale = sc[0];
  h.clip = sc[1];
  h.momentum = sc[2];
  h.beta1 = sc[3];
  h.one_minus_beta1 = sc[4];
  h.beta2 = sc[5];
  h.one_minus_beta2 = sc[6];
  h.eps = sc[7];
  return h;
}

// MXNet's clip, as torch.clamp computes it: NaN stays NaN.
__device__ __forceinline__ float clip_to(float g, float c) {
  return isnan(g) ? g : fminf(fmaxf(g, -c), c);
}

// rescale·g, clipped, plus wd·w (w the weight or its fp32 master copy).
__device__ __forceinline__ float prep(float g, float w, const Hyper& h) {
  float x = __fmul_rn(g, h.rescale);
  if (h.clip >= 0.f) x = clip_to(x, h.clip);
  return __fadd_rn(x, __fmul_rn(h.wd, w));
}

// One element: w the weight as fp32 (in and out), s its states.
template <int V>
__device__ __forceinline__ void update(float& w, float g, float (&s)[STATES], const Hyper& h) {
  constexpr bool MP = V == MP_SGD || V == MP_SGD_MOM || V == MP_ADAM;
  constexpr int MASTER = V == MP_SGD ? 0 : V == MP_SGD_MOM ? 1 : 2;
  float& w32 = MP ? s[MASTER] : w;
  const float x = prep(g, w32, h);
  if (V == SGD || V == MP_SGD) {
    w32 = __fsub_rn(w32, __fmul_rn(h.lr, x));
  } else if (V == SGD_MOM || V == MP_SGD_MOM) {
    s[0] = __fsub_rn(__fmul_rn(s[0], h.momentum), __fmul_rn(h.lr, x));
    w32 = __fadd_rn(w32, s[0]);
  } else {
    s[0] = __fadd_rn(__fmul_rn(s[0], h.beta1), __fmul_rn(h.one_minus_beta1, x));
    s[1] = __fadd_rn(__fmul_rn(s[1], h.beta2), __fmul_rn(h.one_minus_beta2, __fmul_rn(x, x)));
    const float upd = __fdiv_rn(__fmul_rn(h.lrt, s[0]), __fadd_rn(__fsqrt_rn(s[1]), h.eps));
    w32 = __fsub_rn(w32, upd);
  }
  if (MP) w = w32;
}

template <int V>
struct Arity {  // fp32 state arrays of the variant
  static constexpr int value = V == SGD ? 0 : V == SGD_MOM || V == MP_SGD ? 1
                               : V == MP_ADAM ? 3 : 2;
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

template <int V, typename W>
__global__ void __launch_bounds__(THREADS)
    multi_tensor_update(const __grid_constant__ Table t) {
  constexpr int NS = Arity<V>::value;
  const int b = blockIdx.x;
  int lo = 0, hi = t.n - 1;  // the last tensor whose first block is at or before b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
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

}  // namespace

// The kernel's capacity: the tensors one launch takes.
extern "C" int mx_multi_tensor_capacity() { return MAX_TENSORS; }

// The fp32 values a chunk of n tensors reads from device memory.
extern "C" int mx_multi_tensor_values(int n) { return 3 * n + SCALARS; }

// variant: 0 sgd, 1 sgd_mom, 2 mp_sgd, 3 mp_sgd_mom, 4 adam, 5 mp_adam.
// dtype of the weights and gradients: 0 float32, 1 float16, 2 bfloat16.
// n tensors (1..capacity): ptrs holds 5 rows of n pointers (weight, grad,
// then up to three fp32 states, null where the variant has fewer), numel
// their sizes (host memory, read here).  vals: DEVICE memory of 3n + 8 fp32
// values, read by the kernel when it runs: lr, wd and lrt (Adam's
// bias-corrected rate) n values each, then the scalars rescale, clip (< 0:
// none), momentum, beta1, 1 − beta1, beta2, 1 − beta2, epsilon.  Returns
// the cudaError_t of the launch (0 on success, cudaErrorInvalidValue for a
// chunk it cannot take); launches nothing when every tensor is empty;
// never synchronises.
extern "C" int mx_multi_tensor(int variant, int dtype, int n, void* const* ptrs,
                               const long long* numel, const float* vals, void* stream) {
  if (n < 1 || n > MAX_TENSORS || vals == nullptr) return (int)cudaErrorInvalidValue;
  Table t;
  t.n = n;
  t.vals = vals;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0) return (int)cudaErrorInvalidValue;
    t.w[i] = ptrs[i];
    t.g[i] = ptrs[n + i];
    for (int k = 0; k < STATES; ++k) t.s[k][i] = static_cast<float*>(ptrs[(2 + k) * n + i]);
    t.numel[i] = numel[i];
    t.start[i] = (int)blocks;
    blocks += (numel[i] + CHUNK - 1) / CHUNK;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;  // beyond one grid
  }
  t.start[n] = (int)blocks;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case SGD: return (int)launch_variant<SGD>(dtype, t, (int)blocks, s);
    case SGD_MOM: return (int)launch_variant<SGD_MOM>(dtype, t, (int)blocks, s);
    case MP_SGD: return (int)launch_variant<MP_SGD>(dtype, t, (int)blocks, s);
    case MP_SGD_MOM: return (int)launch_variant<MP_SGD_MOM>(dtype, t, (int)blocks, s);
    case ADAM: return (int)launch_variant<ADAM>(dtype, t, (int)blocks, s);
    case MP_ADAM: return (int)launch_variant<MP_ADAM>(dtype, t, (int)blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
