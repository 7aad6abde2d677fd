// Train-mode BatchNorm passes for NVIDIA Hopper (sm_90a), with plain C entry
// points loaded through ctypes by incubator_mxnet_torch/ops/bn.py.
//
// Replaces: the JAX package's ops/pallas_bn.py kernels over the conv output
// viewed as [N, C, HW] (a free view of NCHW):
//   _stats_kernel     -> bn_stats_kernel (+ bn_stats_finalize): per-channel
//                        fp32 (sum x, sum x^2) in one read of x;
//   _apply_kernel     -> bn_apply_kernel<RES = false>: y = x*scale[c] + shift[c],
//                        optional ReLU, fp32 math, y in x's type;
//   _apply_res_kernel -> bn_apply_kernel<RES = true>: the same with a residual
//                        of x's shape, type and strides added before the ReLU.
//
// What bounds them on an H100 SXM (3.35 TB/s): they do a few operations per
// element, so bytes bound them.  ResNet-50 v1 at 224x224 and B=256 in bf16
// gives its 53 BatchNorm layers inputs of 2.71e9 elements a step (5.42 GB):
// the stats pass must read them once (1.62 ms a step), the apply pass read
// and write them (3.24 ms), the residual variant read one more operand.
//
// What the design does about that bound:
// * Both passes read each element once, with 16-byte vector loads.  A row
//   (n, c) of HW elements is contiguous, but its start need not be 16-byte
//   aligned (HW = 49 in bf16 is a 98-byte row): each row takes a scalar
//   head up to the first 16-byte boundary, a vector body, and a scalar tail.
//   The apply pass vectorises a row only when x, the residual and the output
//   rows share that alignment, and runs it in scalars otherwise.
// * Work is split by rows, never by element: a group of LANES lanes (32, or
//   8 for rows of at most 512 bytes, so short rows do not idle most of a
//   warp) walks one row, so the channel of a row comes from one division
//   per row, not per element.
// * bn_stats is deterministic and uses no atomics.  The grid is (channel,
//   slab of N): at C = 64 a channel alone would leave half the 132 SMs idle,
//   so the wrapper splits N into S slabs to give some 2000 blocks.  Each
//   block reduces its slab in a fixed order (per-lane fp32 sums, a warp
//   butterfly, then the warps in order) into an fp32 partial [C, S, 2];
//   bn_stats_finalize sums each channel's S partials in order.  Two runs on
//   the same input give bit-identical sums.
// Not used yet: TMA, warp specialisation, fusing the stats pass into the
// producing convolution's epilogue.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements before the first 16-byte boundary of a row starting at p (never
// more than the row holds).
template <typename T>
__device__ __forceinline__ int aligned_head(const T* p, int hw) {
  const int head = (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) /
                         sizeof(T));
  return head < hw ? head : hw;
}

// Add one row's elements and squares to this lane's sums.
template <typename T, int LANES>
__device__ __forceinline__ void row_sums(const T* row, int hw, int lane, float& s, float& q) {
  constexpr int VEC = 16 / sizeof(T);
  const int head = aligned_head(row, hw);
  for (int i = lane; i < head; i += LANES) {
    const float v = to_f32(row[i]);
    s += v;
    q = fmaf(v, v, q);
  }
  const int nvec = (hw - head) / VEC;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  for (int i = lane; i < nvec; i += LANES) {
    const uint4 u = body[i];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(e[j]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  for (int i = head + nvec * VEC + lane; i < hw; i += LANES) {
    const float v = to_f32(row[i]);
    s += v;
    q = fmaf(v, v, q);
  }
}

// Block (c, slab) of the grid: rows n in [N*slab/S, N*(slab+1)/S) of channel
// c; writes part[c*S + slab] = (sum, sum of squares).
template <typename T, int LANES>
__global__ void __launch_bounds__(THREADS)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int N, int HW,
                long long sN, long long sC, int S) {
  constexpr int GROUPS = THREADS / LANES;
  const int c = blockIdx.x / S;
  const int slab = blockIdx.x % S;
  const int n0 = (int)((long long)N * slab / S);
  const int n1 = (int)((long long)N * (slab + 1) / S);
  const int lane = threadIdx.x % LANES;
  float s = 0.f, q = 0.f;
  for (int n = n0 + (int)threadIdx.x / LANES; n < n1; n += GROUPS)
    row_sums<T, LANES>(x + n * sN + c * sC, HW, lane, s, q);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  __shared__ float red[2][WARPS];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    part[2 * (long long)blockIdx.x] = a;
    part[2 * (long long)blockIdx.x + 1] = b;
  }
}

// out[c] = sum over j in order of part[c*S + j]: the fixed-order second level.
__global__ void __launch_bounds__(THREADS)
bn_stats_finalize(const float* __restrict__ part, float* __restrict__ out, int C, int S) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int j = 0; j < S; ++j) {
    a += part[2 * ((long long)c * S + j)];
    b += part[2 * ((long long)c * S + j) + 1];
  }
  out[2 * c] = a;
  out[2 * c + 1] = b;
}

template <typename T, bool RES>
__device__ __forceinline__ T apply_one(T xv, const T* r, int i, float sc, float sh, int relu) {
  float y = fmaf(to_f32(xv), sc, sh);
  if (RES) y += to_f32(r[i]);
  if (relu && y < 0.f) y = 0.f;  // NaN stays NaN, as max(y, 0) keeps it
  return from_f32<T>(y);
}

// Rows r = n*C + c of the [N, C, HW] input, one per group of LANES lanes,
// grid-strided; the output has its own (N, C) strides and unit HW stride.
template <typename T, int LANES, bool RES>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, const T* __restrict__ res,
                T* __restrict__ out, int N, int C, int HW, long long sN, long long sC,
                long long oN, long long oC, int relu) {
  constexpr int GROUPS = THREADS / LANES;
  constexpr int VEC = 16 / sizeof(T);
  const long long rows = (long long)N * C;
  const int lane = threadIdx.x % LANES;
  for (long long r = (long long)blockIdx.x * GROUPS + threadIdx.x / LANES; r < rows;
       r += (long long)gridDim.x * GROUPS) {
    const long long n = r / C;
    const int c = (int)(r - n * C);
    const float sc = scale[c], sh = shift[c];
    const T* xr = x + n * sN + c * sC;
    const T* rr = RES ? res + n * sN + c * sC : nullptr;
    T* orow = out + n * oN + c * oC;
    const uintptr_t ax = reinterpret_cast<uintptr_t>(xr);
    const bool vec = ((ax ^ reinterpret_cast<uintptr_t>(orow)) & 15u) == 0 &&
                     (!RES || ((ax ^ reinterpret_cast<uintptr_t>(rr)) & 15u) == 0);
    const int head = vec ? aligned_head(xr, HW) : HW;
    for (int i = lane; i < head; i += LANES) orow[i] = apply_one<T, RES>(xr[i], rr, i, sc, sh, relu);
    const int nvec = vec ? (HW - head) / VEC : 0;
    const uint4* xb = reinterpret_cast<const uint4*>(xr + head);
    const uint4* rb = RES ? reinterpret_cast<const uint4*>(rr + head) : nullptr;
    uint4* ob = reinterpret_cast<uint4*>(orow + head);
    for (int i = lane; i < nvec; i += LANES) {
      const uint4 u = xb[i];
      uint4 rv = make_uint4(0u, 0u, 0u, 0u);
      if (RES) rv = rb[i];
      const T* e = reinterpret_cast<const T*>(&u);
      const T* re = reinterpret_cast<const T*>(&rv);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) oe[j] = apply_one<T, RES>(e[j], re, j, sc, sh, relu);
      ob[i] = o;
    }
    for (int i = head + nvec * VEC + lane; i < HW; i += LANES)
      orow[i] = apply_one<T, RES>(xr[i], rr, i, sc, sh, relu);
  }
}

// Rows of at most 512 bytes go to groups of 8 lanes, longer ones to a warp.
template <typename T>
bool short_rows(int HW) {
  return (long long)HW * (long long)sizeof(T) <= 512;
}

template <typename T>
cudaError_t stats(const void* x, float* part, float* out, int N, int C, int HW, long long sN,
                  long long sC, int S, cudaStream_t st) {
  const unsigned blocks = (unsigned)C * (unsigned)S;
  if (short_rows<T>(HW))
    bn_stats_kernel<T, 8><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(x), part, N, HW,
                                                      sN, sC, S);
  else
    bn_stats_kernel<T, 32><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(x), part, N, HW,
                                                       sN, sC, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  bn_stats_finalize<<<(C + THREADS - 1) / THREADS, THREADS, 0, st>>>(part, out, C, S);
  return cudaGetLastError();
}

template <typename T, bool RES>
cudaError_t apply(const void* x, const float* scale, const float* shift, const void* res,
                  void* out, int N, int C, int HW, long long sN, long long sC, long long oN,
                  long long oC, int relu, cudaStream_t st) {
  const bool short_r = short_rows<T>(HW);
  const long long groups = THREADS / (short_r ? 8 : 32);
  const long long rows = (long long)N * C;
  long long blocks = (rows + groups - 1) / groups;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-strided beyond two waves of 8 blocks/SM
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  if (short_r)
    bn_apply_kernel<T, 8, RES><<<(unsigned)blocks, THREADS, 0, st>>>(
        xp, scale, shift, rp, op, N, C, HW, sN, sC, oN, oC, relu);
  else
    bn_apply_kernel<T, 32, RES><<<(unsigned)blocks, THREADS, 0, st>>>(
        xp, scale, shift, rp, op, N, C, HW, sN, sC, oN, oC, relu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 fp16, 2 bf16.  x is [N, C, HW] with element strides
// (sN, sC, 1).  part holds C*S*2 floats; with S == 1 it may be out itself.
// out is fp32 [C, 2].  Returns the CUDA error of the launches (0 on success).
extern "C" int mx_bn_stats(int dtype, const void* x, float* part, float* out, int N, int C,
                           int HW, long long sN, long long sC, int S, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || S <= 0 || S > N || (S == 1 && part != out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)stats<float>(x, part, out, N, C, HW, sN, sC, S, st);
    case 1: return (int)stats<__half>(x, part, out, N, C, HW, sN, sC, S, st);
    case 2: return (int)stats<__nv_bfloat16>(x, part, out, N, C, HW, sN, sC, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[n, c, :] = relu?(x[n, c, :] * scale[c] + shift[c]); out has element
// strides (oN, oC, 1).  scale and shift are fp32 [C].
extern "C" int mx_bn_apply(int dtype, const void* x, const float* scale, const float* shift,
                           void* out, int N, int C, int HW, long long sN, long long sC,
                           long long oN, long long oC, int relu, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)apply<float, false>(x, scale, shift, nullptr, out, N, C, HW, sN, sC, oN, oC, relu, st);
    case 1: return (int)apply<__half, false>(x, scale, shift, nullptr, out, N, C, HW, sN, sC, oN, oC, relu, st);
    case 2: return (int)apply<__nv_bfloat16, false>(x, scale, shift, nullptr, out, N, C, HW, sN, sC, oN, oC, relu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As mx_bn_apply, with res (x's shape, type and strides) added before the ReLU.
extern "C" int mx_bn_apply_res(int dtype, const void* x, const float* scale,
                               const float* shift, const void* res, void* out, int N, int C,
                               int HW, long long sN, long long sC, long long oN, long long oC,
                               int relu, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)apply<float, true>(x, scale, shift, res, out, N, C, HW, sN, sC, oN, oC, relu, st);
    case 1: return (int)apply<__half, true>(x, scale, shift, res, out, N, C, HW, sN, sC, oN, oC, relu, st);
    case 2: return (int)apply<__nv_bfloat16, true>(x, scale, shift, res, out, N, C, HW, sN, sC, oN, oC, relu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
