// Flash attention for head dims above 256 on NVIDIA Hopper (sm_90a): the
// forward (flash_wide_fwd: o and lse) and the two backward passes
// (flash_wide_bwd_dq: dq; flash_wide_bwd_dkv: dk and dv), with plain C entry
// points loaded through ctypes by incubator_mxnet_torch/ops/attention.py.
//
// Replaces: the JAX package's ops/attention.py:_fwd_kernel, _bwd_dq_kernel
// and _bwd_dkv_kernel at the head dims that flash_fwd.cu and flash_bwd.cu
// have no instance for.  The JAX function takes any head dim; the wrapper
// zero-pads one that is not a multiple of 64 up to the next (zero columns add
// nothing to any product or to rowsum(do*o)) and passes the true head dim's
// scale.  Same function as the other kernels: fp32 scores, softmax and sums;
// the forward rounds p to v's type before p*v and o to q's type; the
// backward computes p = exp(s - lse) from the forward's lse, delta =
// rowsum(do*o) from the stored o, rounds p to do's type before p^T*do and
// ds = p*(dp - delta) to q's type before ds*k and ds^T*q; causal masking
// q_pos >= k_pos (top-left aligned); a row with no visible key gets o = 0
// and lse = 0.
//
// What bounds it on an H100 SXM: at these widths a whole 128-row 16-bit tile
// is 64 KB (Dh 256) to 128 KB (Dh 512), so the whole-width tiles of the
// other kernels would not fit in the 227 KB of shared memory a block has.
// This design streams instead, and is simple first (CUDA-core fp32 FMA, no
// TMA, no warpgroup MMA):
// * every q*k^T and do*v^T reduction runs over Dh in 64-column chunks of
//   both operands, staged in shared memory as fp32 (the scores of a tile
//   stay in registers across the chunks);
// * every output is produced in 128-column slabs (the last one 64 wide
//   where Dh is an odd multiple of 64), one slab a block (blockIdx.z),
//   recomputing the scores for each slab; the dk/dv pass gives dv and dk
//   slabs blocks of their own;
// * 256 threads a block, 64 output rows by 32 keys (or queries) a score
//   tile, each thread 4 rows by 2 columns of scores and 4 rows by 8 columns
//   of its slab; under 48 KB of static shared memory, so no opt-in call.
// It is bound by operations on the CUDA cores (67 TFLOP/s fp32), which the
// slab recomputation multiplies: PERF.md gives its time beside its bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;   // output rows of a block: queries (fwd, dq) or keys (dk/dv)
constexpr int COLS = 32;   // keys (fwd, dq) or queries (dk/dv) of a score tile
constexpr int CHUNK = 64;  // Dh columns of one reduction step
constexpr int SLAB = 128;  // output columns of a block
constexpr int PITCH = CHUNK + 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* lse;  // written by the forward (or null), read by the backward
  void* out;   // o (fwd) or dq
  void* dk;
  void* dv;
  int B, H, Sq, Sk, D;  // D: the padded head dim, a multiple of 64
  // element strides (batch, head, sequence) of q, k, v, o, do, out, dk, dv
  long long st[8][3];
  float scale;
  int causal;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, OUT = 5, DK = 6, DV = 7 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: where the plain version casts to the 16-bit type.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f<T>(from_f<T>(x)); }

// The first element of (batch b, head h) of operand `which`.
template <typename T>
__device__ __forceinline__ const T* base(const Params& p, int which, const void* ptr, int b,
                                         int h) {
  return static_cast<const T*>(ptr) + b * p.st[which][0] + h * p.st[which][1];
}

// rows [row0, row0 + n) x columns [c0, c0 + w) of a [S, Dh] operand (sequence
// stride ss) into dst[n][pitch] as fp32; rows at or past `nrows` read as 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* g, long long ss, int row0,
                                      int n, int nrows, int c0, int w) {
  for (int idx = threadIdx.x; idx < n * w; idx += THREADS) {
    const int r = idx / w, c = idx % w;
    const int row = row0 + r;
    dst[r * pitch + c] = row < nrows ? to_f<T>(g[row * ss + c0 + c]) : 0.f;
  }
}

// acc[i][j] += sum over Dh of a[row0 + 4ty + i] * b[col0 + 2tx + j]: a ROWS x
// COLS product of two [S, Dh] operands, streamed through sa and sb in
// CHUNK-column steps.  Ends with a barrier, so the buffers may be reused.
template <typename T>
__device__ void reduce_dh(float (&acc)[4][2], float* sa, float* sb, const T* a, long long a_ss,
                          int a0, int na, const T* b, long long b_ss, int b0, int nb, int D) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int c0 = 0; c0 < D; c0 += CHUNK) {
    stage<T>(sa, PITCH, a, a_ss, a0, ROWS, na, c0, CHUNK);
    stage<T>(sb, PITCH, b, b_ss, b0, COLS, nb, c0, CHUNK);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < CHUNK; ++d) {
      float av[4], bv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[(4 * ty + i) * PITCH + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[j] = sb[(2 * tx + j) * PITCH + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[4ty + i][tx + 16c] += sum over the COLS columns of w[4ty + i][.] *
// rows[.][tx + 16c]: the slab product of a ROWS x COLS weight tile (sw) with
// COLS rows of an operand's slab, staged into sv.  The last slab of a head
// dim that is not a multiple of SLAB is 64 columns wide: the columns past D
// are never written out.  Ends with a barrier.
template <typename T>
__device__ void slab_product(float (&out)[4][8], const float* sw, float* sv, const T* g,
                             long long ss, int row0, int nrows, int c0, int D) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  stage<T>(sv, SLAB, g, ss, row0, COLS, nrows, c0, min(SLAB, D - c0));
  __syncthreads();
#pragma unroll 4
  for (int j = 0; j < COLS; ++j) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = sw[(4 * ty + i) * (COLS + 1) + j];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float x = sv[j * SLAB + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][c] = fmaf(wv[i], x, out[i][c]);
    }
  }
  __syncthreads();
}

// max and sum over the 16 lanes of a half warp (one row's threads)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of every kernel: two reduction chunks (ROWS and COLS rows),
// which a slab tile of COLS x SLAB reuses, and a ROWS x COLS weight tile.
constexpr int CHUNK_FLOATS = (ROWS + COLS) * PITCH;
static_assert(CHUNK_FLOATS >= COLS * SLAB, "the slab tile reuses the chunk buffers");
constexpr int SMEM_FLOATS = CHUNK_FLOATS + ROWS * (COLS + 1);
static_assert(SMEM_FLOATS * 4 + 2 * COLS * 4 <= 48 * 1024, "static shared memory");

// Block (batch*head x, query tile y, slab z): o[rows, slab] and, from slab
// 0, lse[rows].
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_wide_fwd(Params p) {
  __shared__ float smem[SMEM_FLOATS];
  float* sa = smem;
  float* sb = smem + ROWS * PITCH;
  float* sp = smem + CHUNK_FLOATS;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.y * ROWS, bh = blockIdx.x, c0 = blockIdx.z * SLAB;
  const int b = bh / p.H, h = bh % p.H;
  const T* q = base<T>(p, Q, p.q, b, h);
  const T* k = base<T>(p, K, p.k, b, h);
  const T* v = base<T>(p, V, p.v, b, h);

  float acc[4][8] = {}, m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  int nk = (p.Sk + COLS - 1) / COLS;
  if (p.causal) nk = min(nk, (min(q0 + ROWS, p.Sq) + COLS - 1) / COLS);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * COLS;
    float s[4][2] = {};
    reduce_dh<T>(s, sa, sb, q, p.st[Q][2], q0, p.Sq, k, p.st[K][2], k0, p.Sk, p.D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 2 * tx + j;
        const bool masked = key >= p.Sk || (p.causal && key > row);
        s[i][j] = masked ? -INFINITY : s[i][j] * p.scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        rs += e;
        sp[(4 * ty + i) * (COLS + 1) + 2 * tx + j] = round_to<T>(e);
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    // sp is complete after the barrier inside slab_product's staging
    slab_product<T>(acc, sp, sa, v, p.st[V][2], k0, p.Sk, c0, p.D);
  }
  T* o = static_cast<T*>(p.out) + b * p.st[OUT][0] + h * p.st[OUT][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= p.Sq) continue;
    const float lsum = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + tx + 16 * c < p.D)
        o[row * p.st[OUT][2] + c0 + tx + 16 * c] = from_f<T>(acc[i][c] / lsum);
    if (p.lse != nullptr && blockIdx.z == 0 && tx == 0)
      p.lse[(long long)bh * p.Sq + row] = (m[i] == -INFINITY ? 0.f : m[i]) + logf(lsum);
  }
}

// Block (batch*head x, query tile y, slab z): dq[rows, slab].
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_wide_bwd_dq(Params p) {
  __shared__ float smem[SMEM_FLOATS];
  float* sa = smem;
  float* sb = smem + ROWS * PITCH;
  float* sds = smem + CHUNK_FLOATS;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.y * ROWS, bh = blockIdx.x, c0 = blockIdx.z * SLAB;
  const int b = bh / p.H, h = bh % p.H;
  const T* q = base<T>(p, Q, p.q, b, h);
  const T* k = base<T>(p, K, p.k, b, h);
  const T* v = base<T>(p, V, p.v, b, h);
  const T* o = base<T>(p, O, p.o, b, h);
  const T* dout = base<T>(p, DO, p.dout, b, h);

  // delta = rowsum(do * o) and the lse of this thread's four rows
  float delta[4], lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    float part = 0.f;
    if (row < p.Sq)
      for (int c = tx; c < p.D; c += 16)
        part = fmaf(to_f<T>(dout[row * p.st[DO][2] + c]), to_f<T>(o[row * p.st[O][2] + c]), part);
    delta[i] = row_sum(part);
    lse[i] = row < p.Sq ? p.lse[(long long)bh * p.Sq + row] : 0.f;
  }
  float acc[4][8] = {};
  int nk = (p.Sk + COLS - 1) / COLS;
  if (p.causal) nk = min(nk, (min(q0 + ROWS, p.Sq) + COLS - 1) / COLS);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * COLS;
    float s[4][2] = {}, dp[4][2] = {};
    reduce_dh<T>(s, sa, sb, q, p.st[Q][2], q0, p.Sq, k, p.st[K][2], k0, p.Sk, p.D);
    reduce_dh<T>(dp, sa, sb, dout, p.st[DO][2], q0, p.Sq, v, p.st[V][2], k0, p.Sk, p.D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 2 * tx + j;
        const bool masked = row >= p.Sq || key >= p.Sk || (p.causal && key > row);
        const float pr = masked ? 0.f : expf(s[i][j] * p.scale - lse[i]);
        sds[(4 * ty + i) * (COLS + 1) + 2 * tx + j] = round_to<T>(pr * (dp[i][j] - delta[i]));
      }
    }
    slab_product<T>(acc, sds, sa, k, p.st[K][2], k0, p.Sk, c0, p.D);
  }
  T* dq = static_cast<T*>(p.out) + b * p.st[OUT][0] + h * p.st[OUT][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + tx + 16 * c < p.D)
        dq[row * p.st[OUT][2] + c0 + tx + 16 * c] = from_f<T>(acc[i][c] * p.scale);
  }
}

// Block (batch*head x, key tile y, z): z < slabs gives dv[keys, slab z],
// the rest dk[keys, slab z - slabs].  Scores are held transposed: rows are
// keys, columns queries.
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_wide_bwd_dkv(Params p) {
  __shared__ float smem[SMEM_FLOATS];
  __shared__ float s_delta[COLS], s_lse[COLS];
  float* sa = smem;
  float* sb = smem + ROWS * PITCH;
  float* sw = smem + CHUNK_FLOATS;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.y * ROWS, bh = blockIdx.x;
  const int slabs = (p.D + SLAB - 1) / SLAB;
  const bool is_dk = (int)blockIdx.z >= slabs;
  const int c0 = (blockIdx.z % slabs) * SLAB;
  const int b = bh / p.H, h = bh % p.H;
  const T* q = base<T>(p, Q, p.q, b, h);
  const T* k = base<T>(p, K, p.k, b, h);
  const T* v = base<T>(p, V, p.v, b, h);
  const T* o = base<T>(p, O, p.o, b, h);
  const T* dout = base<T>(p, DO, p.dout, b, h);

  float acc[4][8] = {};
  // causal: queries before the block's first key see none of its keys
  const int first = p.causal ? k0 / COLS * COLS : 0;
  for (int q0 = first; q0 < p.Sq; q0 += COLS) {
    // delta and lse of the tile's queries: 8 threads a query
    {
      const int r = threadIdx.x / 8, part_id = threadIdx.x % 8, row = q0 + r;
      float part = 0.f;
      if (is_dk && row < p.Sq)
        for (int c = part_id; c < p.D; c += 8)
          part = fmaf(to_f<T>(dout[row * p.st[DO][2] + c]), to_f<T>(o[row * p.st[O][2] + c]),
                      part);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (part_id == 0) {
        s_delta[r] = part;
        s_lse[r] = row < p.Sq ? p.lse[(long long)bh * p.Sq + row] : 0.f;
      }
    }
    float s[4][2] = {}, dp[4][2] = {};
    // the barriers inside reduce_dh publish s_delta and s_lse
    reduce_dh<T>(s, sa, sb, k, p.st[K][2], k0, p.Sk, q, p.st[Q][2], q0, p.Sq, p.D);
    if (is_dk)
      reduce_dh<T>(dp, sa, sb, v, p.st[V][2], k0, p.Sk, dout, p.st[DO][2], q0, p.Sq, p.D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int jq = 2 * tx + j, row = q0 + jq;
        const bool masked = row >= p.Sq || key >= p.Sk || (p.causal && key > row);
        const float pr = masked ? 0.f : expf(s[i][j] * p.scale - s_lse[jq]);
        sw[(4 * ty + i) * (COLS + 1) + jq] =
            is_dk ? round_to<T>(pr * (dp[i][j] - s_delta[jq])) : round_to<T>(pr);
      }
    }
    slab_product<T>(acc, sw, sa, is_dk ? q : dout, is_dk ? p.st[Q][2] : p.st[DO][2], q0, p.Sq,
                    c0, p.D);
  }
  const int which = is_dk ? DK : DV;
  T* g = static_cast<T*>(is_dk ? p.dk : p.dv) + b * p.st[which][0] + h * p.st[which][1];
  const float mul = is_dk ? p.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + tx + 16 * c < p.D)
        g[key * p.st[which][2] + c0 + tx + 16 * c] = from_f<T>(acc[i][c] * mul);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int pass, cudaStream_t stream) {
  const unsigned slabs = (unsigned)((p.D + SLAB - 1) / SLAB);
  const unsigned bh = (unsigned)(p.B * p.H);
  if (pass == 0) {
    const dim3 grid(bh, (p.Sq + ROWS - 1) / ROWS, slabs);
    flash_wide_fwd<T><<<grid, THREADS, 0, stream>>>(p);
  } else if (pass == 1) {
    const dim3 grid(bh, (p.Sq + ROWS - 1) / ROWS, slabs);
    flash_wide_bwd_dq<T><<<grid, THREADS, 0, stream>>>(p);
  } else {
    const dim3 grid(bh, (p.Sk + ROWS - 1) / ROWS, 2 * slabs);
    flash_wide_bwd_dkv<T><<<grid, THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// pass 0: the forward, 1: dq, 2: dk/dv.  Nothing to launch for an empty
// grid (Sq or Sk 0 leaves the outputs to the wrapper).
cudaError_t dispatch(int dtype, const Params& p, int pass, cudaStream_t s) {
  if (p.D <= 0 || p.D % CHUNK != 0) return cudaErrorInvalidValue;
  if (p.B <= 0 || p.H <= 0 || p.Sq <= 0 || (pass == 2 && p.Sk <= 0)) return cudaSuccess;
  if ((long long)p.B * p.H > 0x7fffffffLL || p.Sq > 65535 * ROWS || p.Sk > 65535 * ROWS)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(p, pass, s);
    case 1: return launch<__half>(p, pass, s);
    case 2: return launch<__nv_bfloat16>(p, pass, s);
    default: return cudaErrorInvalidValue;
  }
}

void read_strides(Params& p, const long long* strides, int n) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  D: the (padded) head dim, a
// multiple of 64.  strides: 12 element strides, (batch, head, sequence) of
// q, k, v and o.  lse: [B*H, Sq] fp32 or null.  Returns the cudaError_t of
// the launch (0 on success); never synchronises.
extern "C" int mx_flash_wide_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                                 float* lse, int B, int H, int Sq, int Sk, int D,
                                 const long long* strides, float scale, int causal,
                                 void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.out = o; p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  long long st[24] = {};
  for (int i = 0; i < 9; ++i) st[i] = strides[i];                  // q, k, v
  for (int i = 0; i < 3; ++i) st[3 * OUT + i] = strides[9 + i];    // o is the output
  read_strides(p, st, 8);
  p.scale = scale;
  p.causal = causal;
  return (int)dispatch(dtype, p, 0, static_cast<cudaStream_t>(stream));
}

// The backward: the dq pass when dq is given, then the dk/dv pass when dk
// and dv are.  strides: 24 element strides, (batch, head, sequence) of q, k,
// v, o, do, dq, dk and dv (those of absent outputs are ignored).  lse: the
// forward's [B*H, Sq] fp32.  Returns the first nonzero cudaError_t, or 0.
extern "C" int mx_flash_wide_bwd(int dtype, const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const float* lse, void* dq,
                                 void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                                 const long long* strides, float scale, int causal,
                                 void* stream) {
  if (lse == nullptr || (dk == nullptr) != (dv == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.out = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  read_strides(p, strides, 8);
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq != nullptr) {
    const cudaError_t e = dispatch(dtype, p, 1, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (dk != nullptr) return (int)dispatch(dtype, p, 2, s);
  return 0;
}
