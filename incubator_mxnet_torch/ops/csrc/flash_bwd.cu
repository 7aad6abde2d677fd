// Flash-attention backward for NVIDIA Hopper (sm_90a): two kernels with one
// plain C entry point, loaded through ctypes by
// incubator_mxnet_torch/ops/attention.py.
//
// Replaces: the JAX package's ops/attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (the two Pallas kernels launched by _flash_bwd_pallas).
// Same function, the standard two-pass flash gradient:
//   p     = exp(q·kᵀ·scale − lse)     (lse from the forward, [B·H, Sq] fp32)
//   delta = rowsum(do ∘ o)            (from the stored o, in fp32)
//   ds    = p ∘ (do·vᵀ − delta)
//   dq    = scale · ds·k              gridded over query tiles
//   dk    = scale · dsᵀ·q, dv = pᵀ·do gridded over key tiles
// Scores, p and the accumulators are fp32; p is rounded to do's type before
// pᵀ·do and ds to q's type before ds·k and dsᵀ·q; outputs in the input
// type.  Causal masking is top-left aligned (q_pos >= k_pos, both from 0).
// Each block owns its outputs, so there are no atomics and the gradients are
// the same from run to run.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// BERT-base training shape (B=64, S=128, H=12, Dh=64, bf16, non-causal) the
// dq pass must read q, k, v, o, do and lse and write dq, 75.9 MB, 22.7 us at
// the memory rate, against 4.8 GFLOP, 4.9 us at the tensor-core rate; the
// dk/dv pass moves 88.5 MB (26.4 us) for 6.4 GFLOP (6.5 us).  Both are
// memory-bound.
//
// What the design does about that bound: the S x S scores, p and ds never
// leave registers; delta is computed in each kernel from do and o (no extra
// pass or buffer); every operand is read and every gradient written straight
// in the caller's layout (batch, head and sequence strides, unit stride on
// Dh), so the [B, S, 3, H, Dh] QKV projection output is read, and its
// gradient written, with no transpose or stack copy.  The streamed operand
// (K/V for dq, Q/dO for dk/dv) is re-read once per 64-row tile of the owned
// operand; the tiles of one (batch, head) are neighbouring blocks, so the
// re-read comes from L2 rather than device memory.
//
// Layout of the work: 4 warps of 32 threads a block; each warp owns 16 rows
// of the block's 64 (query rows for dq, key rows for dk/dv).  The streamed
// operand goes through shared memory in tiles, zero-filled past the end of
// the sequence; ragged tails are masked explicitly in p (a zero-filled
// query row has p = exp(0 − lse) != 0 otherwise).  bf16/fp16 use mma.sync
// m16n8k16 with fp32 accumulators; A fragments are read from shared memory,
// and the p / ds score fragments are re-packed in registers as the A
// operand of the next product.  fp32 runs on the CUDA cores in full fp32.
// The dk/dv pass streams fewer query rows a tile at Dh = 128 (DkvTile), to
// keep its two fp32 accumulators within the register file.
// wgmma, TMA and cp.async pipelines are not used yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // rows of the owned operand per block
constexpr int BK = 64;        // key rows per streamed tile of the dq pass
constexpr int WARPS = 4;      // each warp owns ROWS / WARPS = 16 rows
constexpr int THREADS = WARPS * 32;

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

struct Params {
  const void* in[5];  // q, k, v, o, do
  void* out[3];       // dq, dk, dv (dq or dk/dv may be null: that pass is skipped)
  const float* lse;   // [B*H, Sq]
  int B, H, Sq, Sk;
  long long st[8][3];  // element strides (batch, head, sequence) of q,k,v,o,do,dq,dk,dv
  float scale;
  int causal;
};

// Query rows streamed per tile by the dk/dv pass, chosen so that no
// instance spills: the tensor-core path keeps two fp32 [16, Dh] accumulators
// a warp, the fp32 path two [Dh / 2] a thread beside its score rows.
template <typename T, int D>
struct DkvTile {
  static constexpr int value = D >= 128 ? 32 : 64;
};

template <int D>
struct DkvTile<float, D> {
  static constexpr int value = D >= 128 ? 16 : 32;
};

template <typename T, int D>
struct Pitch {  // 16 bytes of padding a row: no bank conflicts, 16-byte rows
  static constexpr int value = D + 16 / (int)sizeof(T);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ const T* base(const Params& p, int which, int b, int h) {
  return static_cast<const T*>(p.in[which]) + b * p.st[which][0] + h * p.st[which][1];
}

template <typename T>
__device__ __forceinline__ T* out_base(const Params& p, int which, int b, int h) {
  return static_cast<T*>(p.out[which - DQ]) + b * p.st[which][0] + h * p.st[which][1];
}

// Copy rows [row0, row0 + NR) of one (batch, head) into shared memory, 16
// bytes per thread and step; rows at or past `nrows` become zeros.
template <typename T, int D, int NR>
__device__ __forceinline__ void load_tile(T* smem, const T* g, long long ss, int row0,
                                          int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = Pitch<T, D>::value;
  for (int idx = threadIdx.x; idx < NR * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) val = *reinterpret_cast<const uint4*>(g + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(smem + r * LD + c) = val;
  }
}

// For the NR query rows [row0, row0 + NR) whose do is in sDO: lse into sLse
// and delta = sum_d do·o (o read from device memory in its own type) into
// sDelta; 0 for both past `nrows`.  THREADS / NR threads share a row.
template <typename T, int D, int NR>
__device__ __forceinline__ void row_stats(float* sLse, float* sDelta, const T* sDO,
                                          const T* og, long long o_ss, const float* lse,
                                          int row0, int nrows) {
  constexpr int TPR = THREADS / NR;
  constexpr int PER = D / TPR;
  constexpr int LD = Pitch<T, D>::value;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int row = row0 + r;
  float acc = 0.f;
  if (row < nrows) {
    const T* orow = og + row * o_ss + part * PER;
    const T* drow = sDO + r * LD + part * PER;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc = fmaf(to_f(drow[i]), to_f(orow[i]), acc);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    sDelta[r] = acc;
    sLse[r] = row < nrows ? lse[row] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 16-bit types: tensor-core path
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2t+8..2t+9), a3 (row g+8, same cols)
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g)
//   C 16x8:  c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8, same cols)

// A fragment of k-chunk kc from 16 rows of a row-major tile in shared memory.
template <typename T, int LD>
__device__ __forceinline__ void a_frag(uint32_t a[4], const T* rows, int kc, int g, int t) {
  a[0] = ld32(rows + g * LD + kc * 16 + 2 * t);
  a[1] = ld32(rows + (g + 8) * LD + kc * 16 + 2 * t);
  a[2] = ld32(rows + g * LD + kc * 16 + 8 + 2 * t);
  a[3] = ld32(rows + (g + 8) * LD + kc * 16 + 8 + 2 * t);
}

// A fragment of k-chunk kc re-packed from two C fragments (n-tiles 2kc and
// 2kc + 1) of a 16-row score block, rounded to T.
template <typename T>
__device__ __forceinline__ void a_from_c(uint32_t a[4], float (*c)[4], int kc) {
  a[0] = Mma<T>::pack(c[2 * kc][0], c[2 * kc][1]);
  a[1] = Mma<T>::pack(c[2 * kc][2], c[2 * kc][3]);
  a[2] = Mma<T>::pack(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = Mma<T>::pack(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// acc[n] += A · X[kc*16 .. kc*16+16, n*8 .. n*8+8] for a row-major tile X in
// shared memory (the k dimension runs down X's rows).
template <typename T, int LD, int DN>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t a[4], const T* x,
                                         int kc, int g, int t) {
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x) + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const uint16_t* xp = xr + n * 8;
    const uint32_t b0 = (uint32_t)xp[0] | ((uint32_t)xp[LD] << 16);
    const uint32_t b1 = (uint32_t)xp[8 * LD] | ((uint32_t)xp[9 * LD] << 16);
    Mma<T>::run(acc[n], a, b0, b1);
  }
}

// dq pass: one block per (batch*head, 64 query rows), streaming K/V tiles.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_mma(Params p) {
  constexpr int LD = Pitch<T, D>::value;
  constexpr int KC = D / 16;  // k-chunks of q·kᵀ and do·vᵀ
  constexpr int DN = D / 8;   // n-tiles of ds·k
  constexpr int SN = BK / 8;  // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = sQ + ROWS * LD;
  T* sK = sDO + ROWS * LD;
  T* sV = sK + BK * LD;
  float* sLse = reinterpret_cast<float*>(sV + BK * LD);
  float* sDelta = sLse + ROWS;

  const int nq = (p.Sq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * ROWS;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const T* kg = base<T>(p, K, b, h);
  const T* vg = base<T>(p, V, b, h);
  load_tile<T, D, ROWS>(sQ, base<T>(p, Q, b, h), p.st[Q][2], q0, p.Sq);
  load_tile<T, D, ROWS>(sDO, base<T>(p, DO, b, h), p.st[DO][2], q0, p.Sq);
  __syncthreads();
  row_stats<T, D, ROWS>(sLse, sDelta, sDO, base<T>(p, O, b, h), p.st[O][2],
                        p.lse + (long long)bh * p.Sq, q0, p.Sq);
  __syncthreads();

  const T* qw = sQ + warp * 16 * LD;
  const T* dow = sDO + warp * 16 * LD;
  const int lrow = warp * 16 + g;
  const float lse_r[2] = {sLse[lrow], sLse[lrow + 8]};
  const float delta_r[2] = {sDelta[lrow], sDelta[lrow + 8]};
  const int row_base = q0 + lrow;  // this thread's rows: row_base, row_base + 8

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (min(q0 + ROWS, p.Sq) + BK - 1) / BK);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, D, BK>(sK, kg, p.st[K][2], k0, p.Sk);
    load_tile<T, D, BK>(sV, vg, p.st[V][2], k0, p.Sk);
    __syncthreads();

    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], da[4];
      a_frag<T, LD>(qa, qw, kc, g, t);
      a_frag<T, LD>(da, dow, kc, g, t);
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        const T* kr = sK + (n * 8 + g) * LD + kc * 16 + 2 * t;
        const T* vr = sV + (n * 8 + g) * LD + kc * 16 + 2 * t;
        Mma<T>::run(s[n], qa, ld32(kr), ld32(kr + 8));
        Mma<T>::run(dp[n], da, ld32(vr), ld32(vr + 8));
      }
    }

    // ds = p ∘ (dp − delta), kept in dp
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = row_base + r * 8;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool masked = col >= p.Sk || (p.causal && col > row);
        const float pe = masked ? 0.f : expf(s[n][e] * p.scale - lse_r[r]);
        dp[n][e] = pe * (dp[n][e] - delta_r[r]);
      }
    }

    // acc += ds · k, with ds rounded to T
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a_from_c<T>(a, dp, kc);
      mma_rows<T, LD, DN>(acc, a, sK, kc, g, t);
    }
  }

  T* dqg = out_base<T>(p, DQ, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + r * 8;
    if (row >= p.Sq) continue;
    T* orow = dqg + row * p.st[DQ][2];
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          Mma<T>::pack(acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
  }
}

// dk/dv pass: one block per (batch*head, 64 key rows), streaming Q/dO tiles
// from the first one a causal mask lets see the block's keys.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_mma(Params p) {
  constexpr int LD = Pitch<T, D>::value;
  constexpr int BQ = DkvTile<T, D>::value;
  constexpr int KC = D / 16;  // k-chunks of k·qᵀ and v·doᵀ
  constexpr int DN = D / 8;   // n-tiles of pᵀ·do and dsᵀ·q
  constexpr int SN = BQ / 8;  // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + ROWS * LD;
  T* sQ = sV + ROWS * LD;
  T* sDO = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sDO + BQ * LD);
  float* sDelta = sLse + BQ;

  const int nkb = (p.Sk + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * ROWS;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const T* qg = base<T>(p, Q, b, h);
  const T* dog = base<T>(p, DO, b, h);
  const T* og = base<T>(p, O, b, h);
  const float* lse = p.lse + (long long)bh * p.Sq;
  load_tile<T, D, ROWS>(sK, base<T>(p, K, b, h), p.st[K][2], k0, p.Sk);
  load_tile<T, D, ROWS>(sV, base<T>(p, V, b, h), p.st[V][2], k0, p.Sk);

  const T* kw = sK + warp * 16 * LD;
  const T* vw = sV + warp * 16 * LD;
  const int key_base = k0 + warp * 16 + g;  // this thread's keys: key_base, key_base + 8

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;

  const int nq = (p.Sq + BQ - 1) / BQ;
  for (int j = p.causal ? k0 / BQ : 0; j < nq; ++j) {
    const int qs = j * BQ;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, D, BQ>(sQ, qg, p.st[Q][2], qs, p.Sq);
    load_tile<T, D, BQ>(sDO, dog, p.st[DO][2], qs, p.Sq);
    __syncthreads();
    row_stats<T, D, BQ>(sLse, sDelta, sDO, og, p.st[O][2], lse, qs, p.Sq);
    __syncthreads();

    // sᵀ = k·qᵀ and dpᵀ = v·doᵀ: 16 keys x BQ queries a warp
    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      a_frag<T, LD>(ka, kw, kc, g, t);
      a_frag<T, LD>(va, vw, kc, g, t);
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        const T* qr = sQ + (n * 8 + g) * LD + kc * 16 + 2 * t;
        const T* dr = sDO + (n * 8 + g) * LD + kc * 16 + 2 * t;
        Mma<T>::run(s[n], ka, ld32(qr), ld32(qr + 8));
        Mma<T>::run(dp[n], va, ld32(dr), ld32(dr + 8));
      }
    }

    // pᵀ kept in s, dsᵀ = pᵀ ∘ (dpᵀ − delta) kept in dp; query rows past Sq
    // and (causal) queries before the key get p = 0
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_base + (e >> 1) * 8;
        const int qc = n * 8 + 2 * t + (e & 1);
        const int qi = qs + qc;
        const bool masked = qi >= p.Sq || (p.causal && qi < key);
        const float pe = masked ? 0.f : expf(s[n][e] * p.scale - sLse[qc]);
        s[n][e] = pe;
        dp[n][e] = pe * (dp[n][e] - sDelta[qc]);
      }
    }

    // dv += pᵀ·do and dk += dsᵀ·q, with p and ds rounded to T
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t a[4];
      a_from_c<T>(a, s, kc);
      mma_rows<T, LD, DN>(dv, a, sDO, kc, g, t);
      a_from_c<T>(a, dp, kc);
      mma_rows<T, LD, DN>(dk, a, sQ, kc, g, t);
    }
  }

  T* dkg = out_base<T>(p, DK, b, h);
  T* dvg = out_base<T>(p, DV, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_base + r * 8;
    if (key >= p.Sk) continue;
    T* krow = dkg + key * p.st[DK][2];
    T* vrow = dvg + key * p.st[DV][2];
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + 2 * t) =
          Mma<T>::pack(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + 2 * t) =
          Mma<T>::pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core path.  Lane pair (2i, 2i+1) of a warp owns one of the
// warp's 16 rows: each lane takes every other row of the streamed tile and
// accumulates half of the owned row's Dh gradient columns.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32(Params p) {
  constexpr int LD = Pitch<float, D>::value;
  constexpr int HALF = D / 2;
  constexpr int KPL = BK / 2;  // keys scored per lane and tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + ROWS * LD;
  float* sK = sDO + ROWS * LD;
  float* sV = sK + BK * LD;
  float* sLse = sV + BK * LD;
  float* sDelta = sLse + ROWS;

  const int nq = (p.Sq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * ROWS;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;
  const int lrow = warp * 16 + (lane >> 1);
  const int row = q0 + lrow;

  const float* kg = base<float>(p, K, b, h);
  const float* vg = base<float>(p, V, b, h);
  load_tile<float, D, ROWS>(sQ, base<float>(p, Q, b, h), p.st[Q][2], q0, p.Sq);
  load_tile<float, D, ROWS>(sDO, base<float>(p, DO, b, h), p.st[DO][2], q0, p.Sq);
  __syncthreads();
  row_stats<float, D, ROWS>(sLse, sDelta, sDO, base<float>(p, O, b, h), p.st[O][2],
                            p.lse + (long long)bh * p.Sq, q0, p.Sq);
  __syncthreads();
  const float lse_r = sLse[lrow], delta_r = sDelta[lrow];

  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (min(q0 + ROWS, p.Sq) + BK - 1) / BK);

  const float4* q4 = reinterpret_cast<const float4*>(sQ + lrow * LD);
  const float4* do4 = reinterpret_cast<const float4*>(sDO + lrow * LD);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<float, D, BK>(sK, kg, p.st[K][2], k0, p.Sk);
    load_tile<float, D, BK>(sV, vg, p.st[V][2], k0, p.Sk);
    __syncthreads();

    float s[KPL], dp[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qv = q4[d4], dv = do4[d4];
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        s[i] = dot4(qv, reinterpret_cast<const float4*>(sK + (2 * i + half) * LD)[d4], s[i]);
        dp[i] = dot4(dv, reinterpret_cast<const float4*>(sV + (2 * i + half) * LD)[d4], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int col = k0 + 2 * i + half;
      const bool masked = col >= p.Sk || (p.causal && col > row);
      const float pe = masked ? 0.f : expf(s[i] * p.scale - lse_r);
      dp[i] = pe * (dp[i] - delta_r);  // ds
    }

    const float* kcol = sK + half * HALF;
#pragma unroll 4
    for (int i = 0; i < KPL; ++i) {
      const float mine = dp[i];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      const float d0 = half ? other : mine;  // key 2i
      const float d1 = half ? mine : other;  // key 2i + 1
      const float* k0p = kcol + (2 * i) * LD;
#pragma unroll
      for (int c = 0; c < HALF; ++c) acc[c] = fmaf(d1, k0p[LD + c], fmaf(d0, k0p[c], acc[c]));
    }
  }

  if (row >= p.Sq) return;
  float* orow = out_base<float>(p, DQ, b, h) + row * p.st[DQ][2] + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; ++c) orow[c] = acc[c] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_f32(Params p) {
  constexpr int LD = Pitch<float, D>::value;
  constexpr int HALF = D / 2;
  constexpr int BQ = DkvTile<float, D>::value;
  constexpr int QPL = BQ / 2;  // queries scored per lane and tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + ROWS * LD;
  float* sQ = sV + ROWS * LD;
  float* sDO = sQ + BQ * LD;
  float* sLse = sDO + BQ * LD;
  float* sDelta = sLse + BQ;

  const int nkb = (p.Sk + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / nkb;
  const int k0 = (blockIdx.x % nkb) * ROWS;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;
  const int lrow = warp * 16 + (lane >> 1);
  const int key = k0 + lrow;

  const float* qg = base<float>(p, Q, b, h);
  const float* dog = base<float>(p, DO, b, h);
  const float* og = base<float>(p, O, b, h);
  const float* lse = p.lse + (long long)bh * p.Sq;
  load_tile<float, D, ROWS>(sK, base<float>(p, K, b, h), p.st[K][2], k0, p.Sk);
  load_tile<float, D, ROWS>(sV, base<float>(p, V, b, h), p.st[V][2], k0, p.Sk);

  float dk[HALF], dv[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) dk[c] = dv[c] = 0.f;

  const float4* k4 = reinterpret_cast<const float4*>(sK + lrow * LD);
  const float4* v4 = reinterpret_cast<const float4*>(sV + lrow * LD);
  const int nq = (p.Sq + BQ - 1) / BQ;
  for (int j = p.causal ? k0 / BQ : 0; j < nq; ++j) {
    const int qs = j * BQ;
    __syncthreads();
    load_tile<float, D, BQ>(sQ, qg, p.st[Q][2], qs, p.Sq);
    load_tile<float, D, BQ>(sDO, dog, p.st[DO][2], qs, p.Sq);
    __syncthreads();
    row_stats<float, D, BQ>(sLse, sDelta, sDO, og, p.st[O][2], lse, qs, p.Sq);
    __syncthreads();

    float s[QPL], dp[QPL];
#pragma unroll
    for (int i = 0; i < QPL; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = k4[d4], vv = v4[d4];
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        s[i] = dot4(kv, reinterpret_cast<const float4*>(sQ + (2 * i + half) * LD)[d4], s[i]);
        dp[i] = dot4(vv, reinterpret_cast<const float4*>(sDO + (2 * i + half) * LD)[d4], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      const int qc = 2 * i + half;
      const int qi = qs + qc;
      const bool masked = qi >= p.Sq || (p.causal && qi < key);
      const float pe = masked ? 0.f : expf(s[i] * p.scale - sLse[qc]);
      s[i] = pe;
      dp[i] = pe * (dp[i] - sDelta[qc]);  // ds
    }

    const float* qcol = sQ + half * HALF;
    const float* dcol = sDO + half * HALF;
#pragma unroll 2
    for (int i = 0; i < QPL; ++i) {
      const float p_mine = s[i], ds_mine = dp[i];
      const float p_other = __shfl_xor_sync(0xffffffffu, p_mine, 1);
      const float ds_other = __shfl_xor_sync(0xffffffffu, ds_mine, 1);
      const float p0 = half ? p_other : p_mine, p1 = half ? p_mine : p_other;
      const float s0 = half ? ds_other : ds_mine, s1 = half ? ds_mine : ds_other;
      const float* q0p = qcol + (2 * i) * LD;
      const float* d0p = dcol + (2 * i) * LD;
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        dv[c] = fmaf(p1, d0p[LD + c], fmaf(p0, d0p[c], dv[c]));
        dk[c] = fmaf(s1, q0p[LD + c], fmaf(s0, q0p[c], dk[c]));
      }
    }
  }

  if (key >= p.Sk) return;
  float* krow = out_base<float>(p, DK, b, h) + key * p.st[DK][2] + half * HALF;
  float* vrow = out_base<float>(p, DV, b, h) + key * p.st[DV][2] + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    krow[c] = dk[c] * p.scale;
    vrow[c] = dv[c];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

cudaError_t launch(void (*kernel)(Params), const Params& p, int smem, int tiles,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (long long)p.B * p.H * tiles;
  if (blocks <= 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(void (*dq)(Params), void (*dkv)(Params), const Params& p, cudaStream_t s) {
  constexpr int LD = Pitch<T, D>::value;
  constexpr int BQ = DkvTile<T, D>::value;
  if (p.out[0] != nullptr) {
    const int smem = (2 * ROWS + 2 * BK) * LD * (int)sizeof(T) + 2 * ROWS * (int)sizeof(float);
    const cudaError_t e = launch(dq, p, smem, (p.Sq + ROWS - 1) / ROWS, s);
    if (e != cudaSuccess) return e;
  }
  if (p.out[1] != nullptr) {
    const int smem = (2 * ROWS + 2 * BQ) * LD * (int)sizeof(T) + 2 * BQ * (int)sizeof(float);
    return launch(dkv, p, smem, (p.Sk + ROWS - 1) / ROWS, s);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_mma(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 16: return run<T, 16>(flash_bwd_dq_mma<T, 16>, flash_bwd_dkv_mma<T, 16>, p, s);
    case 32: return run<T, 32>(flash_bwd_dq_mma<T, 32>, flash_bwd_dkv_mma<T, 32>, p, s);
    case 64: return run<T, 64>(flash_bwd_dq_mma<T, 64>, flash_bwd_dkv_mma<T, 64>, p, s);
    case 128: return run<T, 128>(flash_bwd_dq_mma<T, 128>, flash_bwd_dkv_mma<T, 128>, p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 16: return run<float, 16>(flash_bwd_dq_f32<16>, flash_bwd_dkv_f32<16>, p, s);
    case 32: return run<float, 32>(flash_bwd_dq_f32<32>, flash_bwd_dkv_f32<32>, p, s);
    case 64: return run<float, 64>(flash_bwd_dq_f32<64>, flash_bwd_dkv_f32<64>, p, s);
    case 128: return run<float, 128>(flash_bwd_dq_f32<128>, flash_bwd_dkv_f32<128>, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Inputs q, k, v, o, do and
// lse ([B*H, Sq] fp32, from the forward); outputs dq, dk, dv.  A null dq
// skips the dq pass, a null dk (and dv) the dk/dv pass.  strides: 24
// element strides, (batch, head, sequence) for q, k, v, o, do, dq, dk, dv
// in that order; Dh has unit stride.  Returns the cudaError_t of the
// launches (0 on success); never synchronises.
extern "C" int mx_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse, void* dq,
                            void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                            const long long* strides, float scale, int causal, void* stream) {
  Params p;
  p.in[Q] = q;
  p.in[K] = k;
  p.in[V] = v;
  p.in[O] = o;
  p.in[DO] = dout;
  p.out[0] = dq;
  p.out[1] = dk;
  p.out[2] = dv;
  if ((dk == nullptr) != (dv == nullptr)) return (int)cudaErrorInvalidValue;
  p.lse = lse;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_f32(p, D, s);
    case 1: return (int)dispatch_mma<__half>(p, D, s);
    case 2: return (int)dispatch_mma<__nv_bfloat16>(p, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
