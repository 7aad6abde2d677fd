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
//   dq    = scale · ds·k              walked over query tiles
//   dk    = scale · dsᵀ·q, dv = pᵀ·do walked over key tiles
// Scores, p and the accumulators are fp32; p is rounded to do's type before
// pᵀ·do and ds to q's type before ds·k and dsᵀ·q; outputs in the input
// type.  Causal masking is top-left aligned (q_pos >= k_pos, both from 0);
// rows and keys past the sequence get p = 0 and are not stored.  Each block
// owns its outputs, so there are no atomics and the gradients are the same
// from run to run.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// BERT-base training shape (B=64, S=128, H=12, Dh=64, bf16, non-causal) the
// dq pass must read q, k, v, o, do and lse and write dq, 75.9 MB, 22.7 us at
// the memory rate, against 4.8 GFLOP, 4.9 us at the tensor-core rate; the
// dk/dv pass moves 88.5 MB (26.4 us) for 6.4 GFLOP (6.5 us).  Both are
// memory-bound: what matters is loads in flight on every SM all the time,
// and each byte read once.
//
// The 16-bit design (flash_bwd_dq_tma, flash_bwd_dkv_tma) is flash_fwd_tma's
// (flash_tma.cuh holds what they share):
// * Persistent grid, one 384-thread block per SM, walking 128-row work
//   items with a static stride (no atomics).  A dq item is 128 query rows
//   of one (batch, head), a dk/dv item 128 keys; at S <= 128 an item holds
//   the whole head, so every operand is read once.  Causal launches take
//   the items with the most tiles first; a dq item stops at its last
//   visible K tile, a dk/dv item starts at the first query tile that sees
//   its keys.
// * One producer thread keeps TMA rings full.  dq pass: per item Q, dO and O
//   (the item's buffer), streamed K and V tiles (two stages); dk/dv pass:
//   per item K and V, streamed Q, dO and O tiles (two stages).  Every map is
//   4-D over (Dh, S, H, B) in the caller's strides with 64-row boxes, so
//   one set of maps per call serves both kernels and the stores into the
//   three slices of the [B, S, 3, H, Dh] gradient.  TMA fills rows past S
//   with zeros; p is masked there explicitly.
// * Two consumer warpgroups own 64 rows each.  dq: s = q·kᵀ and dp = do·vᵀ
//   (wgmma, both operands K-major in shared memory), p = 2^(s·scale·log2e −
//   lse·log2e), ds = p∘(dp − delta) rounded in registers, dq += ds·k (A from
//   registers, K MN-major: the forward's p·v with K in V's place).  delta
//   comes once per item from O and dO in shared memory, four lanes a row.
//   dk/dv, 64 query columns at a time: sᵀ = k·qᵀ and dpᵀ = v·doᵀ, pᵀ and
//   dsᵀ column-wise, dv += pᵀ·do and dk += dsᵀ·q (A from registers: an
//   accumulator is already the A fragment of the next product; do and q
//   MN-major).  Each streamed
//   tile's delta and lse·log2e are needed by both consumers: three idle
//   warps of the producer warpgroup compute them once per stage into shared
//   memory and arrive on their own barrier.
// * Epilogue: each consumer rounds its rows' gradients (dq and dk times
//   scale) into the rows it owns of the item's own tiles (its Q rows, its K
//   and V rows, read by no one else and no longer needed), in the swizzled
//   layout, and one TMA store per tile writes them in the caller's strides,
//   clipping rows past S.  The item buffer is released once the stores
//   have read it.
// Tiles and shared memory per (type, Dh): DqTiles<D>::SMEM and
// DkvTiles<D>::SMEM; at Dh=128 the streamed tiles have 64 rows and the
// item buffers are single, to keep the accumulators in registers
// (setmaxnreg 56 / 224) and the stages in shared memory.
//
// What the card shows (PERF.md): at the BERT shape the dq pass reaches
// about two thirds of its bytes bound and the dk/dv pass over half, the
// pair faster than SDPA's backward; at S=512, where each item walks four
// tiles, a consumer's products and its p/ds math run in series and the
// pair is slower than SDPA's.
//
// fp32 runs on the CUDA cores in full fp32 (flash_bwd_dq_f32,
// flash_bwd_dkv_f32): 4 warps a block, each warp owning 16 of the block's
// 64 rows, the streamed operand staged synchronously through shared memory.

#include <math.h>

#include "flash_tma.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// 16-bit types: persistent, TMA-fed, warpgroup-MMA path
// ---------------------------------------------------------------------------

constexpr int BM = 128;         // owned rows of a work item (query rows, or keys)
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 owned rows each
constexpr int TMA_THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
// setmaxnreg: 56·128 + 224·256 <= 65536.  The producer warpgroup needs
// more than the forward's 40 (the dk/dv pass at Dh=128 spills there at 40);
// a consumer holds at most 192 accumulators (dk and dv at Dh=128 beside a
// 64 x 64 block of p and one of dp).
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int MAP_ROWS = 64;    // rows of every TMA box; a 128-row tile is two
constexpr int STAT_THREADS = 96;  // producer warps 1-3: delta and lse of a stage
constexpr float LOG2E = 1.4426950408889634f;

// dq pass.  Dynamic shared memory (SMEM, bytes): Dh 16: 42,064; 32:
// 83,024; 64: 164,944; 128: 164,928.
template <int D>
struct DqTiles {
  using I = Box<D, BM>;                            // Q, dO, O of an item
  static constexpr int BKV = D >= 128 ? 64 : 128;  // keys of a K/V tile
  using KV = Box<D, BKV>;
  static constexpr int QS = D >= 128 ? 1 : 2;      // item buffers
  static constexpr int KVS = 2;                    // K/V stages
  static constexpr int BARRIERS = 2 * QS + 3 * KVS;
  static constexpr int SMEM = QS * 3 * I::BYTES + KVS * 2 * KV::BYTES + BARRIERS * 8 + 1024;
};

// dk/dv pass.  Dynamic shared memory (SMEM, bytes): Dh 16: 44,112; 32:
// 85,072; 64: 166,992; 128: 165,952.
template <int D>
struct DkvTiles {
  using I = Box<D, BM>;                           // K, V of an item
  static constexpr int BQ = D >= 128 ? 64 : 128;  // query rows of a streamed tile
  using QT = Box<D, BQ>;                          // Q, dO, O of a stage
  static constexpr int KS = D >= 128 ? 1 : 2;     // item buffers
  static constexpr int QST = 2;                   // Q/dO/O stages
  static constexpr int STAT_BYTES = 2 * BQ * 4;   // delta and lse·log2e of a stage
  static constexpr int BARRIERS = 2 * KS + 3 * QST;
  static constexpr int SMEM = KS * 2 * I::BYTES + QST * (3 * QT::BYTES + STAT_BYTES) +
                              BARRIERS * 8 + 1024;
};

static_assert(DqTiles<16>::SMEM == 42064 && DqTiles<32>::SMEM == 83024 &&
                  DqTiles<64>::SMEM == 164944 && DqTiles<128>::SMEM == 164928,
              "the sizes stated beside DqTiles");
static_assert(DkvTiles<16>::SMEM == 44112 && DkvTiles<32>::SMEM == 85072 &&
                  DkvTiles<64>::SMEM == 166992 && DkvTiles<128>::SMEM == 165952,
              "the sizes stated beside DkvTiles");

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A tile of ROWS rows from `row0` of one (batch, head): MAP_ROWS-row boxes
// of each column box, all completing on `bar`.
template <class L, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int h, int b) {
#pragma unroll
  for (int c = 0; c < L::PARTS; ++c)
#pragma unroll
    for (int r = 0; r < ROWS / MAP_ROWS; ++r)
      tma_load(dst + c * L::PART + r * MAP_ROWS * L::W, map, bar, c * L::BOX,
               row0 + r * MAP_ROWS, h, b);
}

// Head and batch coordinates of operand `which` for (b, h): an operand
// expanded over heads or batch (stride 0) has extent 1 there in its map.
struct Coord {
  int h, b;
};

__device__ __forceinline__ Coord coord(const Params& p, int which, int b, int h) {
  return {p.st[which][1] ? h : 0, p.st[which][0] ? b : 0};
}

// Rounded gradients of a consumer's 64 rows (accumulator layout, times
// `mul`) into those rows of a tile laid out as L, starting at tile row
// `row0`.
template <typename T, class L, int D>
__device__ __forceinline__ void stage_rows(uint32_t tile, const float (&acc)[D / 2], float mul,
                                           int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      sts32(tile + tile_offset<L>(row0 + 8 * r, n * 8 + 2 * t),
            pack2<T>(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul));
}

struct DqItem {
  int b, h, q0, nk;
};

// Work item i of the dq pass: causal launches walk the query tiles from the
// last (most K tiles) down; the others keep a head's query tiles side by
// side.  nk: the K tiles the item sees (the JAX nk_bound).
__device__ __forceinline__ DqItem dq_item(int i, const Params& p, int nqt, int bkv) {
  const int bhn = p.B * p.H;
  int bh, qt;
  if (p.causal) {
    qt = nqt - 1 - i / bhn;
    bh = i % bhn;
  } else {
    bh = i / nqt;
    qt = i % nqt;
  }
  DqItem it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.q0 = qt * BM;
  it.nk = (p.Sk + bkv - 1) / bkv;
  if (p.causal) it.nk = min(it.nk, (min(it.q0 + BM, p.Sq) + bkv - 1) / bkv);
  return it;
}

struct DkvItem {
  int b, h, k0, j0;
};

// Work item i of the dk/dv pass: causal launches walk the key tiles from
// the first (most query tiles) up.  j0: the first query tile that sees the
// item's keys (the JAX j0).
__device__ __forceinline__ DkvItem dkv_item(int i, const Params& p, int nkt, int bq) {
  const int bhn = p.B * p.H;
  int bh, kt;
  if (p.causal) {
    kt = i / bhn;
    bh = i % bhn;
  } else {
    bh = i / nkt;
    kt = i % nkt;
  }
  DkvItem it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.k0 = kt * BM;
  it.j0 = p.causal ? it.k0 / bq : 0;
  return it;
}

template <typename T, int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_bwd_dq_tma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdq, Params p) {
  using L = DqTiles<D>;
  using I = typename L::I;
  using KV = typename L::KV;
  constexpr int BKV = L::BKV;
  extern __shared__ unsigned char smem_dq[];
  const uint32_t base = (smem_addr(smem_dq) + 1023u) & ~1023u;
  const uint32_t sitem = base;                         // QS buffers of Q, dO, O
  const uint32_t skv = sitem + L::QS * 3 * I::BYTES;   // KVS stages of K then V
  const uint32_t bars = skv + L::KVS * 2 * KV::BYTES;
  const uint32_t q_full = bars, q_empty = q_full + 8 * L::QS;
  const uint32_t k_full = q_empty + 8 * L::QS, v_full = k_full + 8 * L::KVS;
  const uint32_t kv_empty = v_full + 8 * L::KVS;

  const int nqt = (p.Sq + BM - 1) / BM;
  const int items = p.B * p.H * nqt;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::QS; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, CONSUMERS);  // each consumer, after its store read
    }
    for (int i = 0; i < L::KVS; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer warpgroup: one thread keeps the rings full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      Ring<L::QS> qr;
      Ring<L::KVS> kvr;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const DqItem it = dq_item(i, p, nqt, BKV);
        const Coord cq = coord(p, Q, it.b, it.h), cdo = coord(p, DO, it.b, it.h);
        const Coord co = coord(p, O, it.b, it.h), ck = coord(p, K, it.b, it.h);
        const Coord cv = coord(p, V, it.b, it.h);
        const int qs = qr.slot();
        const uint32_t buf = sitem + qs * 3 * I::BYTES;
        mbar_wait(q_empty + 8 * qs, qr.parity() ^ 1u);
        mbar_expect_tx(q_full + 8 * qs, 3 * I::BYTES);
        tma_tile<I, BM>(buf, &tq, q_full + 8 * qs, it.q0, cq.h, cq.b);
        tma_tile<I, BM>(buf + I::BYTES, &tdo, q_full + 8 * qs, it.q0, cdo.h, cdo.b);
        tma_tile<I, BM>(buf + 2 * I::BYTES, &to, q_full + 8 * qs, it.q0, co.h, co.b);
        ++qr.n;
        for (int j = 0; j < it.nk; ++j) {
          const int s = kvr.slot();
          const uint32_t ks = skv + 2 * s * KV::BYTES, vs = ks + KV::BYTES;
          mbar_wait(kv_empty + 8 * s, kvr.parity() ^ 1u);
          mbar_expect_tx(k_full + 8 * s, KV::BYTES);
          tma_tile<KV, BKV>(ks, &tk, k_full + 8 * s, j * BKV, ck.h, ck.b);
          mbar_expect_tx(v_full + 8 * s, KV::BYTES);
          tma_tile<KV, BKV>(vs, &tv, v_full + 8 * s, j * BKV, cv.h, cv.b);
          ++kvr.n;
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows [64·wg, 64·wg + 64) of each item.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rl = 64 * wg + 16 * warp + g;  // this thread's tile rows: rl, rl + 8
    const float sl2 = p.scale * LOG2E;       // scores in log2 units
    Ring<L::QS> qr;
    Ring<L::KVS> kvr;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const DqItem it = dq_item(i, p, nqt, BKV);
      const int qs = qr.slot();
      const uint32_t buf = sitem + qs * 3 * I::BYTES;
      const uint32_t qa = buf + 64 * wg * I::W;  // this consumer's q rows, then do's
      const uint32_t doa = qa + I::BYTES;
      const int wg_row0 = it.q0 + 64 * wg;
      const int row0 = it.q0 + rl;
      const long long bh = (long long)it.b * p.H + it.h;
      float lse2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lse2[r] = row0 + 8 * r < p.Sq ? p.lse[bh * p.Sq + row0 + 8 * r] * LOG2E : 0.f;
      mbar_wait(q_full + 8 * qs, qr.parity());

      // delta = rowsum(do ∘ o): each of a row's four lanes sums D/4 columns
      float delta[2] = {0.f, 0.f};
      if (it.nk > 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int c = t * (D / 4); c < (t + 1) * (D / 4); c += 2) {
            const uint32_t at = tile_offset<I>(rl + 8 * r, c);
            const float2 d2 = unpack2<T>(lds32(buf + I::BYTES + at));
            const float2 o2 = unpack2<T>(lds32(buf + 2 * I::BYTES + at));
            acc = fmaf(d2.x, o2.x, fmaf(d2.y, o2.y, acc));
          }
          delta[r] = quad_sum(acc);
        }
      }

      float dq[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
      for (int j = 0; j < it.nk; ++j) {
        const int s = kvr.slot();
        const uint32_t par = kvr.parity();
        const uint32_t ks = skv + 2 * s * KV::BYTES, vs = ks + KV::BYTES;
        const int k0 = j * BKV;
        // rows all past Sq, or (causal) a tile all after this consumer's
        // rows: p = 0, nothing to add
        if (wg_row0 >= p.Sq || (p.causal && k0 > wg_row0 + 63)) {
          release(kv_empty + 8 * s, lane);
          ++kvr.n;
          continue;
        }
        float sc[BKV / 2], dp[BKV / 2];
        mbar_wait(k_full + 8 * s, par);
        issue_ss<T, D, I, KV, BKV>(sc, qa, ks);
        mbar_wait(v_full + 8 * s, par);
        issue_ss<T, D, I, KV, BKV>(dp, doa, vs);
        wgmma_wait();
        // p, then ds = p ∘ (dp − delta) in dp; masked only where a key tail
        // or the causal diagonal cuts the tile
        const bool edge = k0 + BKV > p.Sk || (p.causal && k0 + BKV - 1 > wg_row0);
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float pe = exp2_ftz(fmaf(sc[4 * n + e], sl2, -lse2[r]));
            if (edge) {
              const int col = k0 + n * 8 + 2 * t + (e & 1);
              if (col >= p.Sk || (p.causal && col > row0 + 8 * r)) pe = 0.f;
            }
            dp[4 * n + e] = pe * (dp[4 * n + e] - delta[r]);
          }
        uint32_t dsf[BKV / 16][4];
        pack_a<T>(dsf, dp);
        issue_rs<T, D, KV, BKV / 16>(dq, dsf, ks);
        wgmma_wait();
        release(kv_empty + 8 * s, lane);
        ++kvr.n;
      }

      // Epilogue: dq·scale into this consumer's own q rows (no longer read),
      // then one TMA store per column box, which clips rows past Sq.
      stage_rows<T, I, D>(buf, dq, p.scale, rl, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg);
      if (tid == 0) {
        if (wg_row0 < p.Sq) {
          for (int c = 0; c < I::PARTS; ++c)
            tma_store(&tdq, buf + c * I::PART + 64 * wg * I::W, c * I::BOX, wg_row0, it.h, it.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        mbar_arrive(q_empty + 8 * qs);  // the item buffer may be loaded again
      }
      ++qr.n;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_bwd_dkv_tma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv, Params p) {
  using L = DkvTiles<D>;
  using I = typename L::I;
  using QT = typename L::QT;
  constexpr int BQ = L::BQ;
  constexpr int NQ = 64;  // query columns of one product
  extern __shared__ unsigned char smem_dkv[];
  const uint32_t base = (smem_addr(smem_dkv) + 1023u) & ~1023u;
  const uint32_t skv = base;                                // KS buffers of K then V
  const uint32_t sq = skv + L::KS * 2 * I::BYTES;           // QST stages of Q, dO, O
  const uint32_t sstat = sq + L::QST * 3 * QT::BYTES;       // QST stages of delta, lse·log2e
  const uint32_t bars = sstat + L::QST * L::STAT_BYTES;
  const uint32_t kv_full = bars, kv_empty = kv_full + 8 * L::KS;
  const uint32_t s_full = kv_empty + 8 * L::KS, s_stats = s_full + 8 * L::QST;
  const uint32_t s_empty = s_stats + 8 * L::QST;
  float* const stats = reinterpret_cast<float*>(smem_dkv + (sstat - smem_addr(smem_dkv)));

  const int nkt = (p.Sk + BM - 1) / BM;
  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int items = p.B * p.H * nkt;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::KS; ++i) {
      mbar_init(kv_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, CONSUMERS);  // each consumer, after its stores read
    }
    for (int i = 0; i < L::QST; ++i) {
      mbar_init(s_full + 8 * i, 1);
      mbar_init(s_stats + 8 * i, STAT_THREADS);
      mbar_init(s_empty + 8 * i, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      // One thread keeps the rings full.
      Ring<L::KS> kr;
      Ring<L::QST> sr;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const DkvItem it = dkv_item(i, p, nkt, BQ);
        const Coord cq = coord(p, Q, it.b, it.h), cdo = coord(p, DO, it.b, it.h);
        const Coord co = coord(p, O, it.b, it.h), ck = coord(p, K, it.b, it.h);
        const Coord cv = coord(p, V, it.b, it.h);
        const int ks = kr.slot();
        const uint32_t kbuf = skv + ks * 2 * I::BYTES;
        mbar_wait(kv_empty + 8 * ks, kr.parity() ^ 1u);
        mbar_expect_tx(kv_full + 8 * ks, 2 * I::BYTES);
        tma_tile<I, BM>(kbuf, &tk, kv_full + 8 * ks, it.k0, ck.h, ck.b);
        tma_tile<I, BM>(kbuf + I::BYTES, &tv, kv_full + 8 * ks, it.k0, cv.h, cv.b);
        ++kr.n;
        for (int j = it.j0; j < nqt; ++j) {
          const int s = sr.slot();
          const uint32_t qbuf = sq + s * 3 * QT::BYTES;
          mbar_wait(s_empty + 8 * s, sr.parity() ^ 1u);
          mbar_expect_tx(s_full + 8 * s, 3 * QT::BYTES);
          tma_tile<QT, BQ>(qbuf, &tq, s_full + 8 * s, j * BQ, cq.h, cq.b);
          tma_tile<QT, BQ>(qbuf + QT::BYTES, &tdo, s_full + 8 * s, j * BQ, cdo.h, cdo.b);
          tma_tile<QT, BQ>(qbuf + 2 * QT::BYTES, &to, s_full + 8 * s, j * BQ, co.h, co.b);
          ++sr.n;
        }
      }
    } else if (tid >= 128 - STAT_THREADS) {
      // Warps 1-3: delta = rowsum(do ∘ o) and lse·log2e of each stage's
      // query rows, once for both consumers, then an arrival each.
      Ring<L::QST> sr;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const DkvItem it = dkv_item(i, p, nkt, BQ);
        const float* const lse = p.lse + ((long long)it.b * p.H + it.h) * p.Sq;
        for (int j = it.j0; j < nqt; ++j) {
          const int s = sr.slot();
          const uint32_t dob = sq + s * 3 * QT::BYTES + QT::BYTES, ob = dob + QT::BYTES;
          float* const st = stats + s * 2 * BQ;
          mbar_wait(s_full + 8 * s, sr.parity());
          for (int r = tid - (128 - STAT_THREADS); r < BQ; r += STAT_THREADS) {
            float acc = 0.f;
#pragma unroll 1
            for (int c = 0; c < D; c += 8) {  // within the producer's registers
              const uint32_t at = tile_offset<QT>(r, c);
              const uint4 d4 = lds128(dob + at), o4 = lds128(ob + at);
              const uint32_t dw[4] = {d4.x, d4.y, d4.z, d4.w}, ow[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 a = unpack2<T>(dw[e]), b = unpack2<T>(ow[e]);
                acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
              }
            }
            const int row = j * BQ + r;
            st[r] = acc;
            st[BQ + r] = row < p.Sq ? lse[row] * LOG2E : 0.f;
          }
          mbar_arrive(s_stats + 8 * s);
          ++sr.n;
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys [64·wg, 64·wg + 64) of each item.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rl = 64 * wg + 16 * warp + g;  // this thread's tile rows: rl, rl + 8
    const float sl2 = p.scale * LOG2E;
    Ring<L::KS> kr;
    Ring<L::QST> sr;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const DkvItem it = dkv_item(i, p, nkt, BQ);
      const int ks = kr.slot();
      const uint32_t kbuf = skv + ks * 2 * I::BYTES, vbuf = kbuf + I::BYTES;
      const uint32_t ka = kbuf + 64 * wg * I::W, va = vbuf + 64 * wg * I::W;
      const int wg_key0 = it.k0 + 64 * wg;
      const int key0 = it.k0 + rl;  // this thread's keys: key0, key0 + 8
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
      mbar_wait(kv_full + 8 * ks, kr.parity());
      for (int j = it.j0; j < nqt; ++j) {
        const int s = sr.slot();
        const uint32_t par = sr.parity();
        const uint32_t qbuf = sq + s * 3 * QT::BYTES, dob = qbuf + QT::BYTES;
        mbar_wait(s_full + 8 * s, par);
        mbar_wait(s_stats + 8 * s, par);
        // NQ query columns at a time: two fp32 score blocks of 64 x NQ
        // beside the dk and dv accumulators stay within the registers
#pragma unroll 1
        for (int hq = 0; hq < BQ / NQ; ++hq) {
          const int q0 = j * BQ + hq * NQ;
          // a block all past Sq, or (causal) all before this consumer's
          // keys, has p = 0 and adds nothing
          if (q0 >= p.Sq || (p.causal && q0 + NQ - 1 < wg_key0)) continue;
          const uint32_t qh = qbuf + hq * NQ * QT::W, dh = dob + hq * NQ * QT::W;
          const float* const st = stats + s * 2 * BQ + hq * NQ;
          float sc[NQ / 2], dp[NQ / 2];
          issue_ss<T, D, I, QT, NQ>(sc, ka, qh);  // sᵀ = k·qᵀ
          issue_ss<T, D, I, QT, NQ>(dp, va, dh);  // dpᵀ = v·doᵀ
          wgmma_wait();
          // pᵀ in sc and dsᵀ = pᵀ ∘ (dpᵀ − delta) in dp, column by column;
          // masked only where a query tail or the causal diagonal cuts them
          const bool edge = q0 + NQ > p.Sq || (p.causal && q0 < wg_key0 + 63);
#pragma unroll
          for (int n = 0; n < NQ / 8; ++n) {
            const float2 dl = *reinterpret_cast<const float2*>(st + n * 8 + 2 * t);
            const float2 ls = *reinterpret_cast<const float2*>(st + BQ + n * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = e & 1;
              float pe = exp2_ftz(fmaf(sc[4 * n + e], sl2, -(c ? ls.y : ls.x)));
              if (edge) {
                const int qi = q0 + n * 8 + 2 * t + c;
                if (qi >= p.Sq || (p.causal && qi < key0 + 8 * (e >> 1))) pe = 0.f;
              }
              sc[4 * n + e] = pe;
              dp[4 * n + e] = pe * (dp[4 * n + e] - (c ? dl.y : dl.x));
            }
          }
          uint32_t pf[NQ / 16][4], dsf[NQ / 16][4];
          pack_a<T>(pf, sc);
          issue_rs<T, D, QT, NQ / 16>(dv, pf, dh);   // dv += pᵀ·do
          pack_a<T>(dsf, dp);
          issue_rs<T, D, QT, NQ / 16>(dk, dsf, qh);  // dk += dsᵀ·q
          wgmma_wait();
        }
        release(s_empty + 8 * s, lane);
        ++sr.n;
      }

      // Epilogue: dk·scale and dv into this consumer's own k and v rows (no
      // longer read), then one TMA store per column box of each, clipping
      // keys past Sk.
      stage_rows<T, I, D>(kbuf, dk, p.scale, rl, t);
      stage_rows<T, I, D>(vbuf, dv, 1.f, rl, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg);
      if (tid == 0) {
        if (wg_key0 < p.Sk) {
          for (int c = 0; c < I::PARTS; ++c) {
            const uint32_t off = c * I::PART + 64 * wg * I::W;
            tma_store(&tdk, kbuf + off, c * I::BOX, wg_key0, it.h, it.b);
            tma_store(&tdv, vbuf + off, c * I::BOX, wg_key0, it.h, it.b);
          }
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        mbar_arrive(kv_empty + 8 * ks);  // the item buffer may be loaded again
      }
      ++kr.n;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core path.  Lane pair (2i, 2i+1) of a warp owns one of the
// warp's 16 rows: each lane takes every other row of the streamed tile and
// accumulates half of the owned row's Dh gradient columns.
// ---------------------------------------------------------------------------

constexpr int ROWS = 64;      // rows of the owned operand per block
constexpr int BK = 64;        // key rows per streamed tile of the dq pass
constexpr int WARPS = 4;      // each warp owns ROWS / WARPS = 16 rows
constexpr int THREADS = WARPS * 32;

// Query rows streamed per tile by the dk/dv pass, chosen so that no
// instance spills: two [Dh / 2] accumulators a thread beside its score rows.
template <int D>
struct DkvRows {
  static constexpr int value = D >= 128 ? 16 : 32;
};

template <int D>
struct Pitch {  // 4 floats of padding a row: no bank conflicts, 16-byte rows
  static constexpr int value = D + 4;
};

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
template <int D, int NR>
__device__ __forceinline__ void load_tile(float* smem, const float* g, long long ss, int row0,
                                          int nrows) {
  constexpr int CHUNKS = D / 4;
  constexpr int LD = Pitch<D>::value;
  for (int idx = threadIdx.x; idx < NR * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) val = *reinterpret_cast<const float4*>(g + (row0 + r) * ss + c);
    *reinterpret_cast<float4*>(smem + r * LD + c) = val;
  }
}

// For the NR query rows [row0, row0 + NR) whose do is in sDO: lse into sLse
// and delta = sum_d do·o (o read from device memory) into sDelta; 0 for
// both past `nrows`.  THREADS / NR threads share a row.
template <int D, int NR>
__device__ __forceinline__ void row_stats(float* sLse, float* sDelta, const float* sDO,
                                          const float* og, long long o_ss, const float* lse,
                                          int row0, int nrows) {
  constexpr int TPR = THREADS / NR;
  constexpr int PER = D / TPR;
  constexpr int LD = Pitch<D>::value;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int row = row0 + r;
  float acc = 0.f;
  if (row < nrows) {
    const float* orow = og + row * o_ss + part * PER;
    const float* drow = sDO + r * LD + part * PER;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc = fmaf(drow[i], orow[i], acc);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    sDelta[r] = acc;
    sLse[r] = row < nrows ? lse[row] : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32(Params p) {
  constexpr int LD = Pitch<D>::value;
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
  load_tile<D, ROWS>(sQ, base<float>(p, Q, b, h), p.st[Q][2], q0, p.Sq);
  load_tile<D, ROWS>(sDO, base<float>(p, DO, b, h), p.st[DO][2], q0, p.Sq);
  __syncthreads();
  row_stats<D, ROWS>(sLse, sDelta, sDO, base<float>(p, O, b, h), p.st[O][2],
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
    load_tile<D, BK>(sK, kg, p.st[K][2], k0, p.Sk);
    load_tile<D, BK>(sV, vg, p.st[V][2], k0, p.Sk);
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
  constexpr int LD = Pitch<D>::value;
  constexpr int HALF = D / 2;
  constexpr int BQ = DkvRows<D>::value;
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
  load_tile<D, ROWS>(sK, base<float>(p, K, b, h), p.st[K][2], k0, p.Sk);
  load_tile<D, ROWS>(sV, base<float>(p, V, b, h), p.st[V][2], k0, p.Sk);

  float dk[HALF], dv[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) dk[c] = dv[c] = 0.f;

  const float4* k4 = reinterpret_cast<const float4*>(sK + lrow * LD);
  const float4* v4 = reinterpret_cast<const float4*>(sV + lrow * LD);
  const int nq = (p.Sq + BQ - 1) / BQ;
  for (int j = p.causal ? k0 / BQ : 0; j < nq; ++j) {
    const int qs = j * BQ;
    __syncthreads();
    load_tile<D, BQ>(sQ, qg, p.st[Q][2], qs, p.Sq);
    load_tile<D, BQ>(sDO, dog, p.st[DO][2], qs, p.Sq);
    __syncthreads();
    row_stats<D, BQ>(sLse, sDelta, sDO, og, p.st[O][2], lse, qs, p.Sq);
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

cudaError_t launch_f32(void (*kernel)(Params), const Params& p, int smem, int tiles,
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

template <int D>
cudaError_t run_f32(const Params& p, cudaStream_t s) {
  constexpr int LD = Pitch<D>::value;
  constexpr int BQ = DkvRows<D>::value;
  if (p.out[0] != nullptr) {
    const int smem = (2 * ROWS + 2 * BK) * LD * (int)sizeof(float) + 2 * ROWS * (int)sizeof(float);
    const cudaError_t e = launch_f32(flash_bwd_dq_f32<D>, p, smem, (p.Sq + ROWS - 1) / ROWS, s);
    if (e != cudaSuccess) return e;
  }
  if (p.out[1] != nullptr) {
    const int smem = (2 * ROWS + 2 * BQ) * LD * (int)sizeof(float) + 2 * BQ * (int)sizeof(float);
    return launch_f32(flash_bwd_dkv_f32<D>, p, smem, (p.Sk + ROWS - 1) / ROWS, s);
  }
  return cudaSuccess;
}

// The persistent grid of one pass: as many blocks as the card holds at
// once, at most one per work item.
template <typename Kernel, typename... Maps>
cudaError_t launch_tma(Capacity& cache, Kernel kernel, int smem, long long items,
                       cudaStream_t stream, const Params& p, const Maps&... maps) {
  if (items <= 0) return cudaSuccess;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  long long capacity = 0;
  const cudaError_t e = grid_capacity(cache, kernel, TMA_THREADS, smem, &capacity);
  if (e != cudaSuccess) return e;
  const long long grid = items < capacity ? items : capacity;
  kernel<<<(unsigned)grid, TMA_THREADS, smem, stream>>>(maps..., p);
  return cudaGetLastError();
}

// Both passes (or the one asked for) from one set of tensor maps, encoded
// once per call: q, o, do (and dq) over Sq rows, k, v (and dk, dv) over Sk,
// all with MAP_ROWS-row boxes.
template <typename T, int D>
cudaError_t run_tma(const Params& p, cudaStream_t stream) {
  if (p.Sq == 0 && p.Sk == 0) return cudaSuccess;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  const bool dq = p.out[0] != nullptr, dkv = p.out[1] != nullptr;
  const CUtensorMapDataType type = map_type<T>();
  CUtensorMap m[8];
  auto enc = [&](int which, const void* ptr, int S) {
    return encode<D>(&m[which], type, ptr, S, p.H, p.B, p.st[which][2], p.st[which][1],
                     p.st[which][0], MAP_ROWS);
  };
  bool ok = true;
  if (p.Sq > 0) {
    ok = enc(Q, p.in[Q], p.Sq) && enc(O, p.in[O], p.Sq) && enc(DO, p.in[DO], p.Sq) &&
         (!dq || enc(DQ, p.out[0], p.Sq));
  }
  if (p.Sk > 0) {
    ok = ok && enc(K, p.in[K], p.Sk) && enc(V, p.in[V], p.Sk) &&
         (!dkv || (enc(DK, p.out[1], p.Sk) && enc(DV, p.out[2], p.Sk)));
  }
  if (!ok) return cudaErrorInvalidValue;
  // a map needs a nonempty extent; the side of length 0 is never loaded
  if (p.Sq == 0) m[Q] = m[O] = m[DO] = m[DQ] = m[K];
  if (p.Sk == 0) m[K] = m[V] = m[DK] = m[DV] = m[Q];
  const long long bh = (long long)p.B * p.H;
  if (dq) {
    static Capacity cache;
    const cudaError_t e =
        launch_tma(cache, flash_bwd_dq_tma<T, D>, DqTiles<D>::SMEM, bh * ((p.Sq + BM - 1) / BM),
                   stream, p, m[Q], m[K], m[V], m[O], m[DO], m[DQ]);
    if (e != cudaSuccess) return e;
  }
  if (dkv) {
    static Capacity cache;
    return launch_tma(cache, flash_bwd_dkv_tma<T, D>, DkvTiles<D>::SMEM,
                      bh * ((p.Sk + BM - 1) / BM), stream, p, m[Q], m[K], m[V], m[O], m[DO],
                      m[DK], m[DV]);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_tma(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 16: return run_tma<T, 16>(p, s);
    case 32: return run_tma<T, 32>(p, s);
    case 64: return run_tma<T, 64>(p, s);
    case 128: return run_tma<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 16: return run_f32<16>(p, s);
    case 32: return run_f32<32>(p, s);
    case 64: return run_f32<64>(p, s);
    case 128: return run_f32<128>(p, s);
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
    case 1: return (int)dispatch_tma<__half>(p, D, s);
    case 2: return (int)dispatch_tma<__nv_bfloat16>(p, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
