// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C entry
// point loaded through ctypes by incubator_mxnet_torch/ops/attention.py.
//
// Replaces: the JAX package's ops/attention.py:_fwd_kernel (the Pallas
// kernel launched by _flash_fwd_pallas).  Same function: o = softmax(q·kᵀ·scale)·v
// with an online softmax over streamed K/V tiles, fp32 scores and sums, p cast
// to v's type before p·v, o in q's type, optional per-row log-sum-exp, causal
// masking q_pos >= k_pos (top-left aligned) that skips K tiles wholly in the
// future, and o = 0, lse = 0 for a row with no visible key.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// BERT-base shape (B=64, S=128, H=12, Dh=64, bf16, non-causal) one launch must
// move q, k, v and o, 4 x 12.6 MB = 50.3 MB, which takes 15.0 us at the
// memory rate; its 3.2 GFLOP take 3.3 us on the tensor cores.  So it is bound
// by bytes, and what matters is keeping enough loads in flight on every SM,
// all the time, and reading each byte once.
//
// The 16-bit design (flash_fwd_tma) does that:
// * Persistent grid.  A work item is 128 query rows of one (batch, head);
//   as many blocks as fit on the card at once walk the item list with a
//   static stride (item = blockIdx.x + i * gridDim.x: deterministic, no
//   atomics).  At S <= 128 an item holds every query row of its head, so K
//   and V are read from memory once per head.  Causal launches take the
//   items with the most K tiles first; otherwise a head's query tiles are
//   neighbours, so its K/V re-reads come from L2.
// * TMA loads into rings of shared-memory stages tracked by mbarriers: one
//   producer thread issues cp.async.bulk.tensor for Q (two buffers) and
//   for each 128-row K and V tile (two stages), and runs ahead across
//   work items, so the next item's Q, K and V are in flight while the
//   consumers compute this one and store its o.  A Q buffer is released
//   after the item's last q·kᵀ, a K/V stage after its p·v.  The producer
//   also hands each item's coordinates to the consumers beside its Q
//   buffer, so they do no index arithmetic.  The tensor maps are 4-D over
//   (Dh, S, H, B) with the caller's strides, so the [B, S, 3, H, Dh] QKV
//   view is read with no copy; TMA fills rows past S with zeros (keys past
//   Sk are still masked: a zero key scores 0).
// * Warpgroup products.  Two consumer warpgroups own 64 query rows each:
//   s = q·kᵀ is wgmma m64n128k16 with both operands in shared memory
//   (K-major), o += p·v is wgmma m64nDhk16 with p from registers (rounded
//   to v's type) and V in shared memory (MN-major); accumulators in fp32.
//   TMA's swizzle (128 B for Dh 64/128, 64 B for 32, 32 B for 16; Dh=128
//   as two 64-column boxes) is the layout the wgmma descriptors name.
//   setmaxnreg moves registers from the producer to the consumers.
// * scale·log2(e) folded into one multiply and ex2; the mask is tested
//   only on tiles with a key tail or crossing the causal diagonal.
// * o is divided by the row sums in registers, written to the consumer's
//   staging buffer in the swizzled layout and stored by one TMA store,
//   which clips rows past Sq; lse is written once per row.
// Stage and phase counters live in one place (Ring): the n-th use of a
// ring slot waits on parity (n / slots) & 1, producer and consumers alike.
//
// What the card shows (PERF.md): at the BERT shape the kernel reaches
// about three quarters of its bytes bound; at S=512, where each item
// streams four K/V tiles, it reaches about a third, held by each
// consumer's serial chain of q·kᵀ, softmax (one ex2 a score) and p·v per
// tile, which no other warpgroup's work overlaps.
//
// fp32 runs on the CUDA cores in full fp32 (flash_fwd_f32): a block of 4
// warps per (batch*head, 64 query rows), K/V tiles staged synchronously.

#include <math.h>

#include <type_traits>

#include "flash_tma.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B*H, Sq] or null
  int B, H, Sq, Sk;
  // element strides: batch, head, sequence (Dh has unit stride)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// 16-bit types: persistent, TMA-fed, warpgroup-MMA path
// ---------------------------------------------------------------------------

constexpr int BM = 128;         // query rows of a work item
constexpr int BN = 128;         // keys of a K/V tile
constexpr int CONSUMERS = 2;    // consumer warpgroups, 64 query rows each
constexpr int TMA_THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;  // setmaxnreg: 40·128 + 232·256 <= 65536
constexpr int CONSUMER_REGS = 232;

template <int D>
struct Tile : Box<D, BN> {
  using Box<D, BN>::BYTES;
  static constexpr int OBYTES = BYTES / CONSUMERS;  // a consumer's o staging buffer
  static constexpr int QS = 2;                 // Q buffers
  static constexpr int KVS = 2;                // K/V stages
  static constexpr int BARRIERS = 2 * QS + 3 * KVS;
  // tiles, o staging, barriers, a 16-byte Item per Q buffer, and slack to
  // align the base to 1024 bytes
  static constexpr int SMEM =
      (QS + 2 * KVS) * BYTES + CONSUMERS * OBYTES + BARRIERS * 8 + QS * 16 + 1024;
};

// The products of a consumer, each one fenced and committed wgmma group:
// s = q·kᵀ (m64n128k16, K-major q and k) and o += p·v (m64nDhk16, p from
// registers, MN-major v).
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t qa, uint32_t ks) {
  issue_ss<T, D, Tile<D>, Tile<D>, BN>(sc, qa, ks);
}

template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[BN / 16][4],
                                         uint32_t vs) {
  issue_rs<T, D, Tile<D>, BN / 16>(o, pf, vs);
}

// Online softmax of one tile (online_softmax_update in the JAX package), in
// log2 units: the scores in sc become p = 2^(s·scale·log2e − m), masked
// only where a key tail or the causal diagonal cuts the tile; m and l move
// on, and corr is what the earlier o must be multiplied by.  For scale > 0
// the row max of the raw scores times sl2 is the max of the scaled ones and
// one fma scales each score on its way into ex2; a zero or negative scale
// (a branch uniform over the launch) scales the scores before the mask and
// the max, so masked keys stay at −inf and the max is of what ex2 sees.
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int row0, int wg_row0,
                                             const Params& p, float sl2, int t) {
  float mul = sl2;
  if (!(sl2 > 0.f)) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sc[e] *= sl2;
    mul = 1.f;
  }
  if (k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > wg_row0)) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        if (col >= p.Sk || (p.causal && col > row)) sc[4 * n + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
      mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx) * mul);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = exp2_ftz(m[r] - m_safe);
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float pe = exp2_ftz(fmaf(sc[4 * n + e], mul, -m_safe));
        sc[4 * n + e] = pe;
        rs += pe;
      }
    l[r] = l[r] * corr[r] + quad_sum(rs);
    m[r] = m_new;
  }
}

// o *= corr per row, and p cast to v's type as the A operand of p·v.
template <typename T, int D>
__device__ __forceinline__ void rescale_and_pack(float (&o)[D / 2], uint32_t (&pf)[BN / 16][4],
                                                 const float (&sc)[BN / 2],
                                                 const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
  pack_a<T>(pf, sc);
}

struct Item {
  int b, h, q0, nk;
};
static_assert(sizeof(Item) == 16, "Tile<D>::SMEM keeps 16 bytes per Item");

// Work item i: causal launches walk the query tiles from the last (most K
// tiles) down; the others keep a head's query tiles side by side.
__device__ __forceinline__ Item work_item(int i, const Params& p, int nqt) {
  const int bhn = p.B * p.H;
  int bh, qt;
  if (p.causal) {
    qt = nqt - 1 - i / bhn;
    bh = i % bhn;
  } else {
    bh = i / nqt;
    qt = i % nqt;
  }
  Item it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.q0 = qt * BM;
  it.nk = (p.Sk + BN - 1) / BN;
  if (p.causal) it.nk = min(it.nk, (min(it.q0 + BM, p.Sq) + BN - 1) / BN);
  return it;
}

template <typename T, int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_fwd_tma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                  Params p) {
  using L = Tile<D>;
  extern __shared__ unsigned char smem_tma[];
  const uint32_t base = (smem_addr(smem_tma) + 1023u) & ~1023u;
  const uint32_t sq = base;                                // QS buffers
  const uint32_t skv = sq + L::QS * L::BYTES;               // KVS stages of K then V
  const uint32_t so = skv + 2 * L::KVS * L::BYTES;          // o staging, one per consumer
  const uint32_t bars = so + CONSUMERS * L::OBYTES;
  const uint32_t q_full = bars, q_empty = q_full + 8 * L::QS;
  const uint32_t k_full = q_empty + 8 * L::QS, v_full = k_full + 8 * L::KVS;
  const uint32_t kv_empty = v_full + 8 * L::KVS;
  // The producer hands each item's coordinates over beside its Q buffer:
  // written before the arrival on q_full, read after the wait on it.
  Item* const items_of_q = reinterpret_cast<Item*>(
      smem_tma + (kv_empty + 8 * L::KVS - smem_addr(smem_tma)));

  const int nqt = (p.Sq + BM - 1) / BM;
  const int items = p.B * p.H * nqt;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::QS; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int i = 0; i < L::KVS; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, CONSUMERS * 4);
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
        const Item it = work_item(i, p, nqt);
        // an operand expanded over heads or batch (stride 0) has extent 1
        // there in its map, so it is read at coordinate 0
        const int qh = p.q_sh ? it.h : 0, qb = p.q_sb ? it.b : 0;
        const int kh = p.k_sh ? it.h : 0, kb = p.k_sb ? it.b : 0;
        const int vh = p.v_sh ? it.h : 0, vb = p.v_sb ? it.b : 0;
        const int qs = qr.slot();
        mbar_wait(q_empty + 8 * qs, qr.parity() ^ 1u);
        items_of_q[qs] = it;
        mbar_expect_tx(q_full + 8 * qs, L::BYTES);
        for (int c = 0; c < L::PARTS; ++c)
          tma_load(sq + qs * L::BYTES + c * L::PART, &tq, q_full + 8 * qs, c * L::BOX, it.q0,
                   qh, qb);
        ++qr.n;
        for (int j = 0; j < it.nk; ++j) {
          const int s = kvr.slot();
          const uint32_t ks = skv + 2 * s * L::BYTES, vs = ks + L::BYTES;
          mbar_wait(kv_empty + 8 * s, kvr.parity() ^ 1u);
          mbar_expect_tx(k_full + 8 * s, L::BYTES);
          for (int c = 0; c < L::PARTS; ++c)
            tma_load(ks + c * L::PART, &tk, k_full + 8 * s, c * L::BOX, j * BN, kh, kb);
          mbar_expect_tx(v_full + 8 * s, L::BYTES);
          for (int c = 0; c < L::PARTS; ++c)
            tma_load(vs + c * L::PART, &tv, v_full + 8 * s, c * L::BOX, j * BN, vh, vb);
          ++kvr.n;
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows [64·wg, 64·wg + 64) of each item.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row_local = 64 * wg + 16 * warp + g;  // and row_local + 8
    const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units
    Ring<L::QS> qr;
    Ring<L::KVS> kvr;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const int qs = qr.slot();
      mbar_wait(q_full + 8 * qs, qr.parity());
      const Item it = items_of_q[qs];
      const int row0 = it.q0 + row_local;
      const int wg_row0 = it.q0 + 64 * wg;
      const uint32_t qa = sq + qs * L::BYTES + 64 * wg * L::W;  // this consumer's q rows

      float o[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
      float l[2] = {0.f, 0.f};

      if (it.nk == 0) release(q_empty + 8 * qs, lane);
      for (int j = 0; j < it.nk; ++j) {
        const int s = kvr.slot();
        const uint32_t par = kvr.parity();
        const uint32_t ks = skv + 2 * s * L::BYTES, vs = ks + L::BYTES;
        float sc[BN / 2], corr[2];
        uint32_t pf[BN / 16][4];
        mbar_wait(k_full + 8 * s, par);
        issue_qk<T, D>(sc, qa, ks);
        wgmma_wait();
        if (j == it.nk - 1) release(q_empty + 8 * qs, lane);  // q is no longer read
        softmax_tile(sc, m, l, corr, j * BN, row0, wg_row0, p, sl2, t);
        rescale_and_pack<T, D>(o, pf, sc, corr);
        mbar_wait(v_full + 8 * s, par);
        issue_pv<T, D>(o, pf, vs);
        wgmma_wait();
        release(kv_empty + 8 * s, lane);
        ++kvr.n;
      }

      // Epilogue: o / l into this consumer's staging buffer, in the swizzled
      // layout of the o map, then one TMA store, which clips rows past Sq.
      // The buffer is rewritten only after the previous item's store has
      // read it.
      const uint32_t obuf = so + wg * L::OBYTES;
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lsum = l[r] == 0.f ? 1.f : l[r];
        const float inv = 1.f / lsum;
        const int rl = 16 * warp + g + 8 * r;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int col = n * 8 + 2 * t;
          const uint32_t at = obuf + (col / L::BOX) * (L::OBYTES / L::PARTS) +
                              swizzled<L::W>(rl, (col % L::BOX) / 8) + (col % 8) * 2;
          const uint32_t v = pack2<T>(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
        }
        const int row = row0 + 8 * r;
        if (p.lse != nullptr && t == 0 && row < p.Sq)
          p.lse[(long long)(it.b * p.H + it.h) * p.Sq + row] =
              (m[r] == -INFINITY ? 0.f : m[r] * 0.6931471805599453f) + logf(lsum);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (tid == 0 && wg_row0 < p.Sq) {
        for (int c = 0; c < L::PARTS; ++c)
          tma_store(&to, obuf + c * (L::OBYTES / L::PARTS), c * L::BOX, wg_row0, it.h, it.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      ++qr.n;
    }
    // the last store has read its buffer (its writes need no wait)
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core path
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per shared-memory tile
constexpr int WARPS = 4;      // each warp owns BQ / WARPS = 16 query rows
constexpr int THREADS = WARPS * 32;

// Shared-memory row pitch: 16 bytes of padding keeps the fragment loads free
// of bank conflicts and every row 16-byte aligned.
template <typename T, int D>
struct Pitch {
  static constexpr int value = D + 16 / (int)sizeof(T);
};

// Copy rows [row0, row0 + 64) of one (batch, head) into shared memory,
// 16 bytes per thread and step; rows at or past `nrows` become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* smem, const T* g, long long ss, int row0,
                                          int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = Pitch<T, D>::value;
  for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) val = *reinterpret_cast<const uint4*>(g + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(smem + r * LD + c) = val;
  }
}

// Lane pair (2i, 2i+1) of a warp owns one of the warp's 16 query rows: each
// lane scores every other key of a tile and accumulates half of the row's Dh
// output columns.
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Params p) {
  constexpr int LD = Pitch<float, D>::value;
  constexpr int HALF = D / 2;
  constexpr int KPL = BK / 2;  // keys scored per lane and tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * BQ;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;
  const int lrow = warp * 16 + (lane >> 1);
  const int row = q0 + lrow;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<float, D>(sQ, qg, p.q_ss, q0, p.Sq);

  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (min(q0 + BQ, p.Sq) + BK - 1) / BK);

  const float4* q4 = reinterpret_cast<const float4*>(sQ + lrow * LD);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<float, D>(sK, kg, p.k_ss, k0, p.Sk);
    load_tile<float, D>(sV, vg, p.v_ss, k0, p.Sk);
    __syncthreads();

    float s[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qv = q4[d4];
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float4 kv = reinterpret_cast<const float4*>(sK + (2 * i + half) * LD)[d4];
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int col = k0 + 2 * i + half;
      const bool masked = col >= p.Sk || (p.causal && col > row);
      s[i] = masked ? -INFINITY : s[i] * p.scale;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      s[i] = s[i] == -INFINITY ? 0.f : expf(s[i] - m_safe);
      rs += s[i];
    }
    l = l * corr + rs + __shfl_xor_sync(0xffffffffu, rs, 1);
    m = m_new;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= corr;

    const float* vcol = sV + half * HALF;
#pragma unroll 4
    for (int i = 0; i < KPL; ++i) {
      const float mine = s[i];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      const float p0 = half ? other : mine;  // key 2i
      const float p1 = half ? mine : other;  // key 2i + 1
      const float* v0 = vcol + (2 * i) * LD;
#pragma unroll
      for (int c = 0; c < HALF; ++c) acc[c] = fmaf(p1, v0[LD + c], fmaf(p0, v0[c], acc[c]));
    }
  }

  if (row >= p.Sq) return;
  const float lsum = l == 0.f ? 1.f : l;
  float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; ++c) orow[c] = acc[c] / lsum;
  if (p.lse != nullptr && half == 0)
    p.lse[(long long)bh * p.Sq + row] = (m == -INFINITY ? 0.f : m) + logf(lsum);
}


template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * Pitch<float, D>::value * (int)sizeof(float);
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (long long)p.B * p.H * ((p.Sq + BQ - 1) / BQ);
  if (blocks <= 0) return cudaSuccess;
  flash_fwd_f32<D><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_f32<16>(p, s);
    case 32: return launch_f32<32>(p, s);
    case 64: return launch_f32<64>(p, s);
    case 128: return launch_f32<128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The persistent grid: as many blocks as the card holds at once, at most
// one per work item.  The tensor maps hold the call's pointers and are
// encoded on every call.
template <typename T, int D>
cudaError_t launch_tma(const Params& p, cudaStream_t stream) {
  using L = Tile<D>;
  const long long items = (long long)p.B * p.H * ((p.Sq + BM - 1) / BM);
  if (items <= 0) return cudaSuccess;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  const CUtensorMapDataType type = map_type<T>();
  CUtensorMap tq, tk, tv, to;
  bool ok = encode<D>(&tq, type, p.q, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, BM) &&
            encode<D>(&to, type, p.o, p.Sq, p.H, p.B, p.o_ss, p.o_sh, p.o_sb, BM / CONSUMERS);
  if (p.Sk > 0) {
    ok = ok && encode<D>(&tk, type, p.k, p.Sk, p.H, p.B, p.k_ss, p.k_sh, p.k_sb, BN) &&
         encode<D>(&tv, type, p.v, p.Sk, p.H, p.B, p.v_ss, p.v_sh, p.v_sb, BN);
  } else {  // no K/V tile is ever loaded; a map needs a nonempty extent
    tk = tq;
    tv = tq;
  }
  if (!ok) return cudaErrorInvalidValue;
  static Capacity cache;
  long long capacity = 0;
  const cudaError_t e =
      grid_capacity(cache, flash_fwd_tma<T, D>, TMA_THREADS, L::SMEM, &capacity);
  if (e != cudaSuccess) return e;
  const long long grid = items < capacity ? items : capacity;
  flash_fwd_tma<T, D><<<(unsigned)grid, TMA_THREADS, L::SMEM, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tma(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_tma<T, 16>(p, s);
    case 32: return launch_tma<T, 32>(p, s);
    case 64: return launch_tma<T, 64>(p, s);
    case 128: return launch_tma<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  strides: 12 element
// strides, (batch, head, sequence) for q, k, v and o in that order.
// Returns the cudaError_t of the launch (0 on success); never synchronises.
extern "C" int mx_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int H, int Sq, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
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
