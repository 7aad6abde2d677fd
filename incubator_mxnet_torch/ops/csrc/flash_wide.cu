// Flash attention for head dims above 256 on NVIDIA Hopper (sm_90a): the
// forward (flash_wide_fwd: o and lse) and the two backward passes
// (flash_wide_bwd_dq: dq; flash_wide_bwd_dkv: dk and dv), with plain C entry
// points loaded through ctypes by incubator_mxnet_torch/ops/attention.py;
// and fp32, forward and backward, at every head dim.
//
// Replaces: the JAX package's ops/attention.py:_fwd_kernel, _bwd_dq_kernel
// and _bwd_dkv_kernel at the head dims that flash_fwd.cu and flash_bwd.cu
// have no instance for, and in fp32 all three at every head dim (those two
// files hold 16-bit kernels only).  The JAX function takes any head dim; the wrapper
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
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// [B, S, H, Dh] = [4, 512, 8, 512] bf16 the forward must move 67 MB (20 us)
// for 17.2 GFLOP (17 us), the dq pass 101 MB (30 us) for 25.8 GFLOP
// (26 us), the dk/dv pass 118 MB (35 us) for 34 GFLOP (35 us): all sit
// where bytes and tensor-core operations take about the same time, so the
// products must run on wgmma, fed by loads kept in flight.  What makes a
// wide head hard is room: a 64-row 16-bit tile is 40-64 KB at Dh 320-512
// (a block has 227 KB of shared memory), and a 64 x 512 fp32 accumulator
// is 256 registers a thread of a warpgroup (the most a thread may hold is
// 255), so no warpgroup holds a whole row of o, dq, dk or dv: each output
// is split by columns between the two consumer warpgroups.
//
// The 16-bit forward (flash_wide_fwd_tma), Dh = 64·P, P = 5..8:
// * A work item is 64 query rows of one (batch, head), walked by a
//   persistent grid with a static stride (no atomics; causal launches take
//   the items with the most key tiles first).  Two consumer warpgroups share
//   the item's rows and split the head's P column boxes: consumer 0 takes
//   the first ceil(P/2) (N0 = 64·ceil(P/2) columns), consumer 1 the rest
//   (N1).  Each computes its part of s = q·kᵀ over its own columns (wgmma
//   m64n64k16, q and k K-major in shared memory), hands the fp32 partial
//   to the other through shared memory and adds the other's: fp32 addition
//   commutes, so both hold the same scores, run the same online softmax and
//   accumulate o over their own columns (wgmma m64nN0k16, p from registers
//   rounded to v's type, v MN-major): o is 64 x N0 fp32, N0/2 <= 128
//   registers a thread beside 32 of scores and 16 of p.  Nothing is
//   computed twice but the softmax.
// * Shared memory at Dh 512: the item's Q tile (64 KB, released after its
//   last q·kᵀ), for each consumer a ring of two slots of 64 x N0 (its half
//   of a 64-key K tile, then of the V tile: 4 x 32 KB), and the two
//   partial-score buffers (2 x 16 KB): 224 KB, plus barriers and alignment
//   230,480 bytes of the 232,448.  A producer thread fills the rings by TMA
//   (128-byte swizzle, 64-column boxes) and runs ahead: K of tile j+1 loads
//   while p·v of tile j runs, V of tile j+1 while q·kᵀ of tile j+1 runs.  o
//   is divided by the row sums, staged in the consumer's last V slot and
//   written by TMA stores, which clip rows past Sq.
// The 16-bit dq pass (flash_wide_bwd_dq_tma):
// * A work item is 64 query rows of one (batch, head), as the forward's
//   (the same order; each stops at its last visible key tile).  The item's
//   Q and dO tiles stay in shared memory (2 x 64 KB at Dh 512), loaded once.
//   For each 64-key tile, consumer 0 computes s = q·kᵀ over the head and p
//   = 2^(s·scale·log2e − lse·log2e), consumer 1 dp = do·vᵀ and dp − delta
//   (both wgmma m64n64k16 from shared memory, a k box or a v box a ring
//   slot); the two swap p and dp − delta through two fp32 buffers (2 x 16
//   KB; two named barriers a tile) and both form ds = p∘(dp − delta), the
//   same fp32 products, so the same bits, rounded to q's type.  Each then
//   accumulates its half of dq's columns, dq += ds·k (wgmma m64n64k16, ds
//   the register A operand, the k box MN-major): consumer 0 the first
//   ceil(P/2) boxes, consumer 1 the rest, each box from a product slot that
//   carries k boxes x and ceil(P/2) + x side by side, so every slot has one
//   size (16 KB).  Each product is done once: s, dp and ds·k are the three
//   S²·Dh products the pass needs.  The swap rather than a hand-over of p
//   one way and ds back: one exchange point a tile, not two in series.
// * Shared memory at Dh 512: Q and dO 128 KB, the exchange 32 KB and 4
//   slots of 16 KB: 230,480 bytes (7 slots at Dh 320).  Registers: dq is
//   64 x 256 fp32, 128 a thread, beside 32 of scores and 16 of ds
//   fragments, the forward's budget.  At the end each consumer stages its
//   dq boxes (times scale) in the tile only it read, consumer 0 in Q and 1
//   in dO, and TMA stores clip rows past Sq.
// The 16-bit dk/dv pass (flash_wide_bwd_dkv_tma):
// * A work item is 64 keys of one (batch, head) and one slab of dk and dv:
//   slab 0 the first ceil(P/2) column boxes, slab 1 the rest, so the two
//   items of a key tile sit side by side in the item order.  Consumer 0
//   computes sᵀ = k·qᵀ over the whole head, pᵀ = exp(s·scale − lse), and
//   accumulates dv += pᵀ·do over its slab; consumer 1 computes dpᵀ = v·doᵀ,
//   takes pᵀ (fp32) from consumer 0 through shared memory, forms dsᵀ =
//   pᵀ·(dpᵀ − delta) and accumulates dk += dsᵀ·q over the slab.  Per 64 x 64
//   block of scores a slab item does 2·(64·64·Dh) multiply-adds for sᵀ and
//   dpᵀ and 2·(64·64·Dh/2) for its slab of dv and dk; the two slab items
//   together do 6 units where 4 are needed (1.5x), since no warpgroup can
//   hold dk or dv whole (64 x 512 fp32).
// * K and V of the item stay in shared memory (2 x 64 KB at Dh 512); q and
//   do stream through a ring of slots, each one 64-column box of 64 query
//   rows of both (16 KB): for every query tile the head's P boxes for the
//   reductions, then the slab's boxes again for the products.  With the
//   fp32 p buffer (16 KB) that leaves 5 slots at Dh 512, 8 at Dh 320
//   (DkvTiles::SLOTS).  Each consumer releases a slot as soon as its
//   product is done (wait_group 1 keeps one group in flight).  The
//   gradients are staged in the consumer's own K or V tile, no longer
//   read, and written by TMA stores that clip keys past Sk.
// * delta = rowsum(do∘o) is computed once a query row by one launch of its
//   own (flash_wide_bwd_delta, a warp a row or two, into an fp32 buffer the
//   wrapper allocates) before whichever backward passes a call runs, so
//   neither loads o and no item recomputes it.
// * setmaxnreg 40 / 232 moves registers from the producer to the
//   consumers (40·128 + 232·256 <= 65536).
// All three kernels are persistent (a block an SM), deterministic and hold
// one item's state in a block at a time.
// A 16-bit head above 512 (P > 8) runs the same three kernels instantiated
// at D = 512 and streamed (STREAM): no warpgroup can hold more than 256
// columns of o, dq, dk or dv (wgmma's widest N), and no whole-width tile
// fits beside the rings any more (64 rows of Dh 640 are 80 KB).
// * Forward: the slab of o becomes part of the work item, ceil(P/8) even
//   slabs of at most 8 boxes a query tile (4 a consumer).  Each slab item
//   computes the whole head's scores again: consumer 0 reduces over the
//   first ceil(P/2) boxes, consumer 1 over the rest, 4 boxes a round, each
//   round's q boxes in its half of the Q tile's room and its k boxes in its
//   K slot, behind the same full/empty pair; then the swap, softmax and p·v
//   over its boxes of the slab, as above.  q·kᵀ is done ceil(P/8) times.
// * dq: the same slabs of dq as items; s and dp are redone for each slab,
//   each reduction slot carrying a box of q, do, k and v (32 KB, 4 slots),
//   and each consumer stages its dq boxes in a buffer of 4 (2 x 32 KB) in
//   place of the Q and dO tiles.
// * dk/dv: ceil(P/4) even slabs of at most 4 boxes a key tile, an item
//   each; K and V are no longer resident: each reduction slot carries a box
//   of k and of v beside q's and do's (32 KB, 4 slots), and the gradients
//   are staged in two slab buffers (2 x 32 KB) where K and V were.
//
// What the card shows (PERF.md): at [4, 512, 8, 512] bf16 the forward
// reaches about two fifths of its bound and runs about 2.8x faster than
// SDPA's forward; probes that took parts out of copies of this source
// found its time in the chain of score swap and softmax (both consumers run
// it while the tensor cores wait), not in its loads.  The dq pass, its
// delta launch included, reaches about three tenths of its bound; taking
// out any one part (the reductions' or the products' wgmmas, the swap, the
// k and v loads) moved it by at most an eighth, so its time is the chain of
// small steps a key tile (a ring slot a box, one wgmma group in flight,
// two barriers), not one resource.  The dk/dv pass, delta launch included,
// reaches about a fifth of its bound.
//
// fp32 (MXNet's default dtype): wgmma has no full-fp32 product and plain
// TF32 keeps 10 bits of mantissa, far outside the fp32 bounds; so the fp32
// forward (flash_wide_fwd_f32_rows, flash_wide_fwd_f32), dq pass
// (flash_wide_bwd_dq_f32) and dk/dv
// pass (flash_wide_bwd_dkv_f32) run every product in split TF32 on the
// tensor cores: x = hi + lo, each fp32 product hi·hi′ + hi·lo′ + lo·hi′
// (three TF32 products, fp32 sums; lo·lo′ dropped), which errs by about
// 2^-20 of a product.  The tensor core reads a raw fp32 word as TF32 by
// truncation (probed on the card), so the raw word is hi and only lo = x −
// hi is formed, in registers: two instructions an element.  What bounds
// them: 3 x 17.2 (forward), 3 x 25.8 (dq) and 3 x 34.4 (dk/dv) GFLOP of
// TF32 at [4, 512, 8, 512], 0.104, 0.156 and 0.208 ms at 495 TFLOP/s,
// against 67 / 101 / 118 MB of bytes (0.02-0.035 ms).
// * fp32 runs here at every head dim, forward and backward, not only above
//   256: the wrapper pads a narrow head to a multiple of 64 (16, 32, 48 to
//   64; 80 to 128; 160 to 192), and the kernels take any count P of
//   64-column boxes from the call (P = 1 at BERT-base's Dh 64).
// * A head of at most 2 boxes (Dh <= 128) runs the forward on
//   flash_wide_fwd_f32_rows<P>: items of 128 query rows, each consumer 64 of
//   them over the whole head (the 16-bit flash_fwd_tma's structure), q
//   resident in shared memory for the item, k and v through one ring of
//   one-box slots that both consumers read.  No partial scores are swapped
//   and the softmax of a row runs once; at P = 1 the 64-row items below
//   would leave consumer 1 without a box of its own.  What bounds it at
//   BERT-base's [64, 128, 12, 64]: 100.7 MB of q, k, v and o (0.030 ms at
//   3.35 TB/s) against 3 x 3.22 GFLOP of TF32 (0.0195 ms): bytes.  There
//   it takes about 0.07 ms against flash_wide_fwd_f32's 0.10 and SDPA's
//   0.13; at Dh 192 and 256 flash_wide_fwd_f32 was faster (an item's 96 or
//   128 KB of q leave one q buffer and a ring shorter than a key tile's k
//   and v; PERF.md), so wider heads run it.
// * The wider forward's items are the 16-bit kernels': 64 query rows and a slab
//   of at most 6 boxes of o (3 a consumer: 4, 128 registers of o beside 32
//   of scores, made ptxas spill; so Dh 448 and 512 take two slab items,
//   each computing the scores), the consumers splitting the head's boxes
//   and swapping fp32 partial scores.  The dq pass has the same items with
//   slabs of at most 8 boxes (one slab up to Dh 512): for each key tile
//   consumer 0 reduces s = q·kᵀ and consumer 1 dp = do·vᵀ over the whole
//   head, they swap p and dp − delta (as the 16-bit dq pass does) and each
//   accumulates the 32-column half of its own of every box of the slab, dq
//   += ds·k (128 registers at 8 boxes, as a dk/dv consumer holds; heads of
//   at most 2 boxes run an instance of 2, which holds the item's
//   coordinates where the one of 8 recomputes them a tile): the two do
//   equal products at every P, odd and P = 1 too, where a split by boxes
//   would leave one idle.  dk/dv's slab
//   items of a key tile (ceil(P/4) slabs of at most 4 boxes; one at P <=
//   4), consumer 0 computing sᵀ, pᵀ and dv, consumer 1 dpᵀ, dsᵀ (taking pᵀ
//   through shared memory) and dk.  Each score is computed once an item;
//   persistent grid, static stride, one producer thread, setmaxnreg 24 /
//   240 (all the block's registers).
// * A 64 x 64 fp32 box is two 32-column TMA boxes (128-byte swizzle), and no
//   whole fp32 tile fits (64 rows of Dh 512 are 128 KB), so every operand
//   streams: each consumer has its own ring of 3 slots of two boxes (a
//   reduction's A and B box, a product's B box, or up to four of the dq
//   pass's 32-column k halves), which also keeps the producer's count of a
//   consumer's slots exact when P is odd.
// * wgmma takes TF32 operands K-major only, and p·v, ds·k, pᵀ·do and dsᵀ·q
//   reduce over the sequence (v, k, do and q MN-major).  So the products
//   run on mma.sync.m16n8k8.tf32, whose fragments each lane reads itself:
//   by ldmatrix for the K-major reductions (a 16-byte row of 16-bit pairs
//   is 4 fp32 values, a TF32 fragment row), by 32-bit loads for the
//   MN-major ones, both conflict-free in the swizzled rows.  The
//   accumulator's pairs (columns 2t, 2t + 1) become the A fragment of the
//   next product (columns t, t + 4) by permuting the reduction index within
//   each step of 8.
// * o, dq, dk and dv are stored straight from the registers (row and key
//   tails masked); delta = rowsum(do∘o) comes from the call's one delta
//   launch.

#include <math.h>

#include "flash_tma.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* lse;    // written by the forward (or null), read by the backward
  float* delta;  // rowsum(do*o), [B*H, Sq]: written by the delta pass, read by dq and dk/dv
  void* out;     // o (fwd) or dq
  void* dk;
  void* dv;
  int B, H, Sq, Sk, D;  // D: the padded head dim, a multiple of 64
  // element strides (batch, head, sequence) of q, k, v, o, do, out, dk, dv
  long long st[8][3];
  float scale;
  int causal;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, OUT = 5, DK = 6, DV = 7 };

// The first element of (batch b, head h) of operand `which`.
template <typename T>
__device__ __forceinline__ const T* base(const Params& p, int which, const void* ptr, int b,
                                         int h) {
  return static_cast<const T*>(ptr) + b * p.st[which][0] + h * p.st[which][1];
}

// ---------------------------------------------------------------------------
// 16-bit types: TMA rings and warpgroup MMA
// ---------------------------------------------------------------------------

constexpr int TMA_THREADS = 384;   // two consumer warpgroups, then the producer's
constexpr int PRODUCER_REGS = 40;  // setmaxnreg: 40·128 + 232·256 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int TILE = 64;           // query rows or keys of a tile (wgmma's M)
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// Named barriers (0 is __syncthreads): 1 + w a consumer warpgroup's own;
// 3 and 4 shared by both consumers.
enum { BAR_WG = 1, BAR_FREE = 3, BAR_FULL = 4 };

using BX = Box<64, TILE>;  // one 64-column box of a 64-row tile: 8 KB, 128-byte swizzle

// The head's P column boxes split between two warpgroups: B0 = ceil(P/2)
// for the first (its columns of q·kᵀ and o in the forward, slab 0 of dk and
// dv), B1 = floor(P/2) for the second.  The streamed instance (a head above
// 512) is D = 512: its shapes are the most one item holds, P comes from the
// call.
template <int D>
struct Split {
  static_assert(D % 64 == 0 && D > 256 && D <= 512, "16-bit instances: Dh 320-512");
  static constexpr int P = D / 64;
  static constexpr int B0 = (P + 1) / 2;
  static constexpr int B1 = P / 2;
};

// Column boxes [first, first + n) of the head.
struct Span {
  int first, n;
};

// Slab s of `slabs` even slabs of the head's P boxes.
__device__ __forceinline__ Span slab_of(int s, int slabs, int P) {
  const int a = s * P / slabs;
  return {a, (s + 1) * P / slabs - a};
}

// Forward shared memory: the Q tile of an item, a ring of two slots (K
// half, V half) for each consumer, two fp32 partial-score buffers.  The
// streamed instance uses the same room: the Q tile's halves hold each
// consumer's q boxes of a round, beside its k boxes in its K slot.
template <int D>
struct FwdTiles {
  using QT = Box<D, TILE>;
  static constexpr int SLOT = Split<D>::B0 * BX::BYTES;  // 64 keys x N0 columns
  static constexpr int PART = TILE * TILE;                // floats of partial scores
  static constexpr int BARRIERS = 2 + 8;  // Q full, empty; K, V full, empty per consumer
  static constexpr int SMEM = QT::BYTES + 4 * SLOT + 2 * PART * 4 + BARRIERS * 8 + 1024;
};

// dk/dv shared memory: K and V of an item, the fp32 p of a tile, and a
// ring of SLOTS slots, each a 64-column box of a query tile's q and do.
// Streamed (a head above 512): in place of K and V, one slab of dv and of
// dk to stage the gradients in (4 boxes each), and slots of four boxes, a
// box of q, do, k and v.
template <int D, bool STREAM = false>
struct DkvTiles {
  static constexpr int KV = STREAM ? 4 * BX::BYTES : Box<D, TILE>::BYTES;
  static constexpr int SLOT = (STREAM ? 4 : 2) * BX::BYTES;
  static constexpr int PFLOATS = TILE * TILE;
  static constexpr int FIXED = 2 * KV + PFLOATS * 4 + 1024 + 8 * (2 + 2 * 8);
  static constexpr int ROOM = (SMEM_LIMIT - FIXED) / SLOT;
  static constexpr int SLOTS = ROOM < 8 ? ROOM : 8;
  static constexpr int BARRIERS = 2 + 2 * SLOTS;
  static constexpr int SMEM = 2 * KV + PFLOATS * 4 + SLOTS * SLOT + BARRIERS * 8 + 1024;
};

// dq shared memory: the item's Q and dO tiles, which each warpgroup's dq
// boxes are staged in at its end (Q: warpgroup 0's, dO: 1's), the two fp32
// exchange buffers of a key tile (p, and dp − delta), and a ring of SLOTS
// slots of two boxes: a k box and a v box of a key tile for the reductions,
// k boxes x and ceil(n/2) + x of the slab for the products.  Streamed (a
// head above 512): in place of Q and dO, each warpgroup's staging (4 boxes),
// and slots of four boxes, q's and do's beside k's and v's.
template <int D, bool STREAM = false>
struct DqTiles {
  static constexpr int TILE_BYTES = STREAM ? 4 * BX::BYTES : Box<D, TILE>::BYTES;
  static constexpr int SLOT = (STREAM ? 4 : 2) * BX::BYTES;
  static constexpr int PART = TILE * TILE;  // floats of one exchange buffer
  static constexpr int FIXED = 2 * TILE_BYTES + 2 * PART * 4 + 1024 + 8 * (2 + 2 * 8);
  static constexpr int ROOM = (SMEM_LIMIT - FIXED) / SLOT;
  static constexpr int SLOTS = ROOM < 8 ? ROOM : 8;
  static constexpr int BARRIERS = 2 + 2 * SLOTS;
  static constexpr int SMEM = 2 * TILE_BYTES + 2 * PART * 4 + SLOTS * SLOT + BARRIERS * 8 + 1024;
};

// Dynamic shared memory (bytes) at Dh 320 / 384 / 448 / 512 (the limit is
// 232,448): forward 173,136 / 181,328 / 222,288 / 230,480 (and streamed);
// dq (7 / 6 / 5 / 4 slots) 230,528 / 230,512 / 230,496 / 230,480, streamed
// (4 slots) 230,480; dk/dv (8 / 7 / 6 / 5 slots) 230,544 / 230,528 /
// 230,512 / 230,496, streamed (4 slots) 214,096.
static_assert(FwdTiles<320>::SMEM == 173136 && FwdTiles<384>::SMEM == 181328 &&
                  FwdTiles<448>::SMEM == 222288 && FwdTiles<512>::SMEM == 230480,
              "the sizes stated beside FwdTiles");
static_assert(DqTiles<320>::SLOTS == 7 && DqTiles<512>::SLOTS == 4 &&
                  DqTiles<320>::SMEM == 230528 && DqTiles<384>::SMEM == 230512 &&
                  DqTiles<448>::SMEM == 230496 && DqTiles<512>::SMEM == 230480 &&
                  DqTiles<512, true>::SLOTS == 4 && DqTiles<512, true>::SMEM == 230480,
              "the sizes stated beside DqTiles");
static_assert(DkvTiles<320>::SLOTS == 8 && DkvTiles<512>::SLOTS == 5 &&
                  DkvTiles<320>::SMEM == 230544 && DkvTiles<384>::SMEM == 230528 &&
                  DkvTiles<448>::SMEM == 230512 && DkvTiles<512>::SMEM == 230496 &&
                  DkvTiles<512, true>::SLOTS == 4 && DkvTiles<512, true>::SMEM == 214096,
              "the sizes stated beside DkvTiles");

// wgmma descriptors of a BX box: K-major (its columns the reduction) and
// MN-major (its rows the reduction).
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return wgmma_desc(addr, 16, 8 * BX::W, BX::LAYOUT);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Head and batch coordinates of operand `which` for (b, h): an operand
// expanded over heads or batch (stride 0) has extent 1 there in its map.
struct Coord {
  int h, b;
};

__device__ __forceinline__ Coord coord(const Params& p, int which, int b, int h) {
  return {p.st[which][1] ? h : 0, p.st[which][0] ? b : 0};
}

// An fp32 accumulator of a warpgroup (32 values a thread: a 64 x 64 block)
// to or from shared memory, thread-major so that both warpgroups' threads of
// one index hold the same elements.
__device__ __forceinline__ void put_block(float* buf, const float (&x)[32], int tid) {
#pragma unroll
  for (int v = 0; v < 8; ++v)
    *reinterpret_cast<float4*>(buf + v * 512 + 4 * tid) =
        make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
}

__device__ __forceinline__ float4 get4(const float* buf, int v, int tid) {
  return *reinterpret_cast<const float4*>(buf + v * 512 + 4 * tid);
}

// Gradient or output columns of a warpgroup's 64 rows (accumulator layout,
// times `mul`), rounded to T, into boxes [0, nb) at `tile` (swizzled as BX).
template <typename T, int NB>
__device__ __forceinline__ void stage_boxes(uint32_t tile, const float (&acc)[32 * NB], float mul,
                                            int nb, int rl, int t) {
#pragma unroll
  for (int x = 0; x < NB; ++x) {
    if (x >= nb) break;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        sts32(tile + x * BX::BYTES + tile_offset<BX>(rl + 8 * r, n * 8 + 2 * t),
              pack2<T>(acc[32 * x + 4 * n + 2 * r] * mul, acc[32 * x + 4 * n + 2 * r + 1] * mul));
  }
}

struct FwdItem {
  int b, h, q0, nk;
  Span slab;  // the item's columns of o
};

// Work item i of the forward and of the dq pass: causal launches walk the
// query tiles from the last (most key tiles) down; the others keep a head's
// tiles side by side.  Streamed, a query tile has `slabs` items side by
// side, one a slab of o (or dq).  A query tile is `rows` rows (the fp32
// forward of a narrow head takes 128).
__device__ __forceinline__ FwdItem fwd_item(int i, const Params& p, int nqt, int slabs,
                                            int rows = TILE) {
  const int bhn = p.B * p.H;
  const int s = i % slabs;
  i /= slabs;
  int bh, qt;
  if (p.causal) {
    qt = nqt - 1 - i / bhn;
    bh = i % bhn;
  } else {
    bh = i / nqt;
    qt = i % nqt;
  }
  FwdItem it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.q0 = qt * rows;
  it.nk = (p.Sk + TILE - 1) / TILE;
  if (p.causal) it.nk = min(it.nk, (min(it.q0 + rows, p.Sq) + TILE - 1) / TILE);
  it.slab = slab_of(s, slabs, p.D / 64);
  return it;
}

// Slabs of o (or dq) of a streamed item: at most 8 boxes, two
// warpgroups' 4.
__host__ __device__ __forceinline__ int fwd_slabs(const Params& p, bool stream) {
  return stream ? (p.D / 64 + 7) / 8 : 1;
}

// Online softmax of one 64-key tile in log2 units (flash_fwd.cu's
// softmax_tile at 64 keys): sc becomes p = 2^(s·scale·log2e − m), masked
// only where a key tail or the causal diagonal cuts the tile; m and l move
// on, and corr is what the earlier o must be multiplied by.
__device__ __forceinline__ void softmax64(float (&sc)[32], float (&m)[2], float (&l)[2],
                                          float (&corr)[2], int k0, int row0, int q0,
                                          const Params& p, float sl2, int t) {
  float mul = sl2;
  if (!(sl2 > 0.f)) {
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= sl2;
    mul = 1.f;
  }
  if (k0 + TILE > p.Sk || (p.causal && k0 + TILE - 1 > q0)) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
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
    for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx) * mul);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = exp2_ftz(m[r] - m_safe);
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
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

// Consumer warpgroup C of the forward: all 64 rows of each item, its share
// of the item's slab of o (the first ceil(n/2) boxes for C = 0, the rest
// for C = 1).  Its part of the scores: over the same boxes from the
// resident Q tile; streamed, over half the head (C = 0 the first ceil(P/2)
// boxes), 4 boxes a round, q and k boxes both in its K slot's round.
template <typename T, int D, int C, bool STREAM>
__device__ __forceinline__ void fwd_consumer(const CUtensorMap* to, const Params& p, uint32_t sq,
                                             uint32_t sring, float* exch, uint32_t bars,
                                             int items, int nqt, int tid) {
  using L = FwdTiles<D>;
  using QT = typename L::QT;
  constexpr int NB = C ? Split<D>::B1 : Split<D>::B0;  // most boxes of o it holds
  constexpr int N = 64 * NB;
  using OT = Box<N, TILE>;  // its half of a K or V tile, and of o
  const uint32_t kslot = sring + 2 * C * L::SLOT, vslot = kslot + L::SLOT;
  const uint32_t sqc = sq + C * (QT::BYTES / 2);  // streamed: its q boxes of a round
  const uint32_t q_full = bars, q_empty = bars + 8;
  const uint32_t k_full = bars + 16 + 16 * C, v_full = k_full + 8;
  const uint32_t k_empty = bars + 48 + 16 * C, v_empty = k_empty + 8;
  float* const mine = exch + C * L::PART;
  const float* const other = exch + (1 - C) * L::PART;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;  // this thread's rows of the item: rl, rl + 8
  const float sl2 = p.scale * LOG2E;
  const int P = STREAM ? p.D / 64 : Split<D>::P, P0 = (P + 1) / 2;
  const int s0 = C ? P0 : 0, s1 = C ? P : P0;  // streamed: its boxes of the scores
  const int slabs = fwd_slabs(p, STREAM);
  uint32_t nitem = 0, ntile = 0, nround = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++nitem) {
    const FwdItem it = fwd_item(i, p, nqt, slabs);
    const int half = (it.slab.n + 1) / 2;
    const int fb = STREAM ? it.slab.first + (C ? half : 0) : (C ? Split<D>::B0 : 0);
    const int nb = STREAM ? (C ? it.slab.n - half : half) : NB;
    const int row0 = it.q0 + rl;
    float o[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
    float l[2] = {0.f, 0.f};
    if (!STREAM) {
      mbar_wait(q_full, nitem & 1u);
      if (it.nk == 0) release(q_empty, lane);
    }
    for (int j = 0; j < it.nk; ++j, ++ntile) {
      float sc[32];
      if (STREAM) {
        for (int c0 = s0; c0 < s1; c0 += 4, ++nround) {
          const int n = min(4, s1 - c0);
          mbar_wait(k_full, nround & 1u);
          wgmma_fence();
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (x >= n) break;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              Wgmma<T>::ss(sc, k_major(sqc + x * BX::BYTES + 32 * k),
                           k_major(kslot + x * BX::BYTES + 32 * k), c0 > s0 || x + k > 0);
          }
          wgmma_commit();
          wgmma_wait();
          release(k_empty, lane);
        }
      } else {
        mbar_wait(k_full, ntile & 1u);
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            Wgmma<T>::ss(sc, k_major(sq + (fb + x) * QT::PART + 32 * k),
                         k_major(kslot + x * BX::BYTES + 32 * k), x + k > 0);
        wgmma_commit();
        wgmma_wait();
        release(k_empty, lane);
        if (j == it.nk - 1) release(q_empty, lane);  // q is no longer read
      }
      // The partial scores to the other consumer and its part added: both
      // hold s0 + s1 = s1 + s0.  BAR_FREE: the other has read the last ones.
      named_sync(BAR_FREE, 256);
      put_block(mine, sc, tid);
      named_sync(BAR_FULL, 256);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 w = get4(other, v, tid);
        sc[4 * v] += w.x;
        sc[4 * v + 1] += w.y;
        sc[4 * v + 2] += w.z;
        sc[4 * v + 3] += w.w;
      }
      float corr[2];
      softmax64(sc, m, l, corr, j * TILE, row0, it.q0, p, sl2, t);
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
      uint32_t pf[4][4];
      pack_a<T>(pf, sc);
      mbar_wait(v_full, ntile & 1u);
      // streamed, columns past its nb boxes come from stale slot bytes and
      // are never stored
      issue_rs<T, N, OT, 4>(o, pf, vslot);
      wgmma_wait();
      if (j < it.nk - 1) release(v_empty, lane);  // the last one holds o's staging
    }

    // Epilogue: o / l into the V slot (in o's swizzled layout), then one TMA
    // store a box, which clips rows past Sq; the slot is released once the
    // stores have read it.  (With Sk = 0 no tile is ever loaded: the slot
    // is free.)
    named_sync(BAR_WG + C, 128);  // every warp's p·v has read the slot
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsum = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / lsum;
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
        sts32(vslot + tile_offset<OT>(rl + 8 * r, n * 8 + 2 * t),
              pack2<T>(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv));
      const int row = row0 + 8 * r;
      if (C == 0 && it.slab.first == 0 && p.lse != nullptr && t == 0 && row < p.Sq)
        p.lse[(long long)(it.b * p.H + it.h) * p.Sq + row] =
            (m[r] == -INFINITY ? 0.f : m[r] * 0.6931471805599453f) + logf(lsum);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(BAR_WG + C, 128);
    if (tid == 0 && it.q0 < p.Sq) {
#pragma unroll
      for (int x = 0; x < NB; ++x)
        if (x < nb) tma_store(to, vslot + x * BX::BYTES, (fb + x) * 64, it.q0, it.h, it.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    named_sync(BAR_WG + C, 128);
    if (it.nk > 0) release(v_empty, lane);
  }
}

template <typename T, int D, bool STREAM>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_wide_fwd_tma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, Params p) {
  using L = FwdTiles<D>;
  using QT = typename L::QT;
  using S = Split<D>;
  extern __shared__ unsigned char smem_fwd[];
  const uint32_t base_addr = (smem_addr(smem_fwd) + 1023u) & ~1023u;
  const uint32_t sq = base_addr;                     // the Q tile
  const uint32_t sring = sq + QT::BYTES;             // consumer 0's K, V slots, then 1's
  const uint32_t sexch = sring + 4 * L::SLOT;        // partial scores of consumer 0, then 1
  const uint32_t bars = sexch + 2 * L::PART * 4;
  float* const exch = reinterpret_cast<float*>(smem_fwd + (sexch - smem_addr(smem_fwd)));

  const int nqt = (p.Sq + TILE - 1) / TILE;
  const int slabs = fwd_slabs(p, STREAM);
  const int items = p.B * p.H * nqt * slabs;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);      // Q full
    mbar_init(bars + 8, 8);  // Q empty: one arrival per consumer warp
    for (int i = 0; i < 4; ++i) {
      mbar_init(bars + 16 + 8 * i, 1);  // K, V full of each consumer
      mbar_init(bars + 48 + 8 * i, 4);  // K, V empty: that consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer warpgroup: one thread keeps the rings full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      const int P = STREAM ? p.D / 64 : S::P, P0 = (P + 1) / 2;
      uint32_t nitem = 0, ntile = 0, nround[2] = {0, 0};
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++nitem) {
        const FwdItem it = fwd_item(i, p, nqt, slabs);
        const Coord cq = coord(p, Q, it.b, it.h), ck = coord(p, K, it.b, it.h);
        const Coord cv = coord(p, V, it.b, it.h);
        const int half = (it.slab.n + 1) / 2;
        if (!STREAM) {
          mbar_wait(bars + 8, (nitem & 1u) ^ 1u);
          mbar_expect_tx(bars, QT::BYTES);
          for (int x = 0; x < S::P; ++x)
            tma_load(sq + x * QT::PART, &tq, bars, x * 64, it.q0, cq.h, cq.b);
        }
        for (int j = 0; j < it.nk; ++j, ++ntile) {
          const uint32_t par = (ntile & 1u) ^ 1u;
          for (int w = 0; w < 2; ++w) {
            const uint32_t slot = sring + 2 * w * L::SLOT;
            const uint32_t full = bars + 16 + 16 * w, empty = bars + 48 + 16 * w;
            if (STREAM) {  // its half of the head's q and k boxes, 4 a round
              const int s1 = w ? P : P0;
              for (int c0 = w ? P0 : 0; c0 < s1; c0 += 4, ++nround[w]) {
                const int n = min(4, s1 - c0);
                mbar_wait(empty, (nround[w] & 1u) ^ 1u);
                mbar_expect_tx(full, 2 * n * BX::BYTES);
                for (int x = 0; x < n; ++x) {
                  tma_load(sq + w * (QT::BYTES / 2) + x * BX::BYTES, &tq, full, (c0 + x) * 64,
                           it.q0, cq.h, cq.b);
                  tma_load(slot + x * BX::BYTES, &tk, full, (c0 + x) * 64, j * TILE, ck.h, ck.b);
                }
              }
            } else {  // its half of the K tile
              mbar_wait(empty, par);
              const int nb = w ? S::B1 : S::B0, fb = w ? S::B0 : 0;
              mbar_expect_tx(full, nb * BX::BYTES);
              for (int x = 0; x < nb; ++x)
                tma_load(slot + x * BX::BYTES, &tk, full, (fb + x) * 64, j * TILE, ck.h, ck.b);
            }
          }
          for (int w = 0; w < 2; ++w) {  // its boxes of the slab of the V tile
            const int nb = w ? it.slab.n - half : half, fb = it.slab.first + (w ? half : 0);
            const uint32_t slot = sring + (2 * w + 1) * L::SLOT;
            const uint32_t full = bars + 24 + 16 * w;
            mbar_wait(bars + 56 + 16 * w, par);
            mbar_expect_tx(full, nb * BX::BYTES);
            for (int x = 0; x < nb; ++x)
              tma_load(slot + x * BX::BYTES, &tv, full, (fb + x) * 64, j * TILE, cv.h, cv.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg == 0)
      fwd_consumer<T, D, 0, STREAM>(&to, p, sq, sring, exch, bars, items, nqt, tid);
    else
      fwd_consumer<T, D, 1, STREAM>(&to, p, sq, sring, exch, bars, items, nqt, tid);
  }
}

// Lanes a row of the delta launch: 16 where a row is at most 256 bytes
// (fp32 Dh 64), so that every lane of a warp loads (two rows a warp), else
// 32.  The sums are the same bits either way: the lanes a row of 256 bytes
// would leave idle add zeros.
template <typename T>
__host__ __device__ __forceinline__ int delta_lanes(int D) {
  return D * (int)sizeof(T) <= 256 ? 16 : 32;
}

// delta = rowsum(do∘o) in fp32 over the rows of [B·H·Sq], delta_lanes a row,
// 16 bytes a lane and step (8 elements of a 16-bit type, 4 of fp32):
// launched once a backward call, the dq and dk/dv passes read it instead of
// o.
template <typename T>
__global__ void __launch_bounds__(256) flash_wide_bwd_delta(Params p) {
  const int lanes = delta_lanes<T>(p.D);
  const long long row =
      ((long long)blockIdx.x * 8 + threadIdx.x / 32) * (32 / lanes) + threadIdx.x % 32 / lanes;
  const int lane = threadIdx.x % lanes;
  const bool live = row < (long long)p.B * p.H * p.Sq;  // every lane takes the shuffles
  float acc = 0.f;
  if (live) {
    const int s = (int)(row % p.Sq), bh = (int)(row / p.Sq);
    const int b = bh / p.H, h = bh % p.H;
    const T* o = base<T>(p, O, p.o, b, h) + s * p.st[O][2];
    const T* d = base<T>(p, DO, p.dout, b, h) + s * p.st[DO][2];
    if constexpr (std::is_same<T, float>::value) {
      for (int c = 4 * lane; c < p.D; c += 4 * lanes) {
        const float4 o4 = *reinterpret_cast<const float4*>(o + c);
        const float4 d4 = *reinterpret_cast<const float4*>(d + c);
        acc = fmaf(d4.x, o4.x, fmaf(d4.y, o4.y, fmaf(d4.z, o4.z, fmaf(d4.w, o4.w, acc))));
      }
    } else {
      for (int c = 8 * lane; c < p.D; c += 8 * lanes) {
        const uint4 o4 = *reinterpret_cast<const uint4*>(o + c);
        const uint4 d4 = *reinterpret_cast<const uint4*>(d + c);
        const uint32_t ow[4] = {o4.x, o4.y, o4.z, o4.w}, dw[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = unpack2<T>(dw[e]), bb = unpack2<T>(ow[e]);
          acc = fmaf(a.x, bb.x, fmaf(a.y, bb.y, acc));
        }
      }
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane == 0) p.delta[row] = acc;
}

// Consumer warpgroup W of the dq pass, over all 64 rows of each item: W = 0
// computes s = q·kᵀ over the head and p = 2^(s·scale·log2e − lse·log2e),
// W = 1 dp = do·vᵀ and dp − delta; the two swap these through shared memory
// and both form ds = p∘(dp − delta) (the same fp32 products in both, so the
// same bits), rounded to T.  Each then accumulates its boxes of the item's
// slab of dq (W = 0 the first ceil(n/2)), dq += ds·k, ds the register A
// operand and the product slot's k box MN-major.  `stile` is its own
// resident tile, Q (W = 0) or dO, whose boxes it reduces over and stages
// its dq boxes in at the end; streamed, its staging, q and do boxes coming
// through the reduction slots.
template <typename T, int D, int W, bool STREAM>
__device__ __forceinline__ void dq_consumer(const CUtensorMap* tdq, const Params& p,
                                            uint32_t stile, uint32_t sring, float* exch,
                                            uint32_t bars, int items, int nqt, int tid) {
  using L = DqTiles<D, STREAM>;
  constexpr int NB = Split<D>::B0;  // the most dq boxes a warpgroup holds
  const uint32_t full = bars + 16, empty = full + 8 * L::SLOTS;
  float* const mine = exch + W * L::PART;
  const float* const other = exch + (1 - W) * L::PART;
  const float* const stat = W ? p.delta : p.lse;
  const float stat_mul = W ? 1.f : LOG2E;  // delta, or lse in log2 units
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;  // this thread's rows of the item: rl, rl + 8
  const float sl2 = p.scale * LOG2E;
  const int P = STREAM ? p.D / 64 : Split<D>::P;
  const int slabs = fwd_slabs(p, STREAM);
  Ring<L::SLOTS> ring;
  uint32_t nitem = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++nitem) {
    const FwdItem it = fwd_item(i, p, nqt, slabs);
    const int half = (it.slab.n + 1) / 2;
    const int nb = W ? it.slab.n - half : half;  // its dq boxes
    const int fb = it.slab.first + (W ? half : 0);
    const int row0 = it.q0 + rl;
    const long long bh = (long long)it.b * p.H + it.h;
    float st[2];  // lse·log2e (W = 0) or delta of this thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r)
      st[r] = row0 + 8 * r < p.Sq ? stat[bh * p.Sq + row0 + 8 * r] * stat_mul : 0.f;
    float acc[32 * NB];  // its dq boxes
#pragma unroll
    for (int e = 0; e < 32 * NB; ++e) acc[e] = 0.f;
    if (!STREAM) mbar_wait(bars, nitem & 1u);  // the item's Q and dO tiles
    for (int j = 0; j < it.nk; ++j) {
      const int k0 = j * TILE;
      // s (W = 0) or dp over the head's boxes, one ring slot each
      float sc[32];
      int prev = 0;
#pragma unroll 1
      for (int x = 0; x < P; ++x) {
        const int s = ring.slot();
        mbar_wait(full + 8 * s, ring.parity());
        const uint32_t slot = sring + s * L::SLOT;
        const uint32_t a = STREAM ? slot + (2 + W) * BX::BYTES : stile + x * BX::BYTES;
        const uint32_t b = slot + W * BX::BYTES;  // k box (W = 0) or v box
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          Wgmma<T>::ss(sc, k_major(a + 32 * k), k_major(b + 32 * k), x + k > 0);
        wgmma_commit();
        if (x > 0) {
          wgmma_wait_pending<1>();
          release(empty + 8 * prev, lane);
        }
        prev = s;
        ++ring.n;
      }
      wgmma_wait();
      release(empty + 8 * prev, lane);

      // W = 0: p, masked only where a key tail or the causal diagonal cuts
      // the tile; W = 1: dp − delta
      const bool edge = k0 + TILE > p.Sk || (p.causal && k0 + TILE - 1 > it.q0);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          if (W == 0) {
            float pe = exp2_ftz(fmaf(sc[4 * n + e], sl2, -st[r]));
            if (edge) {
              const int key = k0 + n * 8 + 2 * t + (e & 1);
              if (key >= p.Sk || (p.causal && key > row0 + 8 * r)) pe = 0.f;
            }
            sc[4 * n + e] = pe;
          } else {
            sc[4 * n + e] -= st[r];
          }
        }
      // The swap; BAR_FREE: the other has read the last one.  Both then
      // hold ds = p∘(dp − delta).
      named_sync(BAR_FREE, 256);
      put_block(mine, sc, tid);
      named_sync(BAR_FULL, 256);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 w = get4(other, v, tid);
        sc[4 * v] *= w.x;
        sc[4 * v + 1] *= w.y;
        sc[4 * v + 2] *= w.z;
        sc[4 * v + 3] *= w.w;
      }
      uint32_t af[4][4];  // ds rounded to q's type
      pack_a<T>(af, sc);
      // dq += ds·k over its boxes; product slot x holds k boxes first + x
      // and first + half + x (the second when the slab has it).  Each
      // warpgroup waits for and releases every slot, its own or not.
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        if (x < half) {
          const int s = ring.slot();
          mbar_wait(full + 8 * s, ring.parity());
          if (x < nb)
            issue_rs<T, 64, BX, 4>(*reinterpret_cast<float(*)[32]>(acc + 32 * x), af,
                                   sring + s * L::SLOT + W * BX::BYTES);
          if (x > 0) {
            if (x < nb)
              wgmma_wait_pending<1>();
            else
              wgmma_wait();
            release(empty + 8 * prev, lane);
          }
          prev = s;
          ++ring.n;
        }
      }
      wgmma_wait();
      release(empty + 8 * prev, lane);
    }

    // Epilogue: dq times scale into the warpgroup's own tile (no longer
    // read) or staging, then one TMA store a box, which clips rows past Sq;
    // the producer reloads the tiles once both warpgroups' stores have read
    // them.
    named_sync(BAR_WG + W, 128);  // every warp's reductions have read the tile
    stage_boxes<T, NB>(stile, acc, p.scale, nb, rl, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(BAR_WG + W, 128);
    if (tid == 0) {
      if (it.q0 < p.Sq) {
        for (int x = 0; x < nb; ++x)
          tma_store(tdq, stile + x * BX::BYTES, (fb + x) * 64, it.q0, it.h, it.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      if (!STREAM) mbar_arrive(bars + 8);
    }
  }
}

template <typename T, int D, bool STREAM>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_wide_bwd_dq_tma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq, Params p) {
  using L = DqTiles<D, STREAM>;
  extern __shared__ unsigned char smem_dq[];
  const uint32_t base_addr = (smem_addr(smem_dq) + 1023u) & ~1023u;
  const uint32_t stiles = base_addr;  // Q, then dO (streamed: the warpgroups' staging)
  const uint32_t sring = stiles + 2 * L::TILE_BYTES;
  const uint32_t sexch = sring + L::SLOTS * L::SLOT;  // p, then dp − delta
  const uint32_t bars = sexch + 2 * L::PART * 4;
  float* const exch = reinterpret_cast<float*>(smem_dq + (sexch - smem_addr(smem_dq)));

  const int nqt = (p.Sq + TILE - 1) / TILE;
  const int slabs = fwd_slabs(p, STREAM);
  const int items = p.B * p.H * nqt * slabs;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);      // Q/dO full
    mbar_init(bars + 8, 2);  // Q/dO empty: each consumer, after its stores read its tile
    for (int i = 0; i < L::SLOTS; ++i) {
      mbar_init(bars + 16 + 8 * i, 1);
      mbar_init(bars + 16 + 8 * L::SLOTS + 8 * i, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      const uint32_t full = bars + 16, empty = full + 8 * L::SLOTS;
      const int P = STREAM ? p.D / 64 : Split<D>::P;
      Ring<L::SLOTS> ring;
      uint32_t nitem = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++nitem) {
        const FwdItem it = fwd_item(i, p, nqt, slabs);
        const Coord cq = coord(p, Q, it.b, it.h), cdo = coord(p, DO, it.b, it.h);
        const Coord ck = coord(p, K, it.b, it.h), cv = coord(p, V, it.b, it.h);
        const int half = (it.slab.n + 1) / 2;
        if (!STREAM) {
          mbar_wait(bars + 8, (nitem & 1u) ^ 1u);
          mbar_expect_tx(bars, 2 * L::TILE_BYTES);
          for (int x = 0; x < P; ++x) {
            tma_load(stiles + x * BX::BYTES, &tq, bars, x * 64, it.q0, cq.h, cq.b);
            tma_load(stiles + L::TILE_BYTES + x * BX::BYTES, &tdo, bars, x * 64, it.q0, cdo.h,
                     cdo.b);
          }
        }
        // a key tile: the head's k and v boxes (streamed, with q's and
        // do's) for the reductions, then the slab's k boxes for the products
        for (int j = 0; j < it.nk; ++j) {
          for (int x = 0; x < P + half; ++x) {
            const int s = ring.slot();
            const uint32_t slot = sring + s * L::SLOT, bar = full + 8 * s;
            mbar_wait(empty + 8 * s, ring.parity() ^ 1u);
            if (x < P) {
              mbar_expect_tx(bar, (STREAM ? 4 : 2) * BX::BYTES);
              tma_load(slot, &tk, bar, x * 64, j * TILE, ck.h, ck.b);
              tma_load(slot + BX::BYTES, &tv, bar, x * 64, j * TILE, cv.h, cv.b);
              if (STREAM) {
                tma_load(slot + 2 * BX::BYTES, &tq, bar, x * 64, it.q0, cq.h, cq.b);
                tma_load(slot + 3 * BX::BYTES, &tdo, bar, x * 64, it.q0, cdo.h, cdo.b);
              }
            } else {
              const int y = x - P;
              const bool second = y < it.slab.n - half;
              mbar_expect_tx(bar, (second ? 2 : 1) * BX::BYTES);
              tma_load(slot, &tk, bar, (it.slab.first + y) * 64, j * TILE, ck.h, ck.b);
              if (second)
                tma_load(slot + BX::BYTES, &tk, bar, (it.slab.first + half + y) * 64, j * TILE,
                         ck.h, ck.b);
            }
            ++ring.n;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg == 0)
      dq_consumer<T, D, 0, STREAM>(&tdq, p, stiles, sring, exch, bars, items, nqt, tid);
    else
      dq_consumer<T, D, 1, STREAM>(&tdq, p, stiles + L::TILE_BYTES, sring, exch, bars, items,
                                   nqt, tid);
  }
}

struct DkvItem {
  int b, h, k0, j0;
  Span slab;  // the item's columns of dk and dv
};

// Slabs of dk and dv a key tile: two, the warpgroups' split of the head;
// streamed, as many even slabs of at most 4 boxes as the head needs.
__host__ __device__ __forceinline__ int dkv_slabs(const Params& p, bool stream) {
  return stream ? (p.D / 64 + 3) / 4 : 2;
}

// Work item i of the dk/dv pass: the slabs of a key tile side by side;
// causal launches walk the key tiles from the first (most query tiles) up.
// j0: the first query tile that sees the item's keys.
template <int D, bool STREAM>
__device__ __forceinline__ DkvItem dkv_item(int i, const Params& p, int nkt) {
  const int bhn = p.B * p.H, slabs = dkv_slabs(p, STREAM);
  const int s = i % slabs;
  i /= slabs;
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
  it.k0 = kt * TILE;
  it.j0 = p.causal ? it.k0 / TILE : 0;
  using S = Split<D>;
  it.slab = STREAM ? slab_of(s, slabs, p.D / 64) : (s ? Span{S::B0, S::B1} : Span{0, S::B0});
  return it;
}

// Consumer warpgroup W of the dk/dv pass, over the item's 64 keys: W = 0
// computes sᵀ = k·qᵀ, pᵀ, and dv += pᵀ·do over the item's slab; W = 1
// computes dpᵀ = v·doᵀ, dsᵀ = pᵀ∘(dpᵀ − delta) with pᵀ from W = 0, and
// dk += dsᵀ·q.  `tout` is dv's map (W = 0) or dk's.  Its reduction's A
// operand (k or v) is the item's resident tile, or streamed, the slot's box.
template <typename T, int D, int W, bool STREAM>
__device__ __forceinline__ void dkv_consumer(const CUtensorMap* tout, const Params& p,
                                             uint32_t skv, uint32_t sring, float* pbuf,
                                             uint32_t bars, int items, int nkt, int nqt,
                                             int tid) {
  using L = DkvTiles<D, STREAM>;
  using S = Split<D>;
  const uint32_t mine = skv + W * L::KV;  // K (W = 0) or V, or streamed, its staging
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  const uint32_t full = bars + 16, empty = full + 8 * L::SLOTS;
  const float* const stat = W ? p.delta : p.lse;
  const float stat_mul = W ? 1.f : LOG2E;  // delta, or lse in log2 units
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;  // this thread's keys of the item: rl, rl + 8
  const float sl2 = p.scale * LOG2E;
  const int P = STREAM ? p.D / 64 : S::P;
  Ring<L::SLOTS> ring;
  uint32_t nitem = 0, ntile = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++nitem) {
    const DkvItem it = dkv_item<D, STREAM>(i, p, nkt);
    const int nb = it.slab.n, fb = it.slab.first;
    const int key0 = it.k0 + rl;
    const long long bh = (long long)it.b * p.H + it.h;
    float acc[32 * S::B0];  // dv (W = 0) or dk over the slab's boxes
#pragma unroll
    for (int e = 0; e < 32 * S::B0; ++e) acc[e] = 0.f;
    if (!STREAM) mbar_wait(kv_full, nitem & 1u);
    for (int j = it.j0; j < (p.Sq + TILE - 1) / TILE; ++j, ++ntile) {
      const int q0 = j * TILE;
      float2 st[8];  // lse·log2e (W = 0) or delta of this thread's 16 queries
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int qi = q0 + n * 8 + 2 * t;
        st[n].x = qi < p.Sq ? stat[bh * p.Sq + qi] * stat_mul : 0.f;
        st[n].y = qi + 1 < p.Sq ? stat[bh * p.Sq + qi + 1] * stat_mul : 0.f;
      }
      // sᵀ (W = 0) or dpᵀ over the head's boxes, one ring slot each
      float sc[32];
      int prev = 0;
#pragma unroll 1
      for (int x = 0; x < P; ++x) {
        const int s = ring.slot();
        mbar_wait(full + 8 * s, ring.parity());
        const uint32_t slot = sring + s * L::SLOT;
        const uint32_t a = STREAM ? slot + (2 + W) * BX::BYTES : mine + x * BX::BYTES;
        const uint32_t b = slot + W * BX::BYTES;  // q box (W = 0) or do box
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          Wgmma<T>::ss(sc, k_major(a + 32 * k), k_major(b + 32 * k), x + k > 0);
        wgmma_commit();
        if (x > 0) {
          wgmma_wait_pending<1>();
          release(empty + 8 * prev, lane);
        }
        prev = s;
        ++ring.n;
      }
      wgmma_wait();
      release(empty + 8 * prev, lane);

      // masked only where a query tail or the causal diagonal cuts the block
      const bool edge = q0 + TILE > p.Sq || (p.causal && q0 < it.k0 + TILE - 1);
      if (W == 0) {
        // pᵀ = 2^(sᵀ·scale·log2e − lse·log2e), to the other warpgroup in fp32
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = e & 1;
            float pe = exp2_ftz(fmaf(sc[4 * n + e], sl2, -(c ? st[n].y : st[n].x)));
            if (edge) {
              const int qi = q0 + n * 8 + 2 * t + c;
              if (qi >= p.Sq || (p.causal && qi < key0 + 8 * (e >> 1))) pe = 0.f;
            }
            sc[4 * n + e] = pe;
          }
        if (ntile > 0) named_sync(BAR_FREE, 256);  // the other has read the last pᵀ
        put_block(pbuf, sc, tid);
        named_arrive(BAR_FULL, 256);
      } else {
        // dsᵀ = pᵀ∘(dpᵀ − delta), pᵀ as the other warpgroup computed it
        named_sync(BAR_FULL, 256);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 pv = get4(pbuf, n, tid);
          sc[4 * n] = pv.x * (sc[4 * n] - st[n].x);
          sc[4 * n + 1] = pv.y * (sc[4 * n + 1] - st[n].y);
          sc[4 * n + 2] = pv.z * (sc[4 * n + 2] - st[n].x);
          sc[4 * n + 3] = pv.w * (sc[4 * n + 3] - st[n].y);
        }
        named_arrive(BAR_FREE, 256);
      }
      // dv += pᵀ·do (W = 0) or dk += dsᵀ·q over the slab, a box a slot:
      // pᵀ rounded to do's type, dsᵀ to q's
      uint32_t af[4][4];
      pack_a<T>(af, sc);
#pragma unroll
      for (int x = 0; x < S::B0; ++x) {
        if (x < nb) {
          const int s = ring.slot();
          mbar_wait(full + 8 * s, ring.parity());
          const uint32_t b = sring + s * L::SLOT + (1 - W) * BX::BYTES;  // do box (W = 0) or q
          issue_rs<T, 64, BX, 4>(*reinterpret_cast<float(*)[32]>(acc + 32 * x), af, b);
          if (x > 0) {
            wgmma_wait_pending<1>();
            release(empty + 8 * prev, lane);
          }
          prev = s;
          ++ring.n;
        }
      }
      wgmma_wait();
      release(empty + 8 * prev, lane);
    }

    // Epilogue: the gradient (dk times scale) into this warpgroup's own K or
    // V tile (no longer read), then one TMA store a box, clipping keys past
    // Sk; the item's tiles are released once both warpgroups' stores have
    // read them.
    named_sync(BAR_WG + W, 128);  // every warp's reduction has read the tile
    stage_boxes<T, S::B0>(mine, acc, W ? p.scale : 1.f, nb, rl, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(BAR_WG + W, 128);
    if (tid == 0) {
      if (it.k0 < p.Sk) {
        for (int x = 0; x < nb; ++x)
          tma_store(tout, mine + x * BX::BYTES, (fb + x) * 64, it.k0, it.h, it.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      if (!STREAM) mbar_arrive(kv_empty);
    }
  }
  // the other warpgroup's last arrival on BAR_FREE
  if (W == 0 && ntile > 0) named_sync(BAR_FREE, 256);
}

template <typename T, int D, bool STREAM>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_wide_bwd_dkv_tma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv, Params p) {
  using L = DkvTiles<D, STREAM>;
  using S = Split<D>;
  extern __shared__ unsigned char smem_dkv[];
  const uint32_t base_addr = (smem_addr(smem_dkv) + 1023u) & ~1023u;
  const uint32_t skv = base_addr;            // K, then V (streamed: dv's staging, then dk's)
  const uint32_t sring = skv + 2 * L::KV;    // SLOTS slots of a q box and a do box (and k, v)
  const uint32_t spbuf = sring + L::SLOTS * L::SLOT;
  const uint32_t bars = spbuf + L::PFLOATS * 4;
  float* const pbuf = reinterpret_cast<float*>(smem_dkv + (spbuf - smem_addr(smem_dkv)));

  const int nkt = (p.Sk + TILE - 1) / TILE;
  const int nqt = (p.Sq + TILE - 1) / TILE;
  const int items = dkv_slabs(p, STREAM) * p.B * p.H * nkt;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);      // K/V full
    mbar_init(bars + 8, 2);  // K/V empty: each consumer, after its stores read
    for (int i = 0; i < L::SLOTS; ++i) {
      mbar_init(bars + 16 + 8 * i, 1);
      mbar_init(bars + 16 + 8 * L::SLOTS + 8 * i, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      const uint32_t full = bars + 16, empty = full + 8 * L::SLOTS;
      const int P = STREAM ? p.D / 64 : S::P;
      Ring<L::SLOTS> ring;
      uint32_t nitem = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++nitem) {
        const DkvItem it = dkv_item<D, STREAM>(i, p, nkt);
        const Coord cq = coord(p, Q, it.b, it.h), cdo = coord(p, DO, it.b, it.h);
        const Coord ck = coord(p, K, it.b, it.h), cv = coord(p, V, it.b, it.h);
        if (!STREAM) {
          mbar_wait(bars + 8, (nitem & 1u) ^ 1u);
          mbar_expect_tx(bars, 2 * L::KV);
          for (int x = 0; x < S::P; ++x) {
            tma_load(skv + x * BX::BYTES, &tk, bars, x * 64, it.k0, ck.h, ck.b);
            tma_load(skv + L::KV + x * BX::BYTES, &tv, bars, x * 64, it.k0, cv.h, cv.b);
          }
        }
        for (int j = it.j0; j < nqt; ++j) {
          // the head's boxes for the reductions (streamed, with k's and v's),
          // then the slab's for the products
          for (int x = 0; x < P + it.slab.n; ++x) {
            const bool reduction = x < P;
            const int col = 64 * (reduction ? x : it.slab.first + x - P);
            const int s = ring.slot();
            const uint32_t slot = sring + s * L::SLOT;
            mbar_wait(empty + 8 * s, ring.parity() ^ 1u);
            mbar_expect_tx(full + 8 * s, (STREAM && reduction ? 4 : 2) * BX::BYTES);
            tma_load(slot, &tq, full + 8 * s, col, j * TILE, cq.h, cq.b);
            tma_load(slot + BX::BYTES, &tdo, full + 8 * s, col, j * TILE, cdo.h, cdo.b);
            if (STREAM && reduction) {
              tma_load(slot + 2 * BX::BYTES, &tk, full + 8 * s, col, it.k0, ck.h, ck.b);
              tma_load(slot + 3 * BX::BYTES, &tv, full + 8 * s, col, it.k0, cv.h, cv.b);
            }
            ++ring.n;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg == 0)
      dkv_consumer<T, D, 0, STREAM>(&tdv, p, skv, sring, pbuf, bars, items, nkt, nqt, tid);
    else
      dkv_consumer<T, D, 1, STREAM>(&tdk, p, skv, sring, pbuf, bars, items, nkt, nqt, tid);
  }
}

// ---------------------------------------------------------------------------
// fp32: split TF32 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

// An fp32 box: 64 rows by 64 columns as two TMA boxes of 32 columns, each
// 64 rows of 128 bytes swizzled by TMA over 128 bytes (16 KB).
constexpr int F_HALF = TILE * 128;
constexpr int F_BOX = 2 * F_HALF;
// Each consumer warpgroup has a ring of F_SLOTS slots of two boxes: a
// reduction's A and B boxes, or a product's B box in the first.
constexpr int F_SLOTS = 3;
constexpr int F_SLOT = 2 * F_BOX;
// setmaxnreg of the producer and the consumers: 24·128 + 240·256 = 168·384,
// all the registers the block holds at launch (a consumer holds 128 of
// accumulator and 32 of scores beside split fragments).
constexpr int F_PRODUCER_REGS = 24;
constexpr int F_CONSUMER_REGS = 240;
constexpr int F_PART = TILE * TILE;  // floats of one exchange buffer
constexpr int F_BARRIERS = 2 * 2 * F_SLOTS;  // full and empty of each slot of each ring
// Shared memory, as offsets from its 1024-byte-aligned base (so one
// register addresses all of it): consumer 0's ring, consumer 1's, then in
// the forward two exchange buffers (partial scores), in the dq pass the same
// two (p, and dp − delta), in the dk/dv pass one (pᵀ), then the barriers.
// 230,496 bytes (forward and dq) and 214,112 (dk/dv).
constexpr int F_EXCH = 2 * F_SLOTS * F_SLOT;
constexpr int F_FWD_BARS = F_EXCH + 2 * F_PART * 4;
constexpr int F_DKV_BARS = F_EXCH + F_PART * 4;
constexpr int F_FWD_SMEM = F_FWD_BARS + F_BARRIERS * 8 + 1024;
constexpr int F_DKV_SMEM = F_DKV_BARS + F_BARRIERS * 8 + 1024;
static_assert(F_FWD_SMEM == 230496 && F_DKV_SMEM == 214112 && F_FWD_SMEM <= SMEM_LIMIT,
              "the sizes stated beside F_FWD_SMEM");

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr));
  return x;
}

// The split of an fp32 word x into hi + lo: the tensor core reads a raw
// fp32 word as TF32 by dropping its low 13 bits (a probe on the card found
// truncation, not rounding), so the raw word is hi, and lo = x − hi is
// exact in fp32 (|lo| < 2^-10·|x|; read as TF32 in turn it loses at most
// 2^-20·|x|).
__device__ __forceinline__ uint32_t lo_of(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u));
}

// d (16 x 8, fp32) += a (16 x 8) · b (8 x 8) in TF32.  Fragments (g = lane
// / 4, t = lane % 4): a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4); b0 (k t, column g), b1 (k t + 4, g); d as wgmma's
// accumulator: d0, d1 (row g, columns 2t, 2t + 1), d2, d3 (row g + 8).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in split TF32: hi·lo′, lo·hi′ and hi·hi′ (lo·lo′, below 2^-20
// of the product, is dropped), small ones first.  a as hi words and lo
// words, b as raw words.
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t b0, uint32_t b1) {
  mma_tf32(d, ah, lo_of(b0), lo_of(b1));
  mma_tf32(d, al, b0, b1);
  mma_tf32(d, ah, b0, b1);
}

// i itself, as a value the compiler cannot tie to i: what is computed from
// it is computed anew where it is used, not held in a register through the
// consumers' hot loops (a consumer holds 128 or 96 registers of
// accumulator and 32 of scores; ptxas spilled when it held more).
__device__ __forceinline__ int opaque(int i) {
  asm volatile("" : "+r"(i));
  return i;
}

// A consumer thread's index in its warpgroup, read afresh where it is used.
__device__ __forceinline__ int ctid() { return opaque((int)threadIdx.x) % 128; }

// A lane's byte offsets into an fp32 box (64 rows by two 32-column halves,
// rows of 128 bytes swizzled as TMA writes them: 16-byte chunk c of row r
// at r·128 + ((c ^ r % 8) << 4)).  For the lane's row, step m of a half's
// four 8-column steps lies at offset ^ (m << 5), since only the chunk's
// bits 1-2 change with m (the address bits 5-6); a box starts on a
// 1024-byte boundary, so (box + offset) ^ (m << 5) is the address.  a, b:
// the ldmatrix row of reduce_box's A and B operands (an 8 x 8 matrix of
// 16-bit pairs is 8 rows of 4 fp32 values, which is how TF32 fragments
// lie); e: product_box's element of column tile 0 in the lane's even row
// of a step of 8 (its odd row: bit 4 flipped and 128 on).  Every read is
// conflict-free.
struct Frag {
  uint32_t a, b, e;
};

__device__ __forceinline__ Frag frag_offsets() {
  // computed afresh at each box (a few instructions) rather than held in
  // three registers through the consumer's loops
  const int tid = ctid(), warp = tid / 32, lane = tid % 32;
  const int mi = lane >> 3, ri = lane & 7, g = lane >> 2, t = lane & 3;
  return {(16 * warp + ri + 8 * (mi & 1)) * 128u | (ri >> 1) << 5 | (((mi >> 1) ^ ri) & 1) << 4,
          (ri + 8 * (mi >> 1)) * 128u | (ri >> 1) << 5 | (((mi & 1) ^ ri) & 1) << 4,
          2 * t * 128u | t << 5 | (g >> 2) << 4 | (g & 3) << 2};
}

// sc (this warp's 16 rows of a 64 x 64 block) += a·bᵀ over the 64 columns
// of two boxes, both K-major: a's rows (the warp's), b's 64 rows.
__device__ __forceinline__ void reduce_box(float (&sc)[32], uint32_t a, uint32_t b) {
  const Frag f = frag_offsets();
  a += f.a;
  b += f.b;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t step = (k & 3) << 5, half = (k >> 2) * F_HALF;
    uint32_t ah[4], al[4];
    ldsm4(ah, (a ^ step) + half);
#pragma unroll
    for (int e = 0; e < 4; ++e) al[e] = lo_of(ah[e]);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t bf[4];  // b0 and b1 of column tiles n and n + 1
      ldsm4(bf, (b ^ step) + n * 1024 + half);
      mma3(sc + 4 * n, ah, al, bf[0], bf[1]);
      mma3(sc + 4 * n + 4, ah, al, bf[2], bf[3]);
    }
  }
}

// acc (this warp's 16 rows by N 8-column tiles: N = 8, a box's 64 columns,
// or N = 4, one 32-column half of it at b) += w·b: w (the warp's 16 rows by
// the tile's 64 keys or queries, in accumulator layout) and b a box whose
// 64 rows are the reduction (MN-major), its fragments read by hand.  The
// reduction index is permuted within each step of 8 so that w's
// accumulator pairs are its A fragments: step j's k = t is row 8j + 2t, k =
// t + 4 row 8j + 2t + 1, for w's columns and b's rows alike.
template <int N>
__device__ __forceinline__ void product_box(float (&acc)[4 * N], const float (&w)[32],
                                            uint32_t b) {
  static_assert(N == 4 || N == 8, "a box or a half");
  b += frag_offsets().e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t ah[4] = {__float_as_uint(w[4 * j]), __float_as_uint(w[4 * j + 2]),
                            __float_as_uint(w[4 * j + 1]), __float_as_uint(w[4 * j + 3])};
    uint32_t al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) al[e] = lo_of(ah[e]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint32_t step = (n & 3) << 5, at = j * 1024 + (n >> 2) * F_HALF;
      mma3(acc + 4 * n, ah, al, lds32((b ^ step) + at), lds32((b ^ step ^ 16) + 128 + at));
    }
  }
}

// put_block and get4 on a 32-bit shared-memory address.
__device__ __forceinline__ void put_block_s(uint32_t buf, const float (&x)[32], int tid) {
#pragma unroll
  for (int v = 0; v < 8; ++v)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(buf + (v * 512 + 4 * tid) * 4),
                 "f"(x[4 * v]), "f"(x[4 * v + 1]), "f"(x[4 * v + 2]), "f"(x[4 * v + 3])
                 : "memory");
}

__device__ __forceinline__ float4 get4_s(uint32_t buf, int v, int tid) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"(buf + (v * 512 + 4 * tid) * 4)
               : "memory");
  return r;
}

// One 64-column box of a 4-D fp32 map: two TMA boxes of 32 columns.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, Coord c) {
  tma_load(dst, map, bar, col, row, c.h, c.b);
  tma_load(dst + F_HALF, map, bar, col + 32, row, c.h, c.b);
}

// The barriers of slot s of consumer w's ring: full (the producer's loads
// landed), empty (each of the consumer's warps is past its reads).
__device__ __forceinline__ uint32_t f_full(uint32_t bars, int w, int s) {
  return bars + 8 * (2 * F_SLOTS * w + s);
}
__device__ __forceinline__ uint32_t f_empty(uint32_t bars, int w, int s) {
  return bars + 8 * (2 * F_SLOTS * w + F_SLOTS + s);
}

// Every slot's full barrier takes the producer's one arrival (with its
// bytes), every empty one an arrival of each of its consumer's four warps.
__device__ __forceinline__ void f_init(uint32_t bars) {
  for (int w = 0; w < 2; ++w)
    for (int s = 0; s < F_SLOTS; ++s) {
      mbar_init(f_full(bars, w, s), 1);
      mbar_init(f_empty(bars, w, s), 4);
    }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Consumer W's side of its ring (barriers at base + BARS): wait for the
// next slot, then its address; release it.
template <int W, int BARS>
struct FRing {
  Ring<F_SLOTS> r;
  uint32_t base;
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(f_full(base + BARS, W, r.slot()), r.parity());
    return base + (W * F_SLOTS + r.slot()) * F_SLOT;
  }
  __device__ __forceinline__ void release_slot(int lane) {
    release(f_empty(base + BARS, W, r.slot()), lane);
    ++r.n;
  }
};

// The producer's side of consumer w's ring: wait until the next slot is
// free and expect `bytes` on its full barrier.
struct FFill {
  uint32_t slot, full;
};

__device__ __forceinline__ FFill f_fill(Ring<F_SLOTS>& r, uint32_t base, uint32_t bars, int w,
                                        uint32_t bytes) {
  const int s = r.slot();
  mbar_wait(f_empty(bars, w, s), r.parity() ^ 1u);
  const FFill f = {base + (w * F_SLOTS + s) * F_SLOT, f_full(bars, w, s)};
  mbar_expect_tx(f.full, bytes);
  ++r.n;
  return f;
}

// The forward's boxes of one consumer in one key tile: reductions over
// [r0, r0 + nr) of the head (q box and k box a slot), then the products
// over its nb boxes of o from fb (a v box a slot).
struct FwdShare {
  int r0, nr, fb, nb;
};

__device__ __forceinline__ FwdShare fwd_share(const FwdItem& it, int P, int C) {
  const int P0 = (P + 1) / 2, half = (it.slab.n + 1) / 2;
  return {C ? P0 : 0, C ? P - P0 : P0, it.slab.first + (C ? half : 0),
          C ? it.slab.n - half : half};
}

// The most boxes of an fp32 forward item's slab of o: 6, a consumer's 3.  (A
// consumer holding 4 boxes, 128 registers of o beside 32 of scores, left
// ptxas too few registers: it spilled at every setmaxnreg split tried.)
constexpr int F_FWD_SLAB = 6;
// The most boxes of an fp32 dq item's slab: 8, a 32-column half of each a
// consumer, 128 registers of dq beside 32 of scores (as dk/dv holds).  A
// head of at most 2 boxes (Dh 64 and 128) runs an instance of 2, 32
// registers of dq, which has room to hold the item's coordinates: 121
// against 140 us for the instance of 8 at [64, 128, 12, 64] (125 for one of
// 4; H100 80GB HBM3, 700 W).
constexpr int F_DQ_SLAB = 8;
constexpr int F_DQ_NARROW = 2;

// Even slabs of at most `most` boxes over a head of P.
__host__ __device__ __forceinline__ int f32_slabs(int P, int most) {
  return (P + most - 1) / most;
}

// The counts of an fp32 forward or dq call (slabs of at most `most` boxes):
// head boxes P, slabs an item, tiles and items, computed afresh from opaque
// copies of the parameters at each item.
struct FShape {
  int P, slabs, tiles, items;
};

__device__ __forceinline__ FShape fwd_shape(const Params& p, int most = F_FWD_SLAB) {
  const int P = opaque(p.D) / 64, slabs = f32_slabs(P, most);
  const int tiles = (opaque(p.Sq) + TILE - 1) / TILE;
  return {P, slabs, tiles, p.B * p.H * tiles * slabs};
}

// Consumer warpgroup C of the fp32 forward: all 64 rows of each item, its
// boxes of the item's slab of o; its part of the scores over its half of
// the head, swapped with the other's as in flash_wide_fwd_tma.
template <int C>
__device__ __forceinline__ void fwd_f32_consumer(const Params& p, uint32_t base, int tid) {
  constexpr int MINE = F_EXCH + C * F_PART * 4, OTHER = F_EXCH + (1 - C) * F_PART * 4;
  const int lane = tid % 32, t = lane & 3;
  const int rl = 16 * (tid / 32) + lane / 4;  // this thread's rows of the item: rl, rl + 8
  const float sl2 = p.scale * LOG2E;
  FRing<C, F_FWD_BARS> rg{{}, base};
  for (int i = blockIdx.x; i < fwd_shape(p).items; i += gridDim.x) {
    const FShape sp = fwd_shape(p);
    const FwdItem it = fwd_item(i, p, sp.tiles, sp.slabs);
    const FwdShare sh = fwd_share(it, sp.P, C);
    const int row0 = it.q0 + rl;
    float o[96];
#pragma unroll
    for (int e = 0; e < 96; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
    float l[2] = {0.f, 0.f};
    for (int j = 0; j < it.nk; ++j) {
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
#pragma unroll 1
      for (int x = 0; x < sh.nr; ++x) {
        const uint32_t slot = rg.acquire();
        reduce_box(sc, slot, slot + F_BOX);
        rg.release_slot(lane);
      }
      // the swap: both then hold s0 + s1 = s1 + s0
      named_sync(BAR_FREE, 256);
      put_block_s(base + MINE, sc, tid);
      named_sync(BAR_FULL, 256);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 w = get4_s(base + OTHER, v, tid);
        sc[4 * v] += w.x;
        sc[4 * v + 1] += w.y;
        sc[4 * v + 2] += w.z;
        sc[4 * v + 3] += w.w;
      }
      float corr[2];
      softmax64(sc, m, l, corr, j * TILE, row0, it.q0, p, sl2, t);
#pragma unroll
      for (int n = 0; n < 24; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        if (x >= sh.nb) break;
        const uint32_t slot = rg.acquire();
        product_box<8>(*reinterpret_cast<float(*)[32]>(o + 32 * x), sc, slot);
        rg.release_slot(lane);
      }
    }
    // o / l straight from the registers, rows past Sq not written
    float* const out = static_cast<float*>(p.out) + it.b * p.st[OUT][0] + it.h * p.st[OUT][1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsum = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / lsum;
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        if (x >= sh.nb) break;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(out + row * p.st[OUT][2] + (sh.fb + x) * 64 + 8 * n + 2 * t) =
              make_float2(o[32 * x + 4 * n + 2 * r] * inv, o[32 * x + 4 * n + 2 * r + 1] * inv);
      }
      if (C == 0 && it.slab.first == 0 && p.lse != nullptr && t == 0)
        p.lse[(long long)(it.b * p.H + it.h) * p.Sq + row] =
            (m[r] == -INFINITY ? 0.f : m[r] * 0.6931471805599453f) + logf(lsum);
    }
  }
}

// The fp32 forward's producer thread: keeps both rings full, each
// consumer's loads of a key tile in its own order, the two interleaved.
__device__ __forceinline__ void fwd_f32_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                                 const CUtensorMap* tv, const Params& p,
                                                 uint32_t base) {
  const uint32_t bars = base + F_FWD_BARS;
  const FShape sp = fwd_shape(p);
  const int P = sp.P;
  Ring<F_SLOTS> r0, r1;
  for (int i = blockIdx.x; i < sp.items; i += gridDim.x) {
    const FwdItem it = fwd_item(i, p, sp.tiles, sp.slabs);
    const int half = (it.slab.n + 1) / 2;
    const int n = max((P + 1) / 2 + half, P / 2 + it.slab.n - half);
    for (int j = 0; j < it.nk; ++j)
      for (int x = 0; x < n; ++x)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const FwdShare s = fwd_share(it, P, w);
          if (x >= s.nr + s.nb) continue;
          Ring<F_SLOTS>& r = w ? r1 : r0;
          if (x < s.nr) {
            const FFill f = f_fill(r, base, bars, w, 2 * F_BOX);
            load_box(f.slot, tq, f.full, (s.r0 + x) * 64, it.q0, coord(p, Q, it.b, it.h));
            load_box(f.slot + F_BOX, tk, f.full, (s.r0 + x) * 64, j * TILE,
                     coord(p, K, it.b, it.h));
          } else {
            const FFill f = f_fill(r, base, bars, w, F_BOX);
            load_box(f.slot, tv, f.full, (s.fb + x - s.nr) * 64, j * TILE,
                     coord(p, V, it.b, it.h));
          }
        }
  }
}

__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_wide_fwd_f32(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, Params p) {
  extern __shared__ unsigned char smem_ff[];
  const uint32_t base = (smem_addr(smem_ff) + 1023u) & ~1023u;
  if (threadIdx.x == 0) f_init(base + F_FWD_BARS);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PRODUCER_REGS));
    if (threadIdx.x == 256) fwd_f32_producer(&tq, &tk, &tv, p, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_CONSUMER_REGS));
    if (wg == 0)
      fwd_f32_consumer<0>(p, base, threadIdx.x % 128);
    else
      fwd_f32_consumer<1>(p, base, threadIdx.x % 128);
  }
}

// The fp32 forward of a head of P <= 2 boxes
// (flash_wide_fwd_f32_rows<P>): items of 128 query rows, consumer C owning
// rows [64·C, 64·C + 64) of each over the whole head, so it reduces q·kᵀ
// over all P boxes, runs its rows' softmax and accumulates all P boxes of
// their o (32·P registers): no partial scores are swapped, no named barrier
// is passed a tile, and the two consumers do equal work at every P.  The
// item's q stays in shared memory (Q_BUFS buffers of 128 rows, consumer
// C's P boxes at C·P); k and v stream through one ring of one-box slots
// that both consumers read (a key tile's P k boxes, then its P v boxes;
// each slot's empty barrier takes the arrivals of all eight consumer
// warps), so each k and v box crosses into shared memory once an item.
// Shared memory (the limit 232,448): two q buffers, so the next item's q
// loads while this one's is read, and the slots that fit beside them, at
// most 8: P = 1, 2 x 32 KB and 8 slots (of 16 KB), 197,792 bytes; P = 2,
// 2 x 64 KB and 6 slots, 230,528.
constexpr int F_ROWS = 2 * TILE;  // query rows of an item

template <int P>
struct FRows {
  static constexpr int Q_BYTES = 2 * P * F_BOX;  // an item's 128 rows of q
  static constexpr int Q_BUFS = 2;
  static constexpr int ROOM =
      (SMEM_LIMIT - Q_BUFS * Q_BYTES - 1024 - 8 * (2 * Q_BUFS + 16)) / F_BOX;
  static constexpr int SLOTS = ROOM < 8 ? ROOM : 8;
  static constexpr int RING = Q_BUFS * Q_BYTES;         // offset of the ring's slots
  static constexpr int BARS = RING + SLOTS * F_BOX;     // offset of the barriers
  static constexpr int SMEM = BARS + 8 * (2 * Q_BUFS + 2 * SLOTS) + 1024;
  // q buffer b full (the producer's loads landed) and empty (every consumer
  // warp is past its last reduction of the item); ring slot s full and empty
  __device__ static uint32_t q_full(uint32_t bars, int b) { return bars + 8 * b; }
  __device__ static uint32_t q_empty(uint32_t bars, int b) { return bars + 8 * (Q_BUFS + b); }
  __device__ static uint32_t full(uint32_t bars, int s) { return bars + 8 * (2 * Q_BUFS + s); }
  __device__ static uint32_t empty(uint32_t bars, int s) {
    return bars + 8 * (2 * Q_BUFS + SLOTS + s);
  }
};
static_assert(FRows<1>::SLOTS == 8 && FRows<1>::SMEM == 197792 && FRows<2>::SLOTS == 6 &&
                  FRows<2>::SMEM == 230528,
              "the sizes stated beside FRows");

// Work items of flash_wide_fwd_f32_rows: 128-row query tiles of each
// (batch, head).
__device__ __forceinline__ int rows_tiles(const Params& p) { return (p.Sq + F_ROWS - 1) / F_ROWS; }

template <int P, int C>
__device__ __forceinline__ void fwd_rows_consumer(const Params& p, uint32_t base, int tid) {
  using L = FRows<P>;
  const uint32_t bars = base + L::BARS;
  const int lane = tid % 32, t = lane & 3;
  const int rl = TILE * C + 16 * (tid / 32) + lane / 4;  // this thread's rows of an item: rl, rl + 8
  const float sl2 = p.scale * LOG2E;
  Ring<L::Q_BUFS> qr;
  Ring<L::SLOTS> kv;
  for (int i = blockIdx.x; i < p.B * p.H * rows_tiles(p); i += gridDim.x, ++qr.n) {
    const FwdItem it = fwd_item(i, p, rows_tiles(p), 1, F_ROWS);
    const int r0 = it.q0 + TILE * C;  // its first row
    // the key tiles its own rows see: none past Sq
    const int nk = r0 >= p.Sq  ? 0
                   : p.causal ? min(it.nk, (min(r0 + TILE, p.Sq) + TILE - 1) / TILE)
                              : it.nk;
    const uint32_t sq = base + qr.slot() * L::Q_BYTES + C * P * F_BOX;  // its q boxes
    float o[32 * P];
#pragma unroll
    for (int e = 0; e < 32 * P; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
    float l[2] = {0.f, 0.f};
    mbar_wait(L::q_full(bars, qr.slot()), qr.parity());
    if (it.nk == 0) release(L::q_empty(bars, qr.slot()), lane);
    for (int j = 0; j < it.nk; ++j) {
      const bool live = j < nk;  // a tile past its rows' last visible key is only passed through
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      // not unrolled: the body with P copies of reduce_box ran P = 2 a
      // sixth slower (PERF.md)
#pragma unroll 1
      for (int x = 0; x < P; ++x) {
        mbar_wait(L::full(bars, kv.slot()), kv.parity());
        if (live) reduce_box(sc, sq + x * F_BOX, base + L::RING + kv.slot() * F_BOX);
        release(L::empty(bars, kv.slot()), lane);
        ++kv.n;
      }
      if (j == it.nk - 1) release(L::q_empty(bars, qr.slot()), lane);  // q is no longer read
      if (live) {
        float corr[2];
        softmax64(sc, m, l, corr, j * TILE, it.q0 + rl, r0, p, sl2, t);
#pragma unroll
        for (int n = 0; n < 8 * P; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
      }
#pragma unroll
      for (int x = 0; x < P; ++x) {
        mbar_wait(L::full(bars, kv.slot()), kv.parity());
        if (live)
          product_box<8>(*reinterpret_cast<float(*)[32]>(o + 32 * x), sc,
                         base + L::RING + kv.slot() * F_BOX);
        release(L::empty(bars, kv.slot()), lane);
        ++kv.n;
      }
    }
    // o / l straight from the registers, rows past Sq not written
    float* const out = static_cast<float*>(p.out) + it.b * p.st[OUT][0] + it.h * p.st[OUT][1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsum = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / lsum;
      const int row = it.q0 + rl + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int x = 0; x < P; ++x)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(out + row * p.st[OUT][2] + x * 64 + 8 * n + 2 * t) =
              make_float2(o[32 * x + 4 * n + 2 * r] * inv, o[32 * x + 4 * n + 2 * r + 1] * inv);
      if (p.lse != nullptr && t == 0)
        p.lse[(long long)(it.b * p.H + it.h) * p.Sq + row] =
            (m[r] == -INFINITY ? 0.f : m[r] * 0.6931471805599453f) + logf(lsum);
    }
  }
}

// Its producer thread: an item's q (the 64-row halves that hold a row
// before Sq) into the next q buffer, then for each key tile the P k boxes
// and the P v boxes into the ring, a box a slot.
template <int P>
__device__ __forceinline__ void fwd_rows_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                                  const CUtensorMap* tv, const Params& p,
                                                  uint32_t base) {
  using L = FRows<P>;
  const uint32_t bars = base + L::BARS;
  Ring<L::Q_BUFS> qr;
  Ring<L::SLOTS> kv;
  for (int i = blockIdx.x; i < p.B * p.H * rows_tiles(p); i += gridDim.x, ++qr.n) {
    const FwdItem it = fwd_item(i, p, rows_tiles(p), 1, F_ROWS);
    const int halves = it.q0 + TILE < p.Sq ? 2 : 1;
    const int b = qr.slot();
    mbar_wait(L::q_empty(bars, b), qr.parity() ^ 1u);
    mbar_expect_tx(L::q_full(bars, b), halves * P * F_BOX);
    for (int c = 0; c < halves; ++c)
      for (int x = 0; x < P; ++x)
        load_box(base + b * L::Q_BYTES + (c * P + x) * F_BOX, tq, L::q_full(bars, b), x * 64,
                 it.q0 + c * TILE, coord(p, Q, it.b, it.h));
    for (int j = 0; j < it.nk; ++j)
      for (int w = 0; w < 2; ++w)
        for (int x = 0; x < P; ++x, ++kv.n) {
          const int s = kv.slot();
          mbar_wait(L::empty(bars, s), kv.parity() ^ 1u);
          mbar_expect_tx(L::full(bars, s), F_BOX);
          load_box(base + L::RING + s * F_BOX, w ? tv : tk, L::full(bars, s), x * 64, j * TILE,
                   coord(p, w ? V : K, it.b, it.h));
        }
  }
}

template <int P>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_wide_fwd_f32_rows(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, Params p) {
  using L = FRows<P>;
  extern __shared__ unsigned char smem_fr[];
  const uint32_t base = (smem_addr(smem_fr) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    const uint32_t bars = base + L::BARS;
    for (int b = 0; b < L::Q_BUFS; ++b) {
      mbar_init(L::q_full(bars, b), 1);
      mbar_init(L::q_empty(bars, b), 8);  // each of the two consumers' four warps
    }
    for (int s = 0; s < L::SLOTS; ++s) {
      mbar_init(L::full(bars, s), 1);
      mbar_init(L::empty(bars, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PRODUCER_REGS));
    if (threadIdx.x == 256) fwd_rows_producer<P>(&tq, &tk, &tv, p, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_CONSUMER_REGS));
    if (wg == 0)
      fwd_rows_consumer<P, 0>(p, base, threadIdx.x % 128);
    else
      fwd_rows_consumer<P, 1>(p, base, threadIdx.x % 128);
  }
}

// Consumer warpgroup W of the fp32 dq pass, over all 64 rows of each item
// (the forward's items, 64 query rows and a slab of dq, with slabs of at
// most MAXB boxes):
// W = 0 reduces s = q·kᵀ over the head (a q box and a k box a slot) and
// forms p = 2^(s·scale·log2e − lse·log2e), W = 1 dp = do·vᵀ (a do box and a
// v box) and dp − delta; they swap these through the two exchange buffers
// and both form ds = p∘(dp − delta), the same fp32 products, so the same
// bits.  Each then accumulates the 32-column half W of every box of the
// slab, dq += ds·k (k MN-major, 4 halves a slot), so the two do the same
// products whatever the slab's count of boxes (one at Dh 64).
template <int W, int MAXB>
__device__ __forceinline__ void dq_f32_consumer(const Params& p, uint32_t base, int tid) {
  constexpr int MINE = F_EXCH + W * F_PART * 4, OTHER = F_EXCH + (1 - W) * F_PART * 4;
  const int lane = tid % 32;
  FRing<W, F_FWD_BARS> rg{{}, base};
  for (int i = blockIdx.x; i < fwd_shape(p, MAXB).items; i += gridDim.x) {
    float acc[16 * MAXB];  // half W of each of the slab's boxes, 16 values a half
#pragma unroll
    for (int e = 0; e < 16 * MAXB; ++e) acc[e] = 0.f;
    const FShape sp0 = fwd_shape(p, MAXB);
    const FwdItem it0 = fwd_item(i, p, sp0.tiles, sp0.slabs);
    const int nk = it0.nk, nb = it0.slab.n;  // the item's key tiles and boxes of dq
    for (int j = 0; j < nk; ++j) {
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
#pragma unroll 1
      for (int x = 0; x < opaque(p.D) / 64; ++x) {
        const uint32_t slot = rg.acquire();
        reduce_box(sc, slot, slot + F_BOX);
        rg.release_slot(lane);
      }
      {
        // W = 0: p = 2^(s·scale·log2e − lse·log2e), masked only where a key
        // tail or the causal diagonal cuts the tile (and 0 past Sq: lse is
        // taken as +inf there); W = 1: dp − delta (0 past Sq).  At 8 boxes
        // the item's coordinates and the thread's rows are computed afresh
        // here, not held through the products (128 registers of dq leave no
        // room for them: holding them spilled 20 bytes); at 2 they are the
        // item's.
        const FwdItem it = MAXB > F_DQ_NARROW
                               ? fwd_item(opaque(i), p, fwd_shape(p, MAXB).tiles,
                                          fwd_shape(p, MAXB).slabs)
                               : it0;
        const int c = MAXB > F_DQ_NARROW ? ctid() : tid;
        const int t = c % 4, row0 = it.q0 + 16 * (c / 32) + c % 32 / 4;
        const float* const stat =
            (W ? p.delta : p.lse) + ((long long)it.b * p.H + it.h) * p.Sq;
        float st[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          st[r] = row < p.Sq ? stat[row] * (W ? 1.f : LOG2E) : (W ? 0.f : INFINITY);
        }
        const int k0 = j * TILE;
        const bool edge = k0 + TILE > p.Sk || (p.causal && k0 + TILE - 1 > it.q0);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            if (W == 0) {
              float pe = exp2_ftz(fmaf(sc[4 * n + e], p.scale * LOG2E, -st[r]));
              if (edge) {
                const int key = k0 + n * 8 + 2 * t + (e & 1);
                if (key >= p.Sk || (p.causal && key > row0 + 8 * r)) pe = 0.f;
              }
              sc[4 * n + e] = pe;
            } else {
              sc[4 * n + e] -= st[r];
            }
          }
      }
      // the swap (BAR_FREE: the other has read the last one); both then
      // hold ds = p∘(dp − delta)
      named_sync(BAR_FREE, 256);
      put_block_s(base + MINE, sc, tid);
      named_sync(BAR_FULL, 256);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 w = get4_s(base + OTHER, v, tid);
        sc[4 * v] *= w.x;
        sc[4 * v + 1] *= w.y;
        sc[4 * v + 2] *= w.z;
        sc[4 * v + 3] *= w.w;
      }
      // dq += ds·k over half W of each of the slab's boxes, 4 halves a slot
      uint32_t slot = 0;
#pragma unroll
      for (int x = 0; x < MAXB; ++x) {
        if (x >= nb) break;
        if (x % 4 == 0) slot = rg.acquire();
        product_box<4>(*reinterpret_cast<float(*)[16]>(acc + 16 * x), sc,
                       slot + (x % 4) * F_HALF);
        if (x % 4 == 3 || x == nb - 1) rg.release_slot(lane);
      }
    }
    // dq times scale straight from the registers, rows past Sq not written
    // (at 8 boxes the item's coordinates computed again, not held through
    // the loop)
    const FwdItem it = MAXB > F_DQ_NARROW
                           ? fwd_item(opaque(i), p, fwd_shape(p, MAXB).tiles,
                                      fwd_shape(p, MAXB).slabs)
                           : it0;
    const int t = lane & 3;
    float* const out = static_cast<float*>(p.out) + it.b * p.st[OUT][0] + it.h * p.st[OUT][1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = it.q0 + 16 * (tid / 32) + lane / 4 + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int x = 0; x < MAXB; ++x) {
        if (x >= it.slab.n) break;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(out + row * p.st[OUT][2] + (it.slab.first + x) * 64 +
                                     32 * W + 8 * n + 2 * t) =
              make_float2(acc[16 * x + 4 * n + 2 * r] * p.scale,
                          acc[16 * x + 4 * n + 2 * r + 1] * p.scale);
      }
    }
  }
}

// The fp32 dq pass's producer thread: for each key tile of an item, the
// head's boxes for the reductions (q and k to consumer 0, do and v to 1),
// then the slab's k halves for the products (half w of each box to
// consumer w, 4 a slot), the two consumers' loads interleaved.
template <int MAXB>
__device__ __forceinline__ void dq_f32_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                                const CUtensorMap* tv, const CUtensorMap* tdo,
                                                const Params& p, uint32_t base) {
  const uint32_t bars = base + F_FWD_BARS;
  const FShape sp = fwd_shape(p, MAXB);
  const int P = sp.P;
  Ring<F_SLOTS> r0, r1;
  for (int i = blockIdx.x; i < sp.items; i += gridDim.x) {
    const FwdItem it = fwd_item(i, p, sp.tiles, sp.slabs);
    const Coord ck = coord(p, K, it.b, it.h);
    for (int j = 0; j < it.nk; ++j)
      for (int x = 0; x < P + (it.slab.n + 3) / 4; ++x)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          Ring<F_SLOTS>& r = w ? r1 : r0;
          if (x < P) {
            const FFill f = f_fill(r, base, bars, w, 2 * F_BOX);
            load_box(f.slot, w ? tdo : tq, f.full, x * 64, it.q0, coord(p, w ? DO : Q, it.b, it.h));
            load_box(f.slot + F_BOX, w ? tv : tk, f.full, x * 64, j * TILE,
                     coord(p, w ? V : K, it.b, it.h));
          } else {
            const int y0 = 4 * (x - P), n = min(4, it.slab.n - y0);
            const FFill f = f_fill(r, base, bars, w, n * F_HALF);
            for (int y = 0; y < n; ++y)
              tma_load(f.slot + y * F_HALF, tk, f.full, (it.slab.first + y0 + y) * 64 + 32 * w,
                       j * TILE, ck.h, ck.b);
          }
        }
  }
}

template <int MAXB>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_wide_bwd_dq_f32(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, Params p) {
  extern __shared__ unsigned char smem_fq[];
  const uint32_t base = (smem_addr(smem_fq) + 1023u) & ~1023u;
  if (threadIdx.x == 0) f_init(base + F_FWD_BARS);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PRODUCER_REGS));
    if (threadIdx.x == 256) dq_f32_producer<MAXB>(&tq, &tk, &tv, &tdo, p, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_CONSUMER_REGS));
    if (wg == 0)
      dq_f32_consumer<0, MAXB>(p, base, threadIdx.x % 128);
    else
      dq_f32_consumer<1, MAXB>(p, base, threadIdx.x % 128);
  }
}

// Work item i of the fp32 dk/dv pass: slab s of `slabs` even slabs (at most
// 4 boxes each) of a key tile, the slabs side by side; causal launches walk
// the key tiles from the first (most query tiles) up.  (The streamed 16-bit
// pass's items, dkv_item<512, true>, with the counts passed in: computed
// there from the parameters, they cost the dk/dv consumers a register
// spill.)
__device__ __forceinline__ DkvItem dkv_f32_item(int i, const Params& p, int nkt, int slabs) {
  const int bhn = p.B * p.H;
  const int s = i % slabs;
  i /= slabs;
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
  it.k0 = kt * TILE;
  it.j0 = p.causal ? it.k0 / TILE : 0;
  it.slab = slab_of(s, slabs, p.D / 64);
  return it;
}

__host__ __device__ __forceinline__ int dkv_f32_slabs(int P) { return (P + 3) / 4; }

__device__ __forceinline__ FShape dkv_shape(const Params& p) {
  const int P = opaque(p.D) / 64, slabs = dkv_f32_slabs(P);
  const int tiles = (opaque(p.Sk) + TILE - 1) / TILE;
  return {P, slabs, tiles, p.B * p.H * tiles * slabs};
}

// Consumer warpgroup W of the fp32 dk/dv pass, over the item's 64 keys: W =
// 0 computes sᵀ = k·qᵀ over the head, pᵀ, and dv += pᵀ·do over the item's
// slab; W = 1 dpᵀ = v·doᵀ, dsᵀ = pᵀ∘(dpᵀ − delta) with pᵀ from W = 0, and
// dk += dsᵀ·q.  Each reduction slot holds its k (or v) box and q (or do)
// box, each product slot its do (or q) box.
template <int W>
__device__ __forceinline__ void dkv_f32_consumer(const Params& p, uint32_t base, int tid) {
  const float stat_mul = W ? 1.f : LOG2E;  // delta, or lse in log2 units
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;  // this thread's keys of the item: rl, rl + 8
  const float sl2 = p.scale * LOG2E;
  FRing<W, F_DKV_BARS> rg{{}, base};
  uint32_t ntile = 0;
  for (int i = blockIdx.x; i < dkv_shape(p).items; i += gridDim.x) {
    float acc[128];  // dv (W = 0) or dk over the slab's boxes
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.f;
    {
      const FShape sp = dkv_shape(p);
      const int P = sp.P, nqt = (p.Sq + TILE - 1) / TILE;
      const DkvItem it = dkv_f32_item(i, p, sp.tiles, sp.slabs);
      const int key0 = it.k0 + rl;
      for (int j = it.j0; j < nqt; ++j, ++ntile) {
        const int q0 = j * TILE;
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
#pragma unroll 1
        for (int x = 0; x < P; ++x) {
          const uint32_t slot = rg.acquire();
          reduce_box(sc, slot, slot + F_BOX);
          rg.release_slot(lane);
        }
        // lse·log2e (W = 0) or delta of this thread's 16 queries
        const float* const stat = (W ? p.delta : p.lse) + ((long long)it.b * p.H + it.h) * p.Sq;
        float2 st[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int qi = q0 + n * 8 + 2 * t;
          st[n].x = qi < p.Sq ? stat[qi] * stat_mul : 0.f;
          st[n].y = qi + 1 < p.Sq ? stat[qi + 1] * stat_mul : 0.f;
        }
        // masked only where a query tail or the causal diagonal cuts the block
        const bool edge = q0 + TILE > p.Sq || (p.causal && q0 < it.k0 + TILE - 1);
        if (W == 0) {
          // pᵀ = 2^(sᵀ·scale·log2e − lse·log2e), to the other warpgroup in fp32
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = e & 1;
              float pe = exp2_ftz(fmaf(sc[4 * n + e], sl2, -(c ? st[n].y : st[n].x)));
              if (edge) {
                const int qi = q0 + n * 8 + 2 * t + c;
                if (qi >= p.Sq || (p.causal && qi < key0 + 8 * (e >> 1))) pe = 0.f;
              }
              sc[4 * n + e] = pe;
            }
          if (ntile > 0) named_sync(BAR_FREE, 256);  // the other has read the last pᵀ
          put_block_s(base + F_EXCH, sc, tid);
          named_arrive(BAR_FULL, 256);
        } else {
          // dsᵀ = pᵀ∘(dpᵀ − delta), pᵀ as the other warpgroup computed it
          named_sync(BAR_FULL, 256);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float4 pv = get4_s(base + F_EXCH, n, tid);
            sc[4 * n] = pv.x * (sc[4 * n] - st[n].x);
            sc[4 * n + 1] = pv.y * (sc[4 * n + 1] - st[n].y);
            sc[4 * n + 2] = pv.z * (sc[4 * n + 2] - st[n].x);
            sc[4 * n + 3] = pv.w * (sc[4 * n + 3] - st[n].y);
          }
          named_arrive(BAR_FREE, 256);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (x >= it.slab.n) break;
          const uint32_t slot = rg.acquire();
          product_box<8>(*reinterpret_cast<float(*)[32]>(acc + 32 * x), sc, slot);
          rg.release_slot(lane);
        }
      }
    }
    // dv, or dk times scale, straight from the registers; keys past Sk not
    // written (the item's coordinates computed again, not held through the
    // loop)
    const FShape sp = dkv_shape(p);
    const DkvItem it = dkv_f32_item(i, p, sp.tiles, sp.slabs);
    const int which = W ? DK : DV;
    float* const out = static_cast<float*>(W ? p.dk : p.dv) + it.b * p.st[which][0] +
                       it.h * p.st[which][1];
    const float mul = W ? p.scale : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = it.k0 + rl + 8 * r;
      if (key >= p.Sk) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (x >= it.slab.n) break;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(out + key * p.st[which][2] + (it.slab.first + x) * 64 +
                                     8 * n + 2 * t) =
              make_float2(acc[32 * x + 4 * n + 2 * r] * mul, acc[32 * x + 4 * n + 2 * r + 1] * mul);
      }
    }
  }
  // the other warpgroup's last arrival on BAR_FREE
  if (W == 0 && ntile > 0) named_sync(BAR_FREE, 256);
}

// The fp32 dk/dv pass's producer thread: for each query tile of an item,
// the head's boxes for the reductions (k and q to consumer 0, v and do to
// 1), then the slab's for the products (do to 0, q to 1), the two
// consumers' loads interleaved.
__device__ __forceinline__ void dkv_f32_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                                 const CUtensorMap* tv, const CUtensorMap* tdo,
                                                 const Params& p, uint32_t base) {
  const uint32_t bars = base + F_DKV_BARS;
  const FShape sp = dkv_shape(p);
  const int P = sp.P, nqt = (p.Sq + TILE - 1) / TILE;
  Ring<F_SLOTS> r0, r1;
  for (int i = blockIdx.x; i < sp.items; i += gridDim.x) {
    const DkvItem it = dkv_f32_item(i, p, sp.tiles, sp.slabs);
    for (int j = it.j0; j < nqt; ++j)
      for (int x = 0; x < P + it.slab.n; ++x)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          Ring<F_SLOTS>& r = w ? r1 : r0;
          if (x < P) {
            const FFill f = f_fill(r, base, bars, w, 2 * F_BOX);
            load_box(f.slot, w ? tv : tk, f.full, x * 64, it.k0, coord(p, w ? V : K, it.b, it.h));
            load_box(f.slot + F_BOX, w ? tdo : tq, f.full, x * 64, j * TILE,
                     coord(p, w ? DO : Q, it.b, it.h));
          } else {
            const FFill f = f_fill(r, base, bars, w, F_BOX);
            load_box(f.slot, w ? tq : tdo, f.full, (it.slab.first + x - P) * 64, j * TILE,
                     coord(p, w ? Q : DO, it.b, it.h));
          }
        }
  }
}

__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_wide_bwd_dkv_f32(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, Params p) {
  extern __shared__ unsigned char smem_fd[];
  const uint32_t base = (smem_addr(smem_fd) + 1023u) & ~1023u;
  if (threadIdx.x == 0) f_init(base + F_DKV_BARS);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PRODUCER_REGS));
    if (threadIdx.x == 256) dkv_f32_producer(&tq, &tk, &tv, &tdo, p, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_CONSUMER_REGS));
    if (wg == 0)
      dkv_f32_consumer<0>(p, base, threadIdx.x % 128);
    else
      dkv_f32_consumer<1>(p, base, threadIdx.x % 128);
  }
}

// A 4-D map of operand `which` over rows [0, S) of the head's D columns,
// 64-row boxes of 64 columns.
template <typename T>
bool map_of(CUtensorMap* map, const Params& p, int which, const void* ptr, int S) {
  return encode<64>(map, map_type<T>(), ptr, S, p.H, p.B, p.st[which][2], p.st[which][1],
                    p.st[which][0], TILE, p.D);
}

// The persistent grid: as many blocks as the card holds at once, at most
// one per work item.
template <typename Kernel, typename... Maps>
cudaError_t launch_persistent(Capacity& cache, Kernel kernel, int smem, long long items,
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

// The forward at a head of D columns, or streamed (D = 512) at a wider one.
template <typename T, int D, bool STREAM>
cudaError_t run_fwd_tma(const Params& p, cudaStream_t stream) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  CUtensorMap tq, tk, tv, to;
  bool ok = map_of<T>(&tq, p, Q, p.q, p.Sq) && map_of<T>(&to, p, OUT, p.out, p.Sq);
  if (p.Sk > 0) {
    ok = ok && map_of<T>(&tk, p, K, p.k, p.Sk) && map_of<T>(&tv, p, V, p.v, p.Sk);
  } else {  // no K/V tile is ever loaded; a map needs a nonempty extent
    tk = tq;
    tv = tq;
  }
  if (!ok) return cudaErrorInvalidValue;
  static Capacity cache;
  const long long items =
      (long long)fwd_slabs(p, STREAM) * p.B * p.H * ((p.Sq + TILE - 1) / TILE);
  return launch_persistent(cache, flash_wide_fwd_tma<T, D, STREAM>, FwdTiles<D>::SMEM, items,
                           stream, p, tq, tk, tv, to);
}

// The dq kernel (streamed at D = 512 for a wider head).  With Sk = 0 no
// k or v box is ever loaded (a map needs a nonempty extent) and dq is 0.
template <typename T, int D, bool STREAM>
cudaError_t run_dq_tma(const Params& p, cudaStream_t stream) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  CUtensorMap tq, tk, tv, tdo, tdq;
  bool ok = map_of<T>(&tq, p, Q, p.q, p.Sq) && map_of<T>(&tdo, p, DO, p.dout, p.Sq) &&
            map_of<T>(&tdq, p, OUT, p.out, p.Sq);
  if (p.Sk > 0) {
    ok = ok && map_of<T>(&tk, p, K, p.k, p.Sk) && map_of<T>(&tv, p, V, p.v, p.Sk);
  } else {
    tk = tq;
    tv = tq;
  }
  if (!ok) return cudaErrorInvalidValue;
  static Capacity cache;
  const long long items =
      (long long)fwd_slabs(p, STREAM) * p.B * p.H * ((p.Sq + TILE - 1) / TILE);
  return launch_persistent(cache, flash_wide_bwd_dq_tma<T, D, STREAM>, DqTiles<D, STREAM>::SMEM,
                           items, stream, p, tq, tk, tv, tdo, tdq);
}

// The dk/dv kernel (streamed at D = 512 for a wider head).
template <typename T, int D, bool STREAM>
cudaError_t run_dkv_tma(const Params& p, cudaStream_t stream) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  const bool ok = map_of<T>(&tq, p, Q, p.q, p.Sq) && map_of<T>(&tdo, p, DO, p.dout, p.Sq) &&
                  map_of<T>(&tk, p, K, p.k, p.Sk) && map_of<T>(&tv, p, V, p.v, p.Sk) &&
                  map_of<T>(&tdk, p, DK, p.dk, p.Sk) && map_of<T>(&tdv, p, DV, p.dv, p.Sk);
  if (!ok) return cudaErrorInvalidValue;
  static Capacity cache;
  const long long items =
      (long long)dkv_slabs(p, STREAM) * p.B * p.H * ((p.Sk + TILE - 1) / TILE);
  return launch_persistent(cache, flash_wide_bwd_dkv_tma<T, D, STREAM>,
                           DkvTiles<D, STREAM>::SMEM, items, stream, p, tq, tk, tv, tdo, tdk,
                           tdv);
}

// A 4-D map of an fp32 operand over (Dh, S, H, B): 64-row boxes of 32
// columns (128 bytes), swizzled over 128 bytes; strides as encode<> takes
// them (an expanded head or batch becomes extent 1, an expanded sequence
// fails).
bool map_f32(CUtensorMap* map, const Params& p, int which, const void* ptr, int S) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)p.D, (cuuint64_t)S, (cuuint64_t)p.H, (cuuint64_t)p.B};
  const long long elem[3] = {p.st[which][2], p.st[which][1], p.st[which][0]};
  cuuint64_t strides[3];
  cuuint64_t dense = 4ull * p.D;
  for (int i = 0; i < 3; ++i) {
    if (elem[i] == 0 && dims[i + 1] > 1) {
      if (i == 0) return false;
      dims[i + 1] = 1;
    }
    strides[i] = dims[i + 1] == 1 ? dense : (cuuint64_t)(4 * elem[i]);
    dense = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {32, TILE, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// flash_wide_fwd_f32_rows<P>: an item a 128-row query tile.
template <int P>
cudaError_t run_fwd_rows(const Params& p, cudaStream_t stream, const CUtensorMap& tq,
                         const CUtensorMap& tk, const CUtensorMap& tv) {
  static Capacity cache;
  const long long items = (long long)p.B * p.H * ((p.Sq + F_ROWS - 1) / F_ROWS);
  return launch_persistent(cache, flash_wide_fwd_f32_rows<P>, FRows<P>::SMEM, items, stream, p,
                           tq, tk, tv);
}

// The fp32 forward (split TF32): a head of at most 2 boxes on
// 128-row items, a wider one on flash_wide_fwd_f32's 64-row slab items.
// With Sk = 0 no k or v box is ever loaded.
cudaError_t run_fwd_f32(const Params& p, cudaStream_t stream) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  CUtensorMap tq, tk, tv;
  bool ok = map_f32(&tq, p, Q, p.q, p.Sq);
  if (p.Sk > 0) {
    ok = ok && map_f32(&tk, p, K, p.k, p.Sk) && map_f32(&tv, p, V, p.v, p.Sk);
  } else {
    tk = tq;
    tv = tq;
  }
  if (!ok) return cudaErrorInvalidValue;
  if (p.D == 64) return run_fwd_rows<1>(p, stream, tq, tk, tv);
  if (p.D == 128) return run_fwd_rows<2>(p, stream, tq, tk, tv);
  static Capacity cache;
  const long long items =
      (long long)f32_slabs(p.D / 64, F_FWD_SLAB) * p.B * p.H * ((p.Sq + TILE - 1) / TILE);
  return launch_persistent(cache, flash_wide_fwd_f32, F_FWD_SMEM, items, stream, p, tq, tk, tv);
}

// The fp32 dq pass (split TF32).  With Sk = 0 no k or v box is ever loaded
// and dq is 0.
cudaError_t run_dq_f32(const Params& p, cudaStream_t stream) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  CUtensorMap tq, tk, tv, tdo;
  bool ok = map_f32(&tq, p, Q, p.q, p.Sq) && map_f32(&tdo, p, DO, p.dout, p.Sq);
  if (p.Sk > 0) {
    ok = ok && map_f32(&tk, p, K, p.k, p.Sk) && map_f32(&tv, p, V, p.v, p.Sk);
  } else {
    tk = tq;
    tv = tq;
  }
  if (!ok) return cudaErrorInvalidValue;
  const long long tiles = (long long)p.B * p.H * ((p.Sq + TILE - 1) / TILE);
  if (p.D / 64 <= F_DQ_NARROW) {
    static Capacity cache;
    return launch_persistent(cache, flash_wide_bwd_dq_f32<F_DQ_NARROW>, F_FWD_SMEM, tiles,
                             stream, p, tq, tk, tv, tdo);
  }
  static Capacity cache;
  return launch_persistent(cache, flash_wide_bwd_dq_f32<F_DQ_SLAB>, F_FWD_SMEM,
                           f32_slabs(p.D / 64, F_DQ_SLAB) * tiles, stream, p, tq, tk, tv, tdo);
}

// The fp32 dk/dv pass (split TF32).
cudaError_t run_dkv_f32(const Params& p, cudaStream_t stream) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  CUtensorMap tq, tk, tv, tdo;
  const bool ok = map_f32(&tq, p, Q, p.q, p.Sq) && map_f32(&tdo, p, DO, p.dout, p.Sq) &&
                  map_f32(&tk, p, K, p.k, p.Sk) && map_f32(&tv, p, V, p.v, p.Sk);
  if (!ok) return cudaErrorInvalidValue;
  static Capacity cache;
  const long long items =
      (long long)dkv_f32_slabs(p.D / 64) * p.B * p.H * ((p.Sk + TILE - 1) / TILE);
  return launch_persistent(cache, flash_wide_bwd_dkv_f32, F_DKV_SMEM, items, stream, p, tq, tk,
                           tv, tdo);
}

// pass 0: the forward, 1: dq, 2: dk/dv.
template <typename T, int D, bool STREAM = false>
cudaError_t run_tma(const Params& p, int pass, cudaStream_t s) {
  if (pass == 0) return run_fwd_tma<T, D, STREAM>(p, s);
  return pass == 1 ? run_dq_tma<T, D, STREAM>(p, s) : run_dkv_tma<T, D, STREAM>(p, s);
}

// At a 16-bit head of D columns: an instance a width up to 512, the
// streamed one above.
template <typename T>
cudaError_t dispatch_tma(const Params& p, int pass, cudaStream_t s) {
  switch (p.D) {
    case 320: return run_tma<T, 320>(p, pass, s);
    case 384: return run_tma<T, 384>(p, pass, s);
    case 448: return run_tma<T, 448>(p, pass, s);
    case 512: return run_tma<T, 512>(p, pass, s);
    default: return run_tma<T, 512, true>(p, pass, s);
  }
}

// The backward: delta = rowsum(do∘o) once, then the dq pass and the dk/dv
// pass, each when asked for.
template <typename T>
cudaError_t backward(const Params& p, bool dq, bool dkv, cudaStream_t s) {
  if (!dq && !dkv) return cudaSuccess;
  const long long per_block = 8 * (32 / delta_lanes<T>(p.D));  // rows: 8 warps
  const long long blocks = ((long long)p.B * p.H * p.Sq + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_wide_bwd_delta<T><<<(unsigned)blocks, 256, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if constexpr (std::is_same<T, float>::value) {
    if (e == cudaSuccess && dq) e = run_dq_f32(p, s);
    if (e == cudaSuccess && dkv) e = run_dkv_f32(p, s);
  } else {
    if (e == cudaSuccess && dq) e = dispatch_tma<T>(p, 1, s);
    if (e == cudaSuccess && dkv) e = dispatch_tma<T>(p, 2, s);
  }
  return e;
}

// The head dims the kernels take: multiples of one column box.
constexpr int D_STEP = 64;

// What every call must be: a head dim the kernels take and a known dtype.
cudaError_t check(int dtype, const Params& p) {
  if (p.D <= 0 || p.D % D_STEP != 0 || dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  if ((long long)p.B * p.H > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

void read_strides(Params& p, const long long* strides, int n) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  D: the (padded) head dim, a
// multiple of 64: the wrapper sends a 16-bit head here above 256 (narrower
// ones to flash_fwd.cu) and an fp32 one at every width (up to 128 columns
// flash_wide_fwd_f32_rows, above flash_wide_fwd_f32).  strides: 12 element
// strides, (batch, head, sequence) of q, k, v and o.  lse: [B*H, Sq] fp32 or
// null.  Nothing is launched for Sq = 0.  Returns the cudaError_t of the
// launch (0 on success); never synchronises.
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
  const cudaError_t e = check(dtype, p);
  if (e != cudaSuccess || B <= 0 || H <= 0 || Sq <= 0) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)run_fwd_f32(p, s);
    case 1: return (int)dispatch_tma<__half>(p, 0, s);
    default: return (int)dispatch_tma<__nv_bfloat16>(p, 0, s);
  }
}

// The backward: the dq pass when dq is given, the dk/dv pass when dk and dv
// are.  D: the (padded) head dim, a multiple of 64; the wrapper sends a
// 16-bit head here above 256 and an fp32 one at every width.  strides: 24 element strides, (batch, head, sequence) of q, k, v, o,
// do, dq, dk and dv (those of absent outputs are ignored).  lse: the
// forward's [B*H, Sq] fp32.  delta: [B*H, Sq] fp32 scratch, which one
// launch fills with rowsum(do∘o) before the passes, which read it.  Nothing
// is launched for Sq = 0, nor the dk/dv pass for Sk = 0.  Returns the first
// nonzero cudaError_t, or 0.
extern "C" int mx_flash_wide_bwd(int dtype, const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const float* lse,
                                 float* delta, void* dq, void* dk, void* dv, int B, int H,
                                 int Sq, int Sk, int D, const long long* strides, float scale,
                                 int causal, void* stream) {
  if (lse == nullptr || delta == nullptr || (dk == nullptr) != (dv == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.out = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  read_strides(p, strides, 8);
  p.scale = scale;
  p.causal = causal;
  cudaError_t e = check(dtype, p);
  if (e != cudaSuccess || B <= 0 || H <= 0 || Sq <= 0) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dkv = dk != nullptr && Sk > 0;
  switch (dtype) {
    case 0: return (int)backward<float>(p, dq != nullptr, dkv, s);
    case 1: return (int)backward<__half>(p, dq != nullptr, dkv, s);
    default: return (int)backward<__nv_bfloat16>(p, dq != nullptr, dkv, s);
  }
}
