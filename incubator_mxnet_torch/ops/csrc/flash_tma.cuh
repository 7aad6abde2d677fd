// What the Hopper attention kernels share (flash_fwd.cu's forward and
// flash_bwd.cu's dq and dk/dv passes): the layout of a 16-bit tile as TMA
// writes it into shared memory, the ring arithmetic of a pipeline of
// stages, mbarrier, TMA and warpgroup-MMA (wgmma) wrappers, the 4-D tensor
// maps over (Dh, S, H, B) and the persistent grid's size.
//
// A tile of ROWS rows by D columns arrives as D / BOX column boxes of
// ROWS rows, each row W = 2·BOX bytes long and swizzled by TMA over W bytes
// (128 B for Dh 64/128, 64 B for 32, 32 B for 16): chunk c of row r (16
// bytes) lands at r·W + ((c ^ f(r)) << 4).  The wgmma descriptors name the
// same swizzle, so a tile is read as a K-major operand (its columns the
// reduction) or an MN-major one (its rows the reduction) with no copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A ROWS x D tile of a 16-bit operand as TMA lays it out in shared memory.
template <int D, int ROWS>
struct Box {
  static constexpr int BOX = D < 64 ? D : 64;  // columns of one TMA box
  static constexpr int W = BOX * 2;            // bytes of a box row = swizzle span
  static constexpr int PARTS = D / BOX;        // column boxes of a tile: 2 at Dh=128
  static constexpr int PART = ROWS * W;        // bytes of one column box
  static constexpr int BYTES = ROWS * D * 2;   // bytes of the tile
  static constexpr int LAYOUT = W == 128 ? 1 : W == 64 ? 2 : 3;  // wgmma swizzle code
};

// The n-th use of a slot of an N-slot ring: slot n % N, and the mbarrier
// phase of that use has parity (n / N) & 1.  Consumers wait for that parity
// on a "full" barrier; the producer waits for the opposite parity on an
// "empty" one, which a fresh barrier passes at once.
template <int N>
struct Ring {
  uint32_t n = 0;
  __device__ __forceinline__ int slot() const { return (int)(n % N); }
  __device__ __forceinline__ uint32_t parity() const { return (n / N) & 1u; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A warp's arrival on an "empty" barrier (counted per warp), once all its
// lanes are past their reads of the slot.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D map at coordinates (column, row, head, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(row), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c, int row,
                                          int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout code.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x in one MUFU instruction; results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two 16-bit values of one 32-bit word as floats.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w);

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// wgmma accumulator layout (m64nN, fp32): warp w of the warpgroup holds
// rows 16w..16w+15; with g = lane / 4, t = lane % 4, d[4j], d[4j+1] are
// (row g, cols 8j+2t, 8j+2t+1) and d[4j+2], d[4j+3] the same cols of row
// g+8.  The register A operand of m64nNk16 has mma.m16n8k16's A layout:
// a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (row g, k 2t+8..), a3 (row g+8).
// So accumulator columns 16k..16k+15 are, packed in pairs, the A fragment
// of k-step k of the next product (pack_a).
template <typename T>
struct Wgmma;

// The accumulator operands d[i..i+n) of an asm statement.
#define MX_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MX_D16(i) MX_D8(i), MX_D8(i + 8)
#define MX_D32(i) MX_D16(i), MX_D16(i + 16)
#define MX_D64 MX_D32(0), MX_D32(32)

// The asm names of those operands, %0 to %n-1.
#define MX_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define MX_R16 MX_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define MX_R32 \
  MX_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define MX_R64 MX_R32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// m64nNk16 with A and B K-major in shared memory: d[N/2] (+)= A·Bᵀ.
#define MX_WGMMA_SS(TY, N, DREGS, DA, DB, SCALE, DOPS)                                      \
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da, uint64_t db,    \
                                            int accumulate) {                               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "            \
                 DREGS ", " DA ", " DB ", p, 1, 1, 0, 0;\n}\n"                              \
                 : DOPS                                                                     \
                 : "l"(da), "l"(db), "r"(accumulate));                                      \
  }

// m64nNk16 with A from registers and B MN-major in shared memory:
// d[N/2] += A·B.
#define MX_WGMMA_RS(TY, N, DREGS, AREGS, B, SCALE, DOPS)                                    \
  static __device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],      \
                                            uint64_t db) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "            \
                 DREGS ", " AREGS ", " B ", p, 1, 1, 1;\n}\n"                               \
                 : DOPS                                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));            \
  }

// One specialisation per 16-bit type, TY its PTX type suffix.
#define MX_WGMMA(T, TY)                                                                     \
  template <>                                                                               \
  struct Wgmma<T> {                                                                         \
    MX_WGMMA_SS(TY, 64, "{" MX_R32 "}", "%32", "%33", "%34", MX_D32(0))                     \
    MX_WGMMA_SS(TY, 128, "{" MX_R64 "}", "%64", "%65", "%66", MX_D64)                       \
    MX_WGMMA_RS(TY, 16, "{" MX_R8 "}", "{%8, %9, %10, %11}", "%12", "%13", MX_D8(0))        \
    MX_WGMMA_RS(TY, 32, "{" MX_R16 "}", "{%16, %17, %18, %19}", "%20", "%21", MX_D16(0))    \
    MX_WGMMA_RS(TY, 64, "{" MX_R32 "}", "{%32, %33, %34, %35}", "%36", "%37", MX_D32(0))    \
    MX_WGMMA_RS(TY, 128, "{" MX_R64 "}", "{%64, %65, %66, %67}", "%68", "%69", MX_D64)      \
  };

MX_WGMMA(__nv_bfloat16, "bf16")
MX_WGMMA(__half, "f16")
#undef MX_WGMMA
#undef MX_WGMMA_RS
#undef MX_WGMMA_SS
#undef MX_R64
#undef MX_R32
#undef MX_R16
#undef MX_R8
#undef MX_D64
#undef MX_D32
#undef MX_D16
#undef MX_D8

// The k-th 16-column step of a K-major operand laid out as L: which box,
// and 32 bytes per step along its swizzled rows.
template <class L>
__device__ __forceinline__ uint32_t kstep_offset(int k) {
  return (k * 16 / L::BOX) * L::PART + (k * 16 % L::BOX) * 2;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a TMA-swizzled box
// whose rows are W bytes: the chunk index is XORed with address bits 7 and up.
template <int W>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * W + ((chunk ^ ((row * W / 128) % (W / 16))) << 4);
}

// Byte offset of column `col` (even) of row `row` in a tile laid out as L.
template <class L>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col / L::BOX) * L::PART + swizzled<L::W>(row, (col % L::BOX) / 8) + (col % 8) * 2;
}

// One fenced and committed wgmma group: d[N/2] = A·Bᵀ over the D columns
// of both, A (64 rows at `a`, laid out as LA) and B (N rows at `b`, as LB)
// K-major in shared memory.
template <typename T, int D, class LA, class LB, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    Wgmma<T>::ss(d, wgmma_desc(a + kstep_offset<LA>(k), 16, 8 * LA::W, LA::LAYOUT),
                 wgmma_desc(b + kstep_offset<LB>(k), 16, 8 * LB::W, LB::LAYOUT), k > 0);
  wgmma_commit();
}

// One fenced and committed wgmma group: d[D/2] += A·B, A (64 x 16·K) from
// registers in K k-steps and B (16·K rows at `b`, laid out as L) MN-major
// in shared memory.
template <typename T, int D, class L, int K>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], const uint32_t (&a)[K][4],
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < K; ++k)
    Wgmma<T>::rs(d, a[k], wgmma_desc(b + k * 16 * L::W, L::PART, 8 * L::W, L::LAYOUT));
  wgmma_commit();
}

// Accumulator columns as the A fragments of the next product, rounded to T.
template <typename T, int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], const float (&d)[8 * K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k][0] = pack2<T>(d[8 * k + 0], d[8 * k + 1]);
    a[k][1] = pack2<T>(d[8 * k + 2], d[8 * k + 3]);
    a[k][2] = pack2<T>(d[8 * k + 4], d[8 * k + 5]);
    a[k][3] = pack2<T>(d[8 * k + 6], d[8 * k + 7]);
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
  }
  return fn;
}

// cuTensorMapEncodeTiled needs a current context, which a thread that has
// made no runtime call yet (autograd's backward thread, a server's worker)
// lacks: cudaSetDevice makes the current device's primary context current.
inline cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaSetDevice(dev);
}

// A 4-D map over (Dh, S, H, B) of a 16-bit operand, boxes of `rows` rows by
// Box<D, rows>::BOX columns, swizzled by the box row's bytes.  A dimension
// of extent 1 is never stepped, so it gets a dense stride (a 16-byte
// multiple, as TMA requires) whatever the caller's was.  A head or batch
// dimension of stride 0 (an expanded tensor) becomes one of extent 1, which
// the kernels read at coordinate 0; a sequence of stride 0 cannot be read by
// boxes of rows, and fails (the wrapper hands such an operand over
// contiguous).
template <int D>
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int S, int H, int B,
            long long ss, long long sh, long long sb, int rows) {
  using L = Box<D, 64>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const long long elem[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  cuuint64_t dense = 2ull * D;
  for (int i = 0; i < 3; ++i) {
    if (elem[i] == 0 && dims[i + 1] > 1) {
      if (i == 0) return false;
      dims[i + 1] = 1;
    }
    strides[i] = dims[i + 1] == 1 ? dense : (cuuint64_t)(2 * elem[i]);
    dense = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)L::BOX, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// How many blocks of one kernel the current device holds at once, asked of
// the runtime once per device (with the kernel's shared-memory limit
// raised) and kept in `known`, one per kernel instance.
struct Capacity {
  static constexpr int MAX_DEVICES = 64;
  std::atomic<int> known[MAX_DEVICES];  // 0: not asked yet
};

template <typename Kernel>
cudaError_t grid_capacity(Capacity& cache, Kernel kernel, int threads, int smem,
                          long long* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev < Capacity::MAX_DEVICES;
  const int cached = kept ? cache.known[dev].load(std::memory_order_relaxed) : 0;
  if (cached > 0) {
    *blocks = cached;
    return cudaSuccess;
  }
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (kept) cache.known[dev].store(n, std::memory_order_relaxed);
  *blocks = n;
  return cudaSuccess;
}

}  // namespace
