// A warp-specialised wgmma/TMA GEMM mainloop for Hopper (sm_90a), shared by
// the kernels of lm_head_ce_sm90.cu.
//
// A block computes 128 x 128 output tiles of C = A B with fp32 accumulators
// in registers, from bf16 or fp16 operands streamed through shared memory:
//
// - warpgroup 0 is the producer: one thread issues TMA loads of 64-deep
//   K-stages into a ring of STAGES stages (16 KB of A and 16 KB of B each,
//   128-byte swizzled), signalling each stage's `full` mbarrier with the
//   bytes it expects;
// - warpgroups 1 and 2 are the consumers, 64 output rows each: they wait
//   on a stage's `full` barrier, issue four m64n128k16 `wgmma`s over it,
//   and release the stage before (its products are done, wgmma.wait_group
//   1) on its `empty` barrier, so one stage's products overlap the next
//   stage's issue and the producer's loads run STAGES deep ahead;
// - `setmaxnreg` gives the producer 40 registers a thread and the
//   consumers 232 (the 64 accumulators and the epilogue's state).
//
// Operands are K-major (K contiguous in memory: one TMA box of 64 K x 128
// rows) or MN-major (M or N contiguous: two boxes of 64 M/N x 64 K, one per
// 64-wide swizzle atom), chosen per operand at compile time and read
// through the wgmma transpose bits, so a product over a transposed operand
// (G^T x, G E) needs no transposed copy. TMA fills rows and columns past a
// tensor's extent with zeros, so ragged M, N and K add nothing to the sums;
// the epilogues mask their stores by index.
//
// A kernel is wg::gemm_kernel<Epi>: Epi says how many tiles a block runs,
// each tile's (m0, n0) and K depth, and what happens to the accumulators
// (Epi::tile, on registers, in the consumer threads) and after the last
// tile (Epi::finish). The accumulator layout of m64nNk16: consumer thread
// t (of 128) holds, for 8-column block nb and i in 0..3, row
// 16 (t / 32) + (t % 32) / 4 + 8 (i / 2) and column 8 nb + 2 (t % 4) +
// (i % 2) of its warpgroup's 64 x 128 tile, in acc[4 nb + i].
//
// The host side encodes the TMA descriptors with cuTensorMapEncodeTiled,
// obtained from the driver through cudaGetDriverEntryPointByVersion, so the
// library links against the runtime only (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wg {

constexpr int BM = 128;               // output rows a block (2 x 64)
constexpr int BN = 128;               // output columns a block
constexpr int BK = 64;                // K a stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;          // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int TILE_BYTES = BM * BK * 2;            // 16 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;         // one 64-row box
constexpr int STAGE_BYTES = 2 * TILE_BYTES;        // A and B
constexpr size_t SMEM_BYTES =
    (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment
constexpr int ACC = BN / 2;           // accumulators a consumer thread

// ---------------------------------------------------------------------------
// device primitives (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_R8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_MMA(TYPE)                                                      \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "\
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                \
      "%64, %65, p, 1, 1, %67, %68;\n"                                    \
      "}\n"                                                               \
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),   \
        WG_R8(48), WG_R8(56)                                              \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

// d[64] += A[64 x 16] B[16 x 128] (one warpgroup); TA / TB: the operand is
// MN-major (the transpose bit)
template <typename T, int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[ACC], uint64_t da,
                                               uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    WG_MMA("f16");
  } else {
    WG_MMA("bf16");
  }
}
#undef WG_MMA
#undef WG_R8

// Descriptors of k-step j (16 deep) of a stage. K-major: rows of 128 bytes
// (64 K), 8-row groups 1024 bytes apart, a k-step 32 bytes along the row.
// MN-major: K rows of 128 bytes (64 M/N), 8-row groups 1024 bytes apart, a
// k-step 16 rows (2048 bytes) down, the second 64-wide atom 8 KB on.
template <bool MN>
__device__ __forceinline__ uint64_t stage_desc(const uint8_t* tile, int j) {
  return MN ? make_desc(tile + j * 2048, HALF_BYTES, 1024)
            : make_desc(tile + j * 32, 16, 1024);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Epi (a struct passed by value) provides:
//   static constexpr bool A_MN, B_MN;   operand majors
//   using T = element type (__nv_bfloat16 or __half)
//   int tiles() const;                  tiles this block runs
//   int2 origin(int t) const;           (m0, n0) of tile t
//   int ksteps() const;                 64-deep K-stages a tile
//   void begin(int cw) ...              consumer set-up (state in `st`)
//   void tile(float (&acc)[64], int t, int cw, State& st) const;
//   void finish(int cw, State& st) const;
// with `using State = ...` a per-thread state struct.
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const Epi epi) {
  using T = typename Epi::T;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = base;                                   // [STAGES][16 KB]
  uint8_t* sb = base + STAGES * TILE_BYTES;             // [STAGES][16 KB]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * TILE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    prefetch_map(&map_a);
    prefetch_map(&map_b);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ntiles = epi.tiles(), nk = epi.ksteps();
  if (wgi == 0) {
    // ---- producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        const int2 o = epi.origin(t);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint64_t* bar = &full[stage];
          mbar_expect_tx(bar, STAGE_BYTES);
          uint8_t* a = sa + stage * TILE_BYTES;
          uint8_t* b = sb + stage * TILE_BYTES;
          const int k0 = kb * BK;
          if constexpr (Epi::A_MN) {
            tma_load(a, &map_a, bar, o.x, k0);
            tma_load(a + HALF_BYTES, &map_a, bar, o.x + 64, k0);
          } else {
            tma_load(a, &map_a, bar, k0, o.x);
          }
          if constexpr (Epi::B_MN) {
            tma_load(b, &map_b, bar, o.y, k0);
            tma_load(b + HALF_BYTES, &map_b, bar, o.y + 64, k0);
          } else {
            tma_load(b, &map_b, bar, k0, o.y);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each
    setmaxnreg_inc<232>();
    const int cw = wgi - 1;
    const bool signal = threadIdx.x % 128 == 0;
    typename Epi::State st;
    epi.begin(cw, st);
    int stage = 0;
    uint32_t phase = 0;
    float acc[ACC];
    for (int t = 0; t < ntiles; ++t) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = sa + stage * TILE_BYTES + cw * HALF_BYTES;
        const uint8_t* b = sb + stage * TILE_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
          mma_m64n128k16<T, Epi::A_MN ? 1 : 0, Epi::B_MN ? 1 : 0>(
              acc, stage_desc<Epi::A_MN>(a, j), stage_desc<Epi::B_MN>(b, j));
        wgmma_commit();
        wgmma_wait<1>();            // the previous stage's products are done
        fence_acc(acc);
        if (prev >= 0 && signal) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && signal) mbar_arrive(&empty[prev]);
      epi.tile(acc, t, cw, st);
    }
    epi.finish(cw, st);
  }
}

// The position of accumulator i of consumer thread `t` (0..127) in its
// warpgroup's 64 x 128 tile.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i / 4) + 2 * (t % 4) + (i % 2);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of an operand, a row-major [rows, cols] matrix (row stride `ld`
// elements): boxes of 64 columns (128 bytes, swizzled) x 128 rows for a
// K-major operand, x 64 rows (K) for an MN-major one; zeros past the
// extent. False when the driver refuses it.
template <typename T>
bool operand_map(CUtensorMap* map, const void* ptr, long rows, long cols,
                 long ld, bool mn_major) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {64, mn_major ? 64u : 128u};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Epi>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b,
                   const Epi& epi, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_kernel<Epi><<<grid, THREADS, SMEM_BYTES, stream>>>(a, b, epi);
  return cudaGetLastError();
}

}  // namespace wg
