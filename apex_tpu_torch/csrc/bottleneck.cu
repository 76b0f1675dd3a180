// ResNet-50's conv2_x bottleneck in one kernel for Hopper (sm_90a), NHWC
// bf16, batch-norms folded to scale and shift:
//
//   x [N, 56, 56, 256] -> 1x1 w1 [256, 64] -> *g1 + b1 -> relu -> bf16 (h1)
//     -> 3x3 w2 [3, 3, 64, 64] SAME -> *g2 + b2 -> relu -> bf16 (h2)
//     -> 1x1 w3 [64, 256] -> *g3 + b3 -> + x -> relu -> bf16
//
// Replaces the Pallas kernel `_kernel` of scripts/bottleneck_proto.py (:89,
// launched by `pallas_block` :157), which keeps a haloed 58 x 64 x 256 image
// strip (1.9 MB at TILE 56) in VMEM so the [*, 64] intermediates never
// reach HBM. Same arithmetic: products of bf16 values accumulated in fp32,
// the 3x3 as 9 shifted products accumulated in fp32, the folded scale and
// shift in fp32 (a product then a sum, never contracted), h1 and h2 rounded
// to bf16, h1 zeroed outside the image (relu(b1) != 0, so a zero input
// would not give the SAME padding's zero), the residual added in fp32 and
// the output rounded once. Each output tile is computed by one block in
// one fixed sequence of products whatever the batch or the block, so a
// rerun is bitwise and an image gives the same bits alone as in a batch.
//
// Bound on the H100 at N 32: bytes. x and out are 51.4 MB each: 102.8 MB
// at 3.35 TB/s is 0.0307 ms; the products are 100,352 px x 139,264 flops =
// 13.98 GFLOP, 0.0141 ms at 989 TFLOP/s. The library composition writes and
// re-reads the two 12.8 MB squeeze activations and reads x twice (>= 205 MB,
// >= 0.061 ms): keeping h1 and h2 on chip is what the fusion buys.
// Measured at N 32 (scripts/kernel_times.py, NVIDIA H100 80GB HBM3, 700 W):
// 0.0553 ms, 56 % of the byte bound (the first port's kernel: 0.272); a
// band takes ~3.1 us in each warpgroup (scripts/bottleneck_timeline.py).
//
// Design: a persistent kernel with the weights resident in shared memory.
// - Grid: at most one block an SM (`bottleneck_plan` in
//   scripts/bottleneck_proto.py chooses it and the segment length). The
//   image is cut into 4 column strips of 14 output columns and each strip
//   into bands of 4 output rows; a unit of work is a segment of a strip
//   (`seg_bands` bands; 14 at N 32, so a block walks one whole strip top to
//   bottom). Block b takes units b, b + grid, ... in that fixed order.
// - Each block loads w1, w2 and w3 once, by TMA in 64 x 64 boxes as stored
//   (128-byte swizzle, read by wgmma as MN-major B through the descriptor's
//   transpose bit: no transposed copy), and keeps them (139,264 B).
// - Phase 1 (h1): a band's 4 new h1 rows over the haloed strip (16 columns)
//   are one m64n64 product over K 256: x arrives by TMA in four 64-channel
//   boxes of 4 rows x 16 columns (a 4-D map over NHWC whose negative or
//   past-the-edge start coordinates zero-fill the image border) through a
//   4-stage ring (one step: the next step's copies overlap this step's
//   phase 2).
//   h1 is stored in a rolling window of 6 rows x 16 columns (+ 8 pad
//   slots) in the no-swizzle canonical layout [channel/8][slot][8]: the
//   band's last two rows are copied to the window's top for the next band,
//   so phase 1 recomputes only the column halo. A segment starts with one
//   phase-1-only product (its top two h1 rows). Recompute ratio (h1 pixels
//   computed / output pixels) at N 32: 15 x 64 / (14 x 56) = 1.2245
//   (1.5625 in the first port's 8 x 8 tiles).
// - Phase 2 (h2): nine m64n64 products over K 64, one a tap; output pixel
//   m = 16 r + c reads h1 slot m + 16 dy + dx, so each tap's A is the same
//   window behind a descriptor start shifted by (16 dy + dx) x 16 bytes.
//   Columns 14 and 15 of each row are padding (discarded). h2 goes to an
//   8 KB tile in the same no-swizzle layout.
// - Phase 3 (out): the h2 tile is copied into register-A fragments
//   (ldmatrix) and freed at once; four register-A m64n64 products over K
//   64 (64 output channels each), two in flight, so one chunk's epilogue
//   (fold, residual, ReLU) overlaps the next chunk's product. The residual
//   is a TMA re-read of the band's centre (4 rows x 14 columns x 256
//   channels; L2 holds it from phase 1's read) into four staging boxes; the
//   epilogue writes the output over each box in place and a TMA store
//   sends it, box by box, the producer refilling a box for the next band
//   once its store has read it.
// - Warp roles: warpgroup 0 runs phases 1 and 2 band after band and hands
//   h2 over; warpgroup 1 runs phase 3, its epilogues and the stores one band
//   behind, so the two warpgroups' epilogues overlap each other's products;
//   one producer thread issues every TMA load (a step's x boxes, then the
//   step before's residual boxes). mbarriers carry the hand-offs (x ring,
//   residual boxes, h2 full/empty).
// Shared memory, bytes: weights 139,264; x ring 4 x 8,192; residual/output
// 4 x 7,168; h1 window 13,312; h2 8,192; folded vectors (fp32) 3,072;
// barriers 256; 1,024 of alignment slack:
// 226,560 of the 232,448 a block may use.
// Registers: 146 a thread (288 threads: ptxas caps them at 168), no spill.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int H = 56, W = 56, C = 256, S = 64;
constexpr int BAND = 4;                   // output rows a band
constexpr int STRIP = 14;                 // output columns a strip
constexpr int HW16 = STRIP + 2;           // haloed columns: 16
constexpr int STRIPS = W / STRIP;         // 4
constexpr int BANDS = H / BAND;           // 14
constexpr int M = BAND * HW16;            // 64 rows a product
constexpr int CH = 64;                    // channels a TMA box
constexpr int STAGES = 4;
constexpr int XBOX = M * CH * 2;          // 8,192: one x box
constexpr int RPIX = BAND * STRIP;        // 56 output pixels a band
constexpr int RBOX = RPIX * CH * 2;       // 7,168: one residual box
constexpr int SLOTS = 104;                // h1 window: 6 x 16 rows + 8 pad
constexpr int LBO_H1 = SLOTS * 16;        // 1,664: next 8 channels
constexpr int LBO_H2 = M * 16;            // 1,024: h2's next 8 channels
constexpr int WBOX = 64 * 64 * 2;         // 8,192: one weight box
constexpr int WG_THREADS = 128;
// warpgroup 0: phases 1 and 2; warpgroup 1: phase 3; then the producer warp
constexpr int THREADS = 2 * WG_THREADS + 32;

constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = OFF_W1 + C * S * 2;          // 32,768
constexpr int OFF_W3 = OFF_W2 + 9 * S * S * 2;      // 106,496
constexpr int OFF_RING = OFF_W3 + S * C * 2;        // 139,264
constexpr int OFF_RES = OFF_RING + STAGES * XBOX;   // 172,032
constexpr int OFF_H1 = OFF_RES + 4 * RBOX;          // 200,704
constexpr int OFF_H2 = OFF_H1 + 8 * LBO_H1;         // 214,016
constexpr int OFF_VEC = OFF_H2 + 8 * LBO_H2;        // 222,208
constexpr int OFF_BAR = OFF_VEC + (4 * S + 2 * C) * 4;  // 225,280
// w1, w2, w3; the ring's full and empty; the residual boxes' full and
// empty; h2's full and empty
constexpr int NBARS = 3 + 2 * STAGES + 8 + 2;
constexpr int SMEM = OFF_BAR + 256 + 1024;          // 226,560
static_assert(NBARS * 8 <= 256, "barriers");
static_assert(SMEM <= 232448, "shared memory");

using wg::fence_proxy_async;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

__device__ __forceinline__ float bn(float acc, float g, float b) {
  return __fadd_rn(__fmul_rn(acc, g), b);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the named barrier of warpgroup `wgi` (its 128 threads)
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wgi), "n"(WG_THREADS)
               : "memory");
}

// 4-D TMA load of the box at (c0 inner, .., c3 outer) into dst
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 4-D TMA store of the box in shared memory at src
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// descriptors of 128-byte-swizzled tiles (TMA's layout): K-major A, a
// k-step 32 bytes along the row; MN-major B (64 columns), a k-step 16 rows
// (2,048 bytes) on
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* p) {
  return wg::make_desc(p, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* p) {
  return wg::make_desc(p, WBOX, 1024);
}

// descriptor of a no-swizzle K-major tile in the canonical layout
// [channel/8][pixel][8] (the h1 window, h2): core matrices of 8 pixels x 16
// bytes, the next 8 pixels 128 bytes on (stride), the next 8 channels `lbo`
// bytes on (leading)
__device__ __forceinline__ uint64_t plain_desc(const uint8_t* p, int lbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((128 >> 4) & 0x3FFF) << 32;
  return d;                               // layout 0: no swizzle
}

#define BK_R8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define BK_S32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d[32] (+)= A[64 x 16] B[16 x 64]: A K-major and B MN-major, both from
// shared memory; `accum` 0 overwrites d (the first k-step of a product)
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accum) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BK_S32
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : BK_R8(0), BK_R8(8), BK_R8(16), BK_R8(24)
      : "l"(da), "l"(db), "r"(accum));
}

// the same with A from registers (the m64k16 fragment of each warp)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int accum) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BK_S32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : BK_R8(0), BK_R8(8), BK_R8(16), BK_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accum));
}
#undef BK_R8
#undef BK_S32

// phase 1's product of one step: h1 rows Y + 1 .. Y + 4 over the strip's
// 16 columns from the next four x boxes of the ring; returns the first
// stage it read
__device__ __forceinline__ int phase1_issue(float (&d)[32],
                                            const uint8_t* ring,
                                            const uint8_t* w1, uint64_t* full,
                                            int& stage, uint32_t& phase) {
  const int first = stage;
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < C / CH; ++q) {
    mbar_wait(&full[stage], phase);
    const uint8_t* xa = ring + stage * XBOX;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_ss(d, kmajor_desc(xa + j * 32),
             mnmajor_desc(w1 + (4 * q + j) * 2048), q | j);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_commit();
  return first;
}

// phase 1's epilogue, its product complete: the x boxes go back to the
// producer; with `carry`, the window's bottom two rows become its top two;
// then fold, ReLU, zero outside the image and write the four new rows
__device__ __forceinline__ void phase1_epilogue(const float (&d)[32],
                                                uint8_t* h1, uint64_t* empty,
                                                int first, const float* g1,
                                                const float* b1, int Y, int x0,
                                                bool carry, int t) {
  if (t == 0) {
    int s = first;
#pragma unroll
    for (int q = 0; q < C / CH; ++q) {
      mbar_arrive(&empty[s]);
      s = s + 1 == STAGES ? 0 : s + 1;
    }
  }
  if (carry) {
    for (int i = t; i < 8 * 32; i += WG_THREADS) {
      uint8_t* row = h1 + (i / 32) * LBO_H1;
      *reinterpret_cast<uint4*>(row + (i % 32) * 16) =
          *reinterpret_cast<const uint4*>(row + (64 + i % 32) * 16);
    }
  }
  wg_sync(0);
  const int w = t / 32, g = (t % 32) / 4, c2 = 2 * (t % 4);
  float2 gv[8], bv[8];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    gv[nb] = *reinterpret_cast<const float2*>(g1 + nb * 8 + c2);
    bv[nb] = *reinterpret_cast<const float2*>(b1 + nb * 8 + c2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 16 * w + g + 8 * half;   // row r = w, column c
    const int yy = Y + 1 + w, xx = x0 - 1 + m % 16;
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    uint8_t* slot = h1 + (32 + m) * 16 + c2 * 2;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float v0 = fmaxf(bn(d[4 * nb + 2 * half], gv[nb].x, bv[nb].x), 0.f);
      float v1 = fmaxf(bn(d[4 * nb + 2 * half + 1], gv[nb].y, bv[nb].y), 0.f);
      if (!inside) v0 = v1 = 0.f;
      *reinterpret_cast<uint32_t*>(slot + nb * LBO_H1) = pack(v0, v1);
    }
  }
  fence_proxy_async();
  wg_sync(0);
}

// phase 2's product: nine taps, each the window behind a shifted start
__device__ __forceinline__ void phase2_issue(float (&d)[32], const uint8_t* h1,
                                             const uint8_t* w2) {
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3) * HW16 + tap % 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss(d, plain_desc(h1 + 2 * kk * LBO_H1 + shift * 16, LBO_H1),
             mnmajor_desc(w2 + tap * WBOX + kk * 2048), tap | kk);
  }
  wgmma_commit();
}

// phase 2's epilogue: h2 = relu(fold) in bf16 into the h2 tile
// ([channel/8][pixel][8]), phase 3's A operand
__device__ __forceinline__ void phase2_epilogue(const float (&d)[32],
                                                uint8_t* h2, const float* g2,
                                                const float* b2, int t) {
  const int w = t / 32, g = (t % 32) / 4, c2 = 2 * (t % 4);
  float2 gv[8], bv[8];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    gv[nb] = *reinterpret_cast<const float2*>(g2 + nb * 8 + c2);
    bv[nb] = *reinterpret_cast<const float2*>(b2 + nb * 8 + c2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint8_t* px = h2 + (16 * w + g + 8 * half) * 16 + c2 * 2;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<uint32_t*>(px + nb * LBO_H2) = pack(
          fmaxf(bn(d[4 * nb + 2 * half], gv[nb].x, bv[nb].x), 0.f),
          fmaxf(bn(d[4 * nb + 2 * half + 1], gv[nb].y, bv[nb].y), 0.f));
  }
}

// h2 as phase 3's register-A fragments: k-step kk of warp w's 16 rows,
// four 8 x 8 matrices (rows +0/+8, channels +0/+8) by one ldmatrix
__device__ __forceinline__ void load_h2(uint32_t (&a)[4][4], const uint8_t* h2,
                                        int t) {
  const int w = t / 32, l = t % 32, mat = l / 8;
  const int row = 16 * w + (l % 8) + 8 * (mat & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(smem_u32(h2 + (2 * kk + (mat >> 1)) * LBO_H2 + row * 16)));
}

// phase 3's product for output channels [64 q, 64 q + 64): h2 (register
// A) times w3's q-th 64-column box, one group
__device__ __forceinline__ void phase3_chunk(float (&d)[32],
                                             const uint32_t (&a)[4][4],
                                             const uint8_t* w3, int q) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs(d, a[kk], mnmajor_desc(w3 + q * WBOX + kk * 2048), kk);
  wgmma_commit();
}

// phase 3's epilogue for output channels [64 q, 64 q + 64): fold, add the
// residual read from the staging box, ReLU, write the output over it. The
// residuals and the folded vectors are read before any write, so the reads
// issue back to back.
__device__ __forceinline__ void phase3_epilogue(const float (&d)[32],
                                                uint8_t* res, int q,
                                                const float* g3,
                                                const float* b3, int t) {
  const int w = t / 32, g = (t % 32) / 4, c2 = 2 * (t % 4);
  uint8_t* box = res + q * RBOX;
  uint32_t r[2][8];
  float2 gv[8], bv[8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = w * STRIP + g + 8 * half;    // pixel row of the box
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      // column g + 8 half of the band's 16; 14 and 15 are padding
      r[half][nb] = (half == 0 || g + 8 < STRIP)
                        ? *reinterpret_cast<const uint32_t*>(
                              box + p * 128 + ((nb ^ (p % 8)) * 16) + c2 * 2)
                        : 0u;
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    gv[nb] = *reinterpret_cast<const float2*>(g3 + q * 64 + nb * 8 + c2);
    bv[nb] = *reinterpret_cast<const float2*>(b3 + q * 64 + nb * 8 + c2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half == 1 && g + 8 >= STRIP) continue;
    const int p = w * STRIP + g + 8 * half;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float v0 = fmaxf(
          __fadd_rn(bn(d[4 * nb + 2 * half], gv[nb].x, bv[nb].x),
                    __uint_as_float(r[half][nb] << 16)), 0.f);
      const float v1 = fmaxf(
          __fadd_rn(bn(d[4 * nb + 2 * half + 1], gv[nb].y, bv[nb].y),
                    __uint_as_float(r[half][nb] & 0xFFFF0000u)), 0.f);
      *reinterpret_cast<uint32_t*>(
          box + p * 128 + ((nb ^ (p % 8)) * 16) + c2 * 2) = pack(v0, v1);
    }
  }
}

// Step k of this block's walk (units b, b + grid, ...; each unit's
// phase-1-only step, then its bands): the image, the strip's first column,
// the band's first output row (the step's x box starts one row lower) and
// whether it is a band. False past the last step.
__device__ __forceinline__ bool step_at(int k, int units, int segs,
                                        int seg_bands, int& img, int& x0,
                                        int& Y, bool& band) {
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int seg = u % segs;
    const int nb = min(seg_bands, BANDS - seg * seg_bands);
    if (k <= nb) {
      img = u / (STRIPS * segs);
      x0 = ((u / segs) % STRIPS) * STRIP;
      Y = (seg * seg_bands + k - 1) * BAND;
      band = k > 0;
      return true;
    }
    k -= nb + 1;
  }
  return false;
}

__global__ void __launch_bounds__(THREADS, 1)
bottleneck_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap rmap,
                  const __grid_constant__ CUtensorMap omap,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map,
                  const __grid_constant__ CUtensorMap w3map,
                  const bf16* __restrict__ g1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ g2, const bf16* __restrict__ b2,
                  const bf16* __restrict__ g3, const bf16* __restrict__ b3,
                  int units, int seg_bands) {
  // the base aligned by offsetting bn_smem itself, so that the compiler
  // keeps shared-memory accesses (LDS/STS) and not generic ones
  extern __shared__ __align__(1024) uint8_t bn_smem[];
  uint8_t* base = bn_smem + ((1024 - (smem_u32(bn_smem) & 1023)) & 1023);
  uint8_t* sW1 = base + OFF_W1;
  uint8_t* sW2 = base + OFF_W2;
  uint8_t* sW3 = base + OFF_W3;
  uint8_t* ring = base + OFF_RING;
  uint8_t* res = base + OFF_RES;
  uint8_t* h1 = base + OFF_H1;
  uint8_t* h2 = base + OFF_H2;
  float* vG1 = reinterpret_cast<float*>(base + OFF_VEC);
  float* vB1 = vG1 + S;
  float* vG2 = vB1 + S;
  float* vB2 = vG2 + S;
  float* vG3 = vB2 + S;
  float* vB3 = vG3 + C;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + OFF_BAR);
  uint64_t* wbar = bars;                   // w1, w2, w3
  uint64_t* full = bars + 3;               // the x ring
  uint64_t* empty = full + STAGES;
  uint64_t* res_full = empty + STAGES;     // the four residual boxes
  uint64_t* res_empty = res_full + 4;
  uint64_t* h2_full = res_empty + 4;       // h2, from warpgroup 0 to 1
  uint64_t* h2_empty = h2_full + 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NBARS; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int segs = (BANDS + seg_bands - 1) / seg_bands;
  const int role = threadIdx.x / WG_THREADS;   // 2: the producer warp
  const int t = threadIdx.x % WG_THREADS;

  if (role == 2) {
    // ---- producer: one thread issues every load. A step's x boxes go out
    // before the last step's residual boxes
    if (t != 0) return;
    wg::prefetch_map(&xmap);
    wg::prefetch_map(&rmap);
    wg::prefetch_map(&omap);
    mbar_expect_tx(&wbar[0], C * S * 2);
    for (int k = 0; k < C / 64; ++k)
      wg::tma_load(sW1 + k * WBOX, &w1map, &wbar[0], 0, 64 * k);
    int stage = 0, nres = 0;               // nres: residuals loaded
    uint32_t phase = 0;
    int img, x0, Y, r_img = 0, r_x0 = 0, r_y = 0;
    bool band, r_band = false;
    // the residual boxes of the step before: each box waits for the store
    // of the band before it to have read it
    auto load_residual = [&]() {
      for (int q = 0; q < 4; ++q) {
        if (nres > 0) mbar_wait(&res_empty[q], (nres - 1) & 1);
        mbar_expect_tx(&res_full[q], RBOX);
        tma_load_4d(res + q * RBOX, &rmap, &res_full[q], q * CH, r_x0, r_y,
                    r_img);
      }
      ++nres;
    };
    for (int k = 0; step_at(k, units, segs, seg_bands, img, x0, Y, band);
         ++k) {
      for (int q = 0; q < C / CH; ++q) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], XBOX);
        tma_load_4d(ring + stage * XBOX, &xmap, &full[stage], q * CH, x0 - 1,
                    Y + 1, img);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (k == 0) {                        // after the first x boxes
        mbar_expect_tx(&wbar[1], 9 * S * S * 2);
        for (int j = 0; j < 9; ++j)
          wg::tma_load(sW2 + j * WBOX, &w2map, &wbar[1], 0, 64 * j);
        mbar_expect_tx(&wbar[2], S * C * 2);
        for (int j = 0; j < C / 64; ++j)
          wg::tma_load(sW3 + j * WBOX, &w3map, &wbar[2], 64 * j, 0);
      }
      if (r_band) load_residual();
      r_band = band;
      r_img = img;
      r_x0 = x0;
      r_y = Y;
    }
    if (r_band) load_residual();
    return;
  }

  if (role == 0) {
    // ---- warpgroup 0: phases 1 and 2, band after band
    for (int i = t; i < S; i += WG_THREADS) {
      vG1[i] = __bfloat162float(g1[i]);
      vB1[i] = __bfloat162float(b1[i]);
      vG2[i] = __bfloat162float(g2[i]);
      vB2[i] = __bfloat162float(b2[i]);
    }
    // the window's pad slots feed only discarded rows; keep them finite
    for (int i = t; i < 8 * (SLOTS - 96); i += WG_THREADS)
      *reinterpret_cast<uint4*>(h1 + (i / 8) * LBO_H1 + (96 + i % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    wg_sync(0);
    int stage = 0, count = 0;              // count: bands handed over
    uint32_t phase = 0;
    float acc[32];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int strip = (u / segs) % STRIPS, seg = u % segs;
      const int x0 = strip * STRIP;
      const int y_seg = seg * seg_bands * BAND;
      const int nb = min(seg_bands, BANDS - seg * seg_bands);
      for (int b = -1; b < nb; ++b) {
        const int Y = y_seg + BAND * b;
        mbar_wait(&wbar[0], 0);
        const int first = phase1_issue(acc, ring, sW1, full, stage, phase);
        wgmma_wait<0>();
        wg::fence_regs(acc);
        phase1_epilogue(acc, h1, empty, first, vG1, vB1, Y, x0, b >= 0, t);
        if (b < 0) continue;               // a unit's top rows only
        mbar_wait(&wbar[1], 0);
        phase2_issue(acc, h1, sW2);
        wgmma_wait<0>();
        wg::fence_regs(acc);
        if (count > 0) mbar_wait(h2_empty, (count - 1) & 1);
        phase2_epilogue(acc, h2, vG2, vB2, t);
        wg_sync(0);
        if (t == 0) mbar_arrive(h2_full);
        ++count;
      }
    }
    return;
  }

  // ---- warpgroup 1: phase 3, its epilogues and the output stores, one
  // band behind warpgroup 0. Two 64-channel products in flight: a chunk's
  // epilogue overlaps the next chunk's product.
  for (int i = t; i < C; i += WG_THREADS) {
    vG3[i] = __bfloat162float(g3[i]);
    vB3[i] = __bfloat162float(b3[i]);
  }
  wg_sync(1);
  mbar_wait(&wbar[2], 0);
  int count = 0;
  uint32_t res_parity = 0;
  float accA[32], accB[32];
  uint32_t a2[4][4];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int img = u / (STRIPS * segs);
    const int strip = (u / segs) % STRIPS, seg = u % segs;
    const int x0 = strip * STRIP;
    const int y_seg = seg * seg_bands * BAND;
    const int nb = min(seg_bands, BANDS - seg * seg_bands);
    for (int b = 0; b < nb; ++b, ++count) {
      const int Y = y_seg + BAND * b;
      // box q: its residual, the epilogue, then its store; the box before
      // it goes back to the producer (the next band's residual) once its
      // store has read it
      auto finish = [&](const float(&d)[32], int q) {
        mbar_wait(&res_full[q], res_parity);
        phase3_epilogue(d, res, q, vG3, vB3, t);
        fence_proxy_async();
        wg_sync(1);
        if (t == 0) {
          tma_store_4d(&omap, res + q * RBOX, q * CH, x0, Y, img);
          wg::bulk_commit();
          if (q > 0) {
            wg::bulk_wait_read<1>();
            mbar_arrive(&res_empty[q - 1]);
          }
        }
      };
      mbar_wait(h2_full, count & 1);
      load_h2(a2, h2, t);
      wg_sync(1);
      if (t == 0) mbar_arrive(h2_empty);   // h2 is in registers now
      phase3_chunk(accA, a2, sW3, 0);
      phase3_chunk(accB, a2, sW3, 1);
      wgmma_wait<1>();
      wg::fence_regs(accA);
      finish(accA, 0);
      phase3_chunk(accA, a2, sW3, 2);
      wgmma_wait<1>();
      wg::fence_regs(accB);
      finish(accB, 1);
      phase3_chunk(accB, a2, sW3, 3);
      wgmma_wait<1>();
      wg::fence_regs(accA);
      finish(accA, 2);
      wgmma_wait<0>();
      wg::fence_regs(accB);
      finish(accB, 3);
      if (t == 0) {
        wg::bulk_wait_read<0>();
        mbar_arrive(&res_empty[3]);
      }
      res_parity ^= 1;
    }
  }
  if (t == 0) wg::bulk_wait<0>();
}

// the 4-D map of an NHWC [n, 56, 56, 256] bf16 tensor in boxes of 64
// channels x `cols` columns x 4 rows x 1 image, 128-byte swizzled, zeros
// outside
bool nhwc_map(CUtensorMap* map, const void* ptr, int n, int cols) {
  wg::EncodeTiledFn fn = wg::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {C, W, H, (cuuint64_t)n};
  const cuuint64_t strides[3] = {C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {CH, (cuuint32_t)cols, BAND, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous bf16
// tensors: x and out [n, 56, 56, 256]; w1 [256, 64], w2 [3, 3, 64, 64],
// w3 [64, 256]; g1, b1, g2, b2 [64]; g3, b3 [256]; all 16-byte aligned.
// `grid`, `seg_bands` and `smem` come from `bottleneck_plan(n)`; `smem`
// must equal the kernel's layout. Returns the launch's cudaError_t
// (cudaErrorNotSupported when the driver refuses a TMA map).
extern "C" int apex_bottleneck(const void* x, const void* w1, const void* w2,
                               const void* w3, const void* g1,
                               const void* b1, const void* g2,
                               const void* b2, const void* g3,
                               const void* b3, void* out, int n, int grid,
                               int seg_bands, int smem, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (smem != SMEM || seg_bands < 1 || seg_bands > BANDS || grid < 1)
    return cudaErrorInvalidValue;
  const int units = n * STRIPS * ((BANDS + seg_bands - 1) / seg_bands);
  if (grid > units) return cudaErrorInvalidValue;
  CUtensorMap xmap, rmap, omap, w1map, w2map, w3map;
  if (!nhwc_map(&xmap, x, n, HW16) || !nhwc_map(&rmap, x, n, STRIP) ||
      !nhwc_map(&omap, out, n, STRIP) ||
      !wg::operand_map<bf16>(&w1map, w1, C, S, S, true) ||
      !wg::operand_map<bf16>(&w2map, w2, 9 * S, S, S, true) ||
      !wg::operand_map<bf16>(&w3map, w3, S, C, C, true))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  bottleneck_kernel<<<grid, THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      xmap, rmap, omap, w1map, w2map, w3map, static_cast<const bf16*>(g1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(g2),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(g3),
      static_cast<const bf16*>(b3), units, seg_bands);
  return cudaGetLastError();
}
