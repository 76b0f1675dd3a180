// An exact-fp32 tile product on the CUDA cores for Hopper (sm_90a):
// register-blocked FFMA, operands staged in shared memory by asynchronous
// copies. The O0 (fp32) kernels use it where wgmma has no exact fp32
// product (TF32 rounds the operands): every product is an fmaf of fp32
// operands, summed in a fixed k order, so a rerun gives the same bits.
//
// One block computes a BM x BN tile of C = A^T B, where both operands
// are stored k-row by k-row ("MN-major"): A[k][m] at a.p[k * a.ld + m],
// B[k][n] at b.p[k * b.ld + n]. That is the layout a CUDA-core product
// wants: for each k a thread reads its 8 values of A and its 8 of B as two
// float4s each from shared memory and does 64 FFMAs into its 8 x 8
// accumulators (64 FFMAs a 4 LDS.128, no warp shuffles). An operand whose
// contraction index is the contiguous one in memory is transposed once
// into this layout by the caller (ce32_transpose_kernel in lm_head_ce.cu):
// a pass over the operand's bytes, against a product that reads each of
// them many times.
//
// - Block: 256 threads, 8 warps as 4 (m) x 2 (n), a warp 32 x 64 outputs,
//   a lane 8 x 8: rows {32 wm + 16 i + 4 ly + 0..3 : i = 0, 1} and
//   columns {64 wn + 32 j + 4 lx + 0..3 : j = 0, 1}, ly = lane / 8,
//   lx = lane % 8. For one k a warp reads 4 distinct float4s of A (64
//   bytes) and 8 of B (128 bytes): one shared-memory wavefront each.
// - Staging: a ring of 3 stages of 32 k-rows of each operand, filled by
//   16-byte `cp.async.cg` copies (four of A and four of B a thread a
//   stage), rows padded by 4 floats; a copy past an operand's m
//   (n) extent or k extent fills zeros (src-size 0), so ragged edges need
//   no branch in the product. The m and n extents are multiples of 4
//   (whole 16-byte chunks).
// - Occupancy: two blocks an SM (__launch_bounds__(256, 2): at most 128
//   registers a thread; 2 x 101 KB of shared memory), 16 warps to hide
//   the shared-memory latency behind the FFMAs of the others. 32 k-rows a
//   stage halve the barriers and copy rounds of 16 (faster at the O0
//   shape; 8 k-rows with 6 stages slower, and so were 8 x 16 outputs a
//   lane in blocks of 128 threads, eight warps an SM).
//
// The H100's fp32 peak outside the tensor cores is 128 FFMAs a clock an
// SM, 67 TFLOP/s at 1.98 GHz.

#pragma once

#include <stdint.h>

namespace simt {

constexpr int BM = 128;        // block tile rows (A's m)
constexpr int BN = 128;        // block tile columns (B's n)
constexpr int BK = 32;         // k-rows a stage
constexpr int STAGES = 3;
constexpr int TN = 8;          // a lane's columns (its rows: 8)
constexpr int WARPS_N = 2;     // warps across the tile's columns
constexpr int THREADS = 256;
static_assert(BN == WARPS_N * 8 * TN && THREADS == 32 * (BM / 32) * WARPS_N,
              "a warp is 4 x 8 lanes of 8 x 8 outputs");
constexpr int PAD = 4;         // floats of padding a staged row
constexpr int LDA = BM + PAD;
constexpr int LDB = BN + PAD;
constexpr int STAGE_FLOATS = BK * (LDA + LDB);
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_FLOATS * 4;

// An MN-major operand: element (k, mn) at p[k * ld + mn]; reads past
// `mn_ext` (a multiple of 4) or `k_ext` are zeros.
struct Operand {
  const float* p;
  long ld;
  int mn_ext;
  int k_ext;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lane's first output row (of the two groups of 4: +0 and +16) and
// first column (+0 and +32) in the block tile.
__device__ __forceinline__ int row0() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return 32 * (warp / WARPS_N) + 4 * (lane / 8);
}
__device__ __forceinline__ int col0() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (BN / WARPS_N) * (warp % WARPS_N) + 4 * (lane % 8);
}
// row of accumulator row i (0..7), column of accumulator column j (0..TN)
__device__ __forceinline__ int row_of(int i) {
  return row0() + 16 * (i / 4) + i % 4;
}
__device__ __forceinline__ int col_of(int j) {
  return col0() + 32 * (j / 4) + j % 4;
}

// one stage: k-rows [k0, k0 + BK) of the block's 128 columns of A (from
// m0) and of B (from n0): 1024 16-byte chunks each, four a thread
__device__ __forceinline__ void load_stage(float* st, const Operand& a,
                                           const Operand& b, int m0, int n0,
                                           int k0) {
  float* sa = st;
  float* sb = st + BK * LDA;
#pragma unroll
  for (int i = 0; i < BK * 32 / THREADS; ++i) {
    const int c = threadIdx.x + THREADS * i;
    const int kk = c / 32, q = 4 * (c % 32);
    const int k = k0 + kk;
    const bool ka = k < a.k_ext, kb = k < b.k_ext;
    const bool va = ka && m0 + q < a.mn_ext, vb = kb && n0 + q < b.mn_ext;
    copy16(sa + kk * LDA + q, va ? a.p + k * a.ld + m0 + q : a.p, va);
    copy16(sb + kk * LDB + q, vb ? b.p + k * b.ld + n0 + q : b.p, vb);
  }
}

// acc[i][j] += sum over k < kdim of A[k][m0 + row_of(i)] B[k][n0 +
// col_of(j)], in k order, one fmaf a term. `smem` holds STAGES stages;
// every thread of the block calls it; on return the ring is idle (the
// caller may reuse the shared memory after a barrier of its own).
__device__ __forceinline__ void product(float* smem, const Operand& a,
                                        const Operand& b, int m0, int n0,
                                        int kdim, float (&acc)[8][TN]) {
  const int nk = (kdim + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(smem + s * STAGE_FLOATS, a, b, m0, n0, s * BK);
    commit();
  }
  const int r0 = row0(), c0 = col0();
  for (int kt = 0; kt < nk; ++kt) {
    wait_groups<STAGES - 2>();
    __syncthreads();   // stage kt is in; every thread is done with kt - 1
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage(smem + (nxt % STAGES) * STAGE_FLOATS, a, b, m0, n0,
                 nxt * BK);
    commit();
    const float* sa = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* sb = sa + BK * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * LDA + r0);
      const float4 a1 =
          *reinterpret_cast<const float4*>(sa + kk * LDA + r0 + 16);
      float bv[TN];
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(sb + kk * LDB + c0 + 32 * g);
        bv[4 * g] = b4.x;
        bv[4 * g + 1] = b4.y;
        bv[4 * g + 2] = b4.z;
        bv[4 * g + 3] = b4.w;
      }
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  wait_groups<0>();
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[8][TN]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

}  // namespace simt
