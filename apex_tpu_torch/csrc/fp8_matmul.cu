// fp8 dequant-matmul for Hopper (sm_90a): y = x @ (q / scale) with an e4m3
// weight and one per-tensor fp32 scale, fp32 accumulation, bf16 out.
//
// Replaces the Pallas kernel `_fp8_mm_kernel` of apex_tpu/ops/fp8_matmul.py
// (:76, launched by `_fp8_mm_pallas` :104 from `fp8_dequant_matmul` :136).
// Contract (shared with apex_tpu_torch.ops.fp8_matmul):
//   x      [m, K]  bf16, contiguous
//   q      [K, N]  float8_e4m3fn bytes, contiguous (the JAX [in, out] layout)
//   scale  0-d fp32 on the device: read by the kernel, never by the host
//   y      [m, N]  bf16
//   y[r, n] = bf16( sum_k float(x[r, k]) * float(q[k, n]) / scale )
// The divide by the scale is applied once per output, after the sum (the
// reference divides every weight element first: the two differ by fp32
// rounding only). Requires K % 16 == 0 and N % 16 == 0 (checked by the
// wrapper). Every output row depends on its own row of x alone, with a
// summation order fixed by (K, N): no row of y ever mixes with another, which
// is what keeps a speculative-verify row bitwise a plain-decode row.
//
// Two regimes, chosen by m:
//
// * Decode, m <= 8: bound by the weight's bytes (K*N, one byte each; 16
//   flops a byte at m = 8). One launch: a block per (64-column tile, K
//   split), the K splits of a tile one thread-block cluster of 1, 2, 4 or
//   8 blocks (from (K, N) alone: `splits` and `kc`, the rows a split, come
//   from the wrapper's `_splits`). A producer thread issues, at the start,
//   TMA 2-D box loads of the block's whole weight slice (64 rows x 64
//   columns of e4m3 a stage) and of x's matching 64 columns (all 8 rows;
//   TMA fills rows past m and columns past K with zeros) into a ring of up
//   to 8 stages, one mbarrier a stage; a slice deeper than the ring
//   refills a stage once its consumers release it. Eight consumer warps
//   take one 16-deep k-step and two of the four product tiles of every
//   stage each and multiply on the tensor cores: mma.sync m16n8k16 bf16
//   with the weight as the 16-row operand (16 output columns, converted
//   exactly from e4m3 to bf16 in registers) and x^T as the 8-column
//   operand (the 8 decode rows), fp32 accumulate. Every e4m3 value and
//   every bf16 x is exact in bf16, so the products are exact. The four
//   k-steps' partials meet in shared memory and are summed in k-step
//   order; each block of the cluster owns 64 / splits columns, receives
//   the other splits' partials of them into its shared memory (st.async
//   from registers, counted on an mbarrier: no cluster barrier on the way
//   out), sums them in rank order, applies 1 / scale and writes bf16. No
//   atomics and no workspace in device memory: the sum order is fixed by
//   (K, N), so a rerun is bitwise the same, and a row never mixes with
//   another row (the m8 tile always runs whole, rows past m are zeros),
//   so a row is bitwise the same whatever rows come with it.
// * Prefill, m > 8: bound by operations (2 m K N). 64x64 output tiles, 4 warps
//   of 2x2 wmma bf16 16x16x16 fragments with fp32 accumulators. The e4m3
//   tile is converted to bf16 on its way into shared memory: every e4m3 value
//   is exact in bf16, so the tensor cores multiply the exact operands and
//   only the fp32 summation order differs from the reference. No load
//   pipelining yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "dsmem.cuh"        // the cluster's pushes
#include "wgmma_gemm.cuh"   // mbarrier / TMA primitives, the map encoder

namespace {

__device__ __forceinline__ void e4m3x8_to_float(const uint2& u, float* f) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * j)) & 0xffffu);
      const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3));
      const float2 t = __half22float2(h);
      f[4 * i + 2 * j] = t.x;
      f[4 * i + 2 * j + 1] = t.y;
    }
  }
}

// ---------------------------------------------------------------- decode

constexpr int DEC_BN = 64;             // columns a block: 64-byte rows
constexpr int DEC_BK = 64;             // weight rows a stage
constexpr int DEC_KSTEPS = DEC_BK / 16;  // 16-deep k-steps of a stage
// consumer warps: k-step w % 4, product tiles {0, 1} or {2, 3} (w / 4)
constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = 32 * (DEC_WARPS + 1);   // + the producer warp
constexpr int DEC_RING = 8;            // stages in shared memory at most
constexpr int DEC_W_BYTES = DEC_BK * DEC_BN;       // 4 KB of e4m3
constexpr int DEC_X_BYTES = 8 * DEC_BK * 2;        // 8 rows x 64 bf16
constexpr int DEC_MAX_SPLITS = 8;      // a portable cluster
constexpr int DEC_PART_BYTES = 8 * DEC_BN * 4;     // an [8][64] fp32 tile

__host__ __device__ constexpr size_t dec_smem_bytes(int ring) {
  // 1024 for alignment, the rings, the k-steps' partials, the partials
  // gathered from the splits, the barriers
  return 1024 + (size_t)ring * (DEC_W_BYTES + DEC_X_BYTES) +
         (size_t)(DEC_KSTEPS + 1) * DEC_PART_BYTES + (2 * (size_t)ring + 1) * 8;
}

// Two e4m3 bytes (the low byte the lower k) as bf16x2, exactly: e4m3 ->
// f16 is exact and gives an f16 normal or a zero; its exponent and top
// three mantissa bits moved into bf16's fields give the value times
// 2^-112 (a bf16 normal, or the zero), which one exact bf16 product with
// 2^112 (0x7780) restores.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), __NV_E4M3);
  const uint32_t u = (uint32_t)h.x | ((uint32_t)h.y << 16);
  const uint32_t r = ((u >> 3) & 0x0FFF0FFFu) | (u & 0x80008000u);
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(r), "r"(0x77807780u), "r"(0x80008000u));
  return out;
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block: columns [n0, n0 + 64) over the K rows of its split (its
// cluster rank). Shared memory: the weight ring [ring][64 rows][64] e4m3
// (64-byte swizzled by TMA: the 16-byte chunk c of row r sits at chunk
// c ^ ((r / 2) % 4)) and the x ring [ring][8 rows][64] bf16 (128-byte
// swizzled: chunk c of row r at c ^ (r % 8)), the k-steps' partials
// [4][8][64] fp32, the partials gathered from the splits ([splits][8][W]:
// this block's W = 64 / splits columns, slot r from rank r) and the
// barriers.
//
// Fragments of a consumer lane (g = lane / 4, t = lane % 4) of warp w for
// its k-step k = w % 4 (rows r0 = 16 k + 2 t, r0 + 1, r0 + 8, r0 + 9 of a
// stage; chunk c of each sits at c ^ t): the 8 bytes at columns 8 g of
// each of the four rows hold, in byte j of their low word, column 8 g + j
// (row g of product tile j), and in byte j of their high word column
// 8 g + 4 + j (row g + 8 of tile j); so one 8-byte load a row feeds four
// m16n8k16 products, of which the warp takes two (tiles 2 (w / 4) and
// 2 (w / 4) + 1). The x operand: x[g][16 k + 2 t ..] and
// x[g][16 k + 2 t + 8 ..], two 4-byte loads. A warp releases its stage as
// soon as its loads are done. The accumulators of tile j: y rows 2 t,
// 2 t + 1 at columns 8 g + j (d0, d1) and 8 g + 4 + j (d2, d3).
//
// The K splits meet without a cluster-wide barrier on the way out: block
// q owns columns [q W, (q + 1) W) of the tile; every block stores its
// partial of each owner's columns from registers into that owner's gather
// slot (st.async, completing on the owner's mbarrier, which the owner armed
// with the bytes it expects at its start), and each owner sums its columns
// over the splits in rank order, divides by the scale and writes bf16.
__global__ void __launch_bounds__(DEC_THREADS)
fp8_mm_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ scale,
                     __nv_bfloat16* __restrict__ y, int m, int K, int N,
                     int kc, int ring) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sw = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sx = sw + ring * DEC_W_BYTES;
  float* red = reinterpret_cast<float*>(sx + ring * DEC_X_BYTES);
  float* gath = red + DEC_KSTEPS * 8 * DEC_BN;          // [splits][8][W]
  uint64_t* full = reinterpret_cast<uint64_t*>(gath + 8 * DEC_BN);
  uint64_t* empty = full + ring;
  uint64_t* gbar = empty + ring;

  const int rank = blockIdx.y, splits = gridDim.y;     // the cluster: K
  const int W = DEC_BN / splits;                        // columns owned
  const int n0 = blockIdx.x * DEC_BN;
  const int k_begin = rank * kc;
  const int k_end = min(K, k_begin + kc);
  const int nst = k_end > k_begin ? (k_end - k_begin + DEC_BK - 1) / DEC_BK
                                  : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool producer = tid == DEC_WARPS * 32;
  const float sc = *scale;

  auto issue = [&](int s) {
    const int st = s % ring, k0 = k_begin + s * DEC_BK;
    wg::mbar_expect_tx(&full[st], DEC_W_BYTES + DEC_X_BYTES);
    wg::tma_load(sw + st * DEC_W_BYTES, &wmap, &full[st], n0, k0);
    wg::tma_load(sx + st * DEC_X_BYTES, &xmap, &full[st], k0, 0);
  };
  if (producer) {
    // the barriers (the gather armed with the bytes it will receive), then
    // every stage the ring holds, at once
    wg::prefetch_map(&wmap);
    wg::prefetch_map(&xmap);
    for (int s = 0; s < ring; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], DEC_WARPS);
    }
    wg::mbar_init(gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    wg::mbar_expect_tx(gbar, (uint32_t)(splits * m * W * 4));
    for (int s = 0; s < min(nst, ring); ++s) issue(s);
  }
  __syncthreads();
  dsmem::cluster_arrive();

  if (warp == DEC_WARPS) {
    // ---- producer: a slice deeper than the ring refills freed stages
    if (producer)
      for (int s = ring; s < nst; ++s) {
        wg::mbar_wait(&empty[s % ring], ((s / ring) - 1) & 1);
        issue(s);
      }
  } else {
    // ---- consumers
    const int ks = warp % DEC_KSTEPS, jp = warp / DEC_KSTEPS;
    const uint32_t sel = jp ? 0x7362u : 0x5140u;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * ks + 2 * t;
    const int wo = (((g >> 1) ^ t) << 4) + 8 * (g & 1);
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int s = 0; s < nst; ++s) {
      const int st = s % ring;
      wg::mbar_wait(&full[st], (s / ring) & 1);
      const uint8_t* ws = sw + st * DEC_W_BYTES + wo;
      const uint8_t* xs = sx + st * DEC_X_BYTES + g * 128;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
          xs + (((2 * ks) ^ g) << 4) + 4 * t);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
          xs + (((2 * ks + 1) ^ g) << 4) + 4 * t);
      const uint2 R0 = *reinterpret_cast<const uint2*>(ws + r0 * 64);
      const uint2 R1 = *reinterpret_cast<const uint2*>(ws + (r0 + 1) * 64);
      const uint2 R8 = *reinterpret_cast<const uint2*>(ws + (r0 + 8) * 64);
      const uint2 R9 = *reinterpret_cast<const uint2*>(ws + (r0 + 9) * 64);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[st]);    // the stage is read
      // the k pairs (k, k + 1) of one column in a 16-bit half, tile
      // 2 jp low and 2 jp + 1 high (selector 0x5140 for tiles 0/1,
      // 0x7362 for 2/3)
      const uint32_t p0 = __byte_perm(R0.x, R1.x, sel);
      const uint32_t p1 = __byte_perm(R0.y, R1.y, sel);
      const uint32_t p2 = __byte_perm(R8.x, R9.x, sel);
      const uint32_t p3 = __byte_perm(R8.y, R9.y, sel);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int sh = 16 * j;
        mma_bf16_16816(acc[j], e4m3x2_to_bf16x2(p0 >> sh),
                       e4m3x2_to_bf16x2(p1 >> sh),
                       e4m3x2_to_bf16x2(p2 >> sh),
                       e4m3x2_to_bf16x2(p3 >> sh), b0, b1);
      }
    }
    float* rw = red + ks * 8 * DEC_BN + 8 * g + 2 * jp;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {      // y rows 2 t + e
        rw[(2 * t + e) * DEC_BN + j] = acc[j][e];
        rw[(2 * t + e) * DEC_BN + 4 + j] = acc[j][2 + e];
      }
  }
  __syncthreads();
  dsmem::cluster_wait();           // every block has started

  // the block's partial (its k-steps in k-step order), four columns a
  // thread, into the gather slot `rank` of the columns' owner
  for (int i = tid; i < m * DEC_BN / 4; i += DEC_THREADS) {
    const int row = i / (DEC_BN / 4), col = 4 * (i % (DEC_BN / 4));
    float4 tot = *reinterpret_cast<const float4*>(red + row * DEC_BN + col);
#pragma unroll
    for (int k = 1; k < DEC_KSTEPS; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          red + (k * 8 + row) * DEC_BN + col);
      tot.x += v.x;
      tot.y += v.y;
      tot.z += v.z;
      tot.w += v.w;
    }
    dsmem::store_to_rank(gath + (rank * 8 + row) * W + col % W, tot, gbar,
                         col / W);
  }
  // this block's columns: the splits' partials in rank order
  wg::mbar_wait(gbar, 0);
  for (int i = tid; i < m * W; i += DEC_THREADS) {
    const int row = i / W, col = rank * W + i % W;
    if (n0 + col >= N) continue;
    float tot = gath[row * W + i % W];
    for (int r = 1; r < splits; ++r) tot += gath[(r * 8 + row) * W + i % W];
    y[(long)row * N + n0 + col] = __float2bfloat16(tot / sc);
  }
}

// The maps of the decode regime: the weight [K, N] e4m3 in boxes of 64
// columns x 64 rows (64-byte swizzled), x [m, K] bf16 in boxes of 64
// columns x 8 rows (128-byte swizzled), zeros past the extents. False
// when the driver refuses.
bool decode_maps(CUtensorMap* wmap, CUtensorMap* xmap, const void* x,
                 const void* q, int m, int K, int N) {
  wg::EncodeTiledFn fn = wg::encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t estr[2] = {1, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t wstr[1] = {(cuuint64_t)N};
  const cuuint32_t wbox[2] = {DEC_BN, DEC_BK};
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)m};
  const cuuint64_t xstr[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {DEC_BK, 8};
  return fn(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
            wdims, wstr, wbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
            xdims, xstr, xbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_decode(const void* x, const void* q, const void* scale,
                          void* y, int m, int K, int N, int splits, int kc,
                          cudaStream_t st) {
  if (splits < 1 || splits > DEC_MAX_SPLITS || DEC_BN % splits ||
      kc < DEC_BK || kc % DEC_BK || (long)splits * kc < K)
    return cudaErrorInvalidValue;
  CUtensorMap wmap, xmap;
  if (!decode_maps(&wmap, &xmap, x, q, m, K, N)) return cudaErrorNotSupported;
  const int ring = std::min(DEC_RING, kc / DEC_BK);
  const size_t smem = dec_smem_bytes(ring);
  cudaError_t err = cudaFuncSetAttribute(
      fp8_mm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + DEC_BN - 1) / DEC_BN, splits, 1);
  cfg.blockDim = dim3(DEC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fp8_mm_decode_kernel, wmap, xmap,
                           static_cast<const float*>(scale),
                           static_cast<__nv_bfloat16*>(y), m, K, N, kc, ring);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- prefill

constexpr int TC_THREADS = 128;
constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 32;
constexpr int TC_LDA = TC_BK + 8;      // bf16 elements; keeps 32-byte rows
constexpr int TC_LDB = TC_BN + 8;
constexpr int TC_LDC = TC_BN + 4;      // fp32 elements

__global__ void __launch_bounds__(TC_THREADS)
fp8_mm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ q,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ y, int m, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 sA[TC_BM * TC_LDA];
  __shared__ __align__(32) __nv_bfloat16 sB[TC_BK * TC_LDB];
  __shared__ __align__(32) float sC[TC_BM * TC_LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;    // 2 x 2 warps of 32 x 32
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TC_BK) {
    // x tile [64, 32] bf16: 256 chunks of 8 values, 2 per thread
#pragma unroll
    for (int c = tid; c < TC_BM * TC_BK / 8; c += TC_THREADS) {
      const int row = c / (TC_BK / 8), col = (c % (TC_BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < m && k0 + col < K)
        v = *reinterpret_cast<const uint4*>(x + (long)(m0 + row) * K + k0 +
                                            col);
      *reinterpret_cast<uint4*>(sA + row * TC_LDA + col) = v;
    }
    // q tile [32, 64] e4m3 -> bf16: 128 chunks of 16 values, 1 per thread
    {
      const int row = tid / (TC_BN / 16), col = (tid % (TC_BN / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < K && n0 + col < N)
        v = *reinterpret_cast<const uint4*>(q + (long)(k0 + row) * N + n0 +
                                            col);
      float f[16];
      e4m3x8_to_float(make_uint2(v.x, v.y), f);
      e4m3x8_to_float(make_uint2(v.z, v.w), f + 8);
      uint32_t pk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
        pk[e] = *reinterpret_cast<const uint32_t*>(&t);
      }
      uint4* dst = reinterpret_cast<uint4*>(sB + row * TC_LDB + col);
      dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * TC_LDA + kk,
                               TC_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sB + kk * TC_LDB + wn * 32 + j * 16,
                               TC_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * TC_LDC + wn * 32 +
                                  j * 16,
                              acc[i][j], TC_LDC, wmma::mem_row_major);
  __syncthreads();
  const float s = *scale;
  for (int i = tid; i < TC_BM * TC_BN; i += TC_THREADS) {
    const int row = i / TC_BN, col = i % TC_BN;
    if (m0 + row < m && n0 + col < N)
      y[(long)(m0 + row) * N + n0 + col] =
          __float2bfloat16(sC[row * TC_LDC + col] / s);
  }
}

}  // namespace

// C interface (loaded with ctypes); see the contract at the top. `splits` (1,
// 2, 4 or 8) and `kc` (a multiple of 64, splits * kc >= K) are the K split of
// the decode regime, read when m <= 8 (splits a power of two). Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a shape outside the
// contract, cudaErrorNotSupported when the driver refuses a TMA map).
extern "C" int apex_fp8_matmul(const void* x, const void* q, const void* scale,
                               void* y, int m, int K, int N, int splits,
                               int kc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || N <= 0) return cudaSuccess;
  if (K % 16 || N % 16) return cudaErrorInvalidValue;
  if (m <= 8) return launch_decode(x, q, scale, y, m, K, N, splits, kc, st);
  dim3 grid((N + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM);
  fp8_mm_tc_kernel<<<grid, TC_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), m, K,
      N);
  return cudaGetLastError();
}
