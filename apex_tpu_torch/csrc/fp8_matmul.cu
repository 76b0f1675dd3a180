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
// * Prefill, m > 8: bound by operations (2 m K N: 4.3 GFLOP at the serve
//   engines' fc1, m 512). One launch of blocks of 128 output columns by 128
//   or 64 rows (`bm`), three warpgroups each, computing y^T = W^T x^T on
//   the pattern of wgmma_gemm.cuh: one producer thread issues TMA loads,
//   into a ring of 4 stages of 64 K rows with one `full` mbarrier a stage,
//   of x's tile (K-major) and of the weight's e4m3 tile as stored, both
//   128-byte swizzled; two consumer warpgroups, 64 weight columns each,
//   read their columns' e4m3 bytes with ldmatrix (transposed, 16-bit
//   elements: a lane gets the k pairs of two adjacent columns), convert
//   them exactly to bf16 in registers (integer operations and one bf16
//   product) while the previous stage's products run, and issue wgmma
//   m64nBMk16 bf16 with those fragments as the register A operand and x's
//   tile as B, fp32 accumulators in registers. Every e4m3 value and every
//   bf16 x is exact in bf16, so every product is exact and only the fp32
//   summation order differs from the reference. Where (K, N) leaves the
//   card under-filled at the engines' m 512 (proj and fc2: 32 tiles of 128
//   rows), blocks take 64 rows and K is split across a thread-block cluster
//   of 2 (`bm`, `splits` and `kc` from the wrapper's `_prefill_plan`, a
//   function of (K, N) alone): each block owns half of the tile's rows and
//   the other stores its partials of them into its shared memory (st.async,
//   dsmem.cuh), where they are summed in rank order. The owner divides by
//   the scale once (a correctly rounded reciprocal and two remainder
//   corrections: the quotient of `/`), rounds to bf16, stages its rows and
//   writes them with one TMA store a consumer warpgroup (its 64 columns).
//   The tiles, the split and each split's rows depend on (K, N) alone and
//   no atomics run, so a rerun is bitwise the same and a row's bits do not
//   depend on the rows that come with it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dsmem.cuh"        // the cluster's pushes
#include "wgmma_gemm.cuh"   // mbarrier / TMA primitives, the map encoder

namespace {

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

constexpr int PF_BN = 128;            // output columns a block (2 x 64)
constexpr int PF_BK = 64;             // K rows a stage
constexpr int PF_RING = 4;            // stages
constexpr int PF_THREADS = 384;       // producer + two consumer warpgroups
constexpr int PF_W_BYTES = PF_BK * PF_BN;       // [64 K][128] e4m3, 8 KB
constexpr int PF_MAX_SPLITS = 2;

// The sizes of a block of BM output rows (x rows: the products' N)
template <int BM>
struct Pf {
  static constexpr int X_BYTES = BM * PF_BK * 2;   // [BM rows][64 K] bf16
  static constexpr int ACC = BM / 2;               // accumulators a thread
  // the partials a block receives: [splits][ACC / splits / 4][256][4]
  static constexpr int GATHER = 256 * ACC * 4;
  static constexpr int STAGE = BM * PF_BN * 2;     // the staged output
  static constexpr size_t smem(int splits) {
    // 1024 for alignment, the x and weight rings, the gathered partials
    // (split launches only), the staged output, the barriers
    return 1024 + (size_t)PF_RING * (X_BYTES + PF_W_BYTES) +
           (splits > 1 ? GATHER : 0) + STAGE + (2 * PF_RING + 1) * 8;
  }
};
// the launches the plan makes: 128 rows unsplit, 64 rows split or not
static_assert(Pf<128>::smem(1) <= 232448 && Pf<64>::smem(2) <= 232448,
              "shared memory");

#define PF_R8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A[64 x 16] B[16 x BM]: A in registers (64 weight columns, the
// transposed weight converted to bf16), B the x tile from shared memory,
// K-major; `acc` 0 overwrites d
template <int BM>
__device__ __forceinline__ void pf_mma(float (&d)[BM / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (BM == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : PF_R8(0), PF_R8(8), PF_R8(16), PF_R8(24), PF_R8(32), PF_R8(40),
          PF_R8(48), PF_R8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else {
    static_assert(BM == 64, "64 or 128 rows a block");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : PF_R8(0), PF_R8(8), PF_R8(16), PF_R8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
}
#undef PF_R8

// Two e4m3 bytes of `w`, those the byte permute `sel` moves to bytes 1 and
// 3, as bf16x2 (byte 1's value low), exactly and with integer operations
// alone: each sign moved to its half's bit 15 and its exponent and
// mantissa bits 4 bits down, into the bottom of bf16's exponent and the top
// of its mantissa, give the value times 2^-120 (an e4m3 subnormal becomes a
// bf16 subnormal), which one exact bf16 product with 2^120 (0x7B80)
// restores.
__device__ __forceinline__ uint32_t e4m3_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0, sel);
  const uint32_t r = ((t >> 4) & 0x07F007F0u) | (t & 0x80008000u);
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(r), "r"(0x7B807B80u), "r"(0x80008000u));
  return out;
}

// four 8 x 8 matrices of 16-bit elements, transposed: lane L gives the row
// address of matrix L / 8, row L % 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(p)));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void pf_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// folds a set of A fragments into `live`: a real read of each register,
// which keeps the set in registers of its own until here
__device__ __forceinline__ void pf_live(uint32_t& live,
                                        const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) live ^= a[j][i];
}

// The staged output tile: two halves of 64 columns, each [BM rows][128
// bytes] with the 16-byte chunk c of row r at c ^ (r % 8): the layout of a
// 128-byte-swizzled TMA box, and free of bank conflicts for the
// accumulator writes.
template <int BM>
__device__ __forceinline__ int pf_stage_off(int r, int col) {
  return (col / 64) * (BM * 128) + r * 128 + ((((col % 64) / 8) ^ (r % 8)) << 4) +
         2 * (col % 8);
}

__device__ __forceinline__ void pf_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a bulk tensor store of the box at (c0 inner, c1 outer) from src
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// One block: output rows [m0, m0 + BM) x columns [n0, n0 + 128) over the K
// rows of its split (its cluster rank), as y^T = W^T x^T: the weight is the
// products' A operand, in registers, and x their B, from shared memory.
// Shared memory: the x ring [RING][BM rows][64 K] bf16 and the weight ring
// [RING][64 K][128] e4m3 (TMA, both 128-byte swizzled: the 16-byte chunk c
// of row r at c ^ (r % 8)), the gathered partials (SPLITS > 1) and the
// barriers: `full` (a stage's bytes landed), `empty` (both consumer
// warpgroups are done with it), `gbar` (the other splits' partials
// landed).
//
// Consumer warpgroup cw takes the weight columns n0 + 64 cw .. + 63: the A
// rows of its m64 products, permuted so that lane (g = lane / 4, t = lane
// % 4) of warp w holds columns c = 64 cw + 16 w + 2 g (A row 16 w + g) and
// c + 1 (A row 16 w + g + 8). One ldmatrix.x4.trans over 8-row blocks of
// the e4m3 tile, read as 16-bit elements, hands the lane, for each block,
// the bytes (k 2 t, c), (2 t, c + 1), (2 t + 1, c), (2 t + 1, c + 1): a
// byte permute picks each column's k pair, converted exactly to bf16 by
// integer operations and one bf16 product (e4m3_to_bf16x2). A stage's fragments are built while the
// previous stage's products run (two register sets). Accumulator 4 nb + i
// of the lane is y[m0 + 8 nb + 2 t + i % 2][n0 + c + i / 2].
template <int BM, int SPLITS>
__global__ void __launch_bounds__(PF_THREADS, 1)
fp8_mm_prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap ymap,
                      const float* __restrict__ scale, int m, int K,
                      int kc) {
  using P = Pf<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sw = sx + PF_RING * P::X_BYTES;
  float* gath = reinterpret_cast<float*>(sw + PF_RING * PF_W_BYTES);
  uint8_t* stg = reinterpret_cast<uint8_t*>(gath) +
                 (SPLITS > 1 ? P::GATHER : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + P::STAGE);
  uint64_t* empty = full + PF_RING;
  uint64_t* gbar = empty + PF_RING;

  constexpr int OWN = P::ACC / SPLITS;   // accumulators an owner's share
  constexpr int CH = OWN / 4;            // ... in float4s: one nb each
  const int rank = blockIdx.x % SPLITS;  // the cluster: K
  const int n0 = (blockIdx.x / SPLITS) * PF_BN, m0 = blockIdx.y * BM;
  const int k_begin = rank * kc;
  const int k_end = min(K, k_begin + kc);
  const int nst = k_end > k_begin ? (k_end - k_begin + PF_BK - 1) / PF_BK
                                  : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    wg::prefetch_map(&xmap);
    wg::prefetch_map(&wmap);
    wg::prefetch_map(&ymap);
    for (int s = 0; s < PF_RING; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 2);
    }
    wg::mbar_init(gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (SPLITS > 1)
      wg::mbar_expect_tx(gbar, (uint32_t)((SPLITS - 1) * CH * 256 * 16));
  }
  __syncthreads();
  if constexpr (SPLITS > 1) dsmem::cluster_arrive();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full
    if (tid == 0)
      for (int s = 0; s < nst; ++s) {
        const int slot = s % PF_RING, k0 = k_begin + s * PF_BK;
        if (s >= PF_RING)
          wg::mbar_wait(&empty[slot], ((s / PF_RING) - 1) & 1);
        wg::mbar_expect_tx(&full[slot], P::X_BYTES + PF_W_BYTES);
        wg::tma_load(sx + slot * P::X_BYTES, &xmap, &full[slot], k0, m0);
        wg::tma_load(sw + slot * PF_W_BYTES, &wmap, &full[slot], n0, k0);
      }
    return;
  }

  // ---- consumers
  const int cw = tid / 128 - 1, t = tid % 128, lane = t % 32, w = t / 32;
  const float sc = *scale;         // read now, used after the products
  // this lane's ldmatrix row: k row lane % 8 of 8-row block lane / 8, in
  // the 16-byte chunk of columns 64 cw + 16 w .. + 15
  const int lrow = 8 * (lane / 8) + lane % 8;
  const int lds_off =
      lrow * PF_BN + (((4 * cw + w) ^ (lane % 8)) << 4);
  float acc[P::ACC];
#pragma unroll
  for (int i = 0; i < P::ACC; ++i) acc[i] = 0.f;

  // stage s: its A fragments (k-step j: [j][4]) into `a` while the
  // previous stage's products run, then its products and the previous
  // stage released once they are done
  auto stage = [&](int s, uint32_t(&a)[4][4]) {
    const int slot = s % PF_RING;
    wg::mbar_wait(&full[slot], (s / PF_RING) & 1);
    const uint8_t* wt = sw + slot * PF_W_BYTES;
    uint32_t r[2][4];
    ldsm_x4_trans(r[0], wt + lds_off);                  // k rows 0 .. 31
    ldsm_x4_trans(r[1], wt + lds_off + 32 * PF_BN);     // k rows 32 .. 63
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // k rows 16 j .. + 7 and 16 j + 8 .. + 15: bytes (k 2 t, c),
      // (2 t, c + 1), (2 t + 1, c), (2 t + 1, c + 1)
      const uint32_t lo = r[j / 2][2 * (j % 2)];
      const uint32_t hi = r[j / 2][2 * (j % 2) + 1];
      a[j][0] = e4m3_to_bf16x2(lo, 0x2404);    // column c, k 2 t, 2 t + 1
      a[j][1] = e4m3_to_bf16x2(lo, 0x3414);    // column c + 1
      a[j][2] = e4m3_to_bf16x2(hi, 0x2404);    // column c, k 2 t + 8, + 9
      a[j][3] = e4m3_to_bf16x2(hi, 0x3414);    // column c + 1
    }
    const uint8_t* xt = sx + slot * P::X_BYTES;
    pf_fence(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < PF_BK / 16; ++j)
      pf_mma<BM>(acc, a[j], wg::make_desc(xt + j * 32, 16, 1024), s | j);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();             // the previous stage's products are done
    pf_fence(acc);
    if (s > 0 && t == 0) wg::mbar_arrive(&empty[(s - 1) % PF_RING]);
  };
  // Two fragment sets, each read again (into `live`) once the next stage
  // has waited for the products that use it: otherwise ptxas gives the
  // four k-steps' fragments one set of registers, converts each just before
  // its product and serializes the products (ptxas warning C7513; one
  // WARPGROUP.DEPBAR a product in the SASS). The store `live` feeds never
  // runs (kc > 0).
  uint32_t a0[4][4], a1[4][4], live = 0;
  for (int s = 0; s < nst; s += 2) {
    stage(s, a0);
    if (s > 0) pf_live(live, a1);
    if (s + 1 < nst) {
      stage(s + 1, a1);
      pf_live(live, a0);
    }
  }
  wg::wgmma_wait<0>();
  pf_fence(acc);
  if (kc < 0) sx[live & 7] = 0;

  // the split's partials: each owner's rows into its gather slot
  // [rank][c][u], u = this thread's index over both consumer warpgroups
  const int u = cw * 128 + t;
  if constexpr (SPLITS > 1) {
    dsmem::cluster_wait();           // every block has started
#pragma unroll
    for (int q = 0; q < SPLITS; ++q) {
      if (q == rank) continue;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int i = q * OWN + 4 * c;
        dsmem::store_to_rank(
            gath + ((rank * CH + c) * 256 + u) * 4,
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]), gbar, q);
      }
    }
    wg::mbar_wait(gbar, 0);
  }
  // this block's rows into the staged tile (the splits' partials in rank
  // order, / scale, bf16; rows past m skipped), each warpgroup its own 64
  // columns: it waits for none but itself
  const int col = 64 * cw + 16 * w + 2 * (lane / 4);
  // v / sc, correctly rounded for every normal quotient: a correctly
  // rounded reciprocal, then two remainder corrections (Markstein), as
  // the divide's fast path does, with the reciprocal taken once
  const float rsc = __frcp_rn(sc);
  auto quot = [&](float v) {
    float q = v * rsc;
    q = fmaf(fmaf(-q, sc, v), rsc, q);
    q = fmaf(fmaf(-q, sc, v), rsc, q);
    return v == 0.f ? v : q;         // a signed zero keeps its sign
  };
#pragma unroll
  for (int q = 0; q < SPLITS; ++q) {
    if (q != rank) continue;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = q * OWN + 4 * c;
      const int row = 8 * (i / 4) + 2 * (lane % 4);
      if (m0 + row >= m) continue;
      float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int src = 0; src < SPLITS; ++src) {
        const float4 p =
            src == q ? make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3])
                     : *reinterpret_cast<const float4*>(
                           gath + ((src * CH + c) * 256 + u) * 4);
        if (src == 0) {
          tot = p;
        } else {
          tot.x += p.x;
          tot.y += p.y;
          tot.z += p.z;
          tot.w += p.w;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(stg + pf_stage_off<BM>(row, col)) =
          __floats2bfloat162_rn(quot(tot.x), quot(tot.z));
      *reinterpret_cast<__nv_bfloat162*>(stg +
                                         pf_stage_off<BM>(row + 1, col)) =
          __floats2bfloat162_rn(quot(tot.y), quot(tot.w));
    }
  }
  pf_fence_proxy_async();            // the staged tile, to the bulk store
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  // this block's rows of the warpgroup's 64 columns, one bulk store (rows
  // past m and columns past N clipped by the map)
  if (t == 0) {
    constexpr int ROWS = BM / SPLITS;
    tma_store(&ymap, stg + cw * (BM * 128) + rank * ROWS * 128, n0 + 64 * cw,
              m0 + rank * ROWS);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The maps of the prefill regime: x [m, K] bf16 in boxes of 64 K x BM rows,
// the weight [K, N] e4m3 in boxes of 128 columns x 64 rows (zeros past the
// extents), y [m, N] bf16 in boxes of 64 columns x BM / splits rows (the
// store clipped at the extents), all 128-byte swizzled. False when the
// driver refuses.
bool prefill_maps(CUtensorMap* xmap, CUtensorMap* wmap, CUtensorMap* ymap,
                  const void* x, const void* q, void* y, int m, int K, int N,
                  int bm, int splits) {
  wg::EncodeTiledFn fn = wg::encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t estr[2] = {1, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)m};
  const cuuint64_t xstr[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {PF_BK, (cuuint32_t)bm};
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t wstr[1] = {(cuuint64_t)N};
  const cuuint32_t wbox[2] = {PF_BN, PF_BK};
  const cuuint64_t ydims[2] = {(cuuint64_t)N, (cuuint64_t)m};
  const cuuint64_t ystr[1] = {(cuuint64_t)N * 2};
  const cuuint32_t ybox[2] = {64, (cuuint32_t)(bm / splits)};
  return fn(ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, ydims, ystr, ybox,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
            xdims, xstr, xbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
            wdims, wstr, wbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int SPLITS>
cudaError_t launch_prefill_tile(const CUtensorMap& xmap,
                                const CUtensorMap& wmap,
                                const CUtensorMap& ymap, const void* scale,
                                int m, int K, int N, int kc,
                                cudaStream_t st) {
  const size_t smem = Pf<BM>::smem(SPLITS);
  cudaError_t err = cudaFuncSetAttribute(
      fp8_mm_prefill_kernel<BM, SPLITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLITS * ((N + PF_BN - 1) / PF_BN), (m + BM - 1) / BM,
                     1);
  cfg.blockDim = dim3(PF_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLITS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLITS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, fp8_mm_prefill_kernel<BM, SPLITS>, xmap,
                           wmap, ymap, static_cast<const float*>(scale), m, K,
                           kc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_prefill(const void* x, const void* q, const void* scale,
                           void* y, int m, int K, int N, int bm, int splits,
                           int kc, cudaStream_t st) {
  if ((bm != 64 && bm != 128) || splits < 1 || splits > PF_MAX_SPLITS ||
      kc < PF_BK || kc % PF_BK || (long)splits * kc < K)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, ymap;
  if (!prefill_maps(&xmap, &wmap, &ymap, x, q, y, m, K, N, bm, splits))
    return cudaErrorNotSupported;
#define PF_LAUNCH(B, S) \
  launch_prefill_tile<B, S>(xmap, wmap, ymap, scale, m, K, N, kc, st)
  if (bm == 128)
    return splits == 1 ? PF_LAUNCH(128, 1) : cudaErrorInvalidValue;
  return splits == 1 ? PF_LAUNCH(64, 1) : PF_LAUNCH(64, 2);
#undef PF_LAUNCH
}

}  // namespace

// C interface (loaded with ctypes); see the contract at the top. `splits`
// and `kc` are the K split of the launch's regime: the decode regime's
// (m <= 8; splits 1, 2, 4 or 8, kc a multiple of 64, `_splits`) or the
// prefill regime's (m > 8; `bm` 64 or 128 rows a block, splits 1 or 2,
// 2 only at bm 64, kc a multiple of 64: `_prefill_plan`), with splits * kc
// >= K.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape
// outside the contract, cudaErrorNotSupported when the driver refuses a TMA
// map).
extern "C" int apex_fp8_matmul(const void* x, const void* q, const void* scale,
                               void* y, int m, int K, int N, int bm,
                               int splits, int kc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || N <= 0) return cudaSuccess;
  if (K % 16 || N % 16) return cudaErrorInvalidValue;
  if (m <= 8) return launch_decode(x, q, scale, y, m, K, N, splits, kc, st);
  return launch_prefill(x, q, scale, y, m, K, N, bm, splits, kc, st);
}
