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
// * Decode, m <= 8: bound by the weight's bytes (K*N, one byte each; ~1 flop
//   per byte at m = 1). One block per (128-column tile, K split): 256 threads
//   as 16 column groups of 8 columns times 16 row groups, so each half-warp
//   reads one 128-byte row segment. x of the block's K range sits in shared
//   memory as fp32; each thread keeps m x 8 fp32 sums in registers over its
//   rows, the 16 row groups are summed through shared memory in a fixed
//   order, and the block writes fp32 partials [split, m, N]. A second kernel
//   sums the splits in order and applies 1 / scale. The split count comes
//   from (K, N) alone, aiming at one wave of ~132 blocks, so that the small
//   products (N = 1024) still stream on every SM.
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

namespace {

// ---------------------------------------------------------------- decode

constexpr int SK_THREADS = 256;
constexpr int SK_BN = 128;             // columns per block
constexpr int SK_CG = SK_BN / 8;       // column groups (8 columns each)
constexpr int SK_KG = SK_THREADS / SK_CG;  // row groups
constexpr int SK_MAX_M = 8;
constexpr int SK_MAX_KC = 512;         // rows per split (the wrapper keeps it)

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

template <int M>
__global__ void __launch_bounds__(SK_THREADS)
fp8_mm_skinny_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ q,
                     float* __restrict__ ws, int K, int N, int kc) {
  __shared__ float sX[M][SK_MAX_KC];
  __shared__ float sRed[SK_KG][SK_BN];

  const int tid = threadIdx.x;
  const int cg = tid % SK_CG, kg = tid / SK_CG;
  const int n0 = blockIdx.x * SK_BN;
  const int split = blockIdx.y;
  const int k_begin = split * kc;
  const int k_end = min(K, k_begin + kc);
  const int rows = k_end - k_begin;

  for (int i = tid; i < M * rows; i += SK_THREADS) {
    const int r = i / rows, k = i % rows;
    sX[r][k] = __bfloat162float(x[(long)r * K + k_begin + k]);
  }
  __syncthreads();

  float acc[M][8];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  const int col = n0 + cg * 8;
  if (col < N) {
#pragma unroll 4
    for (int k = kg; k < rows; k += SK_KG) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          q + (long)(k_begin + k) * N + col);
      float w[8];
      e4m3x8_to_float(u, w);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const float xv = sX[r][k];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(xv, w[e], acc[r][e]);
      }
    }
  }

  // sum the row groups in a fixed order, one output row at a time
#pragma unroll
  for (int r = 0; r < M; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sRed[kg][cg * 8 + e] = acc[r][e];
    __syncthreads();
    if (tid < SK_BN && n0 + tid < N) {
      float tot = 0.f;
#pragma unroll
      for (int g = 0; g < SK_KG; ++g) tot += sRed[g][tid];
      ws[((long)split * M + r) * N + n0 + tid] = tot;
    }
    __syncthreads();
  }
}

__global__ void fp8_mm_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     __nv_bfloat16* __restrict__ y, int m,
                                     int N, int splits) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)m * N;
  if (i >= total) return;
  float tot = 0.f;
  for (int s = 0; s < splits; ++s) tot += ws[(long)s * total + i];
  y[i] = __float2bfloat16(tot / *scale);
}

template <int M>
cudaError_t launch_skinny(const void* x, const void* q, const void* scale,
                          void* y, void* ws, int K, int N, int splits,
                          cudaStream_t st) {
  const int kc = (K + splits - 1) / splits;
  if (kc > SK_MAX_KC) return cudaErrorInvalidValue;
  dim3 grid((N + SK_BN - 1) / SK_BN, splits);
  fp8_mm_skinny_kernel<M><<<grid, SK_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<float*>(ws), K, N, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = (long)M * N;
  fp8_mm_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), M, N, splits);
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

// C interface (loaded with ctypes); see the contract at the top. `ws` is an
// fp32 workspace of splits * m * N values (used when m <= 8), `splits` the
// K split of the decode regime. Returns the launches' cudaError_t
// (cudaErrorInvalidValue for a shape outside the contract).
extern "C" int apex_fp8_matmul(const void* x, const void* q, const void* scale,
                               void* y, void* ws, int m, int K, int N,
                               int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || N <= 0) return cudaSuccess;
  if (K % 16 || N % 16 || splits < 1) return cudaErrorInvalidValue;
  switch (m) {
    case 1: return launch_skinny<1>(x, q, scale, y, ws, K, N, splits, st);
    case 2: return launch_skinny<2>(x, q, scale, y, ws, K, N, splits, st);
    case 3: return launch_skinny<3>(x, q, scale, y, ws, K, N, splits, st);
    case 4: return launch_skinny<4>(x, q, scale, y, ws, K, N, splits, st);
    case 5: return launch_skinny<5>(x, q, scale, y, ws, K, N, splits, st);
    case 6: return launch_skinny<6>(x, q, scale, y, ws, K, N, splits, st);
    case 7: return launch_skinny<7>(x, q, scale, y, ws, K, N, splits, st);
    case 8: return launch_skinny<8>(x, q, scale, y, ws, K, N, splits, st);
    default: break;
  }
  dim3 grid((N + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM);
  fp8_mm_tc_kernel<<<grid, TC_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), m, K,
      N);
  return cudaGetLastError();
}
