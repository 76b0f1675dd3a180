// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over a paged KV pool, GQA-aware, fp32 online softmax; bf16, fp16 or fp32
// queries over pages of the query's dtype or of e4m3.
//
// Replaces the Pallas kernel `_paged_decode_kernel` of
// apex_tpu/ops/flash_attention.py (:986, launched by `paged_decode_attention`
// :1056), both of its modes. Contract (shared with apex_tpu_torch.serve.cache):
//   q            [b, kv, group, d]          bf16, fp16 or fp32
//   k/v pages    [kv, num_pages, page, d]   q's dtype, or e4m3 in fp8 mode
//   k/v scales   [kv, num_pages] fp32       fp8 mode only (else null)
//   block_tables [b, m] int32  (page 0 is the null page)
//   seq_lens     [b] int32     (0 = inactive slot: exact zero output)
//   out          [b, kv, group, d]          q's dtype
// Pages wholly past seq_lens[b] are never read; keys past seq_lens[b] in a
// partly live page are left out of the max and the sum (the Pallas kernel
// masks them to -1e30 and zeroes their p: the same result).
//
// fp8 mode (the JAX kernel's `fp8=True`, :1004-1035): a stored page holds
// clip(x * page_scale) in e4m3, one scale per (kv head, page). The score is
// s = (q . k) / ks[kh, page] * scale, and the value term (p . v) / vs[kh,
// page] with p kept in fp32 (folded here as p / vs into the p that
// multiplies v). The bf16 mode's arithmetic is untouched.
//
// Bound on the H100: HBM bytes. Each live K and V row is read once and used
// for 2*group flops per element, so at group 1 the kernel does ~1 flop per
// byte (~2 in fp8 mode): the time is the live pages' bytes over the memory
// rate.
//
// Design. One thread block (128 threads) per (kv head, sequence, chunk of
// up to 8 query rows of the group): the block
// loads its own block-table row and seq_len, which replaces the TPU's scalar
// prefetch, and walks only the live pages. D/8 threads share one key row,
// each loading 8 contiguous elements (16 bytes of bf16, 8 of e4m3), so a
// warp reads whole rows and a page (contiguous in the pool) streams
// coalesced. Per page: scores for every live key into shared memory (a
// shuffle reduction over the D/8 lanes), then one warp per query row takes
// the page max, the exponentials and the sum and publishes the rescale
// factor, then every thread folds its keys' p * v into fp32 accumulators
// held in registers. The accumulators of the key lanes are summed through
// shared memory once, after the last page. A group of more than 8 rows
// (the JAX kernel pads the group to a multiple of 8, :1097) runs in chunks
// of 8, one block each, which read the same pages: the accumulators of 8
// rows x 8 columns a thread are what the registers hold. Splitting a
// sequence across
// blocks (flash-decoding) and deeper load pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void f16x8_to_float(const uint4& u, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

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

// The e4m3 pool's element type
struct E4M3 {};

// 8 consecutive elements of type T from element offset `idx`, as fp32
template <typename T>
__device__ __forceinline__ void load8(const void* base, long idx, float* f) {
  if constexpr (std::is_same<T, E4M3>::value) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(base) + idx);
    e4m3x8_to_float(u, f);
  } else if constexpr (std::is_same<T, float>::value) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + idx);
    const float4 a = p[0], b = p[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (std::is_same<T, __half>::value) {
    f16x8_to_float(*reinterpret_cast<const uint4*>(
                       static_cast<const __half*>(base) + idx), f);
  } else {
    bf16x8_to_float(*reinterpret_cast<const uint4*>(
                        static_cast<const __nv_bfloat16*>(base) + idx), f);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <typename T, int D, int G, bool FP8>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q,
                    const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ seq_lens,
                    T* __restrict__ out, int kv, int num_pages,
                    int page_size, int m, int group_all, float scale) {
  using Pool = typename std::conditional<FP8, E4M3, T>::type;
  constexpr int TPK = D / 8;             // threads per key row
  constexpr int KPI = THREADS / TPK;     // keys per iteration
  constexpr int WARPS = THREADS / 32;

  extern __shared__ float smem[];
  float* sP = smem;                      // [G][page_size] scores, then p
  float* sRed = smem + G * page_size;    // [KPI][D] final reduction
  __shared__ float sM[G], sL[G], sAlpha[G];

  const int kh = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kl = tid / TPK, c = tid % TPK;
  // this block's rows of the group: [g0, g0 + group)
  const int g0 = blockIdx.z * G;
  const int group = min(G, group_all - g0);
  const long qrow = ((long)bi * kv + kh) * group_all + g0;

  const int n_live = min(seq_lens[bi], m * page_size);
  if (n_live <= 0) {                     // inactive slot: exact zeros
    for (int i = tid; i < group * D; i += THREADS)
      out[qrow * D + i] = from_float<T>(0.f);
    return;
  }

  float qf[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < group) {
      load8<T>(q, (qrow + gi) * D + c * 8, qf[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[gi][e] = 0.f;
    }
  }
  float acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gi][e] = 0.f;
  if (tid < G) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int n_pages = (n_live + page_size - 1) / page_size;
  for (int j = 0; j < n_pages; ++j) {
    int page = block_tables[(long)bi * m + j];
    page = min(max(page, 0), num_pages - 1);   // clamp like an XLA gather
    const long base = ((long)kh * num_pages + page) * page_size * D;
    const int live = min(page_size, n_live - j * page_size);
    float ks = 1.f, vs = 1.f;
    if constexpr (FP8) {
      ks = k_scales[(long)kh * num_pages + page];
      vs = v_scales[(long)kh * num_pages + page];
    }

    // ---- scores of the live keys: s = (q . k) * scale
    for (int t0 = 0; t0 < live; t0 += KPI) {
      const int t = t0 + kl;
      float kf[8];
      if (t < live) {
        load8<Pool>(kp, base + (long)t * D + c * 8, kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part += qf[gi][e] * kf[e];
#pragma unroll
        for (int off = 1; off < TPK; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (c == 0 && t < live && gi < group) {
          if constexpr (FP8)
            sP[gi * page_size + t] = part / ks * scale;
          else
            sP[gi * page_size + t] = part * scale;
        }
      }
    }
    __syncthreads();

    // ---- one warp per query row: page max, p = exp(s - m_new), sum
    for (int gi = warp; gi < group; gi += WARPS) {
      float* row = sP + gi * page_size;
      float mx = NEG_INF;
      for (int t = lane; t < live; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < live; t += 32) {
        const float p = __expf(row[t] - m_new);
        if constexpr (FP8)
          row[t] = p / vs;
        else
          row[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        sAlpha[gi] = alpha;
        sL[gi] = alpha * sL[gi] + sum;
        sM[gi] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + sum_t p[t] * v[t]
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float a = gi < group ? sAlpha[gi] : 1.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[gi][e] *= a;
    }
    for (int t = kl; t < live; t += KPI) {
      float vf[8];
      load8<Pool>(vp, base + (long)t * D + c * 8, vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < group) {
          const float p = sP[gi * page_size + t];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[gi][e] += p * vf[e];
        }
      }
    }
    __syncthreads();  // sP is rewritten by the next page
  }

  // ---- sum the key lanes' partial accumulators, normalize, store
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi >= group) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) sRed[kl * D + c * 8 + e] = acc[gi][e];
    __syncthreads();
    for (int col = tid; col < D; col += THREADS) {
      float tot = 0.f;
      for (int r = 0; r < KPI; ++r) tot += sRed[r * D + col];
      const float l = sL[gi];
      out[(qrow + gi) * D + col] = from_float<T>(tot / (l > 0.f ? l : 1.f));
    }
    __syncthreads();
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *bt, *sl;
  void* out;
  int b, kv, num_pages, page_size, m, group;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int G, bool FP8>
cudaError_t launch(const Args& a) {
  constexpr int KPI = THREADS / (D / 8);
  const size_t smem = ((size_t)G * a.page_size + (size_t)KPI * D) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D, G, FP8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.kv, a.b, (a.group + G - 1) / G);
  paged_decode_kernel<T, D, G, FP8><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.kp, a.vp,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.sl),
      static_cast<T*>(a.out), a.kv, a.num_pages, a.page_size,
      a.m, a.group, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool FP8>
cudaError_t dispatch_group(const Args& a) {
  if (a.group <= 1) return launch<T, D, 1, FP8>(a);
  if (a.group <= 2) return launch<T, D, 2, FP8>(a);
  if (a.group <= 4) return launch<T, D, 4, FP8>(a);
  return launch<T, D, 8, FP8>(a);        // chunks of 8 past 8
}

template <typename T, bool FP8>
cudaError_t dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 32: return dispatch_group<T, 32, FP8>(a);
    case 64: return dispatch_group<T, 64, FP8>(a);
    case 128: return dispatch_group<T, 128, FP8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_pool(const Args& a, int d, bool fp8) {
  return fp8 ? dispatch_dim<T, true>(a, d) : dispatch_dim<T, false>(a, d);
}

}  // namespace

// C interface (loaded with ctypes); see the contract at the top. `dtype` is
// q's (0 bf16, 1 fp16, 2 fp32). Null k_scales/v_scales select a pool of
// q's dtype, non-null the e4m3 pool. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a head dim other than 32, 64, 128 or an
// unknown dtype).
extern "C" int apex_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales,
                                 const void* block_tables,
                                 const void* seq_lens, void* out, int b,
                                 int kv, int group, int d, int num_pages,
                                 int page_size, int m, float scale,
                                 int dtype, void* stream) {
  if (b <= 0 || kv <= 0 || group <= 0) return cudaSuccess;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, block_tables,
               seq_lens, out, b, kv, num_pages, page_size, m, group, scale,
               static_cast<cudaStream_t>(stream)};
  if ((k_scales == nullptr) != (v_scales == nullptr))
    return cudaErrorInvalidValue;
  const bool fp8 = k_scales != nullptr;
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return dispatch_pool<__nv_bfloat16>(a, d, fp8);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return dispatch_pool<__half>(a, d, fp8);
#else
      return cudaErrorInvalidValue;
#endif
    case 2:
#if APEX_HAS_DTYPE(2)
      return dispatch_pool<float>(a, d, fp8);
#else
      return cudaErrorInvalidValue;
#endif
    default: return cudaErrorInvalidValue;
  }
}
