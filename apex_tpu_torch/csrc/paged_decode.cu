// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over a paged KV pool, GQA-aware, fp32 online softmax; bf16, fp16 or fp32
// queries over pages of bf16, fp16, fp32 (any of them with any query dtype)
// or e4m3.
//
// Replaces the Pallas kernel `_paged_decode_kernel` of
// apex_tpu/ops/flash_attention.py (:986, launched by `paged_decode_attention`
// :1056), both of its modes. Contract (shared with apex_tpu_torch.serve.cache):
//   q            [b, kv, group, d]          bf16, fp16 or fp32
//   k/v pages    [kv, num_pages, page, d]   bf16, fp16, fp32, or e4m3 in
//                                           fp8 mode
//   k/v scales   [kv, num_pages] fp32       fp8 mode only (else null)
//   block_tables [b, m] int32  (page 0 is the null page)
//   seq_lens     [b] int32     (0 = inactive slot: exact zero output)
//   out          [b, kv, group, d]          q's dtype
// with any head dim d up to 512. Pages wholly past seq_lens[b] are never
// read; keys past seq_lens[b] in a partly live page are left out of the max
// and the sum (the Pallas kernel masks them to -1e30 and zeroes their p: the
// same result). Scores and p are fp32 whatever the dtypes (p is not rounded
// to the pool's dtype before the PV product, as in the plain versions of
// both packages; the Pallas kernel rounds it in its 16-bit mode).
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
// up to 8 query rows of the group): the block loads its own block-table row
// and seq_len, which replaces the TPU's scalar prefetch, and walks only the
// live pages. The head dim runs at its instantiation DP, the next of 32,
// 64, 128, 256 and 512 at or above d: DP/8 threads share one key row (32 at
// DP 512, each holding two pieces), each loading 8 contiguous elements, so
// a warp reads whole rows and a page (contiguous in the pool) streams
// coalesced. While d % 8 == 0 a piece is one vector load (16 bytes of
// bf16, 8 of e4m3); otherwise rows start at any element and the pieces are
// masked element loads, zeros past d. The pool is read in place, never
// padded. The serve engine's case — d equal to its instantiation over a
// pool of q's dtype or of e4m3 — is a compile-time path (constant row
// strides, one vector load a piece); other d and pool dtypes take the
// general one (runtime d, the pool's dtype a warp-uniform branch). Per page: scores for every live key into shared memory (a
// shuffle reduction over the row's lanes), then one warp per query row
// takes the page max, the exponentials and the sum and publishes the
// rescale factor, then every thread folds its keys' p * v into fp32
// accumulators held in registers. The accumulators of the key lanes are
// summed through shared memory once, after the last page. A group of more
// than 8 rows (the JAX kernel pads the group to a multiple of 8, :1097) runs
// in chunks of 8 (4 at DP 512), one block each, which read the same pages:
// the accumulators of 8 rows x 8 columns a thread are what the registers
// hold. Splitting a sequence across blocks (flash-decoding) and deeper load
// pipelining are later work.

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

template <typename P>
__device__ __forceinline__ float elem_to_float(const void* base, long i) {
  if constexpr (std::is_same<P, E4M3>::value) {
    const __half h = __half(__nv_cvt_fp8_to_halfraw(
        static_cast<const __nv_fp8_storage_t*>(base)[i], __NV_E4M3));
    return __half2float(h);
  } else if constexpr (std::is_same<P, float>::value) {
    return static_cast<const float*>(base)[i];
  } else if constexpr (std::is_same<P, __half>::value) {
    return __half2float(static_cast<const __half*>(base)[i]);
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  }
}

// 8 consecutive elements of type P from element offset `idx`, as fp32: one
// vector load (16 bytes of bf16/fp16, 32 of fp32, 8 of e4m3), which needs
// idx % 8 == 0
template <typename P>
__device__ __forceinline__ void load8(const void* base, long idx, float* f) {
  if constexpr (std::is_same<P, E4M3>::value) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(base) + idx);
    e4m3x8_to_float(u, f);
  } else if constexpr (std::is_same<P, float>::value) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + idx);
    const float4 a = p[0], b = p[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (std::is_same<P, __half>::value) {
    f16x8_to_float(*reinterpret_cast<const uint4*>(
                       static_cast<const __half*>(base) + idx), f);
  } else {
    bf16x8_to_float(*reinterpret_cast<const uint4*>(
                        static_cast<const __nv_bfloat16*>(base) + idx), f);
  }
}

// Columns [col, col + 8) of the row at element offset `row` of a [.., d]
// tensor, zeros past d: the vector load while d % 8 == 0 (`vec`), masked
// element loads otherwise (a row then starts at any element).
template <typename P>
__device__ __forceinline__ void load_cols(const void* base, long row,
                                          int col, int d, bool vec,
                                          float* f) {
  if (vec && col < d) {
    load8<P>(base, row + col, f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = col + e < d ? elem_to_float<P>(base, row + col + e) : 0.f;
}

// The same from a pool whose 16-bit or fp32 dtype is known at run time
// (code 0 bf16, 1 fp16, 2 fp32): a warp-uniform branch per row piece.
template <bool FP8>
__device__ __forceinline__ void load_pool(const void* base, int code,
                                          long row, int col, int d, bool vec,
                                          float* f) {
  if constexpr (FP8) {
    load_cols<E4M3>(base, row, col, d, vec, f);
  } else if (code == 0) {
    load_cols<__nv_bfloat16>(base, row, col, d, vec, f);
  } else if (code == 1) {
    load_cols<__half>(base, row, col, d, vec, f);
  } else {
    load_cols<float>(base, row, col, d, vec, f);
  }
}

// A K or V piece: the general path reads a pool of a runtime dtype at a
// runtime d; the exact path (d == DP, a pool of q's dtype or e4m3, the
// serve engine's case) knows both at compile time.
template <typename T, bool FP8, bool GENERAL>
__device__ __forceinline__ void load_kv(const void* base, int code, long row,
                                        int col, int d, bool vec, float* f) {
  if constexpr (GENERAL)
    load_pool<FP8>(base, code, row, col, d, vec, f);
  else
    load_cols<typename std::conditional<FP8, E4M3, T>::type>(base, row, col,
                                                             d, true, f);
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

// DP: the head dim's instantiation (the next of 32 .. 512 at or above the
// runtime d); NV 8-element pieces a thread of a key row (2 at DP 512).
// GENERAL: a runtime d and pool dtype (else d == DP and the pool is q's
// dtype or e4m3).
template <typename T, int DP, int G, bool FP8, bool GENERAL>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q,
                    const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ seq_lens,
                    T* __restrict__ out, int kv, int num_pages,
                    int page_size, int m, int group_all, int d_rt,
                    int pool_code, float scale) {
  constexpr int NV = DP > 256 ? 2 : 1;
  constexpr int TPK = DP / (8 * NV);     // threads per key row
  constexpr int KPI = THREADS / TPK;     // keys per iteration
  constexpr int WARPS = THREADS / 32;
  constexpr int E = 8 * NV;              // elements a thread of a row

  extern __shared__ float smem[];
  float* sP = smem;                      // [G][page_size] scores, then p
  float* sRed = smem + G * page_size;    // [KPI][DP] final reduction
  __shared__ float sM[G], sL[G], sAlpha[G];

  const int kh = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kl = tid / TPK, c = tid % TPK;
  const int d = GENERAL ? d_rt : DP;
  const bool vec = !GENERAL || d % 8 == 0;
  // this block's rows of the group: [g0, g0 + group)
  const int g0 = blockIdx.z * G;
  const int group = min(G, group_all - g0);
  const long qrow = ((long)bi * kv + kh) * group_all + g0;

  const int n_live = min(seq_lens[bi], m * page_size);
  if (n_live <= 0) {                     // inactive slot: exact zeros
    for (int i = tid; i < group * d; i += THREADS)
      out[qrow * d + i] = from_float<T>(0.f);
    return;
  }

  float qf[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (gi < group) {
        load_cols<T>(q, (qrow + gi) * d, (j * TPK + c) * 8, d, vec,
                     qf[gi] + 8 * j);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qf[gi][8 * j + e] = 0.f;
      }
    }
  }
  float acc[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  if (tid < G) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int n_pages = (n_live + page_size - 1) / page_size;
  for (int j = 0; j < n_pages; ++j) {
    int page = block_tables[(long)bi * m + j];
    page = min(max(page, 0), num_pages - 1);   // clamp like an XLA gather
    const long base = ((long)kh * num_pages + page) * page_size * d;
    const int live = min(page_size, n_live - j * page_size);
    float ks = 1.f, vs = 1.f;
    if constexpr (FP8) {
      ks = k_scales[(long)kh * num_pages + page];
      vs = v_scales[(long)kh * num_pages + page];
    }

    // ---- scores of the live keys: s = (q . k) * scale
    for (int t0 = 0; t0 < live; t0 += KPI) {
      const int t = t0 + kl;
      float kf[E];
#pragma unroll
      for (int v8 = 0; v8 < NV; ++v8) {
        if (t < live) {
          load_kv<T, FP8, GENERAL>(kp, pool_code, base + (long)t * d,
                                   (v8 * TPK + c) * 8, d, vec, kf + 8 * v8);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[8 * v8 + e] = 0.f;
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qf[gi][e] * kf[e];
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
      for (int e = 0; e < E; ++e) acc[gi][e] *= a;
    }
    for (int t = kl; t < live; t += KPI) {
      float vf[E];
#pragma unroll
      for (int v8 = 0; v8 < NV; ++v8)
        load_kv<T, FP8, GENERAL>(vp, pool_code, base + (long)t * d,
                                 (v8 * TPK + c) * 8, d, vec, vf + 8 * v8);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < group) {
          const float p = sP[gi * page_size + t];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[gi][e] += p * vf[e];
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
    for (int v8 = 0; v8 < NV; ++v8)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sRed[kl * DP + (v8 * TPK + c) * 8 + e] = acc[gi][8 * v8 + e];
    __syncthreads();
    for (int col = tid; col < d; col += THREADS) {
      float tot = 0.f;
      for (int r = 0; r < KPI; ++r) tot += sRed[r * DP + col];
      const float l = sL[gi];
      out[(qrow + gi) * d + col] = from_float<T>(tot / (l > 0.f ? l : 1.f));
    }
    __syncthreads();
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *bt, *sl;
  void* out;
  int b, kv, num_pages, page_size, m, group, d, pool_code;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DP, int G, bool FP8, bool GENERAL>
cudaError_t launch(const Args& a) {
  constexpr int NV = DP > 256 ? 2 : 1;
  constexpr int KPI = THREADS / (DP / (8 * NV));
  const size_t smem = ((size_t)G * a.page_size + (size_t)KPI * DP) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, DP, G, FP8, GENERAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.kv, a.b, (a.group + G - 1) / G);
  paged_decode_kernel<T, DP, G, FP8, GENERAL>
      <<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.kp, a.vp,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.sl),
      static_cast<T*>(a.out), a.kv, a.num_pages, a.page_size,
      a.m, a.group, a.d, a.pool_code, a.scale);
  return cudaGetLastError();
}

// query rows a block: up to 8 (4 at DP 512, whose rows take twice the
// registers), larger groups in chunks of that many
template <typename T, int DP, bool FP8, bool GENERAL>
cudaError_t dispatch_group(const Args& a) {
  if (a.group <= 1) return launch<T, DP, 1, FP8, GENERAL>(a);
  if (a.group <= 2) return launch<T, DP, 2, FP8, GENERAL>(a);
  if constexpr (DP > 256) {
    return launch<T, DP, 4, FP8, GENERAL>(a);
  } else {
    if (a.group <= 4) return launch<T, DP, 4, FP8, GENERAL>(a);
    return launch<T, DP, 8, FP8, GENERAL>(a);
  }
}

template <typename T, int DP, bool FP8>
cudaError_t dispatch_path(const Args& a, int code) {
  const bool exact = a.d == DP && (FP8 || a.pool_code == code);
  return exact ? dispatch_group<T, DP, FP8, false>(a)
               : dispatch_group<T, DP, FP8, true>(a);
}

// `code`: q's dtype code
template <typename T, bool FP8>
cudaError_t dispatch_dim(const Args& a, int code) {
  if (a.d <= 0) return cudaErrorInvalidValue;
  if (a.d <= 32) return dispatch_path<T, 32, FP8>(a, code);
  if (a.d <= 64) return dispatch_path<T, 64, FP8>(a, code);
  if (a.d <= 128) return dispatch_path<T, 128, FP8>(a, code);
  if (a.d <= 256) return dispatch_path<T, 256, FP8>(a, code);
  if (a.d <= 512) return dispatch_path<T, 512, FP8>(a, code);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_pool(const Args& a, bool fp8, int code) {
  return fp8 ? dispatch_dim<T, true>(a, code)
             : dispatch_dim<T, false>(a, code);
}

}  // namespace

// C interface (loaded with ctypes); see the contract at the top. `dtype` is
// q's (0 bf16, 1 fp16, 2 fp32). Null k_scales/v_scales select a pool of
// `pool_dtype` (0 bf16, 1 fp16, 2 fp32; any of them with any q dtype),
// non-null the e4m3 pool. Any head dim d up to 512. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for d past 512 or an unknown dtype).
extern "C" int apex_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales,
                                 const void* block_tables,
                                 const void* seq_lens, void* out, int b,
                                 int kv, int group, int d, int num_pages,
                                 int page_size, int m, float scale,
                                 int dtype, int pool_dtype, void* stream) {
  if (b <= 0 || kv <= 0 || group <= 0) return cudaSuccess;
  if (pool_dtype < 0 || pool_dtype > 2) return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, block_tables,
               seq_lens, out, b, kv, num_pages, page_size, m, group, d,
               pool_dtype, scale, static_cast<cudaStream_t>(stream)};
  if ((k_scales == nullptr) != (v_scales == nullptr))
    return cudaErrorInvalidValue;
  const bool fp8 = k_scales != nullptr;
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return dispatch_pool<__nv_bfloat16>(a, fp8, 0);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return dispatch_pool<__half>(a, fp8, 1);
#else
      return cudaErrorInvalidValue;
#endif
    case 2:
#if APEX_HAS_DTYPE(2)
      return dispatch_pool<float>(a, fp8, 2);
#else
      return cudaErrorInvalidValue;
#endif
    default: return cudaErrorInvalidValue;
  }
}
