// Operand fragments of the m16n8k16 warp product for bf16, fp16 and fp32
// tiles, shared by the port's SIMT and mma.sync matrix kernels
// (flash_fwd.cu, flash_bwd.cu, lm_head_ce.cu, bottleneck.cu).
//
// A kernel is written once against Frag<T>:
//   Frag<T>::pair              two consecutive k values of one row
//                              (uint32_t of two halves; float2 for fp32)
//   Frag<T>::load(p)           the pair at p (p even in its row)
//   Frag<T>::pack(lo, hi)      a pair from two fp32 values, rounded to T
//   Frag<T>::pack2(lo, hi)     a pair from two T values
//   Frag<T>::mma(c, a, b0, b1) c[4] += A[16x16] B[16x8] in fp32, with the
//                              register layout of mma.sync.m16n8k16.row.col
//   Frag<T>::cvt(x)            fp32 -> T
//
// bf16 and fp16 run the tensor cores (mma.sync, fp32 accumulate). fp32 has
// no tensor-core product in fp32 (TF32 rounds the operands), so its `mma`
// is a SIMT product that keeps the same fragment layout: each lane fetches
// the A values of its rows and the B values of its columns from the lanes
// that hold them (warp shuffles) and accumulates with fp32 FMAs in k
// order. The products are exact fp32 products; it runs at the shuffle
// rate (64 shuffles for 64 FMAs a lane), about 1/30 of the bf16 rate.
// Every lane of the warp must call it (the shuffles are warp-wide), which
// holds wherever the kernels call mma.sync.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "dtype.cuh"

template <typename T>
struct Frag;

template <>
struct Frag<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using pair = uint32_t;
  static __device__ __forceinline__ pair load(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ pair pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ pair pack2(T lo, T hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) |
           ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  static __device__ __forceinline__ void mma(float* c, const pair* a,
                                             pair b0, pair b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ T cvt(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Frag<__half> {
  using T = __half;
  using pair = uint32_t;
  static __device__ __forceinline__ pair load(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ pair pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ pair pack2(T lo, T hi) {
    return (uint32_t)__half_as_ushort(lo) |
           ((uint32_t)__half_as_ushort(hi) << 16);
  }
  static __device__ __forceinline__ void mma(float* c, const pair* a,
                                             pair b0, pair b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ T cvt(float x) {
    return __float2half_rn(x);
  }
};

template <>
struct Frag<float> {
  using T = float;
  using pair = float2;
  static __device__ __forceinline__ pair load(const T* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ pair pack(float lo, float hi) {
    return make_float2(lo, hi);
  }
  static __device__ __forceinline__ pair pack2(T lo, T hi) {
    return make_float2(lo, hi);
  }
  // Lane (g, t) = (lane / 4, lane % 4) holds a[0] = A[g][2t, 2t+1],
  // a[1] = A[g+8][2t, 2t+1], a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][..];
  // b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; and accumulates
  // c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
  static __device__ __forceinline__ void mma(float* c, const pair* a,
                                             pair b0, pair b1) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int qa = lane & ~3;            // the first lane of my rows' quad
    const int qb0 = 8 * t, qb1 = 8 * t + 4;   // lanes of columns 2t, 2t+1
    const unsigned all = 0xffffffffu;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const pair ra = a[2 * half], rb = a[2 * half + 1];
      const pair bb = half ? b1 : b0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float a0 = __shfl_sync(all, ra.x, qa + s);
        const float a1 = __shfl_sync(all, ra.y, qa + s);
        const float h0 = __shfl_sync(all, rb.x, qa + s);
        const float h1 = __shfl_sync(all, rb.y, qa + s);
        const float p0 = __shfl_sync(all, bb.x, qb0 + s);
        const float p1 = __shfl_sync(all, bb.y, qb0 + s);
        const float q0 = __shfl_sync(all, bb.x, qb1 + s);
        const float q1 = __shfl_sync(all, bb.y, qb1 + s);
        c[0] = fmaf(a1, p1, fmaf(a0, p0, c[0]));
        c[1] = fmaf(a1, q1, fmaf(a0, q0, c[1]));
        c[2] = fmaf(h1, p1, fmaf(h0, p0, c[2]));
        c[3] = fmaf(h1, q1, fmaf(h0, q0, c[3]));
      }
    }
  }
  static __device__ __forceinline__ T cvt(float x) { return x; }
};

// Elements of T in one 16-byte vector load.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// x rounded to the dtype of code `code` (the C interfaces' 0 bf16, 1 fp16;
// 2, fp32, leaves it): an fp32 kernel over operands of mixed dtypes rounds
// a product's operand where the JAX kernel casts it to a narrower operand's
// dtype.
__device__ __forceinline__ float round_to(float x, int code) {
  if (code == 0) return __bfloat162float(__float2bfloat16_rn(x));
  if (code == 1) return __half2float(__float2half_rn(x));
  return x;
}
