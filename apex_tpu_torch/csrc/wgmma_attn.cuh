// What attention adds to the wgmma/TMA core of wgmma_gemm.cuh (sm_90a),
// for the flash backward of flash_bwd_sm90.cu and the forward of
// flash_fwd_sm90.cu. wgmma_gemm.cuh itself is
// unchanged, so the kernels built on it alone (lm_head_ce_sm90.cu) compile
// to what they did.
//
// - Products of one warpgroup at the widths attention needs:
//   mma_ss64<T, ACCUM> and mma_ss128<T, ACCUM> (m64n64k16, m64n128k16, A
//   and B from shared memory, both K-major: S = Q K^T, dP = dO V^T and their
//   transposes) and mma_rs<T, N> for N = 64 and 128 (m64nNk16 with A in
//   registers and B from shared memory, K- or MN-major through the
//   transpose bit: dV += P^T dO, dK += dS^T Q, dQ += dS K, B read from the
//   same swizzled tile the S product read K-major, so no transposed copy
//   is made).
// - acc_to_a: the fp32 accumulators of one m64nN product (the layout of
//   wgmma_gemm.cuh's header: thread t holds rows 16 (t / 32) + (t % 32) / 4
//   and that + 8, columns 8 nb + 2 (t % 4) + {0, 1}) as the register A
//   fragments of the next product's k-step kk (columns 16 kk .. 16 kk + 15
//   become its K), rounded to the operand dtype. The A fragment of
//   m64k16 is mma.sync's m16n8k16 A fragment per warp (warp w: rows 16 w ..
//   16 w + 15), so the conversion is a repack of registers in place.
// - mma_ss64_tt<T, ACCUM>: m64n64k16 with A and B from shared memory, both
//   MN-major (the two transpose bits): the single-pass backward's dQ = dS K
//   from the dS^T tile its consumer warpgroups write and the resident K.
// - kmajor_desc / mnmajor_desc: wgmma descriptors of k-step j of a
//   128-byte-swizzled tile of R rows whose 64-column atoms lie one after
//   the other (R x 128 bytes each), K-major (K along the row) or MN-major
//   (K down the rows).
// - tma_load_3d and attn_map: a 3-D TMA map over a [b h, s, d] tensor with
//   boxes of 64 columns x `rows` rows x 1 head: a tile never reaches into
//   the next head, and rows past s arrive as zeros.
// - tma_reduce_add_3d and acc_map: the same map over an fp32 accumulator
//   (boxes of 32 columns), into which a block adds a box from shared memory
//   in one bulk reduction (the single pass's dq), with the bulk-group
//   commit and waits and the proxy fence its writers need.

#pragma once

#include "frag.cuh"
#include "wgmma_gemm.cuh"

namespace wg {

// 3-D TMA load of the box at (c0 inner, c1, c2 outer) into dst
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// k-step j (16 deep) of a K-major tile of R rows, from row r0 (a multiple
// of 8): rows of 128 bytes, 8-row groups 1024 bytes apart, a k-step 32
// bytes along the row, the next 64-column atom R x 128 bytes on.
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int r0,
                                                int j) {
  return make_desc(tile + (j / 4) * (R * 128) + r0 * 128 + (j % 4) * 32, 16,
                   1024);
}

// k-step j of an MN-major tile whose R rows run along K: a k-step 16 rows
// (2048 bytes) down, 8-row groups 1024 bytes apart, the next 64-wide N atom
// (the leading byte offset) R x 128 bytes on.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int j) {
  return make_desc(tile + j * 2048, R * 128, 1024);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define AT_R8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define AT_OUT32 AT_R8(0), AT_R8(8), AT_R8(16), AT_R8(24)
#define AT_OUT64 AT_OUT32, AT_R8(32), AT_R8(40), AT_R8(48), AT_R8(56)
#define AT_S32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define AT_S64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"

// d[32] = A[64 x 16] B[16 x 64] (+ d when ACCUM), both from shared memory,
// K-major. The first k-step of a product passes ACCUM = 0: its
// accumulators need no zeroing, which would tie them to registers another
// product in flight writes and make ptxas wait between the two.
#define AT_SS64(TYPE)                                                     \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %34, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "     \
      AT_S32 ", %32, %33, p, 1, 1, 0, 0;\n"                               \
      "}\n"                                                               \
      : AT_OUT32                                                          \
      : "l"(da), "l"(db), "r"(ACCUM))
// the same at N 128: d[64]
#define AT_SS128(TYPE)                                                    \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "    \
      AT_S64 ", %64, %65, p, 1, 1, 0, 0;\n"                               \
      "}\n"                                                               \
      : AT_OUT64                                                          \
      : "l"(da), "l"(db), "r"(ACCUM))
// d[32] = A[64 x 16] B[16 x 64] (+ d when ACCUM), both from shared memory
// and both MN-major (the two transpose bits): dQ = dS K in the single-pass
// backward, dS from the dS^T tile the warpgroups wrote, K from its resident
// tile
#define AT_SS64_TT(TYPE)                                                  \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %34, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "     \
      AT_S32 ", %32, %33, p, 1, 1, 1, 1;\n"                               \
      "}\n"                                                               \
      : AT_OUT32                                                          \
      : "l"(da), "l"(db), "r"(ACCUM))
// d[N / 2] += A[64 x 16] (registers) B[16 x N] (shared memory); TB: B is
// MN-major
#define AT_RS64(TYPE)                                                     \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %37, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "     \
      AT_S32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"               \
      "}\n"                                                               \
      : AT_OUT32                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),      \
        "n"(TB))
#define AT_RS128(TYPE)                                                    \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %69, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "    \
      AT_S64 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"               \
      "}\n"                                                               \
      : AT_OUT64                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),      \
        "n"(TB))

template <typename T, int ACCUM>
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    AT_SS64("f16");
  } else {
    AT_SS64("bf16");
  }
}

template <typename T, int ACCUM>
__device__ __forceinline__ void mma_ss128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    AT_SS128("f16");
  } else {
    AT_SS128("bf16");
  }
}

template <typename T, int ACCUM>
__device__ __forceinline__ void mma_ss64_tt(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    AT_SS64_TT("f16");
  } else {
    AT_SS64_TT("bf16");
  }
}

template <typename T, int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "m64nNk16 with N 64 or 128");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __half>::value) {
      AT_RS64("f16");
    } else {
      AT_RS64("bf16");
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      AT_RS128("f16");
    } else {
      AT_RS128("bf16");
    }
  }
}
#undef AT_SS64
#undef AT_SS128
#undef AT_SS64_TT
#undef AT_RS64
#undef AT_RS128
#undef AT_S32
#undef AT_S64
#undef AT_OUT32
#undef AT_OUT64
#undef AT_R8

// the register A fragment of k-step kk from the accumulators of an m64nN
// product (N / 2 floats), rounded to T
template <typename T, int NACC>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NACC], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = Frag<T>::pack(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = Frag<T>::pack(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = Frag<T>::pack(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = Frag<T>::pack(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// 3-D TMA reduction: the box at (c0 inner, c1, c2 outer) of the tensor is
// added, element by element, the box in shared memory at src (fp32 add by
// the map's type); completes into the thread's bulk group
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk groups but the last N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ... and completed
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma and TMA reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The map of an fp32 [bh, s, d] accumulator (row-major) for boxes of 32
// columns (128 bytes, swizzled) x `rows` rows x 1 head, for TMA reductions
// into it; rows past s are not written. False when the driver refuses it.
inline bool acc_map(CUtensorMap* map, const float* ptr, long bh, long s,
                    long d, int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)s * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a [bh, s, d] tensor (row-major, d a multiple of 64) for boxes
// of 64 columns x `rows` rows x 1 head, 128-byte swizzled; zeros past s.
// False when the driver refuses it.
template <typename T>
bool attn_map(CUtensorMap* map, const void* ptr, long bh, long s, long d,
              int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T),
                                 (cuuint64_t)s * d * sizeof(T)};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
