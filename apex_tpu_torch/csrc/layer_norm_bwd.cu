// LayerNorm backward for Hopper (sm_90a): dx, dgamma and dbeta of the affine
// LayerNorm over the last axis, in one launch.
//
// Replaces the Pallas kernel `_ln_bwd_kernel` of apex_tpu/ops/layer_norm.py
// (:141, launched by `_ln_pallas_bwd` :197). Contract (shared with
// apex_tpu_torch.ops.layer_norm):
//   x, dy  [n, h]  bf16, fp16 or fp32 (each its own), contiguous
//   w      [h]     bf16, fp16 or fp32
//   dx     [n, h]  x's dtype
//   dw, db [h]     their own dtypes (the parameter's and the bias's)
//   ws     [blocks, 2, h] fp32 scratch (the blocks' partials)
// Per row, as the JAX kernel computes it: mean and variance recomputed from
// x in fp32 (two passes), rstd = 1 / sqrt(var + eps) correctly rounded,
// xhat = (x - mean) rstd, dxhat = dy w, s1 = sum dxhat, s2 = sum dxhat xhat,
// dx = (rstd / h) (h dxhat - s1 - xhat s2), rounded once to x's dtype;
// dgamma = sum over rows of dy xhat, dbeta = sum of dy, in fp32, cast once.
//
// Bound on the H100: bytes (x and dy read once, dx written once: 48 MB at
// the GPT's n 8192 h 1024 in bf16, ~20 flops an element). The design keeps
// every sum of a row inside one warp or one block and every sum over rows
// in a fixed order:
//
// * h <= 1024 (`ln_bwd_warp_rows`): a warp owns a row, each lane 8
//   consecutive columns in each of up to four 256-column groups. Mean,
//   variance and the pair (s1, s2) are xor-butterfly warp shuffles (every
//   lane ends with the same bits), no shared memory and no __syncthreads.
//   A block of 8 warps walks a contiguous range of rows, warp w taking rows
//   w, w + 8, ...; lane 0 keeps the next three rows' x and dy (two for
//   fp32 x and dy) in flight into a ring in shared memory, one bulk copy
//   (TMA) a row and tensor, one mbarrier a slot, while the warp computes
//   the current one,
//   each lane reading its own chunks; the lanes keep their columns' dgamma
//   and dbeta partials in fp32 registers over their rows in order. At the end the block sums its
//   warps' partials in warp order.
// * 1024 < h <= 16384 (`ln_bwd_block_rows`): a block of 512 threads owns a
//   row at a time over its range, each thread the columns t, t + 512, ...
//   (x held in registers, dy read where it is used); a row's sums are warp shuffles, then the 16 warps'
//   values summed in warp order through shared memory; the partials live
//   in shared memory, each thread updating its own columns over the rows in
//   order.
//
// Both meet across blocks in the same launch, in block order: each block
// writes its fp32 partial row of dgamma and of dbeta into `ws`, the blocks
// (co-resident: a cooperative launch of at most one block an SM) pass a
// grid barrier, and block b then sums its slice of the columns over the
// blocks' partials in block order and casts it to the output dtypes. No
// atomics touch a float, so a rerun is bitwise the same; the barrier's two
// counters are this library's own device globals, left at zero by every
// launch (launches on concurrent streams would share them).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

enum { BF16 = 0, F16 = 1, F32 = 2 };

constexpr int WARPS = 8;                 // the warp-rows kernel's block
constexpr int THREADS = 32 * WARPS;
// rows of x and dy a warp holds: 4 where the ring fits this, else 3
constexpr size_t RING_BYTES = 200 << 10;
constexpr int MAX_WARP_H = 1024;         // 32 lanes x 8 columns x 4 groups
constexpr int BR_THREADS = 512;          // the block-rows kernel's block
constexpr int BR_WARPS = BR_THREADS / 32;
constexpr int MAX_H = 16384;

__device__ unsigned int g_arrived;       // the grid barrier: blocks in
__device__ unsigned int g_gen;           // ... and its generation

__host__ __device__ __forceinline__ int dsize(int code) {
  return code == F32 ? 4 : 2;
}

__device__ __forceinline__ float load1(const void* p, long i, int code) {
  if (code == F32) return static_cast<const float*>(p)[i];
  const unsigned short b = static_cast<const unsigned short*>(p)[i];
  return code == BF16 ? __bfloat162float(__ushort_as_bfloat16(b))
                      : __half2float(__ushort_as_half(b));
}

__device__ __forceinline__ void store1(void* p, long i, int code, float v) {
  if (code == F32)
    static_cast<float*>(p)[i] = v;
  else if (code == BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(p)[i] = __float2half_rn(v);
}

__device__ __forceinline__ float2 unpack2(uint32_t w, int code) {
  if (code == BF16)
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  __half2 hv;
  *reinterpret_cast<uint32_t*>(&hv) = w;
  return __half22float2(hv);
}

__device__ __forceinline__ uint32_t pack2(float a, float b, int code) {
  if (code == BF16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive elements at p (16-byte aligned; 32 bytes for fp32, of
// which only the first 16 when `half_only`)
__device__ __forceinline__ void unpack8(const uint8_t* p, int code,
                                        bool half_only, float (&f)[8]) {
  if (code == F32) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = half_only ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : *reinterpret_cast<const float4*>(p + 16);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 t = unpack2(w[e], code);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  }
}

__device__ __forceinline__ void pack8(uint8_t* p, int code, bool half_only,
                                      const float (&f)[8]) {
  if (code == F32) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    if (!half_only)
      *reinterpret_cast<float4*>(p + 16) = make_float4(f[4], f[5], f[6], f[7]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(f[0], f[1], code), pack2(f[2], f[3], code),
                   pack2(f[4], f[5], code), pack2(f[6], f[7], code));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(n)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Every block of the (cooperative) grid arrives, its writes released
// first; the last to arrive moves the generation on (and zeroes the count
// for the next launch: nothing arrives again in this one), the others wait
// for it.
__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &g_gen;
    const unsigned int g0 = *gen;
    __threadfence();
    if (atomicAdd(&g_arrived, 1u) == gridDim.x - 1) {
      atomicAdd(&g_gen, 1u);
      g_arrived = 0;
    } else {
      while (*gen == g0) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// After the barrier: block b's slice of the columns of dgamma and dbeta,
// each summed over the blocks' partials in block order. The block first
// copies a round of the slice (every block's partial of `per` columns)
// into `buf` (`cap` floats) with all its threads, every copy in flight at
// once (cp.async), then one thread a column adds them up in block order.
__device__ void final_sums(const float* __restrict__ ws, void* dw, void* db,
                           int h, int dwc, int dbc, float* buf, int cap) {
  const int nb = gridDim.x;
  const int cs = (h + nb - 1) / nb;            // columns a block
  const int c0 = blockIdx.x * cs, c1 = min(h, c0 + cs);
  const int per = max(1, cap / (2 * nb));      // columns a round
  for (int lo = c0; lo < c1; lo += per) {
    const int cols = min(per, c1 - lo);
    __syncthreads();                           // the last round is read
    for (int i = threadIdx.x; i < 2 * nb * cols; i += blockDim.x) {
      const int b = i / (2 * cols), j = i % (2 * cols);
      cp_async4(buf + i, ws + ((long)b * 2 + j / cols) * h + lo + j % cols);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * cols; j += blockDim.x) {
      float tot = buf[j];
      int b = 1;
      for (; b + 8 <= nb; b += 8) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = buf[(b + k) * 2 * cols + j];
#pragma unroll
        for (int k = 0; k < 8; ++k) tot += v[k];
      }
      for (; b < nb; ++b) tot += buf[b * 2 * cols + j];
      if (j < cols)
        store1(dw, lo + j, dwc, tot);
      else
        store1(db, lo + j - cols, dbc, tot);
    }
  }
}

struct Args {
  const void* x;
  const void* w;
  const void* dy;
  void* dx;
  float* ws;
  void* dw;
  void* db;
  int n, h, rows_per_block;
  int buf_floats;          // the final sums' buffer (after the partials)
  float eps;
  int xc, wc, dyc, dwc, dbc;
};

// ---------------------------------------------------------------- h <= 1024

// G: 256-column groups a lane covers (h <= 256 G); VEC: x and dy rows are
// 16-byte aligned (16-bit: h % 8 == 0, fp32: h % 4 == 0) and arrive in the
// warp's ring, RING - 1 rows ahead, by one bulk copy each (lane 0, one
// mbarrier a slot), else every element is loaded and stored alone. XC:
// x's and dy's dtype code when they share one (the kernel built for it),
// -1 to read both codes at run time.
template <int G, bool VEC, int RING, int XC>
__global__ void __launch_bounds__(THREADS, 1)
ln_bwd_warp_rows(const Args a) {
  extern __shared__ float4 smem4[];
  const int h = a.h, hp = (h + 7) & ~7;
  float* sw = reinterpret_cast<float*>(smem4);          // [hp] weight
  uint8_t* ring = reinterpret_cast<uint8_t*>(sw + hp);  // per warp, RING
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int xc = XC >= 0 ? XC : a.xc, dyc = XC >= 0 ? XC : a.dyc;
  const int xs = dsize(xc), ds = dsize(dyc);
  const int slot_bytes = hp * (xs + ds);                // x, then dy
  uint8_t* my_ring = ring + (long)warp * RING * slot_bytes;
  // the slots' barriers, after the rings (and the partials staged there)
  uint64_t* full = reinterpret_cast<uint64_t*>(
                       ring + (long)a.buf_floats * 4) + warp * RING;
  const float hf = (float)h;

  const int r_begin = blockIdx.x * a.rows_per_block;
  const int r_end = min(a.n, r_begin + a.rows_per_block);
  const int span = r_end - r_begin - warp;
  const int nrows = span > 0 ? (span + WARPS - 1) / WARPS : 0;
  const uint8_t* xb = static_cast<const uint8_t*>(a.x);
  const uint8_t* dyb = static_cast<const uint8_t*>(a.dy);

  // row i's x and dy into its slot: two bulk copies by lane 0 (every lane
  // is done with the slot's last row: the caller syncs the warp)
  auto issue = [&](int i) {
    if (VEC && i < nrows && lane == 0) {
      const long row = r_begin + warp + (long)WARPS * i;
      uint8_t* slot = my_ring + (i % RING) * slot_bytes;
      uint64_t* bar = &full[i % RING];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, (uint32_t)h * (xs + ds));
      bulk_copy(slot, xb + row * h * xs, (uint32_t)h * xs, bar);
      bulk_copy(slot + hp * xs, dyb + row * h * ds, (uint32_t)h * ds, bar);
    }
  };

  float pw[8 * G], pb[8 * G];
#pragma unroll
  for (int k = 0; k < 8 * G; ++k) pw[k] = pb[k] = 0.f;

  // the first rows' copies, then the weight while they land
  if (VEC && lane == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) issue(i);
  for (int i = threadIdx.x; i < hp; i += THREADS)
    sw[i] = i < h ? load1(a.w, i, a.wc) : 0.f;
  __syncthreads();
  for (int i = 0; i < nrows; ++i) {
    __syncwarp();                        // row i - 1's slot is read
    issue(i + RING - 1);
    if (VEC) mbar_wait(&full[i % RING], (i / RING) & 1);
    const long row = r_begin + warp + (long)WARPS * i;
    const uint8_t* slot = my_ring + (i % RING) * slot_bytes;
    float xv[8 * G], dv[8 * G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int col = 8 * (lane + 32 * j);
      float fx[8], fd[8];
      if (VEC) {
        if (col < h) {
          unpack8(slot + col * xs, xc, xs == 4 && col + 4 >= h, fx);
          unpack8(slot + hp * xs + col * ds, dyc, ds == 4 && col + 4 >= h,
                  fd);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ok = col + e < h;
          fx[e] = ok ? load1(a.x, row * h + col + e, xc) : 0.f;
          fd[e] = ok ? load1(a.dy, row * h + col + e, dyc) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = col + e < h;
        xv[8 * j + e] = ok ? fx[e] : 0.f;
        dv[8 * j + e] = ok ? fd[e] : 0.f;
      }
    }
    // mean, then the variance about it
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8 * G; ++k) s += xv[k];
    const float mean = warp_sum(s) / hf;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * j + e;
        xv[k] = 8 * (lane + 32 * j) + e < h ? xv[k] - mean : 0.f;
        v += xv[k] * xv[k];
      }
    const float var = warp_sum(v) / hf;
    const float rstd = __frsqrt_rn(var + a.eps);
    // xhat, and the two sums of dxhat
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int col = min(8 * (lane + 32 * j), hp - 8);
      const float4 w0 = *reinterpret_cast<const float4*>(sw + col);
      const float4 w1 = *reinterpret_cast<const float4*>(sw + col + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * j + e;
        xv[k] *= rstd;
        const float dxh = dv[k] * wv[e];
        s1 += dxh;
        s2 += dxh * xv[k];
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    // dx, and this row into the lane's partials
    const float scale = rstd / hf;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int col = 8 * (lane + 32 * j);
      if (col >= h) continue;
      const float4 w0 = *reinterpret_cast<const float4*>(sw + col);
      const float4 w1 = *reinterpret_cast<const float4*>(sw + col + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * j + e;
        const float dxh = dv[k] * wv[e];
        out[e] = scale * (hf * dxh - s1 - xv[k] * s2);
        pw[k] += dv[k] * xv[k];
        pb[k] += dv[k];
      }
      if (VEC) {
        pack8(static_cast<uint8_t*>(a.dx) + (row * h + col) * xs, xc,
              xs == 4 && col + 4 >= h, out);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < h) store1(a.dx, row * h + col + e, xc, out[e]);
      }
    }
  }

  // the block's partial: its warps' in warp order, through shared memory
  // (the ring is free once every warp is done)
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);          // [WARPS][2][hp]
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int col = 8 * (lane + 32 * j);
    if (col >= h) continue;
    float4* dw4 = reinterpret_cast<float4*>(part + (warp * 2 + 0) * hp + col);
    float4* db4 = reinterpret_cast<float4*>(part + (warp * 2 + 1) * hp + col);
    const int k = 8 * j;
    dw4[0] = make_float4(pw[k], pw[k + 1], pw[k + 2], pw[k + 3]);
    dw4[1] = make_float4(pw[k + 4], pw[k + 5], pw[k + 6], pw[k + 7]);
    db4[0] = make_float4(pb[k], pb[k + 1], pb[k + 2], pb[k + 3]);
    db4[1] = make_float4(pb[k + 4], pb[k + 5], pb[k + 6], pb[k + 7]);
  }
  __syncthreads();
  // four columns a thread: hp is a multiple of 8, columns past h are not
  // written
  float* mine = a.ws + (long)blockIdx.x * 2 * h;
  for (int idx = 4 * threadIdx.x; idx < 2 * hp; idx += 4 * THREADS) {
    const int which = idx / hp, col = idx % hp;
    float4 tot = *reinterpret_cast<const float4*>(part + which * hp + col);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 v =
          *reinterpret_cast<const float4*>(part + (w * 2 + which) * hp + col);
      tot.x += v.x;
      tot.y += v.y;
      tot.z += v.z;
      tot.w += v.w;
    }
    const float tv[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < h) mine[which * h + col + e] = tv[e];
  }
  grid_barrier();
  final_sums(a.ws, a.dw, a.db, h, a.dwc, a.dbc, part, a.buf_floats);
}

// ---------------------------------------------------------------- h > 1024

// the sum of `v` over the block, in warp order (every thread gets the same
// bits); `red` is this reduction's own [BR_WARPS] buffer
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float tot = red[0];
#pragma unroll
  for (int w = 1; w < BR_WARPS; ++w) tot += red[w];
  return tot;
}

// E: columns a thread holds (h <= 512 E)
template <int E>
__global__ void __launch_bounds__(BR_THREADS, 1)
ln_bwd_block_rows(const Args a) {
  extern __shared__ float4 smem4[];
  const int h = a.h;
  float* sw = reinterpret_cast<float*>(smem4);     // [h] weight
  float* spw = sw + h;                              // [h] dgamma partial
  float* spb = spw + h;                             // [h] dbeta partial
  float* red = spb + h;                             // [4][BR_WARPS]
  const int t = threadIdx.x;
  for (int i = t; i < h; i += BR_THREADS) {
    sw[i] = load1(a.w, i, a.wc);
    spw[i] = 0.f;
    spb[i] = 0.f;
  }
  __syncthreads();
  const float hf = (float)h;
  const int r_begin = blockIdx.x * a.rows_per_block;
  const int r_end = min(a.n, r_begin + a.rows_per_block);
  for (long row = r_begin; row < r_end; ++row) {
    // x held, dy read where it is used (twice, the second time from cache)
    float xv[E];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int col = t + BR_THREADS * k;
      xv[k] = col < h ? load1(a.x, row * h + col, a.xc) : 0.f;
      s += xv[k];
    }
    const float mean = block_sum(s, red) / hf;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      xv[k] = t + BR_THREADS * k < h ? xv[k] - mean : 0.f;
      v += xv[k] * xv[k];
    }
    const float var = block_sum(v, red + BR_WARPS) / hf;
    const float rstd = __frsqrt_rn(var + a.eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int col = t + BR_THREADS * k;
      xv[k] *= rstd;
      const float dxh =
          col < h ? load1(a.dy, row * h + col, a.dyc) * sw[col] : 0.f;
      s1 += dxh;
      s2 += dxh * xv[k];
    }
    s1 = block_sum(s1, red + 2 * BR_WARPS);
    s2 = block_sum(s2, red + 3 * BR_WARPS);
    const float scale = rstd / hf;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int col = t + BR_THREADS * k;
      if (col >= h) continue;
      const float dy = load1(a.dy, row * h + col, a.dyc);
      const float dxh = dy * sw[col];
      store1(a.dx, row * h + col, a.xc, scale * (hf * dxh - s1 - xv[k] * s2));
      spw[col] += dy * xv[k];
      spb[col] += dy;
    }
  }
  float* mine = a.ws + (long)blockIdx.x * 2 * h;
  for (int i = t; i < h; i += BR_THREADS) {
    mine[i] = spw[i];
    mine[h + i] = spb[i];
  }
  grid_barrier();
  final_sums(a.ws, a.dw, a.db, h, a.dwc, a.dbc, spw, 2 * h);
}

// ---------------------------------------------------------------- host

template <typename K>
cudaError_t launch_coop(K kernel, int threads, size_t smem, int blocks,
                        const Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  Args copy = a;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(threads), params, smem,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int G, int XC>
cudaError_t launch_warp_rows_dtype(const Args& b, bool vec, int ring,
                                   size_t smem, int blocks, cudaStream_t st) {
  if (!vec)
    return launch_coop(ln_bwd_warp_rows<G, false, 3, XC>, THREADS, smem,
                       blocks, b, st);
  return ring == 4 ? launch_coop(ln_bwd_warp_rows<G, true, 4, XC>, THREADS,
                                 smem, blocks, b, st)
                   : launch_coop(ln_bwd_warp_rows<G, true, 3, XC>, THREADS,
                                 smem, blocks, b, st);
}

template <int G>
cudaError_t launch_warp_rows(const Args& a, bool vec, int blocks,
                             cudaStream_t st) {
  const int hp = (a.h + 7) & ~7;
  const size_t slot = (size_t)hp * (dsize(a.xc) + dsize(a.dyc));
  const int ring = (size_t)WARPS * 4 * slot <= RING_BYTES ? 4 : 3;
  size_t buf = (size_t)WARPS * ring * slot;
  if ((size_t)WARPS * 2 * hp * 4 > buf) buf = (size_t)WARPS * 2 * hp * 4;
  if ((size_t)8 * blocks > buf) buf = (size_t)8 * blocks;
  buf = (buf + 15) & ~(size_t)15;
  Args b = a;
  b.buf_floats = (int)(buf / 4);
  const size_t smem = (size_t)hp * 4 + buf + (size_t)WARPS * ring * 8;
  // x and dy of one dtype in the ring (the main paths): a kernel built for
  // it; else the dtypes read at run time
  if (vec && a.xc == a.dyc) {
    if (a.xc == BF16)
      return launch_warp_rows_dtype<G, BF16>(b, true, ring, smem, blocks, st);
    if (a.xc == F16)
      return launch_warp_rows_dtype<G, F16>(b, true, ring, smem, blocks, st);
    return launch_warp_rows_dtype<G, F32>(b, true, ring, smem, blocks, st);
  }
  return launch_warp_rows_dtype<G, -1>(b, vec, ring, smem, blocks, st);
}

template <int E>
cudaError_t launch_block_rows(const Args& a, int blocks, cudaStream_t st) {
  const size_t smem = (size_t)3 * a.h * 4 + 4 * BR_WARPS * 4;
  return launch_coop(ln_bwd_block_rows<E>, BR_THREADS, smem, blocks, a, st);
}

}  // namespace

// C interface (loaded with ctypes); see the contract at the top. `variant`
// 0 runs the warp-rows kernel (h <= 1024), 1 the block-rows kernel (h <=
// 16384); `blocks` blocks of `rows_per_block` consecutive rows each (the
// wrapper's `_ln_bwd_plan`), at most the blocks the card holds at once;
// dtype codes 0 bf16, 1 fp16, 2 fp32. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for arguments outside the contract).
extern "C" int apex_layer_norm_bwd(const void* x, const void* w,
                                   const void* dy, void* dx, void* ws,
                                   void* dw, void* db, int n, int h,
                                   float eps, int variant, int blocks,
                                   int rows_per_block, int xc, int wc,
                                   int dyc, int dwc, int dbc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c : {xc, wc, dyc, dwc, dbc})
    if (c < BF16 || c > F32) return cudaErrorInvalidValue;
  if (h <= 0 || h > MAX_H || n < 0 || blocks < 1 || rows_per_block < 0 ||
      (long)blocks * rows_per_block < n)
    return cudaErrorInvalidValue;
  Args a{x, w, dy, dx, static_cast<float*>(ws), dw, db, n, h,
         rows_per_block, 0, eps, xc, wc, dyc, dwc, dbc};
  if (variant == 0) {
    if (h > MAX_WARP_H) return cudaErrorInvalidValue;
    const bool vec = (h * dsize(xc)) % 16 == 0 && (h * dsize(dyc)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dx) % 16 == 0;
    if (h <= 256) return launch_warp_rows<1>(a, vec, blocks, st);
    if (h <= 512) return launch_warp_rows<2>(a, vec, blocks, st);
    return launch_warp_rows<4>(a, vec, blocks, st);
  }
  if (variant != 1 || h <= MAX_WARP_H) return cudaErrorInvalidValue;
  if (h <= 4 * BR_THREADS) return launch_block_rows<4>(a, blocks, st);
  if (h <= 8 * BR_THREADS) return launch_block_rows<8>(a, blocks, st);
  if (h <= 16 * BR_THREADS) return launch_block_rows<16>(a, blocks, st);
  return launch_block_rows<32>(a, blocks, st);
}
