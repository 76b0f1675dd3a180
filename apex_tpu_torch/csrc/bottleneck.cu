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
// the 3x3 as 9 shifted products accumulated in fp32 tap by tap, the folded
// scale and shift in fp32 (a product then a sum, never contracted), h1 and
// h2 rounded to bf16, h1 zeroed outside the image (relu(b1) != 0, so a zero
// input would not give the SAME padding's zero), the residual added in fp32
// and the output rounded once.
//
// Bound on the H100 at N 32: bytes. x and out are 51.4 MB each: 102.8 MB
// at 3.35 TB/s is 0.0307 ms; the products are 100,352 px x 139,264 flops =
// 13.98 GFLOP, 0.0141 ms at 989 TFLOP/s. The library composition writes and
// re-reads the two 12.8 MB squeeze activations and reads x twice (>= 205 MB,
// >= 0.061 ms): keeping h1 and h2 on chip is what the fusion buys.
//
// Design. Hopper gives a block 227 KB of shared memory, not the TPU's
// megabytes, so a block owns an 8 x 8 pixel output tile and reads its
// 10 x 10 haloed input (recomputing the h1 halo its neighbours also
// compute: 100 squeeze rows for 64 outputs). Shared memory, bf16 unless
// noted:
//   sX  [100][256 + 8]   the haloed input tile            52,800 B
//   sH1 [100][64 + 8]    h1 over the halo                 14,400 B
//   sH2 [64][64 + 8]     h2 of the tile                    9,216 B
//   sW  [64][64 + 8]     one 64 x 64 weight slab (n, k)    9,216 B
//   g1 b1 g2 b2 g3 b3    fp32                              3,072 B
//   total 88,704 B: two blocks on an SM.
// w1, w2 and w3 (136 KB together) do not fit beside the activations; they
// stream through sW in 64 x 64 slabs, transposed on the way in so every B
// fragment is one 32-bit load: w1 as 4 slabs over k, w2 as its 9 taps, w3 as
// 4 slabs over the output channels. Eight warps; in every phase warp w owns
// the 8 output columns [8w, 8w + 8) of the 64-wide slab and all of the
// phase's rows (7 m-tiles of the 112-row padded halo, then 4 of the 64
// tile pixels), on `mma.sync.m16n8k16` (bf16 in, fp32 accumulate). The
// residual comes from sX, not from HBM: x is read once. Loads are
// synchronous; cp.async double-buffering of the slabs, wgmma and a larger
// tile are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frag.cuh"

namespace {

constexpr int H = 56, W = 56, C = 256, S = 64;
constexpr int TILE = 8;                  // output tile TILE x TILE
constexpr int HALO = TILE + 2;           // 10
constexpr int HP = HALO * HALO;          // 100 haloed pixels
constexpr int M1_TILES = (HP + 15) / 16; // 7 m-tiles of phase 1
constexpr int NPIX = TILE * TILE;        // 64
constexpr int TILES_X = W / TILE;        // 7
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDX = C + 8;
constexpr int LDH = S + 8;
constexpr int LDW = 64 + 8;

constexpr size_t SMEM = (size_t)(HP * LDX + HP * LDH + NPIX * LDH +
                                 64 * LDW) * 2 +
                        (size_t)(4 * S + 2 * C) * 4;

using bf16 = __nv_bfloat16;
using F = Frag<bf16>;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// sW[n][k] = w[k0 + k][n] for the 64 x 64 slab at `base` (row stride ldn)
__device__ __forceinline__ void load_slab(const bf16* base, int ldn,
                                          bf16* sW) {
  for (int idx = threadIdx.x; idx < 64 * 8; idx += THREADS) {
    const int k = idx / 8, c = idx % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(base + (long)k * ldn +
                                                    c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) sW[(c * 8 + j) * LDW + k] = e[j];
  }
}

__device__ __forceinline__ float bn(float acc, float g, float b) {
  return __fadd_rn(__fmul_rn(acc, g), b);
}

__global__ void __launch_bounds__(THREADS, 2)
bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                  const bf16* __restrict__ g1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ g2, const bf16* __restrict__ b2,
                  const bf16* __restrict__ g3, const bf16* __restrict__ b3,
                  bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);
  bf16* sH1 = sX + HP * LDX;
  bf16* sH2 = sH1 + HP * LDH;
  bf16* sW = sH2 + NPIX * LDH;
  float* sG1 = reinterpret_cast<float*>(sW + 64 * LDW);
  float* sB1 = sG1 + S;
  float* sG2 = sB1 + S;
  float* sB2 = sG2 + S;
  float* sG3 = sB2 + S;
  float* sB3 = sG3 + C;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int img = blockIdx.y;
  const int y0 = (blockIdx.x / TILES_X) * TILE;
  const int x0 = (blockIdx.x % TILES_X) * TILE;
  const long img_base = (long)img * H * W * C;

  // ---- the haloed input tile (zeros outside the image) and the vectors
  for (int idx = tid; idx < HP * (C / 8); idx += THREADS) {
    const int p = idx / (C / 8), c = idx % (C / 8);
    const int yy = y0 - 1 + p / HALO, xx = x0 - 1 + p % HALO;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = *reinterpret_cast<const uint4*>(x + img_base +
                                          ((long)yy * W + xx) * C + c * 8);
    *reinterpret_cast<uint4*>(sX + p * LDX + c * 8) = v;
  }
  for (int i = tid; i < S; i += THREADS) {
    sG1[i] = __bfloat162float(g1[i]);
    sB1[i] = __bfloat162float(b1[i]);
    sG2[i] = __bfloat162float(g2[i]);
    sB2[i] = __bfloat162float(b2[i]);
  }
  for (int i = tid; i < C; i += THREADS) {
    sG3[i] = __bfloat162float(g3[i]);
    sB3[i] = __bfloat162float(b3[i]);
  }

  const int ncol = warp * 8;             // the warp's 8 columns of a slab

  // ---- phase 1: h1 = relu(x w1 * g1 + b1) over the 100 haloed pixels
  float acc1[M1_TILES][4];
#pragma unroll
  for (int mt = 0; mt < M1_TILES; ++mt)
    acc1[mt][0] = acc1[mt][1] = acc1[mt][2] = acc1[mt][3] = 0.f;
  for (int kc = 0; kc < C / 64; ++kc) {
    __syncthreads();
    load_slab(w1 + (long)kc * 64 * S, S, sW);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* pb = sW + (ncol + g) * LDW + ks * 16 + tig * 2;
      const uint32_t b0 = ld32(pb), b1v = ld32(pb + 8);
#pragma unroll
      for (int mt = 0; mt < M1_TILES; ++mt) {
        // rows past the 100 pixels read pixel 99; their results are dropped
        const int ra = min(mt * 16 + g, HP - 1);
        const int rb = min(mt * 16 + g + 8, HP - 1);
        const int col = kc * 64 + ks * 16 + tig * 2;
        const uint32_t a[4] = {ld32(sX + ra * LDX + col),
                               ld32(sX + rb * LDX + col),
                               ld32(sX + ra * LDX + col + 8),
                               ld32(sX + rb * LDX + col + 8)};
        F::mma(acc1[mt], a, b0, b1v);
      }
    }
  }
  {
    const int n = ncol + tig * 2;
#pragma unroll
    for (int mt = 0; mt < M1_TILES; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + g + 8 * half;
        if (p >= HP) continue;
        const int yy = y0 - 1 + p / HALO, xx = x0 - 1 + p % HALO;
        const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
        float v0 = fmaxf(bn(acc1[mt][2 * half], sG1[n], sB1[n]), 0.f);
        float v1 = fmaxf(bn(acc1[mt][2 * half + 1], sG1[n + 1], sB1[n + 1]),
                         0.f);
        if (!inside) v0 = v1 = 0.f;
        *reinterpret_cast<uint32_t*>(sH1 + p * LDH + n) = F::pack(v0, v1);
      }
    }
  }

  // ---- phase 2: h2 = relu(sum over 9 taps of h1 shifted w2 * g2 + b2)
  int hrow[4][2];                        // h1 row of tap (0, 0) per m-tile
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mt * 16 + g + 8 * half;
      hrow[mt][half] = (p / TILE) * HALO + p % TILE;
    }
  float acc2[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    acc2[mt][0] = acc2[mt][1] = acc2[mt][2] = acc2[mt][3] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3) * HALO + tap % 3;
    __syncthreads();                     // (the first also publishes sH1)
    load_slab(w2 + (long)tap * S * S, S, sW);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* pb = sW + (ncol + g) * LDW + ks * 16 + tig * 2;
      const uint32_t b0 = ld32(pb), b1v = ld32(pb + 8);
      const int col = ks * 16 + tig * 2;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* pa = sH1 + (hrow[mt][0] + shift) * LDH + col;
        const bf16* pc = sH1 + (hrow[mt][1] + shift) * LDH + col;
        const uint32_t a[4] = {ld32(pa), ld32(pc), ld32(pa + 8), ld32(pc + 8)};
        F::mma(acc2[mt], a, b0, b1v);
      }
    }
  }
  {
    const int n = ncol + tig * 2;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + g + 8 * half;
        const float v0 =
            fmaxf(bn(acc2[mt][2 * half], sG2[n], sB2[n]), 0.f);
        const float v1 =
            fmaxf(bn(acc2[mt][2 * half + 1], sG2[n + 1], sB2[n + 1]), 0.f);
        *reinterpret_cast<uint32_t*>(sH2 + p * LDH + n) = F::pack(v0, v1);
      }
  }

  // ---- phase 3: out = relu(h2 w3 * g3 + b3 + x), 64 channels a slab
  for (int nc = 0; nc < C / 64; ++nc) {
    __syncthreads();                     // (the first also publishes sH2)
    load_slab(w3 + nc * 64, C, sW);
    __syncthreads();
    float acc3[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      acc3[mt][0] = acc3[mt][1] = acc3[mt][2] = acc3[mt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* pb = sW + (ncol + g) * LDW + ks * 16 + tig * 2;
      const uint32_t b0 = ld32(pb), b1v = ld32(pb + 8);
      const int col = ks * 16 + tig * 2;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* pa = sH2 + (mt * 16 + g) * LDH + col;
        const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LDH), ld32(pa + 8),
                               ld32(pa + 8 * LDH + 8)};
        F::mma(acc3[mt], a, b0, b1v);
      }
    }
    const int n = nc * 64 + ncol + tig * 2;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + g + 8 * half;
        const int oy = p / TILE, ox = p % TILE;
        const bf16* res = sX + ((oy + 1) * HALO + ox + 1) * LDX + n;
        const float v0 = fmaxf(
            __fadd_rn(bn(acc3[mt][2 * half], sG3[n], sB3[n]),
                      __bfloat162float(res[0])), 0.f);
        const float v1 = fmaxf(
            __fadd_rn(bn(acc3[mt][2 * half + 1], sG3[n + 1], sB3[n + 1]),
                      __bfloat162float(res[1])), 0.f);
        *reinterpret_cast<uint32_t*>(
            out + img_base + ((long)(y0 + oy) * W + x0 + ox) * C + n) =
            F::pack(v0, v1);
      }
  }
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous bf16
// tensors: x and out [n, 56, 56, 256]; w1 [256, 64], w2 [3, 3, 64, 64],
// w3 [64, 256]; g1, b1, g2, b2 [64]; g3, b3 [256]; all 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int apex_bottleneck(const void* x, const void* w1, const void* w2,
                               const void* w3, const void* g1,
                               const void* b1, const void* g2,
                               const void* b2, const void* g3,
                               const void* b3, void* out, int n,
                               void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(TILES_X * (H / TILE), n);
  bottleneck_kernel<<<grid, THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
      static_cast<const bf16*>(g1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(g2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(g3), static_cast<const bf16*>(b3),
      static_cast<bf16*>(out));
  return cudaGetLastError();
}
