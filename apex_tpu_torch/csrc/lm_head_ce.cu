// Fused LM head + cross entropy for Hopper (sm_90a): the logits x E^T are
// computed tile by tile on the tensor cores and never written to memory.
//
// Replaces the two Pallas kernels of apex_tpu/ops/lm_head_ce.py:
//
// - `_fwd_kernel` (:162, launched by `_fwd_partials` :250) ->
//   ce_fwd_kernel: per (token tile, vocab chunk) the per-token online-
//   softmax partials — row max m, sum-exp l, the target's logit and, for
//   label smoothing, the raw-logit row sum — into [n_vb, n] fp32 buffers
//   that the caller combines (as the JAX package combines its partials
//   outside the kernel, :266-271).
// - `_bwd_kernel` (:198, launched by `_fused_ce_bwd` :316) -> two passes,
//   ce_bwd_de_kernel and ce_bwd_dx_kernel, launched together by one C call.
//   Each recomputes its logit tiles, forms g = (softmax - target) * dloss
//   in fp32 and rounds it to bf16 (the activation dtype, as :221 does),
//   and contracts it: dE = g^T x in the first pass, dx = g E in the second,
//   both accumulated in fp32 and written once (dE in E's dtype, dx in x's).
//
// Numerics as in the JAX package: bf16 operands with fp32 accumulation,
// logits never rounded to bf16, every reduction in fp32, vocab rows past V
// masked out of every reduction (the JAX kernels mask by v_local), label
// smoothing's target (1 - eps) * onehot + eps / V. dx here sums fp32 over
// the whole vocabulary instead of adding bf16 per-block partials.
//
// Bound on the H100: operations. The forward is one product, 2 n V h flops
// (550 GFLOP at n 8192, V 32768, h 1024: 0.556 ms at 989 TFLOP/s); the
// backward function is three (the recomputed logits, dE, dx: 1.65 TFLOP,
// 1.67 ms). Bytes are x, E and the per-token vectors once — tens of MB.
//
// Design. The TPU kernels carry dE across their sequential token grid in
// VMEM and emit [n_vb, n, h] bf16 dx partials (268 MB at the TPU's block
// of 2048 vocab rows; 4.3 GB at a GPU-sized tile of 128). A GPU grid has no
// order and no such memory, so the backward is two passes with no atomics
// and no partials: the first gives each block 32 vocab rows of E for the
// whole run (E tile resident in shared memory, dE rows in registers) and
// loops over the token tiles; the second gives each block 32 tokens (x tile
// resident, dx rows in registers) and loops over the vocabulary. Both
// recompute every logit tile, so the backward does four products where the
// function needs three. Tiles are 32 x 32 with the full reduction depth h
// in shared memory; eight warps each compute one 16 x 8 piece of a logit
// tile with `mma.sync.m16n8k16` (two interleaved accumulators), and each
// warp owns h / 8 columns of the dE or dx rows, whose B operand is read as
// bf16 pairs from the row-major tile. Loads are synchronous; wgmma/TMA and
// larger tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;          // tokens per tile
constexpr int TV = 32;          // vocab rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;
constexpr int VT_FWD = 32;      // vocab tiles per forward block (1024 rows)
constexpr int LDG = TT + PAD;   // row stride of the staged g tile
constexpr int LDS = TV + 1;     // row stride of the forward's fp32 tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_m16n8k16(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + 32) of src [rows, h] (zeros past `rows`) -> dst [32][ld]
__device__ __forceinline__ void load_rows(const __nv_bfloat16* src, int r0,
                                          int rows, int h,
                                          __nv_bfloat16* dst, int ld) {
  const int chunks = h / 8;
  for (int idx = threadIdx.x; idx < 32 * chunks; idx += THREADS) {
    const int r = idx / chunks, c = idx % chunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * h + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// The 16 x 8 piece (rows mt*16.., cols nt*8..) of A B^T over depth h, with
// A and B row-major [32][ld] in shared memory; two accumulators alternate
// so consecutive mma's do not wait on each other.
__device__ __forceinline__ void tile_product(const __nv_bfloat16* sA,
                                             const __nv_bfloat16* sB, int ld,
                                             int h, int mt, int nt,
                                             float* acc) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  const __nv_bfloat16* pa = sA + (mt * 16 + g) * ld + tig * 2;
  const __nv_bfloat16* pb = sB + (nt * 8 + g) * ld + tig * 2;
  int kk = 0;
  for (; kk + 32 <= h; kk += 32) {
    uint32_t a[4] = {ld32(pa + kk), ld32(pa + 8 * ld + kk),
                     ld32(pa + kk + 8), ld32(pa + 8 * ld + kk + 8)};
    mma_m16n8k16(c0, a, ld32(pb + kk), ld32(pb + kk + 8));
    uint32_t a2[4] = {ld32(pa + kk + 16), ld32(pa + 8 * ld + kk + 16),
                      ld32(pa + kk + 24), ld32(pa + 8 * ld + kk + 24)};
    mma_m16n8k16(c1, a2, ld32(pb + kk + 16), ld32(pb + kk + 24));
  }
  if (kk < h) {
    uint32_t a[4] = {ld32(pa + kk), ld32(pa + 8 * ld + kk),
                     ld32(pa + kk + 8), ld32(pa + 8 * ld + kk + 8)};
    mma_m16n8k16(c0, a, ld32(pb + kk), ld32(pb + kk + 8));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = c0[i] + c1[i];
}

// g = (softmax - target) * dloss for one logit s of vocab row v (valid:
// v < V) and a token with target t, stats m, l and upstream grad dl
__device__ __forceinline__ float grad_of(float s, int v, bool valid, int t,
                                         float m, float l, float dl,
                                         float ls, float ls_over_v) {
  const float p = valid ? expf(s - m) / l : 0.f;
  float target = (valid && v == t) ? 1.f : 0.f;
  if (ls > 0.f) target = valid ? (1.f - ls) * target + ls_over_v : 0.f;
  return (p - target) * dl;
}

__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ e,
              const int32_t* __restrict__ tgt, int n, int V, int h,
              float* __restrict__ m_part, float* __restrict__ l_part,
              float* __restrict__ p_part, float* __restrict__ s_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = h + PAD;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sE = sX + TT * ld;
  float* sS = reinterpret_cast<float*>(sE + TV * ld);   // [token][vocab]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mt = warp / 4, nt = warp % 4;   // token m-tile, vocab n-tile
  const int t0 = blockIdx.x * TT, vb = blockIdx.y;
  const int vbase = vb * TV * VT_FWD;
  load_rows(x, t0, n, h, sX, ld);

  // eight lanes per token, four vocab columns each
  const int r = tid / 8, sub = tid % 8;
  const int tok = t0 + r;
  const int t = tok < n ? tgt[tok] : -1;
  float m = NEG_INF, l = 0.f, pred = 0.f, ssum = 0.f;

  for (int vt = 0; vt < VT_FWD; ++vt) {
    const int v0 = vbase + vt * TV;
    if (v0 >= V) break;
    __syncthreads();
    load_rows(e, v0, V, h, sE, ld);
    __syncthreads();
    float acc[4];
    tile_product(sX, sE, ld, h, mt, nt, acc);
    const int row = mt * 16 + g, col = nt * 8 + tig * 2;
    sS[row * LDS + col] = acc[0];
    sS[row * LDS + col + 1] = acc[1];
    sS[(row + 8) * LDS + col] = acc[2];
    sS[(row + 8) * LDS + col + 1] = acc[3];
    __syncthreads();

    float sv[4];
    bool ok[4];
    float tmax = NEG_INF;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cl = sub * 4 + c;
      ok[c] = v0 + cl < V;
      sv[c] = sS[r * LDS + cl];
      if (ok[c]) tmax = fmaxf(tmax, sv[c]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float mnew = fmaxf(m, tmax);
    float tsum = 0.f, tp = 0.f, ts = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!ok[c]) continue;
      tsum += expf(sv[c] - mnew);
      ts += sv[c];
      if (v0 + sub * 4 + c == t) tp += sv[c];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      tp += __shfl_xor_sync(0xffffffffu, tp, off);
      ts += __shfl_xor_sync(0xffffffffu, ts, off);
    }
    l = l * expf(m - mnew) + tsum;
    m = mnew;
    pred += tp;
    ssum += ts;
  }
  if (sub == 0 && tok < n) {
    const long o = (long)vb * n + tok;
    m_part[o] = m;
    l_part[o] = l;
    p_part[o] = pred;
    if (s_part != nullptr) s_part[o] = ssum;
  }
}

// Per-token vectors of a token tile into shared memory (neutral values
// past n: dloss 0 gives those tokens zero gradient).
__device__ __forceinline__ void load_stats(const int32_t* tgt,
                                           const float* m, const float* l,
                                           const float* dl, int t0, int n,
                                           int32_t* sT, float* sM, float* sL,
                                           float* sDl) {
  const int i = threadIdx.x;
  if (i < TT) {
    const int tok = t0 + i;
    const bool in = tok < n;
    sT[i] = in ? tgt[tok] : -1;
    sM[i] = in ? m[tok] : 0.f;
    sL[i] = in ? l[tok] : 1.f;
    sDl[i] = in ? dl[tok] : 0.f;
  }
}

// Accumulate OUT[32, h] += G[32, 32] B[32, h] for this warp's h/8 columns:
// G (bf16, row-major [32][LDG]) is the A operand, B row-major [32][ld] is
// read as bf16 pairs down its rows.
template <int NT>
__device__ __forceinline__ void accumulate(const __nv_bfloat16* sG,
                                           const __nv_bfloat16* sB, int ld,
                                           float (*acc)[NT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int hbase = warp * NT * 8;
#pragma unroll
  for (int ks = 0; ks < TT / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int m2 = 0; m2 < 2; ++m2) {
      const __nv_bfloat16* base = sG + (m2 * 16 + g) * LDG + ks * 16 + tig * 2;
      a[m2][0] = ld32(base);
      a[m2][1] = ld32(base + 8 * LDG);
      a[m2][2] = ld32(base + 8);
      a[m2][3] = ld32(base + 8 * LDG + 8);
    }
    const __nv_bfloat16* pb = sB + (ks * 16 + tig * 2) * ld + hbase + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* p = pb + j * 8;
      const uint32_t b0 = pack_raw(p[0], p[ld]);
      const uint32_t b1 = pack_raw(p[8 * ld], p[9 * ld]);
      mma_m16n8k16(acc[0][j], a[0], b0, b1);
      mma_m16n8k16(acc[1][j], a[1], b0, b1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void store_rows(float (*acc)[NT][4], int r0,
                                           int rows, int h,
                                           __nv_bfloat16* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int hbase = warp * NT * 8;
#pragma unroll
  for (int m2 = 0; m2 < 2; ++m2) {
    const int ra = r0 + m2 * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = hbase + j * 8 + tig * 2;
      if (ra < rows)
        *reinterpret_cast<uint32_t*>(out + (long)ra * h + col) =
            pack_bf16x2(acc[m2][j][0], acc[m2][j][1]);
      if (rb < rows)
        *reinterpret_cast<uint32_t*>(out + (long)rb * h + col) =
            pack_bf16x2(acc[m2][j][2], acc[m2][j][3]);
    }
  }
}

struct BwdArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* e;
  const int32_t* tgt;
  const float* m;
  const float* l;
  const float* dl;
  int n, V;
  float ls, ls_over_v;
};

// pass 1: a block owns 32 vocab rows, loops over token tiles -> dE rows
template <int NT>
__global__ void __launch_bounds__(THREADS)
ce_bwd_de_kernel(BwdArgs args, __nv_bfloat16* __restrict__ de) {
  constexpr int H = NT * 64;
  constexpr int LD = H + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sE = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sX = sE + TV * LD;
  __nv_bfloat16* sG = sX + TT * LD;              // g^T: [vocab][token]
  float* sM = reinterpret_cast<float*>(sG + TV * LDG);
  float* sL = sM + TT;
  float* sDl = sL + TT;
  int32_t* sT = reinterpret_cast<int32_t*>(sDl + TT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mt = warp / 4, nt = warp % 4;   // vocab m-tile, token n-tile
  const int v0 = blockIdx.x * TV;
  load_rows(args.e, v0, args.V, H, sE, LD);
  float acc[2][NT][4];
#pragma unroll
  for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[m2][j][0] = acc[m2][j][1] = acc[m2][j][2] = acc[m2][j][3] = 0.f;

  const int n_tt = (args.n + TT - 1) / TT;
  for (int tt = 0; tt < n_tt; ++tt) {
    const int t0 = tt * TT;
    __syncthreads();
    load_rows(args.x, t0, args.n, H, sX, LD);
    load_stats(args.tgt, args.m, args.l, args.dl, t0, args.n, sT, sM, sL,
               sDl);
    __syncthreads();
    float s[4], gv[4];
    tile_product(sE, sX, LD, H, mt, nt, s);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + mt * 16 + g + (q < 2 ? 0 : 8);
      const int tl = nt * 8 + tig * 2 + (q & 1);
      gv[q] = grad_of(s[q], v, v < args.V, sT[tl], sM[tl], sL[tl], sDl[tl],
                      args.ls, args.ls_over_v);
    }
    const int row = mt * 16 + g, col = nt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(sG + row * LDG + col) =
        pack_bf16x2(gv[0], gv[1]);
    *reinterpret_cast<uint32_t*>(sG + (row + 8) * LDG + col) =
        pack_bf16x2(gv[2], gv[3]);
    __syncthreads();
    accumulate<NT>(sG, sX, LD, acc);
  }
  store_rows<NT>(acc, v0, args.V, H, de);
}

// pass 2: a block owns 32 tokens, loops over the vocabulary -> dx rows
template <int NT>
__global__ void __launch_bounds__(THREADS)
ce_bwd_dx_kernel(BwdArgs args, __nv_bfloat16* __restrict__ dx) {
  constexpr int H = NT * 64;
  constexpr int LD = H + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sE = sX + TT * LD;
  __nv_bfloat16* sG = sE + TV * LD;              // g: [token][vocab]
  float* sM = reinterpret_cast<float*>(sG + TT * LDG);
  float* sL = sM + TT;
  float* sDl = sL + TT;
  int32_t* sT = reinterpret_cast<int32_t*>(sDl + TT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mt = warp / 4, nt = warp % 4;   // token m-tile, vocab n-tile
  const int t0 = blockIdx.x * TT;
  load_rows(args.x, t0, args.n, H, sX, LD);
  load_stats(args.tgt, args.m, args.l, args.dl, t0, args.n, sT, sM, sL, sDl);
  float acc[2][NT][4];
#pragma unroll
  for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[m2][j][0] = acc[m2][j][1] = acc[m2][j][2] = acc[m2][j][3] = 0.f;

  const int n_vt = (args.V + TV - 1) / TV;
  for (int vt = 0; vt < n_vt; ++vt) {
    const int v0 = vt * TV;
    __syncthreads();
    load_rows(args.e, v0, args.V, H, sE, LD);
    __syncthreads();
    float s[4], gv[4];
    tile_product(sX, sE, LD, H, mt, nt, s);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tl = mt * 16 + g + (q < 2 ? 0 : 8);
      const int v = v0 + nt * 8 + tig * 2 + (q & 1);
      gv[q] = grad_of(s[q], v, v < args.V, sT[tl], sM[tl], sL[tl], sDl[tl],
                      args.ls, args.ls_over_v);
    }
    const int row = mt * 16 + g, col = nt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(sG + row * LDG + col) =
        pack_bf16x2(gv[0], gv[1]);
    *reinterpret_cast<uint32_t*>(sG + (row + 8) * LDG + col) =
        pack_bf16x2(gv[2], gv[3]);
    __syncthreads();
    accumulate<NT>(sG, sE, LD, acc);
  }
  store_rows<NT>(acc, t0, args.n, H, dx);
}

size_t fwd_smem(int h) {
  return (size_t)(TT + TV) * (h + PAD) * 2 + (size_t)TT * LDS * 4;
}

size_t bwd_smem(int h) {
  return (size_t)(TT + TV) * (h + PAD) * 2 + (size_t)32 * LDG * 2 +
         (size_t)4 * TT * 4;
}

template <int NT>
cudaError_t launch_bwd(const BwdArgs& args, void* de, void* dx,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(NT * 64);
  cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_de_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_bwd_dx_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  ce_bwd_de_kernel<NT><<<(args.V + TV - 1) / TV, THREADS, smem, stream>>>(
      args, static_cast<__nv_bfloat16*>(de));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_bwd_dx_kernel<NT><<<(args.n + TT - 1) / TT, THREADS, smem, stream>>>(
      args, static_cast<__nv_bfloat16*>(dx));
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous tensors:
// x [n, h] and e [V, h] bf16, tgt [n] int32 (out-of-range ids match no
// vocab row). Forward: m_part, l_part, p_part (and s_part, or null when no
// label smoothing) [ceil(V / 1024), n] fp32. h must be a multiple of 16
// and at most 1536.
extern "C" int apex_lm_head_ce_fwd(const void* x, const void* e,
                                   const void* tgt, void* m_part,
                                   void* l_part, void* p_part, void* s_part,
                                   int n, int V, int h, void* stream) {
  if (h % 16 != 0 || h > 1536) return cudaErrorInvalidValue;
  if (n <= 0 || V <= 0) return cudaSuccess;
  const size_t smem = fwd_smem(h);
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + TT - 1) / TT, (V + TV * VT_FWD - 1) / (TV * VT_FWD));
  ce_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(e),
      static_cast<const int32_t*>(tgt), n, V, h,
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(p_part), static_cast<float*>(s_part));
  return cudaGetLastError();
}

// Backward: m, l (the combined row max and sum-exp) and dl (dloss) [n]
// fp32; writes de [V, h] and dx [n, h] bf16 (every element). h must be one
// of 128, 256, 512, 768, 1024.
extern "C" int apex_lm_head_ce_bwd(const void* x, const void* e,
                                   const void* tgt, const void* m,
                                   const void* l, const void* dl, void* de,
                                   void* dx, int n, int V, int h, float ls,
                                   float ls_over_v, void* stream) {
  if (n <= 0 || V <= 0) return cudaSuccess;
  BwdArgs args{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(e),
               static_cast<const int32_t*>(tgt),
               static_cast<const float*>(m), static_cast<const float*>(l),
               static_cast<const float*>(dl), n, V, ls, ls_over_v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 128: return launch_bwd<2>(args, de, dx, st);
    case 256: return launch_bwd<4>(args, de, dx, st);
    case 512: return launch_bwd<8>(args, de, dx, st);
    case 768: return launch_bwd<12>(args, de, dx, st);
    case 1024: return launch_bwd<16>(args, de, dx, st);
    default: return cudaErrorInvalidValue;
  }
}
