// Fused LM head + cross entropy for Hopper (sm_90a): the logits x E^T are
// computed tile by tile and never written to memory.
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
//   in fp32 and rounds it to the activation dtype (as :221 does), and
//   contracts it: dE = g^T x in the first pass, dx = g E in the second,
//   both accumulated in fp32 and written once in the operands' dtype.
//
// Operands are bf16, fp16 or fp32 (x and E of one dtype, the JAX kernel's
// "any dtype"). Numerics as in the JAX package: products with fp32
// accumulation, logits never rounded, every reduction in fp32, vocab rows
// past V masked out of every reduction (the JAX kernels mask by v_local),
// label smoothing's target (1 - eps) * onehot + eps / V. dx here sums fp32
// over the whole vocabulary instead of adding per-block partials.
//
// Bound on the H100: operations. The forward is one product, 2 n V h flops
// (550 GFLOP at n 8192, V 32768, h 1024: 0.556 ms at 989 TFLOP/s); the
// backward function is three (the recomputed logits, dE, dx: 1.65 TFLOP,
// 1.67 ms). Bytes are x, E and the per-token vectors once — tens of MB.
// fp32 operands run the SIMT product of frag.cuh (exact fp32 products,
// ~1/30 of the bf16 rate; O0).
//
// Design. The TPU kernels carry dE across their sequential token grid in
// VMEM and emit [n_vb, n, h] dx partials (268 MB at the TPU's block of 2048
// vocab rows; 4.3 GB at a GPU-sized tile of 128). A GPU grid has no order
// and no such memory, so the backward is two passes with no atomics and no
// partials: the first gives each block 32 vocab rows of E for the whole run
// (dE rows in registers) and loops over the token tiles; the second gives
// each block 32 tokens (dx rows in registers) and loops over the
// vocabulary. Both recompute every logit tile, so the backward does four
// products where the function needs three. Tiles are 32 x 32; eight warps
// each compute one 16 x 8 piece of a logit tile through the m16n8k16
// fragments of frag.cuh (two interleaved accumulators), and each warp owns
// kc / 8 columns of the dE or dx rows, whose B operand is read as pairs
// from the row-major tile.
//
// Any hidden size. The TPU kernel holds all of h in one block; shared
// memory holds at most kc columns of a 32-row tile (kc <= 1024 for 16-bit
// operands, <= 512 for fp32, a multiple of 64): the wrapper pads h with
// zero columns in x and E to hp = nch * kc (zero columns change no logit
// and get zero gradient) and the kernels loop over the nch chunks. The
// forward accumulates each logit tile over the chunks. In the backward h is
// also an output dimension: the grid's second axis gives each block one
// output chunk, the block accumulates the logit tile over every chunk
// (taking its own last, so the tile that stays in shared memory is the one
// its product needs) and contracts g with its chunk only. With one chunk
// (h <= kc) the tile of the block's own side stays resident for the whole
// run, as before. Loads are synchronous; wgmma/TMA and larger tiles are
// later work. Shared memory: 2 * 32 * (kc + 8) elements plus the g tile
// and the statistics, 134 KB at bf16 kc 1024 and 135 KB at fp32 kc 512.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frag.cuh"

namespace {

constexpr int TT = 32;          // tokens per tile
constexpr int TV = 32;          // vocab rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;
constexpr int VT_FWD = 32;      // vocab tiles per forward block (1024 rows)
constexpr int LDG = TT + PAD;   // row stride of the staged g tile
constexpr int LDS = TV + 1;     // row stride of the forward's fp32 tile
constexpr int NT_MAX = 16;      // 8-column n-tiles a warp, kc / 64
constexpr float NEG_INF = -1e30f;

// rows [r0, r0 + 32) x columns [c0, c0 + kc) of src [rows, hp] (zeros past
// `rows`) -> dst [32][ld]
template <typename T>
__device__ __forceinline__ void load_rows(const T* src, int r0, int rows,
                                          int hp, int c0, int kc, T* dst,
                                          int ld) {
  constexpr int VEC = kVec<T>;
  const int chunks = kc / VEC;
  for (int idx = threadIdx.x; idx < 32 * chunks; idx += THREADS) {
    const int r = idx / chunks, c = idx % chunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * hp + c0 +
                                            c * VEC);
    *reinterpret_cast<uint4*>(dst + r * ld + c * VEC) = val;
  }
}

// acc += the 16 x 8 piece (rows mt*16.., cols nt*8..) of A B^T over depth
// kc, with A and B row-major [32][ld] in shared memory; two accumulators
// alternate so consecutive products do not wait on each other.
template <typename T>
__device__ __forceinline__ void tile_product(const T* sA, const T* sB,
                                             int ld, int kc, int mt, int nt,
                                             float* acc) {
  using F = Frag<T>;
  using P = typename F::pair;
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  const T* pa = sA + (mt * 16 + g) * ld + tig * 2;
  const T* pb = sB + (nt * 8 + g) * ld + tig * 2;
  int kk = 0;
  for (; kk + 32 <= kc; kk += 32) {
    P a[4] = {F::load(pa + kk), F::load(pa + 8 * ld + kk),
              F::load(pa + kk + 8), F::load(pa + 8 * ld + kk + 8)};
    F::mma(c0, a, F::load(pb + kk), F::load(pb + kk + 8));
    P a2[4] = {F::load(pa + kk + 16), F::load(pa + 8 * ld + kk + 16),
               F::load(pa + kk + 24), F::load(pa + 8 * ld + kk + 24)};
    F::mma(c1, a2, F::load(pb + kk + 16), F::load(pb + kk + 24));
  }
  if (kk < kc) {
    P a[4] = {F::load(pa + kk), F::load(pa + 8 * ld + kk),
              F::load(pa + kk + 8), F::load(pa + 8 * ld + kk + 8)};
    F::mma(c0, a, F::load(pb + kk), F::load(pb + kk + 8));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c0[i] + c1[i];
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

// ONE: h fits one chunk (nch == 1), known at compile time so the vocab
// loop keeps its one-tile body
template <typename T, bool ONE>
__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ e,
              const int32_t* __restrict__ tgt, int n, int V, int hp, int kc,
              float* __restrict__ m_part, float* __restrict__ l_part,
              float* __restrict__ p_part, float* __restrict__ s_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = kc + PAD;
  const int nch = ONE ? 1 : hp / kc;
  T* sX = reinterpret_cast<T*>(smem_raw);
  T* sE = sX + TT * ld;
  float* sS = reinterpret_cast<float*>(sE + TV * ld);   // [token][vocab]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mt = warp / 4, nt = warp % 4;   // token m-tile, vocab n-tile
  const int t0 = blockIdx.x * TT, vb = blockIdx.y;
  const int vbase = vb * TV * VT_FWD;
  if (ONE) load_rows<T>(x, t0, n, hp, 0, kc, sX, ld);

  // eight lanes per token, four vocab columns each
  const int r = tid / 8, sub = tid % 8;
  const int tok = t0 + r;
  const int t = tok < n ? tgt[tok] : -1;
  float m = NEG_INF, l = 0.f, pred = 0.f, ssum = 0.f;

  for (int vt = 0; vt < VT_FWD; ++vt) {
    const int v0 = vbase + vt * TV;
    if (v0 >= V) break;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < nch; ++c) {
      __syncthreads();
      if (!ONE) load_rows<T>(x, t0, n, hp, c * kc, kc, sX, ld);
      load_rows<T>(e, v0, V, hp, c * kc, kc, sE, ld);
      __syncthreads();
      tile_product<T>(sX, sE, ld, kc, mt, nt, acc);
    }
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

// Accumulate OUT[32, kc] += G[32, 32] B[32, kc] for this warp's nt 8-column
// tiles: G (row-major [32][LDG]) is the A operand, B row-major [32][ld] is
// read as pairs down its rows.
template <typename T>
__device__ __forceinline__ void accumulate(const T* sG, const T* sB, int ld,
                                           int nt, float (*acc)[NT_MAX][4]) {
  using F = Frag<T>;
  using P = typename F::pair;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int hbase = warp * nt * 8;
#pragma unroll
  for (int ks = 0; ks < TT / 16; ++ks) {
    P a[2][4];
#pragma unroll
    for (int m2 = 0; m2 < 2; ++m2) {
      const T* base = sG + (m2 * 16 + g) * LDG + ks * 16 + tig * 2;
      a[m2][0] = F::load(base);
      a[m2][1] = F::load(base + 8 * LDG);
      a[m2][2] = F::load(base + 8);
      a[m2][3] = F::load(base + 8 * LDG + 8);
    }
    const T* pb = sB + (ks * 16 + tig * 2) * ld + hbase + g;
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      if (j < nt) {
        const T* p = pb + j * 8;
        const P b0 = F::pack2(p[0], p[ld]);
        const P b1 = F::pack2(p[8 * ld], p[9 * ld]);
        F::mma(acc[0][j], a[0], b0, b1);
        F::mma(acc[1][j], a[1], b0, b1);
      }
    }
  }
}

// rows [r0, r0 + 32) of out [rows, hp], columns [c0, c0 + kc)
template <typename T>
__device__ __forceinline__ void store_rows(float (*acc)[NT_MAX][4], int r0,
                                           int rows, int hp, int c0, int nt,
                                           T* out) {
  using F = Frag<T>;
  using P = typename F::pair;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int hbase = c0 + warp * nt * 8;
#pragma unroll
  for (int m2 = 0; m2 < 2; ++m2) {
    const int ra = r0 + m2 * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      if (j >= nt) break;
      const int col = hbase + j * 8 + tig * 2;
      if (ra < rows)
        *reinterpret_cast<P*>(out + (long)ra * hp + col) =
            F::pack(acc[m2][j][0], acc[m2][j][1]);
      if (rb < rows)
        *reinterpret_cast<P*>(out + (long)rb * hp + col) =
            F::pack(acc[m2][j][2], acc[m2][j][3]);
    }
  }
}

template <typename T>
struct BwdArgs {
  const T* x;
  const T* e;
  const int32_t* tgt;
  const float* m;
  const float* l;
  const float* dl;
  int n, V, hp, kc;
  float ls, ls_over_v;
};

__device__ __forceinline__ void zero_acc(float (*acc)[NT_MAX][4]) {
#pragma unroll
  for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j)
      acc[m2][j][0] = acc[m2][j][1] = acc[m2][j][2] = acc[m2][j][3] = 0.f;
}

// pass 1: a block owns 32 vocab rows and output chunk blockIdx.y, loops
// over the token tiles -> dE rows
template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_bwd_de_kernel(BwdArgs<T> args, T* __restrict__ de) {
  using F = Frag<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kc = args.kc, hp = args.hp, ld = kc + PAD;
  const int nch = hp / kc, oc = blockIdx.y, nt = kc / 64;
  T* sE = reinterpret_cast<T*>(smem_raw);
  T* sX = sE + TV * ld;
  T* sG = sX + TT * ld;                          // g^T: [vocab][token]
  float* sM = reinterpret_cast<float*>(sG + TV * LDG);
  float* sL = sM + TT;
  float* sDl = sL + TT;
  int32_t* sT = reinterpret_cast<int32_t*>(sDl + TT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mt = warp / 4, nt_ = warp % 4;  // vocab m-tile, token n-tile
  const int v0 = blockIdx.x * TV;
  if (nch == 1) load_rows<T>(args.e, v0, args.V, hp, 0, kc, sE, ld);
  float acc[2][NT_MAX][4];
  zero_acc(acc);

  const int n_tt = (args.n + TT - 1) / TT;
  for (int tt = 0; tt < n_tt; ++tt) {
    const int t0 = tt * TT;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, gv[4];
    for (int i = 0; i < nch; ++i) {
      const int c = (oc + 1 + i) % nch;     // the block's own chunk last
      __syncthreads();
      if (nch > 1) load_rows<T>(args.e, v0, args.V, hp, c * kc, kc, sE, ld);
      load_rows<T>(args.x, t0, args.n, hp, c * kc, kc, sX, ld);
      if (i == 0)
        load_stats(args.tgt, args.m, args.l, args.dl, t0, args.n, sT, sM, sL,
                   sDl);
      __syncthreads();
      tile_product<T>(sE, sX, ld, kc, mt, nt_, s);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + mt * 16 + g + (q < 2 ? 0 : 8);
      const int tl = nt_ * 8 + tig * 2 + (q & 1);
      gv[q] = grad_of(s[q], v, v < args.V, sT[tl], sM[tl], sL[tl], sDl[tl],
                      args.ls, args.ls_over_v);
    }
    const int row = mt * 16 + g, col = nt_ * 8 + tig * 2;
    *reinterpret_cast<typename F::pair*>(sG + row * LDG + col) =
        F::pack(gv[0], gv[1]);
    *reinterpret_cast<typename F::pair*>(sG + (row + 8) * LDG + col) =
        F::pack(gv[2], gv[3]);
    __syncthreads();
    accumulate<T>(sG, sX, ld, nt, acc);
  }
  store_rows<T>(acc, v0, args.V, hp, oc * kc, nt, de);
}

// pass 2: a block owns 32 tokens and output chunk blockIdx.y, loops over
// the vocabulary -> dx rows
template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_bwd_dx_kernel(BwdArgs<T> args, T* __restrict__ dx) {
  using F = Frag<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kc = args.kc, hp = args.hp, ld = kc + PAD;
  const int nch = hp / kc, oc = blockIdx.y, nt = kc / 64;
  T* sX = reinterpret_cast<T*>(smem_raw);
  T* sE = sX + TT * ld;
  T* sG = sE + TV * ld;                          // g: [token][vocab]
  float* sM = reinterpret_cast<float*>(sG + TT * LDG);
  float* sL = sM + TT;
  float* sDl = sL + TT;
  int32_t* sT = reinterpret_cast<int32_t*>(sDl + TT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mt = warp / 4, nt_ = warp % 4;  // token m-tile, vocab n-tile
  const int t0 = blockIdx.x * TT;
  if (nch == 1) load_rows<T>(args.x, t0, args.n, hp, 0, kc, sX, ld);
  load_stats(args.tgt, args.m, args.l, args.dl, t0, args.n, sT, sM, sL, sDl);
  float acc[2][NT_MAX][4];
  zero_acc(acc);

  const int n_vt = (args.V + TV - 1) / TV;
  for (int vt = 0; vt < n_vt; ++vt) {
    const int v0 = vt * TV;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, gv[4];
    for (int i = 0; i < nch; ++i) {
      const int c = (oc + 1 + i) % nch;     // the block's own chunk last
      __syncthreads();
      if (nch > 1) load_rows<T>(args.x, t0, args.n, hp, c * kc, kc, sX, ld);
      load_rows<T>(args.e, v0, args.V, hp, c * kc, kc, sE, ld);
      __syncthreads();
      tile_product<T>(sX, sE, ld, kc, mt, nt_, s);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tl = mt * 16 + g + (q < 2 ? 0 : 8);
      const int v = v0 + nt_ * 8 + tig * 2 + (q & 1);
      gv[q] = grad_of(s[q], v, v < args.V, sT[tl], sM[tl], sL[tl], sDl[tl],
                      args.ls, args.ls_over_v);
    }
    const int row = mt * 16 + g, col = nt_ * 8 + tig * 2;
    *reinterpret_cast<typename F::pair*>(sG + row * LDG + col) =
        F::pack(gv[0], gv[1]);
    *reinterpret_cast<typename F::pair*>(sG + (row + 8) * LDG + col) =
        F::pack(gv[2], gv[3]);
    __syncthreads();
    accumulate<T>(sG, sE, ld, nt, acc);
  }
  store_rows<T>(acc, t0, args.n, hp, oc * kc, nt, dx);
}

template <typename T>
size_t fwd_smem(int kc) {
  return (size_t)(TT + TV) * (kc + PAD) * sizeof(T) + (size_t)TT * LDS * 4;
}

template <typename T>
size_t bwd_smem(int kc) {
  return (size_t)(TT + TV) * (kc + PAD) * sizeof(T) +
         (size_t)32 * LDG * sizeof(T) + (size_t)4 * TT * 4;
}

// kc must divide hp, be a multiple of 64 and at most 1024 (16-bit) or 512
// (fp32) columns
template <typename T>
bool valid_chunks(int hp, int kc) {
  const int kmax = sizeof(T) == 4 ? 512 : 1024;
  return kc > 0 && kc % 64 == 0 && kc <= kmax && hp % kc == 0;
}

template <typename T, bool ONE>
cudaError_t launch_fwd_kernel(const void* x, const void* e, const void* tgt,
                              void* m_part, void* l_part, void* p_part,
                              void* s_part, int n, int V, int hp, int kc,
                              cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(kc);
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel<T, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + TT - 1) / TT, (V + TV * VT_FWD - 1) / (TV * VT_FWD));
  ce_fwd_kernel<T, ONE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(e),
      static_cast<const int32_t*>(tgt), n, V, hp, kc,
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(p_part), static_cast<float*>(s_part));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* e, const void* tgt,
                       void* m_part, void* l_part, void* p_part,
                       void* s_part, int n, int V, int hp, int kc,
                       cudaStream_t stream) {
  if (!valid_chunks<T>(hp, kc)) return cudaErrorInvalidValue;
  return hp == kc
      ? launch_fwd_kernel<T, true>(x, e, tgt, m_part, l_part, p_part, s_part,
                                   n, V, hp, kc, stream)
      : launch_fwd_kernel<T, false>(x, e, tgt, m_part, l_part, p_part,
                                    s_part, n, V, hp, kc, stream);
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs<T>& args, void* de, void* dx,
                       cudaStream_t stream) {
  if (!valid_chunks<T>(args.hp, args.kc)) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem<T>(args.kc);
  cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_de_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_bwd_dx_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int nch = args.hp / args.kc;
  ce_bwd_de_kernel<T><<<dim3((args.V + TV - 1) / TV, nch), THREADS, smem,
                        stream>>>(args, static_cast<T*>(de));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_bwd_dx_kernel<T><<<dim3((args.n + TT - 1) / TT, nch), THREADS, smem,
                        stream>>>(args, static_cast<T*>(dx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_of(const void* x, const void* e, const void* tgt,
                   const void* m, const void* l, const void* dl, void* de,
                   void* dx, int n, int V, int hp, int kc, float ls,
                   float ls_over_v, cudaStream_t st) {
  BwdArgs<T> args{static_cast<const T*>(x), static_cast<const T*>(e),
                  static_cast<const int32_t*>(tgt),
                  static_cast<const float*>(m), static_cast<const float*>(l),
                  static_cast<const float*>(dl), n, V, hp, kc, ls, ls_over_v};
  return launch_bwd<T>(args, de, dx, st);
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous tensors:
// x [n, hp] and e [V, hp] of one dtype (`dtype` 0 bf16, 1 fp16, 2 fp32),
// tgt [n] int32 (out-of-range ids match no vocab row); hp is a multiple of
// the chunk kc (a multiple of 64, at most 1024 for 16-bit operands and 512
// for fp32). Forward: m_part, l_part, p_part (and s_part, or null when no
// label smoothing) [ceil(V / 1024), n] fp32.
extern "C" int apex_lm_head_ce_fwd(const void* x, const void* e,
                                   const void* tgt, void* m_part,
                                   void* l_part, void* p_part, void* s_part,
                                   int n, int V, int hp, int kc, int dtype,
                                   void* stream) {
  if (n <= 0 || V <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return launch_fwd<__nv_bfloat16>(x, e, tgt, m_part, l_part, p_part,
                                       s_part, n, V, hp, kc, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return launch_fwd<__half>(x, e, tgt, m_part, l_part, p_part, s_part, n,
                                V, hp, kc, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 2:
#if APEX_HAS_DTYPE(2)
      return launch_fwd<float>(x, e, tgt, m_part, l_part, p_part, s_part, n,
                               V, hp, kc, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward: m, l (the combined row max and sum-exp) and dl (dloss) [n]
// fp32; writes de [V, hp] and dx [n, hp] in the operands' dtype (every
// element).
extern "C" int apex_lm_head_ce_bwd(const void* x, const void* e,
                                   const void* tgt, const void* m,
                                   const void* l, const void* dl, void* de,
                                   void* dx, int n, int V, int hp, int kc,
                                   float ls, float ls_over_v, int dtype,
                                   void* stream) {
  if (n <= 0 || V <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return bwd_of<__nv_bfloat16>(x, e, tgt, m, l, dl, de, dx, n, V, hp, kc,
                                   ls, ls_over_v, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return bwd_of<__half>(x, e, tgt, m, l, dl, de, dx, n, V, hp, kc, ls,
                            ls_over_v, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 2:
#if APEX_HAS_DTYPE(2)
      return bwd_of<float>(x, e, tgt, m, l, dl, de, dx, n, V, hp, kc, ls,
                           ls_over_v, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}
