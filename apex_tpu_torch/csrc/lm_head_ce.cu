// Fused LM head + cross entropy for Hopper (sm_90a), fp32 operands (O0):
// the logits x E^T are computed tile by tile and never written to memory.
// bf16 and fp16 operands take lm_head_ce_sm90.cu (wgmma/TMA) instead: this
// source is built for fp32 only (ops/_build.py).
//
// Replaces the two Pallas kernels of apex_tpu/ops/lm_head_ce.py for fp32:
//
// - `_fwd_kernel` (:162, launched by `_fwd_partials` :250) ->
//   ce32_fwd_kernel: per (token tile, vocabulary slice) the per-token
//   online-softmax partials — row max m, sum-exp l, the target's logit
//   and, for label smoothing, the raw-logit row sum — into [n_slices, n]
//   fp32 buffers that the caller combines (as the JAX package combines its
//   partials outside the kernel, :266-271).
// - `_bwd_kernel` (:198, launched by `_fused_ce_bwd` :316) -> three
//   products a chunk of tokens, launched by one C call: ce32_grad_kernel
//   recomputes the chunk's logits once and writes the gradient tile
//   g = (softmax - target) * dloss in fp32 to a workspace, in two layouts
//   (G [tokens, V] and G^T [V, tokens]); then ce32_product_kernel computes
//   dx = G E (from G^T) and dE += G^T x (from G), dE accumulated in fp32
//   across the chunks in chunk order.
//
// Numerics as in the JAX package: exact fp32 products (every product an
// fmaf of fp32 operands, simt_f32.cuh: wgmma has no fp32 product and TF32
// would round the operands; O0 is the mode users compare against), logits
// never rounded, every reduction in fp32, vocab rows past V masked out of
// every reduction (the JAX kernels mask by v_local), label smoothing's
// target (1 - eps) * onehot + eps / V. dx sums fp32 over the whole
// vocabulary instead of adding per-block partials. No atomics: every
// output element is written by one block, dE's chunks in order, so dx and
// dE are the same bits on every run.
//
// Bound on the H100: operations at the fp32 rate outside the tensor cores
// (67 TFLOP/s). The forward is one product, 2 n V h flops (0.55 TFLOP at
// n 8192, V 32768, h 1024: 8.2 ms); the backward three (the recomputed
// logits, dx, dE: 24.6 ms), one fewer than recomputing the logits for each
// of dx and dE.
//
// Design. All three products run on the register-blocked FFMA core of
// simt_f32.cuh (128 x 128 block tiles, 8 x 8 outputs a thread, a 3-stage
// cp.async ring), which takes both operands k-row by k-row. x and E are
// stored with h contiguous, the logits' contraction index, so each call
// first transposes them (ce32_transpose_kernel, 160 MB of fp32 at the
// shape above, against products that read each byte hundreds of times);
// dx and dE contract over vocabulary rows and tokens, along which E, x and
// the two layouts of G are already stored. The forward's blocks each walk
// one slice of the vocabulary for 128 tokens (slices chosen so the grid
// is about two blocks an SM), keeping each of its rows' running
// statistics in one lane: a tile's row statistics are reduced with three
// xor-shuffles a quantity across the 8 lanes that share the row, and the
// grid's two column warps merge once at the end through shared memory.
// The backward's chunks keep G and G^T under F32_WORKSPACE_BYTES
// (ops/lm_head_ce.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "simt_f32.cuh"

namespace {

constexpr int TILE = 128;       // simt::BM == simt::BN
constexpr float NEG_INF = -1e30f;

// out[c][r] = in[r][c] for c < cols and r < rows, zeros for r in [rows,
// rows_p): in [rows, cols] row-major, out [cols, rows_p]
__global__ void __launch_bounds__(256)
ce32_transpose_kernel(const float* __restrict__ in, int rows, int cols,
                      int rows_p, float* __restrict__ out) {
  __shared__ float t[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    t[i][tx] = (r < rows && c < cols) ? in[(long)r * cols + c] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c < cols && r < rows_p) out[(long)c * rows_p + r] = t[tx][i];
  }
}

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

// One block: tokens [t0, t0 + 128), vocabulary tiles [vt_begin, vt_end).
// Lane (ly, lx) of column warp wn keeps the running (m, l, pred, ssum) of
// row row_of(lx) over wn's 64 columns of every tile.
__global__ void __launch_bounds__(simt::THREADS, 2)
ce32_fwd_kernel(simt::Operand xt, simt::Operand et,
                const int32_t* __restrict__ tgt, int n, int V, int hp,
                int vt_per_slice, float* __restrict__ m_part,
                float* __restrict__ l_part, float* __restrict__ p_part,
                float* __restrict__ s_part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int32_t sT[TILE];
  __shared__ float sStat[4][TILE];
  const int t0 = blockIdx.x * TILE, slice = blockIdx.y;
  for (int r = threadIdx.x; r < TILE; r += simt::THREADS)
    sT[r] = t0 + r < n ? tgt[t0 + r] : -1;   // read after product's barrier
  const int lx = threadIdx.x % 8, wn = (threadIdx.x / 32) % 2;
  float m = NEG_INF, l = 0.f, pred = 0.f, ssum = 0.f;
  const int n_vt = (V + TILE - 1) / TILE;
  const int vt_end = min(n_vt, (slice + 1) * vt_per_slice);

  for (int vt = slice * vt_per_slice; vt < vt_end; ++vt) {
    const int v0 = vt * TILE;
    float acc[8][simt::TN];
    simt::zero(acc);
    simt::product(smem, xt, et, t0, v0, hp, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = sT[simt::row_of(i)];
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < simt::TN; ++j)
        if (v0 + simt::col_of(j) < V) tmax = fmaxf(tmax, acc[i][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        tmax = fmaxf(tmax, shfl_xor(tmax, off));
      float ts = 0.f, sr = 0.f, tp = 0.f;
#pragma unroll
      for (int j = 0; j < simt::TN; ++j) {
        const int v = v0 + simt::col_of(j);
        if (v < V) {
          ts += expf(acc[i][j] - tmax);
          sr += acc[i][j];
          if (v == t) tp += acc[i][j];
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        ts += shfl_xor(ts, off);
        sr += shfl_xor(sr, off);
        tp += shfl_xor(tp, off);
      }
      if (lx == i) {
        const float mn = fmaxf(m, tmax);
        l = l * expf(m - mn) + ts * expf(tmax - mn);
        m = mn;
        pred += tp;
        ssum += sr;
      }
    }
  }

  // the second column warp's statistics into the first's, row by row
  const int row = simt::row_of(lx);
  if (wn == 1) {
    sStat[0][row] = m;
    sStat[1][row] = l;
    sStat[2][row] = pred;
    sStat[3][row] = ssum;
  }
  __syncthreads();
  if (wn == 0 && t0 + row < n) {
    const float m1 = sStat[0][row];
    const float mn = fmaxf(m, m1);
    const long o = (long)slice * n + t0 + row;
    m_part[o] = mn;
    l_part[o] = l * expf(m - mn) + sStat[1][row] * expf(m1 - mn);
    p_part[o] = pred + sStat[2][row];
    if (s_part != nullptr) s_part[o] = ssum + sStat[3][row];
  }
}

struct GradArgs {
  const int32_t* tgt;
  const float* m;
  const float* l;
  const float* dl;
  int n, V, vp, hp;
  int c0, chunk;      // the chunk's first token; G's rows (G^T's stride)
  float ls, ls_over_v;
  float* g;           // [chunk, vp]
  float* gt;          // [vp, chunk]
};

// One block: the logits of chunk tokens [tl0, tl0 + 128) x vocabulary
// rows [v0, v0 + 128), then g into G and G^T (zeros past V and for tokens
// past n, whose dloss is 0)
__global__ void __launch_bounds__(simt::THREADS, 2)
ce32_grad_kernel(simt::Operand xt, simt::Operand et, const GradArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int32_t sT[TILE];
  __shared__ float sM[TILE], sL[TILE], sDl[TILE];
  const int tl0 = blockIdx.x * TILE, v0 = blockIdx.y * TILE;
  for (int r = threadIdx.x; r < TILE; r += simt::THREADS) {
    const int tok = a.c0 + tl0 + r;
    const bool in = tok < a.n;
    sT[r] = in ? a.tgt[tok] : -1;
    sM[r] = in ? a.m[tok] : 0.f;
    sL[r] = in ? a.l[tok] : 1.f;
    sDl[r] = in ? a.dl[tok] : 0.f;
  }
  float acc[8][simt::TN];
  simt::zero(acc);
  simt::product(smem, xt, et, a.c0 + tl0, v0, a.hp, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = simt::row_of(i);
    const float mr = sM[r], lr = sL[r], dl = sDl[r];
    const int t = sT[r];
#pragma unroll
    for (int j = 0; j < simt::TN; ++j) {
      const int v = v0 + simt::col_of(j);
      const bool valid = v < a.V;
      const float p = valid ? expf(acc[i][j] - mr) / lr : 0.f;
      float target = (valid && v == t) ? 1.f : 0.f;
      if (a.ls > 0.f)
        target = valid ? (1.f - a.ls) * target + a.ls_over_v : 0.f;
      acc[i][j] = (p - target) * dl;
    }
  }
  const int r0 = simt::row0(), cb = simt::col0();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jg = 0; jg < simt::TN / 4; ++jg) {
      const int v = v0 + cb + 32 * jg;
      if (v < a.vp)
        *reinterpret_cast<float4*>(
            a.g + (long)(tl0 + simt::row_of(i)) * a.vp + v) =
            make_float4(acc[i][4 * jg], acc[i][4 * jg + 1],
                        acc[i][4 * jg + 2], acc[i][4 * jg + 3]);
    }
#pragma unroll
  for (int j = 0; j < simt::TN; ++j)
#pragma unroll
    for (int ig = 0; ig < 2; ++ig) {
      const int v = v0 + simt::col_of(j);
      if (v < a.vp)
        *reinterpret_cast<float4*>(a.gt + (long)v * a.chunk + tl0 + r0 +
                                   16 * ig) =
            make_float4(acc[4 * ig][j], acc[4 * ig + 1][j],
                        acc[4 * ig + 2][j], acc[4 * ig + 3][j]);
    }
}

// out[m0.., n0..] (=, or += with `accumulate`) the block's tile of A^T B
// over kdim, rows below m_out and columns below n_out (a multiple of 4);
// the grid's fast axis walks n, so the blocks of one row of tiles run
// together and share its A panel in L2
__global__ void __launch_bounds__(simt::THREADS, 2)
ce32_product_kernel(simt::Operand a, simt::Operand b, int kdim, int m_out,
                    int n_out, float* __restrict__ out, long ld_out,
                    int accumulate) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[8][simt::TN];
  simt::zero(acc);
  simt::product(smem, a, b, m0, n0, kdim, acc);
  const int cb = simt::col0();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + simt::row_of(i);
    if (r >= m_out) continue;
#pragma unroll
    for (int jg = 0; jg < simt::TN / 4; ++jg) {
      const int c = n0 + cb + 32 * jg;
      if (c >= n_out) continue;
      float4* p = reinterpret_cast<float4*>(out + (long)r * ld_out + c);
      float4 v = make_float4(acc[i][4 * jg], acc[i][4 * jg + 1],
                             acc[i][4 * jg + 2], acc[i][4 * jg + 3]);
      if (accumulate) {
        const float4 o = *p;
        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
      }
      *p = v;
    }
  }
}

int round4(int v) { return (v + 3) / 4 * 4; }
int tiles(int v) { return (v + TILE - 1) / TILE; }

// x [rows, hp] -> xt [hp, round4(rows)]
cudaError_t transpose(const float* in, int rows, int hp, float* out,
                      cudaStream_t st) {
  const int rows_p = round4(rows);
  ce32_transpose_kernel<<<dim3((rows_p + 31) / 32, (hp + 31) / 32), 256, 0,
                          st>>>(in, rows, hp, rows_p, out);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)simt::SMEM_BYTES);
}

cudaError_t fwd(const float* x, const float* e, const int32_t* tgt, float* xt,
                float* et, float* m_part, float* l_part, float* p_part,
                float* s_part, int n, int V, int hp, int slices,
                cudaStream_t st) {
  if (hp % 4 != 0 || slices <= 0) return cudaErrorInvalidValue;
  cudaError_t err = transpose(x, n, hp, xt, st);
  if (err == cudaSuccess) err = transpose(e, V, hp, et, st);
  if (err == cudaSuccess) err = allow_smem(ce32_fwd_kernel);
  if (err != cudaSuccess) return err;
  const int np = round4(n), vp = round4(V);
  const simt::Operand xo{xt, np, np, hp}, eo{et, vp, vp, hp};
  const int per = (tiles(V) + slices - 1) / slices;
  ce32_fwd_kernel<<<dim3(tiles(n), slices), simt::THREADS, simt::SMEM_BYTES,
                    st>>>(xo, eo, tgt, n, V, hp, per, m_part, l_part,
                          p_part, s_part);
  return cudaGetLastError();
}

cudaError_t bwd(const float* x, const float* e, const int32_t* tgt,
                const float* m, const float* l, const float* dl, float* xt,
                float* et, float* g, float* gt, float* de, float* dx, int n,
                int V, int hp, int chunk, float ls, float ls_over_v,
                cudaStream_t st) {
  if (hp % 4 != 0 || chunk <= 0 || chunk % TILE != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = transpose(x, n, hp, xt, st);
  if (err == cudaSuccess) err = transpose(e, V, hp, et, st);
  if (err == cudaSuccess) err = allow_smem(ce32_grad_kernel);
  if (err == cudaSuccess) err = allow_smem(ce32_product_kernel);
  if (err != cudaSuccess) return err;
  const int np = round4(n), vp = round4(V);
  const simt::Operand xo{xt, np, np, hp}, eo{et, vp, vp, hp};
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int tc = n - c0 < chunk ? n - c0 : chunk;
    const GradArgs ga{tgt, m, l, dl, n, V, vp, hp, c0, chunk, ls, ls_over_v,
                      g, gt};
    ce32_grad_kernel<<<dim3(tiles(tc), tiles(V)), simt::THREADS,
                       simt::SMEM_BYTES, st>>>(xo, eo, ga);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // dx [tc, hp] = G E: A = G^T [V, chunk] (k a vocabulary row), B = E
    const simt::Operand gto{gt, chunk, chunk, V}, e_k{e, hp, hp, V};
    ce32_product_kernel<<<dim3(tiles(hp), tiles(tc)), simt::THREADS,
                          simt::SMEM_BYTES, st>>>(
        gto, e_k, V, tc, hp, dx + (long)c0 * hp, hp, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // dE [V, hp] (+)= G^T x: A = G [chunk, vp] (k a token), B = x's rows
    const simt::Operand go{g, vp, vp, tc}, x_k{x + (long)c0 * hp, hp, hp, tc};
    ce32_product_kernel<<<dim3(tiles(hp), tiles(V)), simt::THREADS,
                          simt::SMEM_BYTES, st>>>(go, x_k, tc, V, hp, de, hp,
                                                  c0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous fp32
// tensors (`dtype` 2; any other code returns cudaErrorInvalidValue): x
// [n, hp] and e [V, hp] with hp a multiple of 4 (the wrapper zero-pads
// h), tgt [n] int32 (out-of-range ids match no vocab row); workspaces xt
// [hp, round4(n)] and et [hp, round4(V)].
//
// Forward: m_part, l_part, p_part (and s_part, or null when no label
// smoothing) [n_slices, n] fp32, every element written.
extern "C" int apex_lm_head_ce_fwd(const void* x, const void* e,
                                   const void* tgt, void* xt, void* et,
                                   void* m_part, void* l_part, void* p_part,
                                   void* s_part, int n, int V, int hp,
                                   int n_slices, int dtype, void* stream) {
  if (n <= 0 || V <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 2:
#if APEX_HAS_DTYPE(2)
      return fwd(static_cast<const float*>(x), static_cast<const float*>(e),
                 static_cast<const int32_t*>(tgt), static_cast<float*>(xt),
                 static_cast<float*>(et), static_cast<float*>(m_part),
                 static_cast<float*>(l_part), static_cast<float*>(p_part),
                 static_cast<float*>(s_part), n, V, hp, n_slices, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward: m, l (the combined row max and sum-exp) and dl (dloss) [n]
// fp32; workspaces g [chunk, round4(V)] and gt [round4(V), chunk], chunk
// a multiple of 128 (tokens a chunk); writes de [V, hp] and dx [n, hp]
// (every element).
extern "C" int apex_lm_head_ce_bwd(const void* x, const void* e,
                                   const void* tgt, const void* m,
                                   const void* l, const void* dl, void* xt,
                                   void* et, void* g, void* gt, void* de,
                                   void* dx, int n, int V, int hp, int chunk,
                                   float ls, float ls_over_v, int dtype,
                                   void* stream) {
  if (n <= 0 || V <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 2:
#if APEX_HAS_DTYPE(2)
      return bwd(static_cast<const float*>(x), static_cast<const float*>(e),
                 static_cast<const int32_t*>(tgt),
                 static_cast<const float*>(m), static_cast<const float*>(l),
                 static_cast<const float*>(dl), static_cast<float*>(xt),
                 static_cast<float*>(et), static_cast<float*>(g),
                 static_cast<float*>(gt), static_cast<float*>(de),
                 static_cast<float*>(dx), n, V, hp, chunk, ls, ls_over_v,
                 st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}
