// Fused LM head + cross entropy for Hopper (sm_90a), bf16 and fp16
// operands: the products run on wgmma/TMA (wgmma_gemm.cuh).
//
// Replaces the two Pallas kernels of apex_tpu/ops/lm_head_ce.py for 16-bit
// operands (fp32, the O0 path, stays on lm_head_ce.cu's SIMT product, which
// keeps its loss bitwise the plain one; wgmma has no exact fp32 product):
//
// - `_fwd_kernel` (:162) -> ce_fwd: a block owns 128 tokens and a
//   contiguous slice of the vocabulary, loops over the slice's 128-row
//   vocab tiles, accumulates each tile's logits over h in 64-deep K-stages
//   and folds the tile into running per-token row max m, sum-exp l, target
//   logit and (label smoothing) row sum, reduced over the four lanes that
//   share a row. It writes [n_slices, n] fp32 partials that the wrapper
//   combines, as the JAX package combines its own (:266-271).
// - `_bwd_kernel` (:198) -> three products per token chunk, no atomics:
//   1. ce_grad: S = x_c E^T; the epilogue forms g = (softmax - target) *
//      dloss from the saved m, l (the arithmetic of lm_head_ce.cu's
//      grad_of), rounds it to the activation dtype (as :221 does) and
//      writes it to the workspace G_c [T_c, V] (row stride V rounded up to
//      8, for TMA's 16-byte strides);
//   2. ce_dx: dx_c = G_c E, summed in fp32 over the whole vocabulary and
//      written once in x's dtype;
//   3. ce_de: dE += G_c^T x_c with G_c read MN-major through the wgmma
//      transpose bit: the first chunk writes an fp32 accumulator, later
//      chunks add to it, the last casts the sum into dE's dtype (one chunk:
//      dE directly).
//   Each output element is owned by one block and the chunks run in stream
//   order, so dx and dE are the same bits from run to run.
//
// Numerics as in the JAX package: logits with fp32 accumulation, never
// rounded; fp32 reductions; vocabulary rows past V (TMA's zero fill) masked
// out of every reduction and given g = 0; an out-of-range target matches no
// row; label smoothing's target (1 - eps) onehot + eps / V.
//
// Bound on the H100: operations. The forward is one product, 2 n V h flops
// (550 GFLOP at n 8192, V 32768, h 1024: 0.556 ms at 989 TFLOP/s); the
// backward three (1.65 TFLOP, 1.67 ms). Bytes: x, E once (80 MB) in the
// forward; in the backward G written once and read twice (537 MB at that
// shape, two chunks of 4096 tokens), x, E, dx, dE and the fp32 dE
// accumulator (128 MB, written and read once): ~0.3 ms, below the
// operation bound. The design keeps the tensor cores fed: the logit tile is
// computed once per product that needs it (the parent's SIMT-tiled kernels
// recomputed it in each of two backward passes and once per hidden chunk),
// tiles are 128 x 128 (was 32 x 32), and TMA loads run four stages ahead
// of the wgmma products in a warp-specialised pipeline.
//
// Launch order for L2 reuse: the logit products put the token tiles on the
// fast grid axis, so the blocks in flight share a few vocabulary tiles of E
// and the chunk's x stays in L2; dx and dE put the hidden tiles on the fast
// axis, so the blocks in flight share their rows of G. The logit products'
// blocks walk several vocabulary tiles each (the forward a slice of the
// vocabulary, the backward GRAD_TILES), so the producer's TMA loads for
// the next tile overlap the consumers' epilogue of this one.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "frag.cuh"
#include "wgmma_gemm.cuh"

namespace {

using wg::ACC;
using wg::BK;
using wg::BM;
using wg::BN;

constexpr float NEG_INF = -1e30f;

// this consumer thread's index in its warpgroup, and the first row of its
// two rows (the second is 8 below) in the block's 128-row tile
__device__ __forceinline__ int ctid() { return threadIdx.x % 128; }
__device__ __forceinline__ int row_base(int cw) {
  return 64 * cw + wg::acc_row(ctid(), 0);
}

// ---------------------------------------------------------------------------
// forward: per-token partials over a vocabulary slice
// ---------------------------------------------------------------------------

struct FwdState {
  float m[2], l[2], pred[2], ssum[2];
  int tgt[2];
};

template <typename TT>
struct FwdEpi {
  using T = TT;
  using State = FwdState;
  static constexpr bool A_MN = false, B_MN = false;
  const int32_t* tgt;
  float *m_part, *l_part, *p_part, *s_part;
  int n, V, hp, per, vtiles;          // vocab tiles a slice, in all

  __device__ int tiles() const {
    return max(0, min(per, vtiles - (int)blockIdx.y * per));
  }
  __device__ int2 origin(int t) const {
    return make_int2(blockIdx.x * BM, (blockIdx.y * per + t) * BN);
  }
  __device__ int ksteps() const { return (hp + BK - 1) / BK; }
  __device__ void begin(int cw, State& st) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = blockIdx.x * BM + row_base(cw) + 8 * r;
      st.tgt[r] = row < n ? tgt[row] : -1;
      st.m[r] = NEG_INF;
      st.l[r] = st.pred[r] = st.ssum[r] = 0.f;
    }
  }
  __device__ void tile(float (&acc)[ACC], int t, int cw, State& st) const {
    const int n0 = origin(t).y, tid = ctid();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = NEG_INF;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * nb + 2 * (tid % 4) + e < V)
            tmax = fmaxf(tmax, acc[4 * nb + 2 * r + e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mnew = fmaxf(st.m[r], tmax);
      float sum = 0.f, tp = 0.f, ts = 0.f;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * nb + 2 * (tid % 4) + e;
          const float s = acc[4 * nb + 2 * r + e];
          if (col < V) {
            sum += expf(s - mnew);
            ts += s;
            if (col == st.tgt[r]) tp += s;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        tp += __shfl_xor_sync(0xffffffffu, tp, off);
        ts += __shfl_xor_sync(0xffffffffu, ts, off);
      }
      st.l[r] = st.l[r] * expf(st.m[r] - mnew) + sum;
      st.m[r] = mnew;
      st.pred[r] += tp;
      st.ssum[r] += ts;
    }
  }
  __device__ void finish(int cw, State& st) const {
    if (ctid() % 4 != 0) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = blockIdx.x * BM + row_base(cw) + 8 * r;
      if (row >= n) continue;
      const long o = (long)blockIdx.y * n + row;
      m_part[o] = st.m[r];
      l_part[o] = st.l[r];
      p_part[o] = st.pred[r];
      if (s_part != nullptr) s_part[o] = st.ssum[r];
    }
  }
};

// ---------------------------------------------------------------------------
// backward, product 1: logits -> g into the workspace
// ---------------------------------------------------------------------------

struct GradState {
  float m[2], l[2], dl[2];
  int tgt[2];
};

struct NoState {};

template <typename TT>
struct GradEpi {
  using T = TT;
  using State = GradState;
  static constexpr bool A_MN = false, B_MN = false;
  const int32_t* tgt;                  // the chunk's rows
  const float *m, *l, *dl;
  T* g;                                // [rows, vs]
  int rows, V, vs, hp;
  float ls, ls_over_v;
  int per, vtiles;                     // vocab tiles a block, in all

  __device__ int tiles() const {
    return max(0, min(per, vtiles - (int)blockIdx.y * per));
  }
  __device__ int2 origin(int t) const {
    return make_int2(blockIdx.x * BM, (blockIdx.y * per + t) * BN);
  }
  __device__ int ksteps() const { return (hp + BK - 1) / BK; }
  __device__ void begin(int cw, State& st) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = blockIdx.x * BM + row_base(cw) + 8 * r;
      const bool in = row < rows;
      st.tgt[r] = in ? tgt[row] : -1;
      st.m[r] = in ? m[row] : 0.f;
      st.l[r] = in ? l[row] : 1.f;
      st.dl[r] = in ? dl[row] : 0.f;
    }
  }
  __device__ void tile(float (&acc)[ACC], int t, int cw, State& st) const {
    const int n0 = origin(t).y, tid = ctid();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = blockIdx.x * BM + row_base(cw) + 8 * r;
      if (row >= rows) continue;
      const float inv_l = 1.f / st.l[r];
      T* grow = g + (long)row * vs;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int c = n0 + 8 * nb + 2 * (tid % 4);
        if (c >= V) continue;
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = c + e;
          const bool valid = v < V;
          // grad_of of lm_head_ce.cu
          const float p =
              valid ? expf(acc[4 * nb + 2 * r + e] - st.m[r]) * inv_l : 0.f;
          float target = (valid && v == st.tgt[r]) ? 1.f : 0.f;
          if (ls > 0.f) target = valid ? (1.f - ls) * target + ls_over_v : 0.f;
          gv[e] = (p - target) * st.dl[r];
        }
        *reinterpret_cast<uint32_t*>(grow + c) = Frag<T>::pack(gv[0], gv[1]);
      }
    }
  }
  __device__ void finish(int, State&) const {}
};

// ---------------------------------------------------------------------------
// backward, product 2: dx_c = G_c E
// ---------------------------------------------------------------------------

template <typename TT>
struct DxEpi {
  using T = TT;
  using State = NoState;
  static constexpr bool A_MN = false, B_MN = true;
  T* dx;                               // the chunk's rows, [rows, hp]
  int rows, V, hp;

  __device__ int tiles() const { return 1; }
  __device__ int2 origin(int) const {
    return make_int2(blockIdx.y * BM, blockIdx.x * BN);
  }
  __device__ int ksteps() const { return (V + BK - 1) / BK; }
  __device__ void begin(int, State&) const {}
  __device__ void tile(float (&acc)[ACC], int, int cw, State&) const {
    const int n0 = blockIdx.x * BN, tid = ctid();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = blockIdx.y * BM + row_base(cw) + 8 * r;
      if (row >= rows) continue;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int c = n0 + 8 * nb + 2 * (tid % 4);
        if (c < hp)
          *reinterpret_cast<uint32_t*>(dx + (long)row * hp + c) =
              Frag<T>::pack(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
      }
    }
  }
  __device__ void finish(int, State&) const {}
};

// ---------------------------------------------------------------------------
// backward, product 3: dE (+)= G_c^T x_c
// ---------------------------------------------------------------------------

enum DeMode { DE_ONLY = 0, DE_FIRST = 1, DE_MID = 2, DE_LAST = 3 };

template <typename TT>
struct DeEpi {
  using T = TT;
  using State = NoState;
  static constexpr bool A_MN = true, B_MN = true;
  float* acc_buf;                      // [V, hp] fp32 (null with one chunk)
  T* de;                               // [V, hp]
  int rows, V, hp, mode;

  __device__ int tiles() const { return 1; }
  __device__ int2 origin(int) const {
    return make_int2(blockIdx.y * BM, blockIdx.x * BN);
  }
  __device__ int ksteps() const { return (rows + BK - 1) / BK; }
  __device__ void begin(int, State&) const {}
  __device__ void tile(float (&acc)[ACC], int, int cw, State&) const {
    const int n0 = blockIdx.x * BN, tid = ctid();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = blockIdx.y * BM + row_base(cw) + 8 * r;
      if (v >= V) continue;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int c = n0 + 8 * nb + 2 * (tid % 4);
        if (c >= hp) continue;
        const long o = (long)v * hp + c;
        float2 a = make_float2(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
        if (mode == DE_MID || mode == DE_LAST) {
          const float2 b = *reinterpret_cast<const float2*>(acc_buf + o);
          a.x += b.x;
          a.y += b.y;
        }
        if (mode == DE_FIRST || mode == DE_MID)
          *reinterpret_cast<float2*>(acc_buf + o) = a;
        else
          *reinterpret_cast<uint32_t*>(de + o) = Frag<T>::pack(a.x, a.y);
      }
    }
  }
  __device__ void finish(int, State&) const {}
};

// ---------------------------------------------------------------------------
// the core alone: C [M, N] fp32 = A B, for the card tests of the layouts
// ---------------------------------------------------------------------------

template <typename TT, bool AM, bool BMN>
struct ProbeEpi {
  using T = TT;
  using State = NoState;
  static constexpr bool A_MN = AM, B_MN = BMN;
  float* c;
  int M, N, K;

  __device__ int tiles() const { return 1; }
  __device__ int2 origin(int) const {
    return make_int2(blockIdx.y * BM, blockIdx.x * BN);
  }
  __device__ int ksteps() const { return (K + BK - 1) / BK; }
  __device__ void begin(int, State&) const {}
  __device__ void tile(float (&acc)[ACC], int, int cw, State&) const {
    const int tid = ctid();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int row = blockIdx.y * BM + 64 * cw + wg::acc_row(tid, i);
      const int col = blockIdx.x * BN + wg::acc_col(tid, i);
      if (row < M && col < N) c[(long)row * N + col] = acc[i];
    }
  }
  __device__ void finish(int, State&) const {}
};

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

constexpr cudaError_t MAP_REFUSED = cudaErrorNotSupported;
// vocab tiles a block of the logit product walks: the next tile's loads
// overlap this one's epilogue instead of each tile filling the ring anew
constexpr int GRAD_TILES = 8;

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

template <typename T>
cudaError_t fwd(const void* x, const void* e, const void* tgt, void* m_part,
                void* l_part, void* p_part, void* s_part, int n, int V,
                int hp, int n_slices, cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!wg::operand_map<T>(&ma, x, n, hp, hp, false) ||
      !wg::operand_map<T>(&mb, e, V, hp, hp, false))
    return MAP_REFUSED;
  const int vtiles = cdiv(V, BN);
  const int per = cdiv(vtiles, n_slices);
  FwdEpi<T> epi{static_cast<const int32_t*>(tgt),
                static_cast<float*>(m_part), static_cast<float*>(l_part),
                static_cast<float*>(p_part), static_cast<float*>(s_part),
                n, V, hp, per, vtiles};
  return wg::launch(ma, mb, epi, dim3(cdiv(n, BM), n_slices), st);
}

template <typename T>
cudaError_t bwd(const void* x, const void* e, const void* tgt,
                const void* m, const void* l, const void* dl, void* g,
                void* de_acc, void* de, void* dx, int n, int V, int hp,
                int vs, int chunk, float ls, float ls_over_v,
                cudaStream_t st) {
  CUtensorMap e_k, e_mn;
  if (!wg::operand_map<T>(&e_k, e, V, hp, hp, false) ||
      !wg::operand_map<T>(&e_mn, e, V, hp, hp, true))
    return MAP_REFUSED;
  const int nch = cdiv(n, chunk);
  const int vtiles = cdiv(V, BN);
  if (nch > 1 && de_acc == nullptr) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  for (int c = 0; c < nch; ++c) {
    const long r0 = (long)c * chunk;
    const int rows = (int)(n - r0 < chunk ? n - r0 : chunk);
    const T* xc = xs + r0 * hp;
    CUtensorMap x_k, x_mn, g_k, g_mn;
    if (!wg::operand_map<T>(&x_k, xc, rows, hp, hp, false) ||
        !wg::operand_map<T>(&x_mn, xc, rows, hp, hp, true) ||
        !wg::operand_map<T>(&g_k, g, rows, V, vs, false) ||
        !wg::operand_map<T>(&g_mn, g, rows, V, vs, true))
      return MAP_REFUSED;
    GradEpi<T> ge{static_cast<const int32_t*>(tgt) + r0,
                  static_cast<const float*>(m) + r0,
                  static_cast<const float*>(l) + r0,
                  static_cast<const float*>(dl) + r0,
                  static_cast<T*>(g), rows, V, vs, hp, ls, ls_over_v,
                  GRAD_TILES, vtiles};
    cudaError_t err = wg::launch(
        x_k, e_k, ge, dim3(cdiv(rows, BM), cdiv(vtiles, GRAD_TILES)), st);
    if (err != cudaSuccess) return err;
    DxEpi<T> xe{static_cast<T*>(dx) + r0 * hp, rows, V, hp};
    err = wg::launch(g_k, e_mn, xe, dim3(cdiv(hp, BN), cdiv(rows, BM)), st);
    if (err != cudaSuccess) return err;
    const int mode = nch == 1 ? DE_ONLY
                     : c == 0 ? DE_FIRST
                     : c == nch - 1 ? DE_LAST : DE_MID;
    DeEpi<T> dee{static_cast<float*>(de_acc), static_cast<T*>(de), rows, V,
                 hp, mode};
    err = wg::launch(g_mn, x_mn, dee, dim3(cdiv(hp, BN), cdiv(V, BM)), st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool AM, bool BMN>
cudaError_t probe(const void* a, const void* b, void* c, int M, int N, int K,
                  cudaStream_t st) {
  CUtensorMap ma, mb;
  // A: [M, K] (K-major) or [K, M] (MN-major); B: [N, K] or [K, N]
  if (!(AM ? wg::operand_map<T>(&ma, a, K, M, M, true)
           : wg::operand_map<T>(&ma, a, M, K, K, false)) ||
      !(BMN ? wg::operand_map<T>(&mb, b, K, N, N, true)
            : wg::operand_map<T>(&mb, b, N, K, K, false)))
    return MAP_REFUSED;
  ProbeEpi<T, AM, BMN> epi{static_cast<float*>(c), M, N, K};
  return wg::launch(ma, mb, epi, dim3(cdiv(N, BN), cdiv(M, BM)), st);
}

template <typename T>
cudaError_t probe_of(const void* a, const void* b, void* c, int M, int N,
                     int K, int a_mn, int b_mn, cudaStream_t st) {
  if (a_mn)
    return b_mn ? probe<T, true, true>(a, b, c, M, N, K, st)
                : probe<T, true, false>(a, b, c, M, N, K, st);
  return b_mn ? probe<T, false, true>(a, b, c, M, N, K, st)
              : probe<T, false, false>(a, b, c, M, N, K, st);
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous tensors;
// `dtype` 0 bf16, 1 fp16 (a build holds one, ops/_build.py). x [n, hp] and
// e [V, hp] with hp a multiple of 8 (TMA's 16-byte row strides; the wrapper
// pads h with zero columns), tgt [n] int32.
//
// Forward: m_part, l_part, p_part (and s_part, or null without label
// smoothing) [n_slices, n] fp32.
extern "C" int apex_lm_head_ce_sm90_fwd(const void* x, const void* e,
                                        const void* tgt, void* m_part,
                                        void* l_part, void* p_part,
                                        void* s_part, int n, int V, int hp,
                                        int n_slices, int dtype,
                                        void* stream) {
  if (n <= 0 || V <= 0) return cudaSuccess;
  if (hp % 8 != 0 || n_slices <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return fwd<__nv_bfloat16>(x, e, tgt, m_part, l_part, p_part, s_part, n,
                                V, hp, n_slices, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return fwd<__half>(x, e, tgt, m_part, l_part, p_part, s_part, n, V, hp,
                         n_slices, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward: m, l (the combined statistics) and dl (dloss) [n] fp32; g the
// workspace [chunk, vs] in the operands' dtype (vs: V rounded up to 8);
// de_acc [V, hp] fp32 when n > chunk (else may be null); writes de [V, hp]
// and dx [n, hp] (every element), chunk by chunk of `chunk` tokens.
extern "C" int apex_lm_head_ce_sm90_bwd(const void* x, const void* e,
                                        const void* tgt, const void* m,
                                        const void* l, const void* dl,
                                        void* g, void* de_acc, void* de,
                                        void* dx, int n, int V, int hp,
                                        int vs, int chunk, float ls,
                                        float ls_over_v, int dtype,
                                        void* stream) {
  if (n <= 0 || V <= 0) return cudaSuccess;
  if (hp % 8 != 0 || vs % 8 != 0 || vs < V || chunk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return bwd<__nv_bfloat16>(x, e, tgt, m, l, dl, g, de_acc, de, dx, n, V,
                                hp, vs, chunk, ls, ls_over_v, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return bwd<__half>(x, e, tgt, m, l, dl, g, de_acc, de, dx, n, V, hp,
                         vs, chunk, ls, ls_over_v, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

// The GEMM core alone: c [M, N] fp32 = A B with A [M, K] (a_mn 0) or
// [K, M] (a_mn 1) and B [N, K] (b_mn 0) or [K, N] (b_mn 1); M, N, K
// multiples of 8.
extern "C" int apex_wgmma_probe(const void* a, const void* b, void* c, int M,
                                int N, int K, int a_mn, int b_mn, int dtype,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return probe_of<__nv_bfloat16>(a, b, c, M, N, K, a_mn, b_mn, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return probe_of<__half>(a, b, c, M, N, K, a_mn, b_mn, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}
