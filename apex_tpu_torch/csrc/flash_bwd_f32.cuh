// Flash-attention backward for fp32 operands (O0) on the CUDA cores of
// Hopper (sm_90a): the kernels of flash_bwd.cu's fp32 route at head dims
// 64 and 128, on the register-blocked FFMA form of simt_f32.cuh. Included
// by flash_bwd.cu and built into its fp32 target.
//
// - flash_bwd_f32_kernel replaces `_bwd_fused_kernel`
//   (apex_tpu/ops/flash_attention.py:604, launched by `_flash_bwd_impl`
//   :787), the single pass: dk and dv, and each key block's share of dq
//   added into a zeroed fp32 workspace in a fixed order (turns.cuh);
// - flash_dkdv_f32_kernel replaces `_dkdv_kernel` (:558, launched at
//   :805), the split's dk/dv half;
// - flash_dq_f32_kernel replaces `_dq_kernel` (:671, launched at :820),
//   the split's dq half: a query-side block (its design below, before the
//   kernel).
//
// Numerics: every product is an fmaf of fp32 operands, summed in a fixed
// k order (no TF32, no tensor core): dk, dv and dq are the same bits on
// every run. p = exp(s * scale - lse), zero where the mask is false (the
// end-aligned causal offset sk - sq, negative segment ids as padding), so
// padding rows (lse -1e30) add nothing; ds = p * (dp - delta); the scale
// is applied at the finish. Nothing is rounded below fp32: operands of
// mixed dtypes, whose JAX kernels round p and ds, stay on flash_bwd.cu's
// kernels (ops/flash_attention.py, f32_core_route).
//
// Bound on the H100: operations at the fp32 rate outside the tensor cores
// (67 TFLOP/s). Per live causal (q, key) pair five products of 2 d flops
// in the single pass (S, dP, dV, dK, dQ: 0.642 ms at b8 h16 s1024 d64),
// four in dk/dv (2.05 ms at b2 h16 s4096 d64).
//
// Design of the key-side kernels. A block of 256 threads owns BN keys
// (128 at d 64, 64 at d 128, where two [BN, 128] accumulators a lane
// would not fit beside the score tiles) of one (batch, head) and walks
// the query tiles of 64 rows that reach them. Per tile, with the products
// in simt_f32.cuh's form (a lane accumulates an outer product of a
// float4-loaded column of A and one of B for every k, in k order):
//   S^T = K Q^T and dP^T = V dO^T over d (a lane 8 keys x 4 queries at
//     d 64, 4 x 4 at d 128; K^T and V^T resident, Q^T and dO^T staged);
//   P^T and dS^T in registers, stored as [query][key] in shared memory;
//   dV += P^T dO and dK += dS^T Q over the tile's queries (a lane the same
//     keys x d / 16 columns, accumulated across the tiles in registers);
//   the single pass only: dQ = dS K over the block's keys (a lane 4
//     queries x d / 16 columns), added into the workspace in its turn.
// Every operand reaches the core k-row by k-row. The S and dP products
// contract over d, along which q, k, v and dO are stored: the C entry
// transposes q and dO once a call into [b, h, d, sq] copies (padded to 4
// query columns; the same prologue launch computes delta = rowsum(dO * O)
// when given the forward's output), streamed a tile at a time by 16-byte cp.async copies
// (two stages at d 64, so a tile's copies run under the previous tile's
// products; one at d 128), and each block transposes its own K and V
// into shared memory once. The other products read those transposed
// tiles "K-major": a lane's gradient columns are strided (lx + 8 jj), so
// for 4 consecutive k the 8 lanes of a quarter-warp read 8 float4s from 8
// distinct 16-byte bank groups (rows padded to an odd number of them),
// as many loads as the MN-major form. P and dS are stored with their
// 16-byte granules XOR-swizzled by (query / 4) % 8, so that the lanes
// that store a [key][query] register tile into [query][key], and the
// lanes that read dS by query rows for dQ, fall in distinct bank groups.
// Shared memory: 198.5 KB at d 64 (K^T, V^T; two stages of Q^T, dO^T;
// P, dS), 168 KB at d 128, and the single pass's dq tile (16 and 32 KB
// more): one block an SM, up to 255 registers a thread.
//
// The grid is (b h, key block): every (batch, head)'s block j runs in one
// round of b h blocks, so under a causal mask, where block j walks more
// query tiles than block j + 1, each round's blocks are of one length and
// the rounds fill the card evenly (a grid with the key blocks on its fast
// axis mixes every length in each wave and leaves a tail of the longest).
// The single pass's dq order: the key blocks that reach a query tile add
// their partials from the last down to the first, each after the one
// before it has published its sum; its grid runs the rounds in reverse
// (the shortest first), so a block waits only for one dispatched before
// it, and under a causal mask key block j + 1 reaches a tile two tiles
// (d 64) ahead of block j. The dk/dv kernel runs its rounds in order (the
// longest causal walks first) and keeps nothing beyond its own keys.
//
// Attention dropout (`_p_dp_ds`, :526-555): a variant of each kernel, the
// single pass's flash_bwd_f32_dropout_kernel and the split's
// flash_dkdv_f32_dropout_kernel and flash_dq_f32_dropout_kernel (chosen by
// the C entries when the keep threshold is not 0; the kernels without
// dropout keep their parameters and their code), regenerates the forward's
// keep bit of each (query row, key) element from dropout_hash.cuh at their
// global positions, takes dp = keep ? dp / (1 - rate) : 0 before ds = p (dp
// - delta) with the undropped p, and (the key-side kernels) stores the
// dropped p (0, or p / (1 - rate)) as P for the dV product. delta is
// rowsum(do * out) of the dropped output, as the prologue folds it from
// that output. The hash's (seed, batch, head) term is computed once a block
// and xored with the query rows' terms (the key side: a lane's four, once a
// tile; dq: a lane's rows, once a block); an element costs its key's term,
// one xor and one fmix32.
//
// The additive bias (`_recompute_p`, :500, in each backward kernel): a
// variant of each kernel, flash_bwd_f32_bias_kernel, flash_dkdv_f32_bias_
// kernel and flash_dq_f32_bias_kernel (chosen by the C entries when the
// bias pointer is not null and the keep threshold is 0), with the bias's
// fields in a parameter struct of its own (Bias: fp32 [b|1, h|1, sq, sk],
// the last two dims contiguous, batch and head strides 0 for a broadcast
// dim). Before a tile's S (S^T) product each lane loads its own elements
// of the tile's bias, times 1 / scale, into the S accumulators, which the
// product then adds to: s * scale is the biased score of the Pallas
// kernels up to one rounding, rounded (`__fmul_rn`) before lse is taken
// off, as the forward rounds it. The key-side kernels issue the loads
// before the tile's barrier, so they fly while the block waits; dq issues
// them after it (before the barrier they held S's registers across the
// ring's copies, and dq spilled at d 64). They take no register beyond
// S's (shared memory is full: no staged bias tile fits beside the
// key-side kernels' 198.5 KB or dq's 202 KB). A key-side lane's keys come
// in runs of 4 along a query row (one float4 where sk % 4 == 0, else four
// scalar loads, chosen once a call); dq's lane reads its strided keys one
// by one. Keys past sk read as 0 and rows past sq as the last row (both
// masked). A -inf bias gives p = exp(-inf) = 0 exactly. A finite bias
// takes one more rounding than the Pallas kernel's (bias / scale, then the
// sum times scale): at the -1e30 fill itself that is exact at a scale of a
// power of 2 (head dim 64) and one ulp above at head dim 128's, so a row
// whose bias is the fill on every key stays live, as in the plain version
// (ROADMAP §C).
//
// The bias with dropout (`_p_dp_ds` over `_recompute_p` with its bias,
// :500-555): a variant with both of each kernel, flash_bwd_f32_bias_
// dropout_kernel, flash_dkdv_f32_bias_dropout_kernel and flash_dq_f32_
// bias_dropout_kernel (chosen by the C entries when the bias pointer is set
// and the keep threshold is above 0; they take both structs), composes the
// two: p recomputed from the biased scores (the bias / scale in the S
// accumulators, s * scale rounded before lse is taken off), dp = keep ? dp
// / (1 - rate) : 0, ds = p (dp - delta) with the undropped p, and on the
// key side the dropped p stored as P for the dV product.

#pragma once

#include <stdint.h>

#include "dropout_hash.cuh"
#include "simt_f32.cuh"
#include "turns.cuh"

namespace fa32 {

constexpr int BQ = 64;         // query rows a tile (one turn counter each)
constexpr int LDQ = BQ + 4;    // a staged Q^T / dO^T row: 17 granules

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int THREADS = 256;             // 8 warps
  static constexpr int WK = THREADS / 64;         // warp rows (keys)
  static constexpr int BN = D == 64 ? 128 : 64;   // keys a block
  static constexpr int SK = BN / (4 * WK);        // a lane's keys
  static_assert(SK % 4 == 0, "a lane's keys come in runs of 4");
  static constexpr int GC = D / 16;               // a lane's gradient cols
  static constexpr int STAGES = D == 64 ? 2 : 1;  // Q^T / dO^T stages
  static constexpr int LDK = BN + 4;              // odd count of granules
  static constexpr int KT = D * LDK;              // floats of K^T (V^T)
  static constexpr int QT = D * LDQ;              // floats of Q^T (dO^T)
  static constexpr int PS = BQ * BN;              // floats of P (dS)
  static constexpr int DQ = BQ * D;               // floats of a dq tile
  // the dk/dv kernel's; the single pass stages a dq tile after them
  static constexpr size_t SMEM_BYTES =
      (size_t)(2 * KT + 2 * STAGES * QT + 2 * PS) * 4 + (size_t)BN * 4;
};

struct Params {
  const float* k;        // [b, h, sk, D]
  const float* v;
  const float* qt;       // [b, h, D, sqp]: q transposed, zero past sq
  const float* dot;      // dout, the same
  const float* lse;      // [b, h, sq]
  const float* delta;
  const int32_t* sid_q;  // [b, sq] and [b, sk], or null
  const int32_t* sid_kv;
  float* dq_acc;         // [b, h, sq, D] (the single pass; every element
                         // written: the first contributor stores)
  int* turns;            // [b, h, ceil(sq / 64)], zeroed (the single pass)
  float* dk;             // [b, h, sk, D]
  float* dv;
  int h, sq, sk, sqp, causal;
  float scale;
};

// the dropout variants' own parameters: the seed, the keep threshold and
// 1 / (1 - rate) (the kernels without dropout take Params alone)
struct Dropout {
  uint32_t seed, threshold;
  float inv;
};

// the bias variants' own parameters: the fp32 bias, its batch and head
// strides in elements (0 for a broadcast dim) and 1 / scale
struct Bias {
  const float* bias;
  long sb, sh;
  float inv_scale;
};

// element (query, key) of a [BQ][BN] tile: 16-byte granules XOR-swizzled
// by (query / 4) % 8
template <int BN>
__device__ __forceinline__ int swz(int q, int granule) {
  return q * BN + ((granule ^ ((q >> 2) & 7)) << 2);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// a turn counter's value, read without ordering (the acquire is a fence
// after it, once the value is the awaited one)
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}
__device__ __forceinline__ void add_relaxed(int* p) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
}
// generic-proxy writes to shared memory become visible to the async proxy
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// dst[i] += src[i] (add) or dst[i] = src[i] for the `bytes` / 4 floats at
// src (shared memory): one bulk reduction or copy of the async proxy, in
// the thread's bulk group
__device__ __forceinline__ void bulk_put(float* dst, const float* src,
                                         int bytes, bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
        "[%1], %2;\n" ::"l"(dst),
        "r"(simt::smem_addr(src)), "r"(bytes)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(simt::smem_addr(src)), "r"(bytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk reductions have read their shared memory / completed
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int D, bool WITH_DQ, bool DROP, bool BIAS>
__device__ __forceinline__ void kv_block(float* smem, const Params& p,
                                         const Dropout& dr, const Bias& bs) {
  using C = Cfg<D>;
  constexpr int BN = C::BN, SK = C::SK, GC = C::GC, LDK = C::LDK;
  constexpr int THREADS = C::THREADS;
  float* sKt = smem;                          // [D][LDK]
  float* sVt = sKt + C::KT;
  float* sQ0 = sVt + C::KT;                   // stage s: Q^T then dO^T
  float* sP = sQ0 + 2 * C::STAGES * C::QT;    // [BQ][BN], swizzled
  float* sdS = sP + C::PS;
  int* sSidK = reinterpret_cast<int*>(sdS + C::PS);
  float* sDQ = reinterpret_cast<float*>(sSidK + BN);   // [BQ][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ly = lane / 8, lx = lane % 8;
  const int n_kb = gridDim.y;
  const int j = WITH_DQ ? n_kb - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int n0 = j * BN;
  const long bh = blockIdx.x;
  const int bi = (int)(bh / p.h);
  const int sq = p.sq, sk = p.sk, off = sk - sq;
  const bool seg = p.sid_q != nullptr;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? max(0, n0 - off) / BQ : 0;

  // lane maps: keys (S/dP and dK/dV), queries (S/dP), gradient columns
  // (dK/dV, dQ), query rows (dQ)
  const int kw = (warp / 2) * 4 * SK + 4 * ly;   // + 16 (i / 4) + i % 4
  const int qw = (warp % 2) * 32 + 4 * lx;       // + j
  const int cw = (warp % 2) * (D / 2) + lx;      // + 8 jj
  constexpr int QR = BQ / (4 * C::WK);           // a lane's dQ rows
  const int rw = (warp / 2) * 4 * QR + QR * ly;  // + ii

  const float* qtb = p.qt + bh * D * p.sqp;
  const float* dtb = p.dot + bh * D * p.sqp;
  auto load_tile = [&](int qt, int stage) {
    float* dq_ = sQ0 + stage * 2 * C::QT;
    float* dd_ = dq_ + C::QT;
    const int q0 = qt * BQ;
#pragma unroll
    for (int i = 0; i < D * (BQ / 4) / THREADS; ++i) {
      const int c = tid + THREADS * i;
      const int r = c / (BQ / 4), col = 4 * (c % (BQ / 4));
      const bool ok = q0 + col < p.sqp;
      const long g = (long)r * p.sqp + q0 + col;
      simt::copy16(dq_ + r * LDQ + col, ok ? qtb + g : qtb, ok);
      simt::copy16(dd_ + r * LDQ + col, ok ? dtb + g : dtb, ok);
    }
    simt::commit();
  };
  if (qt0 < n_qt) load_tile(qt0, 0);

  // K and V of the block's keys, transposed into shared memory (zeros
  // past sk): consecutive threads on consecutive keys
#pragma unroll
  for (int i = 0; i < BN * (D / 4) / THREADS; ++i) {   // loads in flight
    const int idx = tid + THREADS * i;
    const int key = idx % BN, c4 = 4 * (idx / BN);
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (n0 + key < sk) {
      const long g = (bh * sk + n0 + key) * D + c4;
      kv = __ldg(reinterpret_cast<const float4*>(p.k + g));
      vv = __ldg(reinterpret_cast<const float4*>(p.v + g));
    }
    sKt[(c4 + 0) * LDK + key] = kv.x;
    sKt[(c4 + 1) * LDK + key] = kv.y;
    sKt[(c4 + 2) * LDK + key] = kv.z;
    sKt[(c4 + 3) * LDK + key] = kv.w;
    sVt[(c4 + 0) * LDK + key] = vv.x;
    sVt[(c4 + 1) * LDK + key] = vv.y;
    sVt[(c4 + 2) * LDK + key] = vv.z;
    sVt[(c4 + 3) * LDK + key] = vv.w;
  }
  for (int r = tid; r < BN; r += THREADS)
    sSidK[r] = (seg && n0 + r < sk) ? p.sid_kv[(long)bi * sk + n0 + r] : -1;

  float dka[SK][GC], dva[SK][GC];
#pragma unroll
  for (int i = 0; i < SK; ++i)
#pragma unroll
    for (int c = 0; c < GC; ++c) dka[i][c] = dva[i][c] = 0.f;
  int* passed = nullptr;   // thread 0: the turn its last reduction holds

  // the bias variant: the (batch, head)'s [sq, sk] slice; the tile's bias /
  // scale into S^T's accumulators (element [i][jq]: key n0 + kw + 16 (i /
  // 4) + i % 4, query q0 + qw + jq; a run of 4 keys one float4 where sk %
  // 4 == 0, else four loads; keys past sk read as 0, rows past sq as the
  // last: both masked)
  const float* bias_bh = nullptr;
  if constexpr (BIAS)
    bias_bh = bs.bias + (long)bi * bs.sb + (bh - (long)bi * p.h) * bs.sh;
  auto bias_into = [&](float (&s_)[SK][4], int q0_) {
    const bool vec = (sk & 3) == 0;
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
      const float* row = bias_bh + (long)min(q0_ + qw + jq, sq - 1) * sk;
#pragma unroll
      for (int g = 0; g < SK / 4; ++g) {
        const int key = n0 + kw + 16 * g;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (vec) {
          if (key < sk) v = __ldg(reinterpret_cast<const float4*>(row + key));
        } else {
          if (key < sk) v.x = __ldg(row + key);
          if (key + 1 < sk) v.y = __ldg(row + key + 1);
          if (key + 2 < sk) v.z = __ldg(row + key + 2);
          if (key + 3 < sk) v.w = __ldg(row + key + 3);
        }
        s_[4 * g][jq] = v.x * bs.inv_scale;
        s_[4 * g + 1][jq] = v.y * bs.inv_scale;
        s_[4 * g + 2][jq] = v.z * bs.inv_scale;
        s_[4 * g + 3][jq] = v.w * bs.inv_scale;
      }
    }
  };

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    const int stage = C::STAGES == 2 ? (qt - qt0) & 1 : 0;
    const float* sQt = sQ0 + stage * 2 * C::QT;
    const float* sDOt = sQt + C::QT;
    float s[SK][4], dp[SK][4];
    if constexpr (BIAS) bias_into(s, q0);   // in flight over the barrier
    simt::wait_groups<0>();
    if (WITH_DQ && tid == 0) bulk_wait_read();   // sDQ is free again
    __syncthreads();   // the tile is in; every thread is done with the last
    if (C::STAGES == 2 && qt + 1 < n_qt) load_tile(qt + 1, stage ^ 1);

    // the lane's query rows: lse, delta, segment ids (used after S, dP);
    // dropout: the hash's (seed, batch, head) and row terms
    float lse_r[4], dl_r[4];
    int sid_r[4];
    uint32_t hq[4];
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
      const int qr = q0 + qw + jq;
      const bool in = qr < sq;
      lse_r[jq] = in ? __ldg(p.lse + bh * sq + qr) : 0.f;
      dl_r[jq] = in ? __ldg(p.delta + bh * sq + qr) : 0.f;
      sid_r[jq] = (seg && in) ? __ldg(p.sid_q + (long)bi * sq + qr) : -1;
      if constexpr (DROP)
        hq[jq] = dropout::base(dr.seed, (uint32_t)bi,
                               (uint32_t)(bh - (long)bi * p.h)) ^
                 dropout::q_term(qr);
    }

    // ---- S^T = K Q^T and dP^T = V dO^T over d (the bias variant's S^T
    // adds to the bias / scale)
#pragma unroll
    for (int i = 0; i < SK; ++i)
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        if constexpr (BIAS)
          dp[i][jq] = 0.f;
        else
          s[i][jq] = dp[i][jq] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < D; ++kk) {
      float ak[SK], av[SK];
#pragma unroll
      for (int g = 0; g < SK / 4; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(
            sKt + kk * LDK + kw + 16 * g);
        const float4 b = *reinterpret_cast<const float4*>(
            sVt + kk * LDK + kw + 16 * g);
        ak[4 * g] = a.x; ak[4 * g + 1] = a.y;
        ak[4 * g + 2] = a.z; ak[4 * g + 3] = a.w;
        av[4 * g] = b.x; av[4 * g + 1] = b.y;
        av[4 * g + 2] = b.z; av[4 * g + 3] = b.w;
      }
      const float4 bq =
          *reinterpret_cast<const float4*>(sQt + kk * LDQ + qw);
      const float4 bd =
          *reinterpret_cast<const float4*>(sDOt + kk * LDQ + qw);
      const float vq[4] = {bq.x, bq.y, bq.z, bq.w};
      const float vd[4] = {bd.x, bd.y, bd.z, bd.w};
#pragma unroll
      for (int i = 0; i < SK; ++i)
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          s[i][jq] = fmaf(ak[i], vq[jq], s[i][jq]);
          dp[i][jq] = fmaf(av[i], vd[jq], dp[i][jq]);
        }
    }

    // ---- mask, p = exp(s * scale - lse), ds = p * (dp - delta) (with
    // dropout dp kept and scaled, P dropped); stored as [query][key]
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
      const int ql = qw + jq, qr = q0 + ql;
#pragma unroll
      for (int i = 0; i < SK; ++i) {
        const int kl = kw + 16 * (i / 4) + i % 4, key = n0 + kl;
        bool ok = qr < sq && key < sk && (!p.causal || key <= qr + off);
        if (seg) ok = ok && sid_r[jq] >= 0 && sid_r[jq] == sSidK[kl];
        // the bias variant rounds s * scale before lse is taken off, as
        // the forward's score is rounded (a huge biased score, the -1e30
        // fill, would otherwise keep its product's rounding error)
        float pv;
        if constexpr (BIAS)
          pv = ok ? __expf(__fmul_rn(s[i][jq], p.scale) - lse_r[jq]) : 0.f;
        else
          pv = ok ? __expf(s[i][jq] * p.scale - lse_r[jq]) : 0.f;
        if constexpr (DROP) {   // dV takes p dropped, ds p undropped
          const bool kept = dropout::keep(hq[jq] ^ dropout::k_term(key),
                                          dr.threshold);
          dp[i][jq] = pv * ((kept ? dp[i][jq] * dr.inv : 0.f) - dl_r[jq]);
          s[i][jq] = kept ? pv * dr.inv : 0.f;
        } else {
          s[i][jq] = pv;
          dp[i][jq] = pv * (dp[i][jq] - dl_r[jq]);
        }
      }
#pragma unroll
      for (int g = 0; g < SK / 4; ++g) {
        const int e = swz<BN>(ql, (kw + 16 * g) >> 2);
        *reinterpret_cast<float4*>(sP + e) =
            make_float4(s[4 * g][jq], s[4 * g + 1][jq], s[4 * g + 2][jq],
                        s[4 * g + 3][jq]);
        *reinterpret_cast<float4*>(sdS + e) =
            make_float4(dp[4 * g][jq], dp[4 * g + 1][jq], dp[4 * g + 2][jq],
                        dp[4 * g + 3][jq]);
      }
    }
    __syncthreads();

    // ---- dV += P^T dO, dK += dS^T Q over the tile's queries (dO and Q
    // read K-major from their transposed tiles)
#pragma unroll 2
    for (int q4 = 0; q4 < BQ / 4; ++q4) {
      float4 bd[GC], bq[GC];
#pragma unroll
      for (int c = 0; c < GC; ++c) {
        bd[c] = *reinterpret_cast<const float4*>(
            sDOt + (cw + 8 * c) * LDQ + 4 * q4);
        bq[c] = *reinterpret_cast<const float4*>(
            sQt + (cw + 8 * c) * LDQ + 4 * q4);
      }
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int ql = 4 * q4 + qq;
        float pa[SK], da[SK];
#pragma unroll
        for (int g = 0; g < SK / 4; ++g) {
          const int e = swz<BN>(ql, (kw + 16 * g) >> 2);
          const float4 a = *reinterpret_cast<const float4*>(sP + e);
          const float4 b = *reinterpret_cast<const float4*>(sdS + e);
          pa[4 * g] = a.x; pa[4 * g + 1] = a.y;
          pa[4 * g + 2] = a.z; pa[4 * g + 3] = a.w;
          da[4 * g] = b.x; da[4 * g + 1] = b.y;
          da[4 * g + 2] = b.z; da[4 * g + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < SK; ++i)
#pragma unroll
          for (int c = 0; c < GC; ++c) {
            dva[i][c] = fmaf(pa[i], at(bd[c], qq), dva[i][c]);
            dka[i][c] = fmaf(da[i], at(bq[c], qq), dka[i][c]);
          }
      }
    }

    if (C::STAGES == 1 && qt + 1 < n_qt) {
      __syncthreads();   // every thread is done with the stage
      load_tile(qt + 1, 0);
    }

    if constexpr (WITH_DQ) {
      // ---- dQ = dS K over the block's keys (dS read K-major by query
      // rows, K K-major from K^T); the tile's turn counter read meanwhile
      int* turn = p.turns + bh * n_qt + qt;
      const int mine =
          (p.causal ? min(n_kb - 1, (q0 + BQ - 1 + off) / BN) : n_kb - 1) -
          j;
      int seen = tid == 0 ? load_relaxed(turn) : mine;
      float dqa[QR][GC];
#pragma unroll
      for (int ii = 0; ii < QR; ++ii)
#pragma unroll
        for (int c = 0; c < GC; ++c) dqa[ii][c] = 0.f;
#pragma unroll 4
      for (int k4 = 0; k4 < BN / 4; ++k4) {
        float4 a[QR], b[GC];
#pragma unroll
        for (int ii = 0; ii < QR; ++ii)
          a[ii] = *reinterpret_cast<const float4*>(sdS + swz<BN>(rw + ii, k4));
#pragma unroll
        for (int c = 0; c < GC; ++c)
          b[c] = *reinterpret_cast<const float4*>(sKt + (cw + 8 * c) * LDK +
                                                  4 * k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int ii = 0; ii < QR; ++ii)
#pragma unroll
            for (int c = 0; c < GC; ++c)
              dqa[ii][c] = fmaf(at(a[ii], kk), at(b[c], kk), dqa[ii][c]);
      }
      // ---- the block's turn on this tile: the key blocks that reach it
      // add in descending order, the last (causal: min(n_kb - 1, the
      // tile's last row + offset over BN)) first. The partial is staged in
      // shared memory and stored (the first) or added (the others: an fp32
      // add an element at L2) by one bulk copy or reduction that thread 0
      // issues in the block's turn; it passes the turn at the next tile's
      // (or the walk's end), once the copy has long completed, so no warp
      // waits for it here
#pragma unroll
      for (int ii = 0; ii < QR; ++ii)
#pragma unroll
        for (int c = 0; c < GC; ++c)
          sDQ[(rw + ii) * D + cw + 8 * c] = dqa[ii][c] * p.scale;
      fence_proxy_async_shared();
      __syncthreads();
      if (tid == 0) {
        bulk_wait();               // the last tile's reduction completed
        while (seen != mine) {     // seldom: the blocks after run ahead
          __nanosleep(64);
          seen = load_relaxed(turn);
        }
        // acquire (this tile's predecessors' sums) and release (the last
        // tile's sum, then its turn passes) in one fence, the async
        // proxy's accesses ordered on both sides of it
        turns::fence_async_global();
        fence_acq_rel();
        if (passed != nullptr) add_relaxed(passed);
        turns::fence_async_global();
        bulk_put(p.dq_acc + (bh * sq + q0) * D, sDQ,
                 min(BQ, sq - q0) * D * 4, mine > 0);
        passed = turn;
      }
    }
  }
  if (WITH_DQ && tid == 0 && passed != nullptr) {
    bulk_wait();
    turns::fence_async_global();
    fence_acq_rel();
    add_relaxed(passed);
  }

  // ---- finish: dk (scaled) and dv of the lane's keys and columns
#pragma unroll
  for (int i = 0; i < SK; ++i) {
    const int key = n0 + kw + 16 * (i / 4) + i % 4;
    if (key < sk) {
      float* dkr = p.dk + (bh * sk + key) * D + cw;
      float* dvr = p.dv + (bh * sk + key) * D + cw;
#pragma unroll
      for (int c = 0; c < GC; ++c) {
        dkr[8 * c] = dka[i][c] * p.scale;
        dvr[8 * c] = dva[i][c];
      }
    }
  }
}

// The call's prologue, one launch: q and dout [n][rows][D] transposed into
// q_t and do_t [n][D][rows_p] (zeros for rows in [rows, rows_p), rows_p a
// multiple of 4), and, given the forward's output (o non-null), delta =
// rowsum(dout * o) into delta [n][rows] (fp32, each row's D products
// summed in a fixed order: four by a thread, then a butterfly over the
// D / 4 lanes that hold the row). Given dq (non-null), it also zeroes its
// first zero_rows rows of each matrix: the rows no key block reaches (a
// causal mask with sq > sk), whose tiles no block stores. grid (2 n, row
// blocks of 64): x < n transposes q, x >= n dout (and delta, and dq's
// rows). A thread moves float4s, D / 16 in and D / 16 out.
template <int D>
__global__ void __launch_bounds__(256)
flash_f32_prologue_kernel(const float* __restrict__ q,
                          const float* __restrict__ dout,
                          const float* __restrict__ o,
                          float* __restrict__ q_t, float* __restrict__ do_t,
                          float* __restrict__ delta, float* __restrict__ dq,
                          int zero_rows, int n, int rows, int rows_p) {
  constexpr int L = D / 4;           // lanes of one row
  __shared__ float t[D][65];
  const bool second = (long)blockIdx.x >= n;
  const long m = second ? (long)blockIdx.x - n : (long)blockIdx.x;
  const float* in = (second ? dout : q) + m * rows * D;
  float* out = (second ? do_t : q_t) + m * D * rows_p;
  const int r0 = blockIdx.y * 64;
  const bool fold = second && o != nullptr;
#pragma unroll
  for (int i = 0; i < 64 * L / 256; ++i) {
    const int idx = threadIdx.x + 256 * i, r = idx / L, c = 4 * (idx % L);
    const int row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows)
      v = __ldg(reinterpret_cast<const float4*>(in + (long)row * D + c));
    t[c][r] = v.x;
    t[c + 1][r] = v.y;
    t[c + 2][r] = v.z;
    t[c + 3][r] = v.w;
    if (second && dq != nullptr && row < zero_rows)
      *reinterpret_cast<float4*>(dq + (m * rows + row) * D + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    if (fold) {
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows)
        w = __ldg(reinterpret_cast<const float4*>(o + (m * rows + row) * D +
                                                  c));
      float sum = fmaf(v.w, w.w, fmaf(v.z, w.z, fmaf(v.y, w.y, v.x * w.x)));
#pragma unroll
      for (int off = 1; off < L; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (c == 0 && row < rows) delta[m * rows + row] = sum;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 64 * L / 256; ++i) {
    const int idx = threadIdx.x + 256 * i, c = idx / 16, r = 4 * (idx % 16);
    if (r0 + r < rows_p)
      *reinterpret_cast<float4*>(out + (long)c * rows_p + r0 + r) =
          make_float4(t[c][r], t[c][r + 1], t[c][r + 2], t[c][r + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_bwd_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, true, false, false>(smem, p, Dropout{}, Bias{});
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_bwd_f32_dropout_kernel(const Params p, const Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, true, true, false>(smem, p, dr, Bias{});
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_bwd_f32_bias_kernel(const Params p, const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, true, false, true>(smem, p, Dropout{}, bs);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_dkdv_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, false, false, false>(smem, p, Dropout{}, Bias{});
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_dkdv_f32_dropout_kernel(const Params p, const Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, false, true, false>(smem, p, dr, Bias{});
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_dkdv_f32_bias_kernel(const Params p, const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, false, false, true>(smem, p, Dropout{}, bs);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_bwd_f32_bias_dropout_kernel(const Params p, const Dropout dr,
                                  const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, true, true, true>(smem, p, dr, bs);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_dkdv_f32_bias_dropout_kernel(const Params p, const Dropout dr,
                                   const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  kv_block<D, false, true, true>(smem, p, dr, bs);
}

// `kernel` over `grid` with `smem` bytes of dynamic shared memory
template <typename... Params_, typename... Args>
cudaError_t start(void (*kernel)(Params_...), dim3 grid, int threads,
                  size_t smem, cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// q and dout [b h, sq, D] transposed into ws [2][b h][D][sqp] (and, given
// the forward's output o, delta into p.delta), then one of the kernels over
// grid (b h, key blocks): the single pass (WITH_DQ) or the split's dk/dv,
// or their dropout variant where dr.threshold is not 0, their bias variant
// where bs.bias is set, or their variant with both where both are
template <int D, bool WITH_DQ>
cudaError_t launch(const float* q, const float* dout, const float* o,
                   float* ws, Params p, const Dropout& dr, const Bias& bs,
                   int b, cudaStream_t stream) {
  const int bh = b * p.h;
  p.sqp = (p.sq + 3) & ~3;
  float* qt = ws;
  float* dot = ws + (long)bh * D * p.sqp;
  p.qt = qt;
  p.dot = dot;
  if (p.sq > 0) {
    flash_f32_prologue_kernel<D><<<dim3(2 * bh, (p.sqp + 63) / 64), 256,
                                   0, stream>>>(
        q, dout, o, qt, dot, const_cast<float*>(p.delta),
        WITH_DQ ? p.dq_acc : nullptr,
        p.causal ? min(p.sq, max(0, p.sq - p.sk)) : 0, bh, p.sq, p.sqp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = Cfg<D>::SMEM_BYTES + (WITH_DQ ? Cfg<D>::DQ * 4 : 0);
  const dim3 grid(bh, (p.sk + Cfg<D>::BN - 1) / Cfg<D>::BN);
  constexpr int T = Cfg<D>::THREADS;
  if (dr.threshold != 0 && bs.bias != nullptr)
    return start(WITH_DQ ? flash_bwd_f32_bias_dropout_kernel<D>
                         : flash_dkdv_f32_bias_dropout_kernel<D>,
                 grid, T, smem, stream, p, dr, bs);
  if (dr.threshold != 0)
    return start(WITH_DQ ? flash_bwd_f32_dropout_kernel<D>
                         : flash_dkdv_f32_dropout_kernel<D>,
                 grid, T, smem, stream, p, dr);
  if (bs.bias != nullptr)
    return start(WITH_DQ ? flash_bwd_f32_bias_kernel<D>
                         : flash_dkdv_f32_bias_kernel<D>,
                 grid, T, smem, stream, p, bs);
  return start(WITH_DQ ? flash_bwd_f32_kernel<D> : flash_dkdv_f32_kernel<D>,
               grid, T, smem, stream, p);
}

// ---------------------------------------------------------------------------
// The split's dq: flash_dq_f32_kernel replaces `_dq_kernel` (:671,
// launched at :820), a query-side block.
//
// Bound: three products of 2 d flops a live pair (S, dP, dQ), 1.54 ms at
// b2 h16 s4096 d64 causal.
//
// A block of 256 threads owns BQ query rows of one (batch, head) (128 at
// d 64, 64 at d 128) and streams the key tiles of 64 that reach them
// through a cp.async ring (3 stages at d 64, 2 at d 128: shared memory).
// Q^T and dO^T of its rows are resident: the [b h, D, sqp] copies the
// split's dk/dv prologue wrote (called alone, the call's own prologue
// writes them). Per key tile, in simt_f32.cuh's form C = A^T B:
//   S = Q K^T and dP = dO V^T over d: A = Q^T, dO^T (k-row by k-row);
//     B = K, V read "K-major" from their own [key][d] tiles, a float4
//     along d for each of a lane's strided keys (lx + 8 j; rows padded to
//     an odd count of 16-byte granules, so a quarter-warp's 8 float4s hit
//     8 bank groups);
//   dS = P o (dP - delta), P = exp(S scale - lse) where the mask holds, in
//     registers, stored [key][query] (rows of odd granule counts: the 8
//     keys of a quarter-warp's stores fall in 8 bank groups);
//   dQ += dS K over the tile's keys: A = dS [key][query], B = K [key][d]
//     in its own layout (MN-major, k = key).
// So K and V are never transposed. A warp owns 16 QI query rows and half
// of the tile's keys (S, dP) or half of dq's columns (dQ): the two warps
// of a warp row exchange dS through a named barrier of 64 threads. dq is
// written once, from registers, times scale: no atomics, no turns, the
// same bits on every run. Under a causal mask a warp row skips the key
// tiles its rows see no key of. The grid is (b h, query tile), the query
// tiles in reverse under a causal mask: each round of b h blocks walks one
// length of keys, the longest first. 8 warps of up to 255 registers and
// 202 KB (d 64) or 217.5 KB (d 128) of shared memory: one block an SM
// (4-warp blocks of 32-key tiles, two an SM, were slower).
// ---------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int THREADS = 256;   // 4 warp rows x 2 warps
  static constexpr int BQ = D == 64 ? 128 : 64;   // resident query rows
  static constexpr int BN = 64;                   // keys a streamed tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int QI = BQ / 64;   // a lane's runs of 4 query rows
  static constexpr int KJ = 4;         // a lane's keys of S, dP: lx + 8 j
  static constexpr int CJ = D / 64;    // a lane's runs of 4 dq columns
  static constexpr int LDQ = BQ + 4;   // Q^T, dO^T, dS rows: odd granules
  static constexpr int LDK = D + 4;    // K, V rows
  static constexpr int QT = D * LDQ;   // floats of Q^T (dO^T)
  static constexpr int KV = BN * LDK;  // floats of a K (V) tile
  static constexpr int DS = BN * LDQ;  // floats of dS
  static constexpr size_t SMEM_BYTES =
      (size_t)(2 * QT + STAGES * 2 * KV + DS) * 4 + (size_t)STAGES * BN * 4;
};

// the threads of warp row `row` (two warps) meet: named barrier 1 + row
__device__ __forceinline__ void pair_sync(int row) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + row) : "memory");
}

// The dq kernel's body: without a variant, with dropout (DROP: dp kept and
// scaled before ds, as the key-side kernels take it) or with the bias
// (BIAS: the tile's bias / scale loaded into S's accumulators)
template <int D, bool DROP, bool BIAS>
__device__ __forceinline__ void dq_block(float* smem, const Params& p,
                                         float* __restrict__ dq,
                                         const Dropout& dr, const Bias& bs) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BN = C::BN, QI = C::QI, KJ = C::KJ, CJ = C::CJ;
  constexpr int LDQ = C::LDQ, LDK = C::LDK, STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS;
  float* sQt = smem;                          // [D][LDQ]
  float* sDt = sQt + C::QT;
  float* sKV = sDt + C::QT;                   // stage s: K, then V
  float* sdS = sKV + STAGES * 2 * C::KV;      // [BN][LDQ]
  int* sSid = reinterpret_cast<int*>(sdS + C::DS);   // [STAGES][BN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ly = lane / 8, lx = lane % 8;
  const int wq = warp / 2, wk = warp % 2;
  const long bh = blockIdx.x;
  const int bi = (int)(bh / p.h);
  const int sq = p.sq, sk = p.sk, off = sk - sq;
  const int n_qt = gridDim.y;
  const int qt = p.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const bool seg = p.sid_q != nullptr;
  const int n_kt = (sk + BN - 1) / BN;
  int kt_end = n_kt;
  if (p.causal) {   // the tile's last row's last key
    const int last = min(sq - 1, q0 + BQ - 1) + off;
    kt_end = last < 0 ? 0 : min(n_kt, last / BN + 1);
  }

  // lane maps: query rows (S, dP and dQ), keys (S, dP), dq columns
  const int qw = wq * 16 * QI + 4 * ly;   // + 16 i + 0..3
  const int kw = wk * 8 * KJ + lx;        // + 8 j
  const int cw = wk * 32 * CJ + 4 * lx;   // + 32 j + 0..3

  auto load_kv = [&](int kt, int stage) {
    float* sk_ = sKV + stage * 2 * C::KV;
    float* sv_ = sk_ + C::KV;
    const int n0 = kt * BN;
#pragma unroll
    for (int i = 0; i < BN * (D / 4) / THREADS; ++i) {
      const int c = tid + THREADS * i;
      const int r = c / (D / 4), col = 4 * (c % (D / 4));
      const bool ok = n0 + r < sk;
      const long g = (bh * sk + n0 + r) * D + col;
      simt::copy16(sk_ + r * LDK + col, ok ? p.k + g : p.k, ok);
      simt::copy16(sv_ + r * LDK + col, ok ? p.v + g : p.v, ok);
    }
    if (seg && tid < BN) {
      const bool ok = n0 + tid < sk;
      simt::copy4(sSid + stage * BN + tid,
            ok ? p.sid_kv + (long)bi * sk + n0 + tid : p.sid_kv, ok);
    }
  };

  // group 0: Q^T and dO^T of the block's rows (zeros past sqp) and the
  // first key tile; then the ring's other stages but one
  if (kt_end > 0) {
    const float* qtb = p.qt + bh * D * p.sqp;
    const float* dtb = p.dot + bh * D * p.sqp;
#pragma unroll
    for (int i = 0; i < D * (BQ / 4) / THREADS; ++i) {
      const int c = tid + THREADS * i;
      const int r = c / (BQ / 4), col = 4 * (c % (BQ / 4));
      const bool ok = q0 + col < p.sqp;
      const long g = (long)r * p.sqp + q0 + col;
      simt::copy16(sQt + r * LDQ + col, ok ? qtb + g : qtb, ok);
      simt::copy16(sDt + r * LDQ + col, ok ? dtb + g : dtb, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_end) load_kv(s, s);
    simt::commit();
  }

  // the lane's query rows: lse, delta, segment ids
  float lse_r[4 * QI], dl_r[4 * QI];
  int sid_r[4 * QI];
#pragma unroll
  for (int r = 0; r < 4 * QI; ++r) {
    const int qr = q0 + qw + 16 * (r / 4) + r % 4;
    const bool in = qr < sq;
    lse_r[r] = in ? __ldg(p.lse + bh * sq + qr) : 0.f;
    dl_r[r] = in ? __ldg(p.delta + bh * sq + qr) : 0.f;
    sid_r[r] = (seg && in) ? __ldg(p.sid_q + (long)bi * sq + qr) : -1;
  }
  // dropout: the hash's (seed, batch, head) term with each row's, once a
  // block
  uint32_t hq[4 * QI];
  if constexpr (DROP) {
    const uint32_t hb =
        dropout::base(dr.seed, (uint32_t)bi, (uint32_t)(bh - (long)bi * p.h));
#pragma unroll
    for (int r = 0; r < 4 * QI; ++r)
      hq[r] = hb ^ dropout::q_term(q0 + qw + 16 * (r / 4) + r % 4);
  }
  // the bias: the (batch, head)'s [sq, sk] slice; a tile's bias / scale
  // into S's accumulators (element [r][j]: row q0 + qw + 16 (r / 4) + r %
  // 4, key n0 + kw + 8 j; keys past sk read as 0, rows past sq as the last:
  // both masked)
  const float* bias_bh = nullptr;
  if constexpr (BIAS)
    bias_bh = bs.bias + (long)bi * bs.sb + (bh - (long)bi * p.h) * bs.sh;
  auto bias_into = [&](float (&s_)[4 * QI][KJ], int n0) {
#pragma unroll
    for (int r = 0; r < 4 * QI; ++r) {
      const float* row =
          bias_bh + (long)min(q0 + qw + 16 * (r / 4) + r % 4, sq - 1) * sk;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = n0 + kw + 8 * j;
        s_[r][j] = (key < sk ? __ldg(row + key) : 0.f) * bs.inv_scale;
      }
    }
  };

  float dqa[4 * QI][4 * CJ];
#pragma unroll
  for (int r = 0; r < 4 * QI; ++r)
#pragma unroll
    for (int c = 0; c < 4 * CJ; ++c) dqa[r][c] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt % STAGES;
    simt::wait_groups<STAGES - 2>();
    __syncthreads();   // the tile is in; every thread is done with kt - 1
    {
      const int nxt = kt + STAGES - 1;
      if (nxt < kt_end) load_kv(nxt, nxt % STAGES);
      simt::commit();
    }
    const int n0 = kt * BN;
    // under a causal mask a warp row whose rows see none of the tile's
    // keys skips it (exactly: its dS would be 0)
    if (p.causal && n0 > q0 + (wq + 1) * 16 * QI - 1 + off) continue;
    const float* sK = sKV + stage * 2 * C::KV;
    const float* sV = sK + C::KV;

    // ---- S = Q K^T and dP = dO V^T over d (the bias variant's S adds to
    // the bias / scale)
    float s[4 * QI][KJ], dp[4 * QI][KJ];
#pragma unroll
    for (int r = 0; r < 4 * QI; ++r)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[r][j] = dp[r][j] = 0.f;
    if constexpr (BIAS) bias_into(s, n0);
#pragma unroll
    for (int k4 = 0; k4 < D / 4; ++k4) {
      float4 kb[KJ], vb[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kb[j] = *reinterpret_cast<const float4*>(sK + (kw + 8 * j) * LDK +
                                                 4 * k4);
        vb[j] = *reinterpret_cast<const float4*>(sV + (kw + 8 * j) * LDK +
                                                 4 * k4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 4 * k4 + e;
        float qa[4 * QI], da[4 * QI];
#pragma unroll
        for (int i = 0; i < QI; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(sQt + kk * LDQ + qw + 16 * i);
          const float4 b =
              *reinterpret_cast<const float4*>(sDt + kk * LDQ + qw + 16 * i);
          qa[4 * i] = a.x; qa[4 * i + 1] = a.y;
          qa[4 * i + 2] = a.z; qa[4 * i + 3] = a.w;
          da[4 * i] = b.x; da[4 * i + 1] = b.y;
          da[4 * i + 2] = b.z; da[4 * i + 3] = b.w;
        }
#pragma unroll
        for (int r = 0; r < 4 * QI; ++r)
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            s[r][j] = fmaf(qa[r], at(kb[j], e), s[r][j]);
            dp[r][j] = fmaf(da[r], at(vb[j], e), dp[r][j]);
          }
      }
    }

    // ---- mask, p = exp(s * scale - lse), ds = p * (dp - delta) (with
    // dropout dp kept and scaled); stored as [key][query]
#pragma unroll
    for (int r = 0; r < 4 * QI; ++r) {
      const int qr = q0 + qw + 16 * (r / 4) + r % 4;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = n0 + kw + 8 * j;
        bool ok = qr < sq && key < sk && (!p.causal || key <= qr + off);
        if (seg)
          ok = ok && sid_r[r] >= 0 &&
               sid_r[r] == sSid[stage * BN + kw + 8 * j];
        // the bias variant rounds s * scale first, as the key side does
        float pv;
        if constexpr (BIAS)
          pv = ok ? __expf(__fmul_rn(s[r][j], p.scale) - lse_r[r]) : 0.f;
        else
          pv = ok ? __expf(s[r][j] * p.scale - lse_r[r]) : 0.f;
        if constexpr (DROP) {
          const bool kept = dropout::keep(hq[r] ^ dropout::k_term(key),
                                          dr.threshold);
          dp[r][j] = pv * ((kept ? dp[r][j] * dr.inv : 0.f) - dl_r[r]);
        } else {
          dp[r][j] = pv * (dp[r][j] - dl_r[r]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int i = 0; i < QI; ++i)
        *reinterpret_cast<float4*>(sdS + (kw + 8 * j) * LDQ + qw + 16 * i) =
            make_float4(dp[4 * i][j], dp[4 * i + 1][j], dp[4 * i + 2][j],
                        dp[4 * i + 3][j]);
    pair_sync(wq);   // the warp row's dS over all BN keys is in

    // ---- dQ += dS K over the tile's keys (both k-row by k-row)
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float4 a[QI], b[CJ];
#pragma unroll
      for (int i = 0; i < QI; ++i)
        a[i] = *reinterpret_cast<const float4*>(sdS + kk * LDQ + qw + 16 * i);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(sK + kk * LDK + cw + 32 * j);
#pragma unroll
      for (int r = 0; r < 4 * QI; ++r)
#pragma unroll
        for (int c = 0; c < 4 * CJ; ++c)
          dqa[r][c] = fmaf(at(a[r / 4], r % 4), at(b[c / 4], c % 4),
                           dqa[r][c]);
    }
  }
  simt::wait_groups<0>();

  // ---- finish: dq (scaled) of the lane's rows and columns; rows no key
  // reaches are zeros
#pragma unroll
  for (int r = 0; r < 4 * QI; ++r) {
    const int qr = q0 + qw + 16 * (r / 4) + r % 4;
    if (qr < sq) {
      float* row = dq + (bh * sq + qr) * D + cw;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        *reinterpret_cast<float4*>(row + 32 * j) = make_float4(
            dqa[r][4 * j] * p.scale, dqa[r][4 * j + 1] * p.scale,
            dqa[r][4 * j + 2] * p.scale, dqa[r][4 * j + 3] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
flash_dq_f32_kernel(const Params p, float* __restrict__ dq) {
  extern __shared__ __align__(16) float smem[];
  dq_block<D, false, false>(smem, p, dq, Dropout{}, Bias{});
}

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
flash_dq_f32_dropout_kernel(const Params p, float* __restrict__ dq,
                            const Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  dq_block<D, true, false>(smem, p, dq, dr, Bias{});
}

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
flash_dq_f32_bias_kernel(const Params p, float* __restrict__ dq,
                         const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  dq_block<D, false, true>(smem, p, dq, Dropout{}, bs);
}

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
flash_dq_f32_bias_dropout_kernel(const Params p, float* __restrict__ dq,
                                 const Dropout dr, const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  dq_block<D, true, true>(smem, p, dq, dr, bs);
}

// The split's dq: given `transposed`, ws already holds q^T and dO^T (the
// dk/dv call's prologue wrote them); else this call's prologue writes
// them (no delta: it is read). Then flash_dq_f32_kernel over grid (b h,
// query tiles), or its dropout variant where dr.threshold is not 0, its
// bias variant where bs.bias is set, or its variant with both where both
// are.
template <int D>
cudaError_t launch_dq(const float* q, const float* dout, float* ws,
                      bool transposed, Params p, float* dq,
                      const Dropout& dr, const Bias& bs, int b,
                      cudaStream_t stream) {
  using C = DqCfg<D>;
  const int bh = b * p.h;
  p.sqp = (p.sq + 3) & ~3;
  p.qt = ws;
  p.dot = ws + (long)bh * D * p.sqp;
  if (!transposed) {
    flash_f32_prologue_kernel<D><<<dim3(2 * bh, (p.sqp + 63) / 64), 256,
                                   0, stream>>>(
        q, dout, nullptr, const_cast<float*>(p.qt),
        const_cast<float*>(p.dot), nullptr, nullptr, 0, bh, p.sq, p.sqp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bh, (p.sq + C::BQ - 1) / C::BQ);
  if (dr.threshold != 0 && bs.bias != nullptr)
    return start(flash_dq_f32_bias_dropout_kernel<D>, grid, C::THREADS,
                 C::SMEM_BYTES, stream, p, dq, dr, bs);
  if (dr.threshold != 0)
    return start(flash_dq_f32_dropout_kernel<D>, grid, C::THREADS,
                 C::SMEM_BYTES, stream, p, dq, dr);
  if (bs.bias != nullptr)
    return start(flash_dq_f32_bias_kernel<D>, grid, C::THREADS,
                 C::SMEM_BYTES, stream, p, dq, bs);
  return start(flash_dq_f32_kernel<D>, grid, C::THREADS, C::SMEM_BYTES,
               stream, p, dq);
}

}  // namespace fa32
