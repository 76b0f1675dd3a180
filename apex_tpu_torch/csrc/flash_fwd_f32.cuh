// Flash-attention forward for fp32 operands (O0) on the CUDA cores of
// Hopper (sm_90a), at head dims 64 and 128: flash_fwd_f32_kernel replaces
// `_fwd_kernel` (apex_tpu/ops/flash_attention.py:251, launched by
// `_flash_fwd_impl` :426) on the register-blocked FFMA form of
// simt_f32.cuh. Included by flash_fwd.cu and built into its fp32 target;
// the wrapper (ops/flash_attention.py, f32_fwd_route) sends it fp32
// operands that round nothing before the PV product, and flash_fwd.cu's
// kernel keeps the rest (d 32/256/512, p rounded to a narrower v).
//
// Numerics, as flash_fwd.cu's: every product is an fmaf of fp32 operands,
// summed in a fixed k order (no TF32, no tensor core), so out and lse are
// the same bits on every run; s * scale, the -1e30 masked fill (the
// end-aligned causal offset sk - sq, negative segment ids as padding),
// the online max and sum with p = 0 where the mask is false (the dead-row
// guard: a row whose max is the fill sums to 0 and normalizes by 1, its
// output exactly zero), out = o / l, lse = m + log(l).
//
// Bound on the H100: two products of 2 d flops a live (q, key) pair at
// the fp32 rate outside the tensor cores (67 TFLOP/s): 0.257 ms at b8 h16
// s1024 d64 causal, 1.03 ms at b2 h16 s4096.
//
// Design. A block of 4 warps owns BQ = 64 query rows of one (batch,
// head): Q's tile is transposed once into shared memory as Q^T
// [d][query] and stays; K and V tiles of BN = 32 keys stream through a
// 2-stage cp.async ring in their own [key][d] layout (rows padded to an
// odd count of 16-byte granules). Small blocks keep 12 warps an SM at
// d 64 (3 blocks; 8 at d 128), whose prologues and barriers overlap one
// another's loops: faster than one block of 8 or 16 warps with larger
// lane tiles. A warp owns 16 query rows and every key of a tile, so each
// row's max and sum over a tile are a lane's own keys, then 3 butterfly
// shuffles across the 8 lanes that share the row: no shared-memory
// exchange, and no barrier but the ring's. A lane holds 4 rows (4 ly +
// 0..3) x the keys lx + 8 j of S and the same rows x the columns 4 lx +
// 32 j of O. Per tile, in simt_f32.cuh's form C = A^T B:
//   S = Q K^T over d: A = Q^T (k-row by k-row), B = K read "K-major" (a
//     float4 along d for each of the lane's strided keys: a quarter-warp's
//     8 float4s hit 8 bank groups);
//   m, l and O rescaled by exp(m_old - m_new); p = exp(s scale - m_new);
//   P^T [key][query] into the warp's own columns of shared memory (the
//     8 keys of a quarter-warp's stores in 8 bank groups), __syncwarp;
//   O += P V: A = P^T, B = V in its own layout (MN-major, k = key).
// The causal walk stops at the tile's last row's last key, and a warp
// skips the tiles its own rows see no key of. The grid is (b h, query
// tile), the query tiles in reverse under a causal mask: each round of
// b h blocks walks one length of keys, the longest first. Shared memory:
// 60 KB at d 64, 109 KB at d 128.
//
// Attention dropout (`_fwd_kernel`'s, :305-308 and :334-339): a variant of
// the kernel, flash_fwd_f32_dropout_kernel (chosen by the C entry when the
// keep threshold is not 0; the kernel without dropout keeps its parameters
// and its code), regenerates the keep bit of each (query row, key) element
// from dropout_hash.cuh at their global positions. l takes the undropped
// sum, as without dropout; p is dropped after the sum and before P^T is
// stored: keep ? p / (1 - rate) : 0, an fp32 product, so the PV product
// stays exact fmaf's in a fixed order and a rerun is the same bits. The
// hash's (seed, batch, head) term is xored with each of a lane's four row
// terms once a block; an element costs its key's term, one xor and one
// fmix32 (about 10 integer operations, on the same cores as the products).
//
// The additive bias (`_fwd_kernel`'s `use_bias`, :282-283): a variant,
// flash_fwd_f32_bias_kernel (chosen by the C entry when the bias pointer is
// not null and the keep threshold is 0), with the bias's fields in a
// parameter struct of its own (Bias: fp32 [b|1, h|1, sq, sk], the last two
// dims contiguous, batch and head strides 0 for a broadcast dim). Before a
// tile's S product each lane loads its 4 rows x 4 strided keys of the
// tile's bias, times 1 / scale, into S's accumulators, which the product
// then adds to, so s * scale is the biased score (up to one rounding) and
// m, l and lse are those of the biased scores, before the mask. The loads
// take no register beyond S's (3 blocks an SM at d 64 hide their latency),
// and a tile the warp skips loads none. Keys
// past sk read as 0 and rows past sq as the last row (both masked). A -inf
// bias gives p = 0 exactly (the row max is floored at the -1e30 fill), and
// a row whose every biased score is -inf is a dead row (out 0, lse -1e30),
// as the Pallas kernel's guard gives it.
//
// The bias with dropout (`_fwd_kernel` with both: the bias at :282-283,
// then the keep bits at :305-308 and :334-339): a variant with both,
// flash_fwd_f32_bias_dropout_kernel (chosen by the C entry when the bias
// pointer is set and the keep threshold is above 0; it takes both structs),
// runs the two as above in the Pallas kernel's order: the bias / scale in
// S's accumulators before the S product, the mask, m and l on the biased,
// undropped scores, then the keep bit on p before P^T's store. A dead row's
// p is 0 whatever its keep bits, so its output stays exactly 0.

#pragma once

#include <stdint.h>

#include "dropout_hash.cuh"
#include "simt_f32.cuh"

namespace fwd32 {

constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  static constexpr int THREADS = 128;            // 4 warps of 16 rows
  // blocks an SM: 3 at d 64 (142 registers), 2 at d 128 (shared memory)
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;
  static constexpr int BQ = 64;                  // resident query rows
  static constexpr int BN = 32;                  // keys a streamed tile
  static constexpr int STAGES = 2;
  static constexpr int KJ = BN / 8;              // a lane's keys: lx + 8 j
  static constexpr int OJ = D / 32;              // a lane's column runs
  static constexpr int LDQ = BQ + 4;             // Q^T, P^T rows
  static constexpr int LDK = D + 4;              // K, V rows
  static constexpr int QT = D * LDQ;             // floats of Q^T
  static constexpr int KV = BN * LDK;            // floats of a K (V) tile
  static constexpr int PT = BN * LDQ;            // floats of P^T
  static constexpr size_t SMEM_BYTES =
      (size_t)(QT + STAGES * 2 * KV + PT) * 4 + (size_t)STAGES * BN * 4;
};

struct Params {
  const float* q;        // [b, h, sq, D]
  const float* k;        // [b, h, sk, D]
  const float* v;
  const int32_t* sid_q;  // [b, sq] and [b, sk], or null
  const int32_t* sid_kv;
  float* out;            // [b, h, sq, D]
  float* lse;            // [b, h, sq]
  int h, sq, sk, causal;
  float scale;
};

// the dropout variant's own parameters: the seed, the keep threshold and
// 1 / (1 - rate) (the kernel without dropout takes Params alone)
struct Dropout {
  uint32_t seed, threshold;
  float inv;
};

// the bias variant's own parameters: the fp32 bias, its batch and head
// strides in elements (0 for a broadcast dim) and 1 / scale
struct Bias {
  const float* bias;
  long sb, sh;
  float inv_scale;
};

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the bias variant: the tile from key n0's bias / scale into S's
// accumulators (element [r][j]: row `row0` + r of the (batch, head)'s [sq,
// sk] slice at `bias_bh`, key n0 + lx + 8 j; keys past sk read as 0, rows
// past sq as the last: both masked)
template <int KJ>
__device__ __forceinline__ void bias_into(float (&s)[4][KJ],
                                          const float* bias_bh, int row0,
                                          int sq, int sk, int n0, int lx,
                                          float inv_scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = bias_bh + (long)min(row0 + r, sq - 1) * sk;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int key = n0 + lx + 8 * j;
      s[r][j] = (key < sk ? __ldg(row + key) : 0.f) * inv_scale;
    }
  }
}

template <int D, bool DROP, bool BIAS>
__device__ __forceinline__ void forward(float* smem, const Params& p,
                                        const Dropout& dr, const Bias& bs) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BN = C::BN, KJ = C::KJ, OJ = C::OJ;
  constexpr int LDQ = C::LDQ, LDK = C::LDK, STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS;
  float* sQt = smem;                          // [D][LDQ]
  float* sKV = sQt + C::QT;                   // stage s: K, then V
  float* sP = sKV + STAGES * 2 * C::KV;       // [BN][LDQ]
  int* sSid = reinterpret_cast<int*>(sP + C::PT);   // [STAGES][BN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ly = lane / 8, lx = lane % 8;
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
  const int qw = 16 * warp + 4 * ly;   // the lane's rows: + 0..3

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
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_end) load_kv(s, s);
    simt::commit();
  }

  // Q's tile, transposed into shared memory (zeros past sq) while the
  // first tiles' copies fly: consecutive threads on consecutive rows
  if (kt_end > 0) {
    const float* qb = p.q + (bh * sq + q0) * D;
#pragma unroll 4
    for (int i = 0; i < BQ * (D / 4) / THREADS; ++i) {
      const int idx = tid + THREADS * i;
      const int r = idx % BQ, c4 = 4 * (idx / BQ);
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq)
        qv = __ldg(reinterpret_cast<const float4*>(qb + (long)r * D + c4));
      sQt[(c4 + 0) * LDQ + r] = qv.x;
      sQt[(c4 + 1) * LDQ + r] = qv.y;
      sQt[(c4 + 2) * LDQ + r] = qv.z;
      sQt[(c4 + 3) * LDQ + r] = qv.w;
    }
  }

  int sid_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qr = q0 + qw + r;
    sid_r[r] = (seg && qr < sq) ? __ldg(p.sid_q + (long)bi * sq + qr) : -1;
  }
  // dropout: the hash's (seed, batch, head) and row terms of the lane's
  // four rows
  uint32_t hq[4];
  if constexpr (DROP) {
    const uint32_t hb =
        dropout::base(dr.seed, (uint32_t)bi, (uint32_t)(bh - (long)bi * p.h));
#pragma unroll
    for (int r = 0; r < 4; ++r) hq[r] = hb ^ dropout::q_term(q0 + qw + r);
  }
  float m[4], l[4], o[4][4 * OJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * OJ; ++c) o[r][c] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt % STAGES;
    simt::wait_groups<STAGES - 2>();
    __syncthreads();   // the tile (and Q^T) is in; kt - 1 is done
    {
      const int nxt = kt + STAGES - 1;
      if (nxt < kt_end) load_kv(nxt, nxt % STAGES);
      simt::commit();
    }
    const int n0 = kt * BN;
    // under a causal mask a warp whose rows see none of the tile's keys
    // skips it (exactly: its p would be 0, m, l and O unchanged)
    if (p.causal && n0 > q0 + 16 * warp + 15 + off) continue;
    const float* sK = sKV + stage * 2 * C::KV;
    const float* sV = sK + C::KV;

    // ---- S = Q K^T over d (the bias variant's adds to the bias / scale)
    float s[4][KJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[r][j] = 0.f;
    if constexpr (BIAS)
      bias_into(s, bs.bias + (long)bi * bs.sb + (bh - (long)bi * p.h) * bs.sh,
                q0 + qw, sq, sk, n0, lx, bs.inv_scale);
#pragma unroll
    for (int k4 = 0; k4 < D / 4; ++k4) {
      float4 kb[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sK + (lx + 8 * j) * LDK +
                                                 4 * k4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 a =
            *reinterpret_cast<const float4*>(sQt + (4 * k4 + e) * LDQ + qw);
        const float qa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < KJ; ++j)
            s[r][j] = fmaf(qa[r], at(kb[j], e), s[r][j]);
      }
    }

    // ---- scale, mask, the online max and sum (the row's keys lie in the
    // 8 lanes of one ly), O rescaled; p into s
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qr = q0 + qw + r;
      uint32_t live = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = n0 + lx + 8 * j;
        bool ok = qr < sq && key < sk && (!p.causal || key <= qr + off);
        if (seg)
          ok = ok && sid_r[r] >= 0 &&
               sid_r[r] == sSid[stage * BN + lx + 8 * j];
        const float val = ok ? s[r][j] * p.scale : NEG_INF;
        s[r][j] = val;
        live |= (ok ? 1u : 0u) << j;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float mn = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pv = (live >> j) & 1u ? __expf(s[r][j] - mn) : 0.f;
        if constexpr (DROP)   // l takes p undropped, the PV product dropped
          s[r][j] = dropout::keep(hq[r] ^ dropout::k_term(n0 + lx + 8 * j),
                                  dr.threshold)
                        ? pv * dr.inv
                        : 0.f;
        else
          s[r][j] = pv;
        sum += pv;
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      const float alpha = __expf(m[r] - mn);
      l[r] = alpha * l[r] + sum;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < 4 * OJ; ++c) o[r][c] *= alpha;
    }

    // ---- P^T [key][query] for the warp's own rows
    float* sPw = sP + qw;
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      *reinterpret_cast<float4*>(sPw + (lx + 8 * j) * LDQ) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // ---- O += P V over the tile's keys (both k-row by k-row)
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sPw + kk * LDQ);
      const float pa[4] = {a.x, a.y, a.z, a.w};
      float4 b[OJ];
#pragma unroll
      for (int j = 0; j < OJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(sV + kk * LDK + 4 * lx +
                                                32 * j);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4 * OJ; ++c)
          o[r][c] = fmaf(pa[r], at(b[c / 4], c % 4), o[r][c]);
    }
  }
  simt::wait_groups<0>();

  // ---- normalize by the (guarded) row sum; out and lse
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qr = q0 + qw + r;
    if (qr >= sq) continue;
    const float sl = l[r] > 0.f ? l[r] : 1.f;
    const float inv = 1.f / sl;
    float* row = p.out + (bh * sq + qr) * D + 4 * lx;
#pragma unroll
    for (int j = 0; j < OJ; ++j)
      *reinterpret_cast<float4*>(row + 32 * j) =
          make_float4(o[r][4 * j] * inv, o[r][4 * j + 1] * inv,
                      o[r][4 * j + 2] * inv, o[r][4 * j + 3] * inv);
    if (lx == 0) p.lse[bh * sq + qr] = m[r] + logf(sl);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fwd_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  forward<D, false, false>(smem, p, Dropout{}, Bias{});
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fwd_f32_dropout_kernel(const Params p, const Dropout dr) {
  extern __shared__ __align__(16) float smem[];
  forward<D, true, false>(smem, p, dr, Bias{});
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fwd_f32_bias_kernel(const Params p, const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  forward<D, false, true>(smem, p, Dropout{}, bs);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fwd_f32_bias_dropout_kernel(const Params p, const Dropout dr,
                                  const Bias bs) {
  extern __shared__ __align__(16) float smem[];
  forward<D, true, true>(smem, p, dr, bs);
}

// the kernel without a variant, with dropout where dr.threshold is not 0,
// with the bias where bs.bias is set, or with both where both are
template <int D>
cudaError_t launch(const Params& p, const Dropout& dr, const Bias& bs,
                   int b, cudaStream_t stream) {
  using C = Cfg<D>;
  const bool drop = dr.threshold != 0, bias = bs.bias != nullptr;
  cudaError_t err = cudaFuncSetAttribute(
      drop && bias ? (const void*)flash_fwd_f32_bias_dropout_kernel<D>
      : drop       ? (const void*)flash_fwd_f32_dropout_kernel<D>
      : bias       ? (const void*)flash_fwd_f32_bias_kernel<D>
                   : (const void*)flash_fwd_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * p.h, (p.sq + C::BQ - 1) / C::BQ);
  if (drop && bias)
    flash_fwd_f32_bias_dropout_kernel<D>
        <<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p, dr, bs);
  else if (drop)
    flash_fwd_f32_dropout_kernel<D>
        <<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p, dr);
  else if (bias)
    flash_fwd_f32_bias_kernel<D>
        <<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p, bs);
  else
    flash_fwd_f32_kernel<D><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fwd32
