// The flash-attention forward for Hopper (sm_90a), bf16 and fp16 operands at
// head dims 64 and 128, on wgmma and TMA (wgmma_attn.cuh over
// wgmma_gemm.cuh's primitives): out [b, h, sq, d] in the operands' dtype and
// lse [b, h, sq] (fp32) from q [b, h, sq, d] and k, v [b, h, sk, d].
//
// Replaces `_fwd_kernel` (apex_tpu/ops/flash_attention.py:251, launched by
// `_flash_fwd_impl` :468) on the route the wrapper (ops/flash_attention.py,
// `sm90_route`) sends here by dtype and kernel head dim alone; fp32, mixed
// operands (promoted to fp32) and head dims 32, 256 and 512 stay on
// flash_fwd.cu.
//
// Numerics are the Pallas kernel's online softmax: s = q k^T * scale in
// fp32, the -1e30 fill where the mask is false, m_new = max(m, rowmax s),
// p = exp(s - m_new) and zero wherever the mask is false (the dead-row
// guard), alpha = exp(m - m_new), l = alpha l + rowsum p, O = alpha O + p V
// with p rounded to v's dtype first, fp32 accumulation; at the end safe_l =
// l where l > 0 else 1, out = O / safe_l, lse = m + log(safe_l). Rows with
// no live key (segment padding, causal rows past sk) come out exactly zero
// with lse -1e30. The exponentials run in base 2 (ex2.approx on s * scale *
// log2(e)), as in the backward kernels of flash_bwd_sm90.cu.
//
// Bound on the H100: two products of 2 d flops per live (q, k) pair over q,
// k, v read once and out, lse written once. At the serve prefill shape (b1
// h16 s512 d64 causal, 2.1 M live pairs) that is 0.54 GFLOP and 4.2 MB:
// 1.3 us of bytes against 0.55 us of operations, far below a launch, so the
// kernel is bound by its own latency there; at b8 h16 s1024 (67 M pairs)
// 17 GFLOP and 67 MB: 20 us of bytes, 17 of operations; at b2 h16 s4096
// (268 M pairs) 69 GFLOP against 67 MB: 69 us of operations.
//
// Design. A block is one producer warpgroup (warp 0 issues the TMA loads
// and stages the key tile's segment ids; setmaxnreg 40) and CONS consumer
// warpgroups of 64 query rows each, CONS 2 (128-row blocks, one an SM,
// consumers at 232 registers) or 1 (64-row blocks, two an SM at d 64,
// where their shared memory fits twice: consumers at 216). The wrapper
// (`fwd_block_rows`) takes 64-row blocks at d 64 and wherever 128-row
// blocks would leave SMs idle (b h ceil(sq / 128) below the SM count, e.g.
// the serve prefill's 64 blocks on 132 SMs): two 64-row blocks an SM
// overlap one's prologue and epilogue with the other's loop
// (`scripts/kernel_times.py` times both heights).
//
// - Q's rows stay resident in shared memory, loaded once by TMA; key tiles
//   of 128 rows (K then V) stream through a ring of STAGES stages with
//   full/empty mbarriers.
// - Per key tile each consumer computes S = Q K^T (m64n128, both operands
//   from shared memory, K-major; the first k-step overwrites), forms p in
//   registers, rescales its O accumulators by alpha in registers and
//   accumulates O += P V with A from registers (acc_to_a: S's
//   accumulators repacked and rounded in place) and V read MN-major
//   through the transpose bit from the tile TMA loaded: no transposed copy
//   of V, no staging of P.
// - A tile's P V is issued together with the next tile's S and runs while
//   that S's softmax does; the first tile is peeled off the loop, so the
//   loop's waits (S, then P V) are the same every iteration and ptxas
//   keeps the products asynchronous.
// - The softmax runs one straight-line loop a tile, its masked version
//   only on diagonal, ragged or segment tiles: there a row's live keys are
//   those below one limit (its causal end and sk) whose segment id is its
//   own, and the -1e30 fill needs no mask of its own afterwards, since
//   2^(-1e30 - m) is exactly 0 unless the row has no live key yet.
// - Row sums are kept per thread (the quad's four partial sums share the
//   row's alpha) and summed over the quad once, at the end.
// - Causal blocks visit only the key tiles at or before the diagonal of
//   their last row, a consumer skips the tiles past its own rows'
//   diagonal, and the grid puts the (batch, head) on its fast axis and the
//   longest loops (the last rows) first.
// - The 3-D TMA map over [b h, s, d] keeps a tile inside its head and
//   zero-fills rows past s; segment ids are masked by index.
//
// Attention dropout (the `_fwd_kernel`'s, :305-308 and :334-339): a variant
// of the kernel (DROP, chosen by the C entry when the keep threshold is not
// 0, so the code without dropout is the same instructions as before) keeps
// l on the undropped p, then replaces each p by 0 where the element is
// dropped and by p / (1 - rate) where it is kept, before the register-A
// conversion to v's dtype for P V; lse is unchanged. The keep bit is
// dropout_hash.cuh's hash of (seed, batch, head, query row, key), the
// row's part hoisted out of the loop: one xor and one fmix32 an element,
// about ten integer operations beside the element's two products of 2 d
// flops, computed into two words of keep bits while the tile's S product
// runs. A tile runs its products whatever its keep bits.
//
// The additive bias (the `_fwd_kernel`'s `use_bias`, :282-283): a variant
// (BIAS, chosen by the C entry when the bias pointer is not null; the code
// without it is the same instructions as before) adds bias[b', h', q, k]
// (fp32, [b|1, h|1, sq, sk], the last two dims contiguous; b' = b or 0
// and h' = h or 0 by the strides the wrapper passes, 0 for a broadcast
// dim) to each scaled score before the mask, so m, l and lse are those of
// the biased scores. It costs the softmax nothing: before a tile's S
// product each thread loads its own elements of the tile's bias, times
// 1 / scale, into S's accumulators (8-byte pairs where sk is even, scalar
// loads where it is odd; keys past sk read as 0, masked), and the
// product's first k-step adds to them instead of overwriting, so S holds
// q k^T + bias / scale and the softmax's s scale log2(e) is the biased
// score in base 2. The loads run while the thread waits for the tile's
// K and V, and take no register beyond S's (a first version held the
// bias in registers of its own beside S: it spilled at head dim 128 and
// was much slower, PERF.md). A -inf bias gives an exact 0
// (ex2.approx.ftz(-inf)), and a row whose every biased score is -inf (or
// below the -1e30 fill) keeps m at the fill and is a dead row: out 0, lse
// -1e30, as the Pallas kernel's guard gives it. The bias variants keep m
// in natural units: s * scale rounded (`__fmul_rn`), a masked score -inf,
// p = 2^((s - m) log2(e)). So a row whose biased scores sit at the fill
// itself, or just above it, on every key the mask keeps (-1e30 to about
// -6.9e29, which are below -1e30 in base-2 units) is live as in the Pallas
// kernel and the plain version: its max is the fill (or its score), p = 1
// on each kept key, out their mean, and lse = m + log(l) is written with
// no round trip through log2(e), so the backward, which rounds s * scale
// the same way, recomputes p = 1 there bit for bit.
//
// The bias with dropout (the `_fwd_kernel` with both, :282-283 then
// :305-308 / :334-339): the variant with both (DROP and BIAS, chosen by the
// C entry when the bias pointer is set and the threshold is above 0) runs
// the two as above, in the Pallas kernel's order: the bias loaded into S
// before the S product, the keep bits computed while it runs, then the
// mask, m and l on the biased, undropped scores, and the dropout on p
// before the conversion for P V. A dead row's p is 0 whatever its keep
// bits, so its output stays exactly 0. In 64-row blocks its consumers take
// 232 registers and the producer 24 (the block's share of the SM's file,
// as 216 and 40): at 216 it spilled at head dim 128.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "dtype.cuh"
#include "wgmma_attn.cuh"

namespace {

constexpr int KT = 128;            // keys a streamed tile
constexpr int MAX_THREADS = 384;   // a producer and two consumers
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;
constexpr cudaError_t MAP_REFUSED = cudaErrorNotSupported;

template <int D, int CONS>
struct Layout {
  static constexpr int BM = 64 * CONS;                 // query rows a block
  static constexpr int THREADS = 128 * (1 + CONS);
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = KT * D * 2;          // one of K, V
  // Q, STAGES x (K, V), STAGES x the key tile's segment ids, 2 STAGES + 1
  // barriers, 1 KB of alignment
  static constexpr size_t SMEM = (size_t)Q_BYTES +
                                 (size_t)STAGES * 2 * KV_BYTES +
                                 STAGES * KT * 4 + (2 * STAGES + 1) * 8 +
                                 1024;
};

struct Params {
  const int32_t* sid_q;
  const int32_t* sid_kv;
  void* out;
  float* lse;
  int h, sq, sk, causal;
  float scale;
  // dropout (the DROP variant): the seed, the keep threshold, 1 / (1 - rate)
  uint32_t seed, threshold;
  float inv;
};

// the kernel's parameters: the BIAS variant's add the bias, fp32 [b|1, h|1,
// sq, sk], its batch and head strides in elements (0 for a broadcast dim)
// and 1 / scale; the others' are Params alone, laid out as before the
// variant
template <bool BIAS>
struct KernelParams : Params {};
template <>
struct KernelParams<true> : Params {
  const float* bias;
  long bias_sb, bias_sh;
  float inv_scale;
};

// bias[key], bias[key + 1] of a row: one 8-byte load where sk is even (key
// is even and the row 8-byte aligned), else two; 0 past sk where `guard`
// (such keys are masked)
__device__ __forceinline__ float2 bias_pair(const float* row, int key,
                                            int sk, bool even, bool guard) {
  if (even) {
    if (guard && key >= sk) return make_float2(0.f, 0.f);
    return __ldg(reinterpret_cast<const float2*>(row + key));
  }
  return make_float2(!guard || key < sk ? __ldg(row + key) : 0.f,
                     !guard || key + 1 < sk ? __ldg(row + key + 1) : 0.f);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 128 threads of consumer warpgroup cw (named barrier 1 + cw)
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// The 128-row block (three warpgroups) starts from 168 registers a
// thread; the 64-row block (two) from 128, so that two blocks share an SM
// (setmaxnreg then gives its consumer 216): one block's prologue and
// epilogue run while the other's loop does
template <typename T, int D, int CONS, bool DROP, bool BIAS>
__global__ void __launch_bounds__(CONS == 1 ? 256 : MAX_THREADS,
                                  CONS == 1 ? 2 : 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const KernelParams<BIAS> p) {
  using L = Layout<D, CONS>;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* sQ = base;
  uint8_t* ring = base + L::Q_BYTES;          // stage s: K then V
  int32_t* sSid =
      reinterpret_cast<int32_t*>(ring + STAGES * 2 * L::KV_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sSid + STAGES * KT);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;

  const int bh = blockIdx.x, bi = bh / p.h;
  // the longest causal loops (the last rows) first
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int sq = p.sq, sk = p.sk, offset = sk - sq;
  const bool causal = p.causal != 0, use_seg = p.sid_q != nullptr;
  const int n_kt = (sk + KT - 1) / KT;
  int kt_end = n_kt;
  if (causal) {     // the last key the block's last row sees
    const int last = min(sq - 1, m0 + BM - 1) + offset;
    kt_end = last < 0 ? 0 : min(n_kt, last / KT + 1);
  }

  if (threadIdx.x == 0) {
    wg::prefetch_map(&map_q);
    wg::prefetch_map(&map_k);
    wg::prefetch_map(&map_v);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 32);          // the producer warp's lanes
      wg::mbar_init(&empty[s], CONS);
    }
    wg::mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: warp 0 keeps the ring full (at 24 registers in the
    // 64-row variant with both, whose consumers take 232)
    wg::setmaxnreg_dec<(DROP && BIAS && CONS == 1) ? 24 : 40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        wg::mbar_expect_tx(res, L::Q_BYTES);
#pragma unroll
        for (int a = 0; a < D / 64; ++a)
          wg::tma_load_3d(sQ + a * BM * 128, &map_q, res, 64 * a, m0, bh);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        const int n0 = kt * KT;
        if (use_seg) {       // every lane's loads issued before its stores
          int32_t sv[KT / 32];
#pragma unroll
          for (int i = 0; i < KT / 32; ++i) {
            const int key = n0 + lane + 32 * i;
            sv[i] = key < sk ? p.sid_kv[(long)bi * sk + key] : -1;
          }
#pragma unroll
          for (int i = 0; i < KT / 32; ++i)
            sSid[stage * KT + lane + 32 * i] = sv[i];
        }
        uint8_t* tk = ring + stage * 2 * L::KV_BYTES;
        if (lane == 0) {
          wg::mbar_expect_tx(&full[stage], 2 * L::KV_BYTES);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            wg::tma_load_3d(tk + a * KT * 128, &map_k, &full[stage], 64 * a,
                            n0, bh);
            wg::tma_load_3d(tk + L::KV_BYTES + a * KT * 128, &map_v,
                            &full[stage], 64 * a, n0, bh);
          }
        } else {
          wg::mbar_arrive(&full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    wg::setmaxnreg_inc<CONS == 1 ? (DROP && BIAS ? 232 : 216) : 232>();
    const int cw = wgi - 1, t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, tig = t % 4;
    const int m0w = m0 + 64 * cw;
    const int row0 = m0w + 16 * warp + g;
    int sid[2];
    uint32_t drow[2];    // dropout: the hash's (seed, batch, head, row) terms
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      sid[r] = (use_seg && row < sq) ? p.sid_q[(long)bi * sq + row] : -1;
      if constexpr (DROP)
        drow[r] = dropout::base(p.seed, bi, bh - bi * p.h) ^
                  dropout::q_term(row);
    }
    // the bias: this thread's two rows of the (batch, head)'s [sq, sk]
    // slice, a row past sq clamped to the last (its scores are masked)
    const float* brow[2];
    if constexpr (BIAS) {
      const float* bb = p.bias + (long)bi * p.bias_sb +
                        (long)(bh - bi * p.h) * p.bias_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        brow[r] = bb + (long)min(row0 + 8 * r, sq - 1) * sk;
    }
    // the last key this warpgroup's rows see (causal)
    const int last_w = min(sq - 1, m0w + 63) + offset;
    const float sl2 = p.scale * LOG2E;
    // m in base-2 units (s * scale * log2(e); the bias variants' in natural
    // units, s * scale), this thread's partial l
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    // A warpgroup's live key tiles are a prefix of the block's: the causal
    // limit of its own last row
    int n_live = m0w < sq ? kt_end : 0;
    if (causal && n_live > 0)
      n_live = last_w < 0 ? 0 : min(kt_end, last_w / KT + 1);

    // S = Q K^T of the tile in `stage` (the caller fences and commits);
    // the bias variant adds it to the tile's bias / scale, which
    // `bias_into` loaded into S (the others' first k-step overwrites)
    auto issue_s = [&](float (&s)[KT / 2], int st) {
      const uint8_t* tk = ring + st * 2 * L::KV_BYTES;
      wg::mma_ss128<T, BIAS ? 1 : 0>(s, wg::kmajor_desc<BM>(sQ, 64 * cw, 0),
                                     wg::kmajor_desc<KT>(tk, 0, 0));
#pragma unroll
      for (int j = 1; j < D / 16; ++j)
        wg::mma_ss128<T, 1>(s, wg::kmajor_desc<BM>(sQ, 64 * cw, j),
                            wg::kmajor_desc<KT>(tk, 0, j));
    };
    // dropout: the keep bits of the tile from key n0 (bit i % 32 of
    // kb[i / 32]: element i, key n0 + 8 (i / 4) + 2 tig + i % 2), computed
    // while the tile's S product runs (in the softmax they spilled at d 128)
    uint32_t kb[2];
    auto keep_bits = [&](int n0) {
      if constexpr (DROP) {
        kb[0] = kb[1] = 0u;
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int key = n0 + 8 * (i / 4) + 2 * tig + i % 2;
          kb[i / 32] |= (uint32_t)dropout::keep(
                            drow[(i / 2) % 2] ^ dropout::k_term(key),
                            p.threshold)
                        << (i % 32);
        }
      }
    };
    // the bias variant: the tile from key n0's bias / scale into S's
    // accumulators (element 4 nb + 2 r + e: row row0 + 8 r, key n0 + 8 nb
    // + 2 tig + e; keys past sk read as 0: they are masked)
    auto bias_into = [&](float (&s)[KT / 2], int n0) {
      if constexpr (BIAS) {
        const bool even = (sk & 1) == 0, guard = n0 + KT > sk;
#pragma unroll
        for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 bv =
                bias_pair(brow[r], n0 + 8 * nb + 2 * tig, sk, even, guard);
            s[4 * nb + 2 * r] = bv.x * p.inv_scale;
            s[4 * nb + 2 * r + 1] = bv.y * p.inv_scale;
          }
      }
    };
    // O += P V over the tile in `st` (p rounded to v's dtype), V MN-major
    uint32_t pa[KT / 16][4];
    auto issue_pv = [&](int st) {
      const uint8_t* tv = ring + st * 2 * L::KV_BYTES + L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wg::mma_rs<T, D, 1>(o, pa[kk], wg::mnmajor_desc<KT>(tv, kk));
    };
    auto release = [&](int st) {
      wg_sync(cw);             // every thread is done with the stage
      if (t == 0) wg::mbar_arrive(&empty[st]);
    };
    // s * scale * log2(e) (the -1e30 fill where masked), the row max over
    // the quad, p = 2^(s - m_new) in s; m and l move on, alpha is returned
    // for O. A masked score's 2^(-1e30 - m_new) is exactly 0 unless the
    // row has no live key yet (m_new is the fill itself): such a row's p
    // is set to 0 (the dead-row guard). The bias variants keep s * scale
    // (rounded) in natural units against the same -1e30 floor, -inf where
    // masked, and p = 2^((s - m_new) log2(e)): a biased score at the fill
    // itself, or just above it (to -6.9e29, below the floor in base-2
    // units), is live with p = 1 as in the Pallas kernel, and a masked
    // score's p is exactly 0 with no guard (the fill is a live score there)
    auto softmax = [&](float (&s)[KT / 2], int n0, int st,
                       float (&alpha)[2]) {
      float mx[2] = {NEG_INF, NEG_INF};
      auto scale_max = [&](auto masked) {
        // a row's live keys in the tile are those below lim (its causal
        // limit and sk, in tile units) whose segment id is its own
        int lim[2];
        if constexpr (decltype(masked)::value) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            const int end = causal ? min(sk, row + offset + 1) : sk;
            lim[r] = row < sq && !(use_seg && sid[r] < 0) ? end - n0 : 0;
          }
        }
        const int32_t* sidk = sSid + st * KT;
#pragma unroll
        for (int nb = 0; nb < KT / 8; ++nb) {
          int2 sk2 = make_int2(0, 0);
          if constexpr (decltype(masked)::value) {
            if (use_seg)
              sk2 = *reinterpret_cast<const int2*>(sidk + 8 * nb + 2 * tig);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = 8 * nb + 2 * tig + e;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * nb + 2 * r + e;
              float x;
              if constexpr (BIAS)
                x = __fmul_rn(s[i], p.scale);
              else
                x = s[i] * sl2;
              if constexpr (decltype(masked)::value) {
                bool ok = kl < lim[r];
                if (use_seg) ok = ok && sid[r] == (e ? sk2.y : sk2.x);
                if constexpr (BIAS)
                  x = ok ? x : __uint_as_float(0xff800000u);   // -inf
                else
                  x = ok ? x : NEG_INF;
              }
              s[i] = x;
              mx[r] = fmaxf(mx[r], x);
            }
          }
        }
      };
      if (use_seg || m0w + 64 > sq || n0 + KT > sk ||
          (causal && n0 + KT - 1 > m0w + offset))
        scale_max(std::true_type{});
      else
        scale_max(std::false_type{});
      float mn[2];
      bool dead[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mn[r] = fmaxf(m[r], mx[r]);
        if constexpr (BIAS) {
          dead[r] = false;
          alpha[r] = ex2(__fmul_rn(m[r] - mn[r], LOG2E));
        } else {
          dead[r] = mn[r] == NEG_INF;
          alpha[r] = ex2(m[r] - mn[r]);
        }
        m[r] = mn[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int r = (i / 2) % 2;
        float pv;
        if constexpr (BIAS)
          pv = ex2(__fmul_rn(s[i] - mn[r], LOG2E));
        else
          pv = dead[r] ? 0.f : ex2(s[i] - mn[r]);
        l[r] += pv;
        if constexpr (DROP)     // l took the undropped p; P V the dropped
          pv = (kb[i / 32] >> (i % 32)) & 1u ? pv * p.inv : 0.f;
        s[i] = pv;
      }
    };

    wg::mbar_wait(res, 0);
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    if (n_live > 0) {
      // the first tile alone: S, then its softmax; its P V goes out with
      // the next tile's S
      float s[KT / 2], alpha[2];
      bias_into(s, 0);
      wg::mbar_wait(&full[stage], phase);
      wg::wgmma_fence();
      issue_s(s, stage);
      wg::wgmma_commit();
      keep_bits(0);
      wg::wgmma_wait<0>();
      wg::fence_regs(s);
      softmax(s, 0, stage, alpha);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) wg::acc_to_a<T>(s, kk, pa[kk]);
      int held = stage;
      advance();
      // each later tile: its S and the held tile's P V in flight together,
      // the softmax of S while P V runs, then O takes alpha
      for (int kt = 1; kt < n_live; ++kt) {
        bias_into(s, kt * KT);
        wg::mbar_wait(&full[stage], phase);
        wg::wgmma_fence();
        issue_s(s, stage);
        wg::wgmma_commit();
        issue_pv(held);
        wg::wgmma_commit();
        keep_bits(kt * KT);
        wg::wgmma_wait<1>();       // S is done; P V may run on
        wg::fence_regs(s);
        softmax(s, kt * KT, stage, alpha);
        wg::wgmma_wait<0>();
        wg::fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) wg::fence_frag(pa[kk]);
        release(held);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) wg::acc_to_a<T>(s, kk, pa[kk]);
        held = stage;
        advance();
      }
      wg::wgmma_fence();
      issue_pv(held);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) wg::fence_frag(pa[kk]);
      release(held);
    }
    // the tiles past this warpgroup's diagonal go back unread
    for (int kt = n_live; kt < kt_end; ++kt) {
      wg::mbar_wait(&full[stage], phase);
      release(stage);
      advance();
    }

    // ---- finish: out = O / safe_l, lse = m + log(safe_l) (natural units;
    // -1e30 on rows with no live key, whose l is 0; the bias variants' m
    // is natural already, so a row at the fill keeps its lse bit for bit
    // for the backward, which rounds s * scale as m was rounded)
    const long bhs = (long)bh * sq;
    T* out = static_cast<T*>(p.out) + bhs * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row < sq) {
        const float safe_l = l[r] > 0.f ? l[r] : 1.f;
        const float inv = 1.f / safe_l;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb)
          *reinterpret_cast<uint32_t*>(out + (long)row * D + 8 * nb +
                                       2 * tig) =
              Frag<T>::pack(o[4 * nb + 2 * r] * inv,
                            o[4 * nb + 2 * r + 1] * inv);
        if (tig == 0) {
          if constexpr (BIAS)
            p.lse[bhs + row] = l[r] > 0.f ? m[r] + logf(safe_l) : NEG_INF;
          else
            p.lse[bhs + row] =
                l[r] > 0.f ? m[r] * LN2 + logf(safe_l) : NEG_INF;
        }
      }
    }
  }
}

// the bias operand of the C entry: null, or fp32 with its strides
struct BiasArg {
  const float* ptr;
  long sb, sh;
};

template <typename T, int D, int CONS, bool DROP, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Params& p, const BiasArg& bias, int b,
                   cudaStream_t stream) {
  using L = Layout<D, CONS>;
  const long bh = (long)b * p.h;
  // a map over at least one row: with sk 0 no key tile is loaded
  CUtensorMap mq, mk, mv;
  if (!wg::attn_map<T>(&mq, q, bh, p.sq, D, L::BM) ||
      !wg::attn_map<T>(&mk, k, bh, p.sk > 0 ? p.sk : 1, D, KT) ||
      !wg::attn_map<T>(&mv, v, bh, p.sk > 0 ? p.sk : 1, D, KT))
    return MAP_REFUSED;
  auto kern = flash_fwd_sm90<T, D, CONS, DROP, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh, (p.sq + L::BM - 1) / L::BM);
  KernelParams<BIAS> kp;
  static_cast<Params&>(kp) = p;
  if constexpr (BIAS) {
    kp.bias = bias.ptr;
    kp.bias_sb = bias.sb;
    kp.bias_sh = bias.sh;
    kp.inv_scale = 1.f / p.scale;
  }
  kern<<<grid, L::THREADS, L::SMEM, stream>>>(mq, mk, mv, kp);
  return cudaGetLastError();
}

template <typename T, bool DROP, bool BIAS>
cudaError_t dispatch_variant(const void* q, const void* k, const void* v,
                             const Params& p, const BiasArg& bs, int b,
                             int d, int block_m, cudaStream_t st) {
  if (d == 64)
    return block_m == 64
               ? launch<T, 64, 1, DROP, BIAS>(q, k, v, p, bs, b, st)
               : launch<T, 64, 2, DROP, BIAS>(q, k, v, p, bs, b, st);
  return block_m == 64 ? launch<T, 128, 1, DROP, BIAS>(q, k, v, p, bs, b, st)
                       : launch<T, 128, 2, DROP, BIAS>(q, k, v, p, bs, b, st);
}

// the variant with dropout where the threshold keeps fewer than all, the
// variant with the bias where there is one, the variant with both where
// both are asked
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const Params& p, const BiasArg& bs, int b, int d,
                     int block_m, cudaStream_t st) {
  if (bs.ptr)
    return p.threshold
               ? dispatch_variant<T, true, true>(q, k, v, p, bs, b, d,
                                                 block_m, st)
               : dispatch_variant<T, false, true>(q, k, v, p, bs, b, d,
                                                  block_m, st);
  return p.threshold
             ? dispatch_variant<T, true, false>(q, k, v, p, bs, b, d,
                                                block_m, st)
             : dispatch_variant<T, false, false>(q, k, v, p, bs, b, d,
                                                 block_m, st);
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous tensors:
// q [b,h,sq,d] and k, v [b,h,sk,d] of one dtype (`dtype` 0 bf16, 1 fp16; a
// build holds one, ops/_build.py), d 64 or 128; sid_q [b,sq] and sid_kv
// [b,sk] int32, or both null; out [b,h,sq,d] in the operands' dtype, lse
// [b,h,sq] f32 (every element written). `block_m`: query rows a block, 64
// or 128. Returns the launch's cudaError_t: cudaErrorInvalidValue for
// another d, dtype or block_m, cudaErrorNotSupported (801) when the driver
// refuses a TMA map (a base address not 16-byte aligned). The bias:
// `bias` fp32 with its last two dims [sq, sk] contiguous and an 8-byte
// aligned base, `bias_sb` and `bias_sh` its batch and head strides in
// elements (0 for a broadcast dim), or null (the kernel without it).
// Dropout: `seed` (the int32 seed as uint32), `threshold` (an element is
// kept where its hash reaches it; 0 keeps every element and runs the
// kernel without dropout) and `inv` = 1 / (1 - rate). A bias with a
// threshold above 0 runs the variant with both.
extern "C" int apex_flash_fwd_sm90(const void* q, const void* k,
                                   const void* v, const void* sid_q,
                                   const void* sid_kv, void* out, void* lse,
                                   int b, int h, int sq, int sk, int d,
                                   int causal, float scale, int dtype,
                                   int block_m, const void* bias,
                                   long bias_sb, long bias_sh,
                                   unsigned int seed, unsigned int threshold,
                                   float inv, void* stream) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if (block_m != 64 && block_m != 128) return cudaErrorInvalidValue;
  if (sq <= 0 || b <= 0 || h <= 0) return cudaSuccess;
  const Params p{static_cast<const int32_t*>(sid_q),
                 static_cast<const int32_t*>(sid_kv), out,
                 static_cast<float*>(lse), h, sq, sk, causal, scale, seed,
                 threshold, inv};
  const BiasArg bs{static_cast<const float*>(bias), bias_sb, bias_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return dispatch<__nv_bfloat16>(q, k, v, p, bs, b, d, block_m, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return dispatch<__half>(q, k, v, p, bs, b, d, block_m, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}
