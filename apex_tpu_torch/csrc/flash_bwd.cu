// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from q, k, v, the
// output gradient do (bf16, fp16 or fp32, one dtype for all), the forward's
// lse and delta = rowsum(do * out) (fp32, computed by the caller as the JAX
// package computes it outside its kernels). Three kernels, the three Pallas
// backward kernels of apex_tpu/ops/flash_attention.py:
//
// - flash_bwd_kernel replaces `_bwd_fused_kernel` (:604, launched by
//   `_flash_bwd_impl` :787): the single-pass backward that recomputes
//   p = exp(s * scale - lse) ONCE per (q block, k block) pair and feeds it to
//   all three gradients;
// - flash_dkdv_kernel replaces `_dkdv_kernel` (:558, launched at :805): dk
//   and dv only, a k block resident while every q block streams past;
// - flash_dq_kernel replaces `_dq_kernel` (:671, launched at :820): dq only,
//   a q block resident while every k block streams past.
//
// The JAX package takes the two-kernel split past its 2 MB VMEM gate
// (`_FUSED_BWD_MAX_KV_BYTES`); the wrapper (ops/flash_attention.py) routes
// the same shapes the same way. Same masking rules as the forward
// (flash_fwd.cu): causal with the end-aligned offset sk - sq, segment ids
// whose negative values are padding, p = 0 wherever the mask is false — so
// padding rows (lse -1e30) give zero dq and add nothing to dk or dv. As in
// the Pallas kernels, p is rounded to the operands' dtype before the dv
// product, ds = p * (dp - delta) is rounded once before the dk and the dq
// products, and the softmax scale is applied at the finish. Over operands
// of mixed dtypes the wrapper promotes them to their common dtype (fp32 for
// any mix) and the fp32 kernels round where the Pallas kernels cast to a
// narrower operand's dtype (`rounds`): p to dout's dtype before dv, ds to
// q's before dk, and to q's then k's (single pass) or to k's (the split's
// dq kernel) before dq. Head dims 32, 64, 128, 256 and 512 are
// instantiated, for every dtype (the wrapper zero-pads other d). The fp32
// build also holds the kernels of flash_bwd_f32.cuh (an exact-FFMA core:
// the single pass, the split's dk/dv and its dq, behind apex_flash_bwd_f32,
// apex_flash_bwd_f32_dkdv and apex_flash_bwd_f32_dq): the wrapper sends
// fp32 operands at head dims 64 and 128 that round nothing there, and the
// kernels below take the rest of fp32 (d 32/256/512, mixed operands).
//
// Bounds on the H100, per live (q, k) pair at head dim d: the single pass
// does five products of 2 * d flops (s, dp, dv, dk, dq) — 42.9 GFLOP at the
// causal training shape b8 h16 s1024 d64, 0.043 ms at 989 TFLOP/s, against
// ~135 MB of q, k, v, do, dq, dk, dv, lse, delta (0.040 ms): nearly
// balanced. The split recomputes s and dp in both kernels: four products
// in dk/dv (s, dp, dv, dk), three in dq (s, dp, dq), seven in all. fp32 runs
// the SIMT product of frag.cuh here, ~1/30 of the bf16 rate.
//
// Design. The TPU kernels keep fp32 accumulators in VMEM across a
// sequential grid; a GPU grid has no order. Here a thread block of four
// warps owns a 64-row tile and loops over the other side's 64-row tiles,
// with its accumulators in fp32 registers (16 rows a warp), products
// through the m16n8k16 fragments of frag.cuh (tensor cores for 16-bit
// operands) and the accumulator fragments of one product converted in
// registers to the A operand of the next. The gradients' columns are split
// in chunks of DC (d itself up to 128 for 16-bit operands and up to 64 for
// fp32; 128 at 16-bit d 256, 64 at d 512), one block per chunk: each
// recomputes s and dp over
// the full d and accumulates only its DC columns, which bounds both the
// registers (two [16, DC] accumulators a warp) and the transposed tiles.
// - k-side blocks (single pass, dk/dv): K and V in shared memory; per q
//   tile each warp computes S^T = K Q^T and dP^T = V dO^T for its 16 keys,
//   forms P^T and dS^T in registers and accumulates dV += P^T dO and
//   dK += dS^T Q. The single pass then stages dS in shared memory,
//   computes the tile's [64, DC] share dS K and adds it into a zeroed
//   [b, h, sq, d] fp32 workspace that the caller casts to the operands'
//   dtype, in a fixed order (turns.cuh): the key tiles that reach a query
//   tile add their shares from the last down to the first, each after the
//   one before it has published its sum, with plain loads and stores, so
//   dq is the same bits on every run. The grid runs the key tiles in
//   reverse, so a block waits only for one dispatched before it, and
//   under a causal mask the block of key tile j + 1 is one query tile
//   ahead of key tile j's from its start, so a block seldom waits. The
//   dk/dv kernel stops before that staging: it keeps no
//   state beyond its own 64 keys at any sequence length, which is what
//   the split buys.
// - q-side blocks (dq): Q and dO in shared memory; per k tile each warp
//   computes S = Q K^T and dP = dO V^T for its 16 rows, forms dS in
//   registers and accumulates dQ += dS K. No atomics: dq is written once,
//   from its block's registers.
// Tiles are loaded synchronously; the B operands that need a transposed
// layout (the chunk's columns of Q, dO, K) are stored transposed as well,
// so every fragment is one pair load. The contractions of S and dP run
// over d in chunks of KC columns (d itself up to 256 for 16-bit operands
// and up to 128 for fp32, else 256 and 128): with one chunk the resident
// side's rows stay in shared memory for the whole loop; past it every
// chunk of both sides is staged in turn and S and dP accumulate in
// registers over the chunks, so shared memory is set by KC, not by d.
// Shared memory (k side): (4 * 64 * (KC + 8) + 4 * DC * 72) elements +
// 1 KB — 200 KB for bf16 at d 256, 172 KB at d 512, 213 KB for fp32 at
// d 128 and above. The fp32 S and dP products are rolled over their
// k-steps (the SIMT product unrolled is what made the fp32 build the
// slowest). wgmma/TMA and a pipelined ring are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frag.cuh"
#include "turns.cuh"
#if APEX_HAS_DTYPE(2)
#include "flash_bwd_f32.cuh"
#endif

namespace {

constexpr int BLOCK_M = 64;   // q rows per tile
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;

template <typename T, int D>
struct Smem {
  // gradient columns per block (64 for 16-bit operands at d 512, whose
  // two [16, 128] accumulators a warp would spill)
  static constexpr int DC = sizeof(T) == 4 || D > 256 ? (D < 64 ? D : 64)
                                                      : (D < 128 ? D : 128);
  static constexpr int NCH = D / DC;
  // contraction columns of S and dP staged at once (the sums run over
  // D / KC chunks)
  static constexpr int KC = sizeof(T) == 4 ? (D < 128 ? D : 128)
                                           : (D < 256 ? D : 256);
  static constexpr int NKC = D / KC;
  // the fp32 (SIMT) products of S and dP are rolled over their k-steps: no
  // register array is indexed by the step, and unrolled they make the fp32
  // build the slowest of all
  static constexpr int KUNROLL = sizeof(T) == 4 ? 1 : KC / 16;
  static constexpr int LDR = KC + PAD;       // row-major [64][KC + PAD]
  static constexpr int LDT = BLOCK_M + PAD;  // transposed [DC][64 + PAD]
  // sK sV sQ sDO, sKt sQt sDOt, sdS, lse delta sid_q sid_k
  static constexpr size_t bytes =
      (size_t)(4 * 64 * LDR + 3 * DC * LDT + BLOCK_M * LDT) * sizeof(T) +
      (size_t)4 * 64 * 4;
  // the dq kernel: sQ sDO sK sV, sKt, sid_k
  static constexpr size_t dq_bytes =
      (size_t)(4 * 64 * LDR + DC * LDT) * sizeof(T) + (size_t)64 * 4;
};

// Row-major copy of columns [c0, c0 + KC) of rows [r0, r0 + 64) of src
// ([rows, D], zero past `rows`) into dst [64][KC + PAD].
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* src, int r0, int rows,
                                          int c0, T* dst) {
  constexpr int VEC = kVec<T>;
  constexpr int CHUNKS = Smem<T, D>::KC / VEC;
  constexpr int LDR = Smem<T, D>::LDR;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * D + c0 +
                                            c * VEC);
    *reinterpret_cast<uint4*>(dst + r * LDR + c * VEC) = val;
  }
}

// The roundings of the fp32 kernels over promoted mixed operands, packed
// as dtype codes (0 bf16, 1 fp16, 2 none) in `rounds`: bits 0-1 p before
// the dv product (dout's dtype), 2-3 ds before the dk product (q's), 4-5
// ds before the dq product (k's).
__device__ __forceinline__ int round_code(int rounds, int which) {
  return (rounds >> (2 * which)) & 3;
}

// Transpose of columns [c0, c0 + DC) of the same rows into dt [DC][64 + PAD]:
// consecutive threads on consecutive rows, so a warp's element stores fall
// in distinct banks.
template <typename T, int D>
__device__ __forceinline__ void load_cols_t(const T* src, int r0, int rows,
                                            int c0, T* dt) {
  constexpr int VEC = kVec<T>;
  constexpr int DC = Smem<T, D>::DC;
  constexpr int LDT = Smem<T, D>::LDT;
  for (int idx = threadIdx.x; idx < 64 * (DC / VEC); idx += THREADS) {
    const int tr = idx % 64, tc = idx / 64;
    uint4 tv = make_uint4(0, 0, 0, 0);
    if (r0 + tr < rows)
      tv = *reinterpret_cast<const uint4*>(src + (long)(r0 + tr) * D + c0 +
                                           tc * VEC);
    const T* te = reinterpret_cast<const T*>(&tv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dt[(tc * VEC + e) * LDT + tr] = te[e];
  }
}

// The A fragments of rows [r, r + 16), k-step kk, of a row-major tile.
template <typename T>
__device__ __forceinline__ void load_a(const T* base, int ld, int r, int c,
                                       typename Frag<T>::pair* a) {
  using F = Frag<T>;
  const int g = (threadIdx.x % 32) / 4;
  a[0] = F::load(base + (r + g) * ld + c);
  a[1] = F::load(base + (r + g + 8) * ld + c);
  a[2] = F::load(base + (r + g) * ld + c + 8);
  a[3] = F::load(base + (r + g + 8) * ld + c + 8);
}

// One block of 64 keys of one (batch, head), gradient columns
// [c0, c0 + DC): dk and dv, and with WITH_DQ the block's dq share added
// into dq_acc in its turn (the single pass; `dq_turns` one zeroed counter a
// (batch x chunk, head, q tile), the grid's key tiles in reverse).
template <typename T, int D, bool WITH_DQ>
__device__ __forceinline__ void kv_block(
    unsigned char* smem_raw, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ sid_q,
    const int32_t* __restrict__ sid_kv, float* __restrict__ dq_acc,
    int* __restrict__ dq_turns, T* __restrict__ dk, T* __restrict__ dv, int h,
    int sq, int sk, int causal, float scale, int rounds) {
  using F = Frag<T>;
  using P = typename F::pair;
  using S = Smem<T, D>;
  constexpr int LDR = S::LDR;
  constexpr int LDT = S::LDT;
  constexpr int DC = S::DC;
  constexpr int KSTEPS = S::KC / 16;     // k-steps of S^T = K Q^T a chunk
  constexpr int DTILES = DC / 8;         // n-tiles over the chunk
  constexpr int QTILES = BLOCK_M / 8;    // n-tiles of S^T (q columns)

  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + 64 * LDR;
  T* sQ = sV + 64 * LDR;
  T* sDO = sQ + 64 * LDR;
  T* sKt = sDO + 64 * LDR;
  T* sQt = sKt + DC * LDT;
  T* sDOt = sQt + DC * LDT;
  T* sdS = sDOt + DC * LDT;            // [q][key]
  float* sLse = reinterpret_cast<float*>(sdS + BLOCK_M * LDT);
  float* sDelta = sLse + 64;
  int32_t* sSidQ = reinterpret_cast<int32_t*>(sDelta + 64);
  int32_t* sSidK = sSidQ + 64;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n_kt = gridDim.x;
  const int jt = WITH_DQ ? n_kt - 1 - blockIdx.x : blockIdx.x;
  const int n0 = jt * BLOCK_N;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z / S::NCH, c0 = (blockIdx.z % S::NCH) * DC;
  const long bh = (long)bi * h + hh;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  const T* dob = dout + bh * sq * D;
  const int offset = sk - sq;
  const bool use_seg = sid_q != nullptr;

  if constexpr (S::NKC == 1) {       // K and V stay for the whole loop
    load_rows<T, D>(kb, n0, sk, 0, sK);
    load_rows<T, D>(vb, n0, sk, 0, sV);
  }
  if (WITH_DQ) load_cols_t<T, D>(kb, n0, sk, c0, sKt);
  for (int r = tid; r < 64; r += THREADS)
    sSidK[r] = (use_seg && n0 + r < sk) ? sid_kv[(long)bi * sk + n0 + r] : -1;

  const int kw = warp * 16;                  // this warp's keys in the tile
  const int key0 = n0 + kw + g, key1 = key0 + 8;
  float dva[DTILES][4], dka[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[t][e] = dka[t][e] = 0.f;

  const int n_qt = (sq + BLOCK_M - 1) / BLOCK_M;
  int qt_begin = 0;
  if (causal) qt_begin = max(0, n0 - offset) / BLOCK_M;

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * BLOCK_M;
    // ---- S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 q,
    // summed over the contraction chunks (staged with K's and V's chunks
    // past one chunk)
    float st[QTILES][4], dpt[QTILES][4];
#pragma unroll
    for (int j = 0; j < QTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    for (int kc = 0; kc < S::NKC; ++kc) {
      const int cc = kc * S::KC;
      __syncthreads();  // every warp is done with the previous tiles
      if constexpr (S::NKC > 1) {
        load_rows<T, D>(kb, n0, sk, cc, sK);
        load_rows<T, D>(vb, n0, sk, cc, sV);
      }
      load_rows<T, D>(qb, q0, sq, cc, sQ);
      load_rows<T, D>(dob, q0, sq, cc, sDO);
      if (kc == 0) {
        load_cols_t<T, D>(qb, q0, sq, c0, sQt);
        load_cols_t<T, D>(dob, q0, sq, c0, sDOt);
        for (int r = tid; r < 64; r += THREADS) {
          const bool in = q0 + r < sq;
          sLse[r] = in ? lse[bh * sq + q0 + r] : 0.f;
          sDelta[r] = in ? delta[bh * sq + q0 + r] : 0.f;
          sSidQ[r] = (use_seg && in) ? sid_q[(long)bi * sq + q0 + r] : -1;
        }
      }
      __syncthreads();
#pragma unroll (S::KUNROLL)
      for (int kk = 0; kk < KSTEPS; ++kk) {
        P ak[4], av[4];
        const int c = kk * 16 + tig * 2;
        load_a<T>(sK, LDR, kw, c, ak);
        load_a<T>(sV, LDR, kw, c, av);
#pragma unroll
        for (int j = 0; j < QTILES; ++j) {
          const T* pq = sQ + (j * 8 + g) * LDR + c;
          F::mma(st[j], ak, F::load(pq), F::load(pq + 8));
          const T* pd = sDO + (j * 8 + g) * LDR + c;
          F::mma(dpt[j], av, F::load(pd), F::load(pd + 8));
        }
      }
    }

    // ---- mask, p = exp(s * scale - lse), ds = p * (dp - delta)
#pragma unroll
    for (int j = 0; j < QTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + tig * 2 + (e & 1);
        const int qrow = q0 + ql;
        const int key = e < 2 ? key0 : key1;
        bool ok = qrow < sq && key < sk && (!causal || key <= qrow + offset);
        if (use_seg) {
          const int sr = sSidQ[ql];
          ok = ok && sr >= 0 && sr == sSidK[key - n0];
        }
        const float p = ok ? __expf(st[j][e] * scale - sLse[ql]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDelta[ql]);
      }
    }

    // ---- dV += P^T dO and dK += dS^T Q (k-steps over the 64 q rows); the
    // fp32 kernels round p and ds to the operands' own dtypes (`rounds`)
    // where the wrapper promoted mixed operands, as the Pallas kernel casts
    // p to dout's dtype and ds to q's; in fp32 the single pass keeps ds
    // unrounded in dpt for the staging below
#pragma unroll
    for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[jj][e] = round_to(st[jj][e], round_code(rounds, 0));
            if constexpr (!WITH_DQ)
              dpt[jj][e] = round_to(dpt[jj][e], round_code(rounds, 1));
          }
      }
      P pa[4], da[4];
      pa[0] = F::pack(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = F::pack(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = F::pack(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = F::pack(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      if constexpr (sizeof(T) == 4 && WITH_DQ) {
        const int rq = round_code(rounds, 1);
        da[0] = F::pack(round_to(dpt[2 * kk][0], rq),
                        round_to(dpt[2 * kk][1], rq));
        da[1] = F::pack(round_to(dpt[2 * kk][2], rq),
                        round_to(dpt[2 * kk][3], rq));
        da[2] = F::pack(round_to(dpt[2 * kk + 1][0], rq),
                        round_to(dpt[2 * kk + 1][1], rq));
        da[3] = F::pack(round_to(dpt[2 * kk + 1][2], rq),
                        round_to(dpt[2 * kk + 1][3], rq));
      } else {
        da[0] = F::pack(dpt[2 * kk][0], dpt[2 * kk][1]);
        da[1] = F::pack(dpt[2 * kk][2], dpt[2 * kk][3]);
        da[2] = F::pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        da[3] = F::pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
      }
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const T* pd = sDOt + (t * 8 + g) * LDT + kk * 16 + tig * 2;
        F::mma(dva[t], pa, F::load(pd), F::load(pd + 8));
        const T* pq = sQt + (t * 8 + g) * LDT + kk * 16 + tig * 2;
        F::mma(dka[t], da, F::load(pq), F::load(pq + 8));
      }
    }

    if constexpr (WITH_DQ) {
      // ---- stage dS (rounded to T; in fp32 over mixed operands to q's
      // dtype, then k's, as the Pallas kernel's dsc.astype(k.dtype)) as
      // [q][key] for the dQ product
#pragma unroll
      for (int j = 0; j < QTILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + tig * 2 + (e & 1);
          const int kl = kw + g + (e < 2 ? 0 : 8);
          float ds = dpt[j][e];
          if constexpr (sizeof(T) == 4)
            ds = round_to(round_to(ds, round_code(rounds, 1)),
                          round_code(rounds, 2));
          sdS[ql * LDT + kl] = F::cvt(ds);
        }
      __syncthreads();

      // ---- dQ[q0 + 16 warp rows, chunk] += dS K over the 64 keys
      float dqa[DTILES][4];
#pragma unroll
      for (int t = 0; t < DTILES; ++t)
        dqa[t][0] = dqa[t][1] = dqa[t][2] = dqa[t][3] = 0.f;
      const int qw = warp * 16;
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        P a[4];
        const int c = kk * 16 + tig * 2;
        load_a<T>(sdS, LDT, qw, c, a);
#pragma unroll
        for (int t = 0; t < DTILES; ++t) {
          const T* pk = sKt + (t * 8 + g) * LDT + c;
          F::mma(dqa[t], a, F::load(pk), F::load(pk + 8));
        }
      }
      // ---- the block's turn on this q tile: the key tiles that reach it
      // add in descending order, the last (causal: min(n_kt - 1, the
      // tile's last row + offset over 64)) first; loads and stores at L2
      // (no stale L1 line), published before the turn passes on
      int* turn = dq_turns + ((long)blockIdx.z * h + hh) * n_qt + qt;
      if (tid == 0) {
        const int last =
            causal ? min(n_kt - 1, (q0 + BLOCK_M - 1 + offset) / BLOCK_N)
                   : n_kt - 1;
        turns::wait(turn, last - jt);
      }
      __syncthreads();
      const int qr0 = q0 + qw + g, qr1 = qr0 + 8;
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const int col = c0 + t * 8 + tig * 2;
        if (qr0 < sq) {
          float2* dst =
              reinterpret_cast<float2*>(dq_acc + (bh * sq + qr0) * D + col);
          const float2 cur = __ldcg(dst);
          __stcg(dst, make_float2(cur.x + dqa[t][0] * scale,
                                  cur.y + dqa[t][1] * scale));
        }
        if (qr1 < sq) {
          float2* dst =
              reinterpret_cast<float2*>(dq_acc + (bh * sq + qr1) * D + col);
          const float2 cur = __ldcg(dst);
          __stcg(dst, make_float2(cur.x + dqa[t][2] * scale,
                                  cur.y + dqa[t][3] * scale));
        }
      }
      __syncthreads();    // the block's stores, published by the release
      if (tid == 0) turns::pass(turn);
    }
  }

  // ---- finish: dk (scaled) and dv for this warp's keys, chunk columns
  T* dkb = dk + bh * sk * D + c0;
  T* dvb = dv + bh * sk * D + c0;
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + tig * 2;
    if (key0 < sk) {
      *reinterpret_cast<P*>(dkb + (long)key0 * D + col) =
          F::pack(dka[t][0] * scale, dka[t][1] * scale);
      *reinterpret_cast<P*>(dvb + (long)key0 * D + col) =
          F::pack(dva[t][0], dva[t][1]);
    }
    if (key1 < sk) {
      *reinterpret_cast<P*>(dkb + (long)key1 * D + col) =
          F::pack(dka[t][2] * scale, dka[t][3] * scale);
      *reinterpret_cast<P*>(dvb + (long)key1 * D + col) =
          F::pack(dva[t][2], dva[t][3]);
    }
  }
}

#define KV_ARGS                                                           \
  const T *__restrict__ q, const T *__restrict__ k,                       \
      const T *__restrict__ v, const T *__restrict__ dout,                \
      const float *__restrict__ lse, const float *__restrict__ delta,     \
      const int32_t *__restrict__ sid_q,                                  \
      const int32_t *__restrict__ sid_kv, float *__restrict__ dq_acc,     \
      int *__restrict__ dq_turns, T *__restrict__ dk, T *__restrict__ dv,    \
      int h, int sq, int sk, int causal, float scale, int rounds
#define KV_PASS q, k, v, dout, lse, delta, sid_q, sid_kv, dq_acc, dq_turns, \
                dk, dv, h, sq, sk, causal, scale, rounds

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_kernel(KV_ARGS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  kv_block<T, D, true>(smem_raw, KV_PASS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_dkdv_kernel(KV_ARGS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  kv_block<T, D, false>(smem_raw, KV_PASS);
}

// One block of 64 q rows of one (batch, head), dq columns [c0, c0 + DC):
// no atomics.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ sid_q,
                const int32_t* __restrict__ sid_kv, T* __restrict__ dq,
                int h, int sq, int sk, int causal, float scale, int rounds) {
  using F = Frag<T>;
  using P = typename F::pair;
  using S = Smem<T, D>;
  constexpr int LDR = S::LDR;
  constexpr int LDT = S::LDT;
  constexpr int DC = S::DC;
  constexpr int KSTEPS = S::KC / 16;     // k-steps of S = Q K^T a chunk
  constexpr int DTILES = DC / 8;         // n-tiles of dq over the chunk
  constexpr int NTILES = BLOCK_N / 8;    // n-tiles of S (key columns)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = sQ + 64 * LDR;
  T* sK = sDO + 64 * LDR;
  T* sV = sK + 64 * LDR;
  T* sKt = sV + 64 * LDR;              // [chunk col][key]
  int32_t* sSidK = reinterpret_cast<int32_t*>(sKt + DC * LDT);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * BLOCK_M;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z / S::NCH, c0 = (blockIdx.z % S::NCH) * DC;
  const long bh = (long)bi * h + hh;
  const T* qb = q + bh * sq * D;
  const T* dob = dout + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  const int offset = sk - sq;
  const bool use_seg = sid_q != nullptr;

  if constexpr (S::NKC == 1) {       // Q and dO stay for the whole loop
    load_rows<T, D>(qb, m0, sq, 0, sQ);
    load_rows<T, D>(dob, m0, sq, 0, sDO);
  }

  // this thread's two rows (g and g + 8 of the warp's 16)
  const int qw = warp * 16;
  const int row0 = m0 + qw + g, row1 = row0 + 8;
  const bool in0 = row0 < sq, in1 = row1 < sq;
  const float lse0 = in0 ? lse[bh * sq + row0] : 0.f;
  const float lse1 = in1 ? lse[bh * sq + row1] : 0.f;
  const float dl0 = in0 ? delta[bh * sq + row0] : 0.f;
  const float dl1 = in1 ? delta[bh * sq + row1] : 0.f;
  const int sid0 = (use_seg && in0) ? sid_q[(long)bi * sq + row0] : -1;
  const int sid1 = (use_seg && in1) ? sid_q[(long)bi * sq + row1] : -1;

  float dqa[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t)
    dqa[t][0] = dqa[t][1] = dqa[t][2] = dqa[t][3] = 0.f;

  // causal: the last key any row of the tile sees is its last row + offset
  const int n_kt = (sk + BLOCK_N - 1) / BLOCK_N;
  int kt_end = n_kt;
  if (causal) {
    const int last = min(sq - 1, m0 + BLOCK_M - 1) + offset;
    kt_end = last < 0 ? 0 : min(n_kt, last / BLOCK_N + 1);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int n0 = kt * BLOCK_N;
    // ---- S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys,
    // summed over the contraction chunks
    float s[NTILES][4], dp[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int kc = 0; kc < S::NKC; ++kc) {
      const int cc = kc * S::KC;
      __syncthreads();  // every warp is done with the previous tiles
      if constexpr (S::NKC > 1) {
        load_rows<T, D>(qb, m0, sq, cc, sQ);
        load_rows<T, D>(dob, m0, sq, cc, sDO);
      }
      load_rows<T, D>(kb, n0, sk, cc, sK);
      load_rows<T, D>(vb, n0, sk, cc, sV);
      if (kc == 0) {
        load_cols_t<T, D>(kb, n0, sk, c0, sKt);
        for (int r = tid; r < 64; r += THREADS)
          sSidK[r] =
              (use_seg && n0 + r < sk) ? sid_kv[(long)bi * sk + n0 + r] : -1;
      }
      __syncthreads();
#pragma unroll (S::KUNROLL)
      for (int kk = 0; kk < KSTEPS; ++kk) {
        P aq[4], ad[4];
        const int c = kk * 16 + tig * 2;
        load_a<T>(sQ, LDR, qw, c, aq);
        load_a<T>(sDO, LDR, qw, c, ad);
#pragma unroll
        for (int j = 0; j < NTILES; ++j) {
          const T* pk = sK + (j * 8 + g) * LDR + c;
          F::mma(s[j], aq, F::load(pk), F::load(pk + 8));
          const T* pv = sV + (j * 8 + g) * LDR + c;
          F::mma(dp[j], ad, F::load(pv), F::load(pv + 8));
        }
      }
    }

    // ---- mask, p = exp(s * scale - lse), ds = p * (dp - delta) (in s)
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int row = lo ? row0 : row1;
        const int key = n0 + j * 8 + tig * 2 + (e & 1);
        bool ok = row < sq && key < sk && (!causal || key <= row + offset);
        if (use_seg) {
          const int sr = lo ? sid0 : sid1;
          ok = ok && sr >= 0 && sr == sSidK[key - n0];
        }
        const float p =
            ok ? __expf(s[j][e] * scale - (lo ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (lo ? dl0 : dl1));
      }
    }

    // ---- dQ += dS K (k-steps over the 64 keys; dS rounded to T, or in
    // fp32 over mixed operands to k's dtype, as the Pallas `_dq_kernel`'s
    // ds.astype(k.dtype))
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < NTILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = round_to(s[j][e], round_code(rounds, 2));
    }
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      P a[4];
      a[0] = F::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = F::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = F::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = F::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const T* pk = sKt + (t * 8 + g) * LDT + kk * 16 + tig * 2;
        F::mma(dqa[t], a, F::load(pk), F::load(pk + 8));
      }
    }
  }

  // ---- finish: dq (scaled), once, chunk columns
  T* dqb = dq + bh * sq * D + c0;
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + tig * 2;
    if (in0)
      *reinterpret_cast<P*>(dqb + (long)row0 * D + col) =
          F::pack(dqa[t][0] * scale, dqa[t][1] * scale);
    if (in1)
      *reinterpret_cast<P*>(dqb + (long)row1 * D + col) =
          F::pack(dqa[t][2] * scale, dqa[t][3] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *sid_q, *sid_kv;
  void *dq, *dk, *dv;       // dq: the fp32 workspace in the single pass
  void* turns;              // the single pass's turn counters
  int b, h, sq, sk, causal;
  float scale;
  int rounds;
  cudaStream_t stream;
};

template <typename T, int D, int KIND>   // 0 single pass, 1 dk/dv, 2 dq
cudaError_t launch(const Args& a) {
  using S = Smem<T, D>;
  const size_t smem = KIND == 2 ? S::dq_bytes : S::bytes;
  auto kernel = KIND == 0 ? flash_bwd_kernel<T, D> : flash_dkdv_kernel<T, D>;
  cudaError_t err;
  if constexpr (KIND == 2) {
    err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.sq + BLOCK_M - 1) / BLOCK_M, a.h, a.b * S::NCH);
    flash_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const int32_t*>(a.sid_q),
        static_cast<const int32_t*>(a.sid_kv), static_cast<T*>(a.dq), a.h,
        a.sq, a.sk, a.causal, a.scale, a.rounds);
    return cudaGetLastError();
  } else {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.sk + BLOCK_N - 1) / BLOCK_N, a.h, a.b * S::NCH);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const int32_t*>(a.sid_q),
        static_cast<const int32_t*>(a.sid_kv), static_cast<float*>(a.dq),
        static_cast<int*>(a.turns), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.h, a.sq, a.sk, a.causal, a.scale,
        a.rounds);
    return cudaGetLastError();
  }
}

template <typename T, int KIND>
cudaError_t dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 32: return launch<T, 32, KIND>(a);
    case 64: return launch<T, 64, KIND>(a);
    case 128: return launch<T, 128, KIND>(a);
    case 256: return launch<T, 256, KIND>(a);
    case 512: return launch<T, 512, KIND>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
int dispatch(const Args& a, int d, int dtype) {
  if (a.b <= 0 || a.h <= 0 || (KIND == 2 ? a.sq : a.sk) <= 0)
    return cudaSuccess;
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return dispatch_dim<__nv_bfloat16, KIND>(a, d);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return dispatch_dim<__half, KIND>(a, d);
#else
      return cudaErrorInvalidValue;
#endif
    case 2:
#if APEX_HAS_DTYPE(2)
      return dispatch_dim<float, KIND>(a, d);
#else
      return cudaErrorInvalidValue;
#endif
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous tensors:
// q, dout [b,h,sq,d] and k, v [b,h,sk,d] of one dtype (`dtype` 0 bf16,
// 1 fp16, 2 fp32); lse, delta [b,h,sq] f32; sid_q [b,sq] and sid_kv [b,sk]
// int32, or both null; `rounds` the fp32 kernels' roundings over promoted
// mixed operands (round_code; 0x2A rounds nothing). Each returns the
// launch's cudaError_t (cudaErrorInvalidValue for a head dim other than 32,
// 64, 128, 256, 512 or an unknown dtype).
//
// The single pass: dq_acc [b,h,sq,d] f32, ZEROED by the caller (the kernel
// adds into it, scale applied, in a fixed order); turns, b * h *
// ceil(sq / 64) * (d / 32) int32 ZEROED by the caller (one counter a
// query tile and gradient-column chunk; left at each tile's count of
// contributors); dk, dv [b,h,sk,d] (every element written).
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* sid_q,
                              const void* sid_kv, void* dq_acc, void* turns,
                              void* dk, void* dv, int b, int h, int sq,
                              int sk, int d, int causal, float scale,
                              int dtype, int rounds, void* stream) {
  const Args a{q, k, v, dout, lse, delta, sid_q, sid_kv, dq_acc, dk, dv,
               turns, b, h, sq, sk, causal, scale, rounds,
               static_cast<cudaStream_t>(stream)};
  return dispatch<0>(a, d, dtype);
}

// The split, dk/dv half: dk, dv [b,h,sk,d] (every element written).
extern "C" int apex_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* sid_q, const void* sid_kv,
                                   void* dk, void* dv, int b, int h, int sq,
                                   int sk, int d, int causal, float scale,
                                   int dtype, int rounds, void* stream) {
  const Args a{q, k, v, dout, lse, delta, sid_q, sid_kv, nullptr, dk, dv,
               nullptr, b, h, sq, sk, causal, scale, rounds,
               static_cast<cudaStream_t>(stream)};
  return dispatch<1>(a, d, dtype);
}

// The split, dq half: dq [b,h,sq,d] (every element written).
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* sid_q,
                                 const void* sid_kv, void* dq, int b, int h,
                                 int sq, int sk, int d, int causal,
                                 float scale, int dtype, int rounds,
                                 void* stream) {
  const Args a{q, k, v, dout, lse, delta, sid_q, sid_kv, dq, nullptr, nullptr,
               nullptr, b, h, sq, sk, causal, scale, rounds,
               static_cast<cudaStream_t>(stream)};
  return dispatch<2>(a, d, dtype);
}

#if APEX_HAS_DTYPE(2)
namespace {

template <bool WITH_DQ>
int f32_dispatch(const void* q, const void* k, const void* v,
                 const void* dout, const void* out, const void* lse,
                 const void* delta,
                 const void* sid_q, const void* sid_kv, void* ws,
                 void* dq_acc, void* turns, void* dk, void* dv, int b, int h,
                 int sq, int sk, int d, int causal, float scale,
                 const fa32::Bias& bs, const fa32::Dropout& dr,
                 void* stream) {
  if (b <= 0 || h <= 0 || sq < 0) return cudaSuccess;
  if (sk <= 0)   // no key: dq is zero (dk and dv are empty)
    return WITH_DQ && sq > 0
               ? cudaMemsetAsync(dq_acc, 0, (size_t)b * h * sq * d * 4,
                                 static_cast<cudaStream_t>(stream))
               : cudaSuccess;
  fa32::Params p{};
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.sid_q = static_cast<const int32_t*>(sid_q);
  p.sid_kv = static_cast<const int32_t*>(sid_kv);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.turns = static_cast<int*>(turns);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  const float* qf = static_cast<const float*>(q);
  const float* df = static_cast<const float*>(dout);
  const float* of = static_cast<const float*>(out);
  float* wf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return fa32::launch<64, WITH_DQ>(qf, df, of, wf, p, dr, bs, b, st);
    case 128:
      return fa32::launch<128, WITH_DQ>(qf, df, of, wf, p, dr, bs, b, st);
    default: return cudaErrorInvalidValue;
  }
}

// the C entries' bias: null, or fp32 with its strides (1 / scale for the
// kernels' accumulators)
fa32::Bias f32_bias(const void* bias, long sb, long sh, float scale) {
  return fa32::Bias{static_cast<const float*>(bias), sb, sh, 1.f / scale};
}

}  // namespace
#endif

// The fp32 exact-FFMA route (flash_bwd_f32.cuh; the fp32 build only,
// cudaErrorInvalidValue elsewhere and for a head dim other than 64 or
// 128): fp32 q, dout [b,h,sq,d], k, v [b,h,sk,d]; lse, delta [b,h,sq];
// out, the forward's output [b,h,sq,d], or null: given, the prologue
// writes delta = rowsum(dout * out) (the delta fold), else delta is read;
// sid_q [b,sq] and sid_kv [b,sk] int32, or both null; ws, 2 * b * h * d *
// ((sq + 3) / 4 * 4) fp32 of scratch (q and dout transposed). The single
// pass: dq_acc [b,h,sq,d] fp32 (dq times scale; every element written: the
// key blocks that reach a query tile add into it in a fixed order, the
// first storing) and turns, b * h * ceil(sq / 64) int32, ZEROED by the
// caller;
// dk, dv [b,h,sk,d] (every element written). Each entry takes the bias
// and attention dropout as the wgmma entries do: `bias` fp32 with its last
// two dims [sq, sk] contiguous and a 16-byte aligned base, `bias_sb` and
// `bias_sh` its batch and head strides in elements (0 for a broadcast dim),
// or null (no bias); `seed`, `threshold` (0: none) and `inv` = 1 / (1 -
// rate), and delta (folded or given) is then rowsum(dout * out) of the
// dropped output. A bias with a threshold above 0 runs the variant with
// both. Each returns the first failing launch's cudaError_t.
extern "C" int apex_flash_bwd_f32(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* out, const void* lse,
                                  void* delta,
                                  const void* sid_q, const void* sid_kv,
                                  void* ws, void* dq_acc, void* turns,
                                  void* dk, void* dv, int b, int h, int sq,
                                  int sk, int d, int causal, float scale,
                                  const void* bias, long bias_sb,
                                  long bias_sh, unsigned int seed,
                                  unsigned int threshold, float inv,
                                  void* stream) {
#if APEX_HAS_DTYPE(2)
  return f32_dispatch<true>(q, k, v, dout, out, lse, delta, sid_q, sid_kv,
                            ws, dq_acc, turns, dk, dv, b, h, sq, sk, d,
                            causal, scale,
                            f32_bias(bias, bias_sb, bias_sh, scale),
                            fa32::Dropout{seed, threshold, inv}, stream);
#else
  return cudaErrorInvalidValue;
#endif
}

// The split's dk/dv half on the same route: dk, dv [b,h,sk,d]; the bias
// and the dropout as above.
extern "C" int apex_flash_bwd_f32_dkdv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* out, const void* lse,
                                       void* delta,
                                       const void* sid_q,
                                       const void* sid_kv, void* ws,
                                       void* dk, void* dv, int b, int h,
                                       int sq, int sk, int d, int causal,
                                       float scale, const void* bias,
                                       long bias_sb, long bias_sh,
                                       unsigned int seed,
                                       unsigned int threshold, float inv,
                                       void* stream) {
#if APEX_HAS_DTYPE(2)
  return f32_dispatch<false>(q, k, v, dout, out, lse, delta, sid_q,
                             sid_kv, ws, nullptr, nullptr, dk, dv, b, h, sq,
                             sk, d, causal, scale,
                             f32_bias(bias, bias_sb, bias_sh, scale),
                             fa32::Dropout{seed, threshold, inv}, stream);
#else
  return cudaErrorInvalidValue;
#endif
}

// The split's dq half on the same route: dq [b,h,sq,d] fp32 (every
// element written, times scale); delta read (the dk/dv call's fold wrote
// it); ws as above: with `transposed` non-zero it already holds q and dout
// transposed (the dk/dv call's prologue, on the same q and dout), else
// this call's prologue writes them first; the bias and the dropout as
// above.
extern "C" int apex_flash_bwd_f32_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* sid_q, const void* sid_kv,
                                     void* ws, int transposed, void* dq,
                                     int b, int h, int sq, int sk, int d,
                                     int causal, float scale,
                                     const void* bias, long bias_sb,
                                     long bias_sh, unsigned int seed,
                                     unsigned int threshold, float inv,
                                     void* stream) {
#if APEX_HAS_DTYPE(2)
  if (b <= 0 || h <= 0 || sq <= 0) return cudaSuccess;
  fa32::Params p{};
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.sid_q = static_cast<const int32_t*>(sid_q);
  p.sid_kv = static_cast<const int32_t*>(sid_kv);
  p.h = h;
  p.sq = sq;
  p.sk = sk < 0 ? 0 : sk;
  p.causal = causal;
  p.scale = scale;
  const float* qf = static_cast<const float*>(q);
  const float* df = static_cast<const float*>(dout);
  float* wf = static_cast<float*>(ws);
  float* out = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const fa32::Dropout dr{seed, threshold, inv};
  const fa32::Bias bs = f32_bias(bias, bias_sb, bias_sh, scale);
  switch (d) {
    case 64:
      return fa32::launch_dq<64>(qf, df, wf, transposed != 0, p, out, dr, bs,
                                 b, st);
    case 128:
      return fa32::launch_dq<128>(qf, df, wf, transposed != 0, p, out, dr,
                                  bs, b, st);
    default: return cudaErrorInvalidValue;
  }
#else
  return cudaErrorInvalidValue;
#endif
}
