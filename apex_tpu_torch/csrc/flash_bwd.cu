// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from q, k, v, the
// output gradient do (bf16), the forward's lse and delta = rowsum(do * out)
// (fp32, computed by the caller as the JAX package computes it outside its
// kernels). Three kernels, the three Pallas backward kernels of
// apex_tpu/ops/flash_attention.py:
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
// the Pallas kernels, p is rounded to bf16 before the dv product, ds =
// p * (dp - delta) is rounded to bf16 once before the dk and the dq
// products, and the softmax scale is applied at the finish.
//
// Bounds on the H100, per live (q, k) pair at head dim d: the single pass
// does five products of 2 * d flops (s, dp, dv, dk, dq) — 42.9 GFLOP at the
// causal training shape b8 h16 s1024 d64, 0.043 ms at 989 TFLOP/s, against
// ~135 MB of q, k, v, do, dq, dk, dv, lse, delta (0.040 ms): nearly
// balanced. The split recomputes s and dp in both kernels: four products
// in dk/dv (s, dp, dv, dk), three in dq (s, dp, dq), seven in all.
//
// Design. The TPU kernels keep fp32 accumulators in VMEM across a
// sequential grid; a GPU grid has no order. Here a thread block of four
// warps owns a 64-row tile and loops over the other side's 64-row tiles,
// with its accumulators in fp32 registers (16 rows a warp), products on the
// tensor cores (`mma.sync.m16n8k16`, bf16 in, fp32 accumulate) and the
// accumulator fragments of one product converted in registers to the A
// operand of the next.
// - k-side blocks (single pass, dk/dv): K and V in shared memory; per q
//   tile each warp computes S^T = K Q^T and dP^T = V dO^T for its 16 keys,
//   forms P^T and dS^T in registers and accumulates dV += P^T dO and
//   dK += dS^T Q. The single pass then stages dS (bf16) in shared memory,
//   computes the tile's [64, d] share dS K and adds it with fp32 atomicAdd
//   into a zeroed [b, h, sq, d] fp32 workspace that the caller casts to
//   bf16 (the atomics make dq's summation order vary from run to run, a
//   last-bit effect in fp32). The dk/dv kernel stops before that staging:
//   it keeps no state beyond its own 64 keys at any sequence length, which
//   is what the split buys.
// - q-side blocks (dq): Q and dO in shared memory; per k tile each warp
//   computes S = Q K^T and dP = dO V^T for its 16 rows, forms dS in
//   registers and accumulates dQ += dS K. No atomics: dq is written once,
//   in bf16, from its block's registers.
// Tiles are loaded synchronously; the B operands that need a transposed
// layout (Q, dO, K) are stored transposed as well, so every fragment is a
// 32-bit shared load. wgmma/TMA and a pipelined ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // q rows per tile
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_m16n8k16(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct Smem {
  static constexpr int LDR = D + PAD;        // row-major [64][D + PAD]
  static constexpr int LDT = BLOCK_M + PAD;  // transposed [D][64 + PAD]
  static constexpr size_t bytes =
      (size_t)(4 * 64 * LDR + 3 * D * LDT + BLOCK_M * LDT) * 2 +
      (size_t)4 * 64 * 4;
};

// The dq kernel: sQ, sDO, sK, sV row-major, sKt transposed, key segment ids.
template <int D>
struct DqSmem {
  static constexpr int LDR = Smem<D>::LDR;
  static constexpr int LDT = Smem<D>::LDT;
  static constexpr size_t bytes =
      (size_t)(4 * 64 * LDR + D * LDT) * 2 + (size_t)64 * 4;
};

// Row-major copy of rows [r0, r0 + 64) of src ([rows, D], zero past `rows`)
// into dst [64][D + PAD], and optionally its transpose into dt [D][64 + PAD].
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, int r0,
                                          int rows, __nv_bfloat16* dst,
                                          __nv_bfloat16* dt) {
  constexpr int CHUNKS = D / 8;
  constexpr int LDR = Smem<D>::LDR;
  constexpr int LDT = Smem<D>::LDT;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDR + c * 8) = val;
    if (dt != nullptr) {
      // transposed: consecutive threads on consecutive rows, so the 2-byte
      // stores of a warp fall in distinct banks
      const int tr = idx % 64, tc = idx / 64;
      uint4 tv = make_uint4(0, 0, 0, 0);
      if (r0 + tr < rows)
        tv = *reinterpret_cast<const uint4*>(src + (long)(r0 + tr) * D +
                                             tc * 8);
      const __nv_bfloat16* te = reinterpret_cast<const __nv_bfloat16*>(&tv);
#pragma unroll
      for (int e = 0; e < 8; ++e) dt[(tc * 8 + e) * LDT + tr] = te[e];
    }
  }
}

// One block of 64 keys of one (batch, head): dk and dv, and with WITH_DQ
// the block's dq share added into dq_acc by atomics (the single pass).
template <int D, bool WITH_DQ>
__device__ __forceinline__ void kv_block(
    unsigned char* smem_raw, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ sid_q,
    const int32_t* __restrict__ sid_kv, float* __restrict__ dq_acc,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int h,
    int sq, int sk, int causal, float scale) {
  constexpr int LDR = Smem<D>::LDR;
  constexpr int LDT = Smem<D>::LDT;
  constexpr int KSTEPS = D / 16;         // k-steps of S^T = K Q^T
  constexpr int DTILES = D / 8;          // n-tiles over d
  constexpr int QTILES = BLOCK_M / 8;    // n-tiles of S^T (q columns)

  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 64 * LDR;
  __nv_bfloat16* sQ = sV + 64 * LDR;
  __nv_bfloat16* sDO = sQ + 64 * LDR;
  __nv_bfloat16* sKt = sDO + 64 * LDR;
  __nv_bfloat16* sQt = sKt + D * LDT;
  __nv_bfloat16* sDOt = sQt + D * LDT;
  __nv_bfloat16* sdS = sDOt + D * LDT;            // [q][key]
  float* sLse = reinterpret_cast<float*>(sdS + BLOCK_M * LDT);
  float* sDelta = sLse + 64;
  int32_t* sSidQ = reinterpret_cast<int32_t*>(sDelta + 64);
  int32_t* sSidK = sSidQ + 64;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * BLOCK_N;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const long bh = (long)bi * h + hh;
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * sk * D;
  const __nv_bfloat16* vb = v + bh * sk * D;
  const __nv_bfloat16* dob = dout + bh * sq * D;
  const int offset = sk - sq;
  const bool use_seg = sid_q != nullptr;

  load_tile<D>(kb, n0, sk, sK, WITH_DQ ? sKt : nullptr);
  load_tile<D>(vb, n0, sk, sV, nullptr);
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
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<D>(qb, q0, sq, sQ, sQt);
    load_tile<D>(dob, q0, sq, sDO, sDOt);
    for (int r = tid; r < 64; r += THREADS) {
      const bool in = q0 + r < sq;
      sLse[r] = in ? lse[bh * sq + q0 + r] : 0.f;
      sDelta[r] = in ? delta[bh * sq + q0 + r] : 0.f;
      sSidQ[r] = (use_seg && in) ? sid_q[(long)bi * sq + q0 + r] : -1;
    }
    __syncthreads();

    // ---- S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 q
    float st[QTILES][4], dpt[QTILES][4];
#pragma unroll
    for (int j = 0; j < QTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ak[4], av[4];
      const int c = kk * 16 + tig * 2;
      ak[0] = ld32(sK + (kw + g) * LDR + c);
      ak[1] = ld32(sK + (kw + g + 8) * LDR + c);
      ak[2] = ld32(sK + (kw + g) * LDR + c + 8);
      ak[3] = ld32(sK + (kw + g + 8) * LDR + c + 8);
      av[0] = ld32(sV + (kw + g) * LDR + c);
      av[1] = ld32(sV + (kw + g + 8) * LDR + c);
      av[2] = ld32(sV + (kw + g) * LDR + c + 8);
      av[3] = ld32(sV + (kw + g + 8) * LDR + c + 8);
#pragma unroll
      for (int j = 0; j < QTILES; ++j) {
        const __nv_bfloat16* pq = sQ + (j * 8 + g) * LDR + c;
        mma_m16n8k16(st[j], ak, ld32(pq), ld32(pq + 8));
        const __nv_bfloat16* pd = sDO + (j * 8 + g) * LDR + c;
        mma_m16n8k16(dpt[j], av, ld32(pd), ld32(pd + 8));
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

    // ---- dV += P^T dO and dK += dS^T Q (k-steps over the 64 q rows)
#pragma unroll
    for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16x2(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16x2(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      da[0] = pack_bf16x2(dpt[2 * kk][0], dpt[2 * kk][1]);
      da[1] = pack_bf16x2(dpt[2 * kk][2], dpt[2 * kk][3]);
      da[2] = pack_bf16x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      da[3] = pack_bf16x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const __nv_bfloat16* pd = sDOt + (t * 8 + g) * LDT + kk * 16 + tig * 2;
        mma_m16n8k16(dva[t], pa, ld32(pd), ld32(pd + 8));
        const __nv_bfloat16* pq = sQt + (t * 8 + g) * LDT + kk * 16 + tig * 2;
        mma_m16n8k16(dka[t], da, ld32(pq), ld32(pq + 8));
      }
    }

    if constexpr (WITH_DQ) {
      // ---- stage dS (bf16) as [q][key] for the dQ product
#pragma unroll
      for (int j = 0; j < QTILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + tig * 2 + (e & 1);
          const int kl = kw + g + (e < 2 ? 0 : 8);
          sdS[ql * LDT + kl] = __float2bfloat16_rn(dpt[j][e]);
        }
      __syncthreads();

      // ---- dQ[q0 + 16 warp rows, :] += dS K over the 64 keys -> atomics
      float dqa[DTILES][4];
#pragma unroll
      for (int t = 0; t < DTILES; ++t)
        dqa[t][0] = dqa[t][1] = dqa[t][2] = dqa[t][3] = 0.f;
      const int qw = warp * 16;
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        uint32_t a[4];
        const int c = kk * 16 + tig * 2;
        a[0] = ld32(sdS + (qw + g) * LDT + c);
        a[1] = ld32(sdS + (qw + g + 8) * LDT + c);
        a[2] = ld32(sdS + (qw + g) * LDT + c + 8);
        a[3] = ld32(sdS + (qw + g + 8) * LDT + c + 8);
#pragma unroll
        for (int t = 0; t < DTILES; ++t) {
          const __nv_bfloat16* pk = sKt + (t * 8 + g) * LDT + c;
          mma_m16n8k16(dqa[t], a, ld32(pk), ld32(pk + 8));
        }
      }
      const int qr0 = q0 + qw + g, qr1 = qr0 + 8;
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const int col = t * 8 + tig * 2;
        if (qr0 < sq) {
          float* dst = dq_acc + (bh * sq + qr0) * D + col;
          atomicAdd(dst, dqa[t][0] * scale);
          atomicAdd(dst + 1, dqa[t][1] * scale);
        }
        if (qr1 < sq) {
          float* dst = dq_acc + (bh * sq + qr1) * D + col;
          atomicAdd(dst, dqa[t][2] * scale);
          atomicAdd(dst + 1, dqa[t][3] * scale);
        }
      }
    }
  }

  // ---- finish: dk (scaled) and dv for this warp's keys
  __nv_bfloat16* dkb = dk + bh * sk * D;
  __nv_bfloat16* dvb = dv + bh * sk * D;
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + tig * 2;
    if (key0 < sk) {
      *reinterpret_cast<uint32_t*>(dkb + (long)key0 * D + col) =
          pack_bf16x2(dka[t][0] * scale, dka[t][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (long)key0 * D + col) =
          pack_bf16x2(dva[t][0], dva[t][1]);
    }
    if (key1 < sk) {
      *reinterpret_cast<uint32_t*>(dkb + (long)key1 * D + col) =
          pack_bf16x2(dka[t][2] * scale, dka[t][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (long)key1 * D + col) =
          pack_bf16x2(dva[t][2], dva[t][3]);
    }
  }
}

#define KV_ARGS                                                              \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k, \
      const __nv_bfloat16 *__restrict__ v,                                   \
      const __nv_bfloat16 *__restrict__ dout,                                \
      const float *__restrict__ lse, const float *__restrict__ delta,        \
      const int32_t *__restrict__ sid_q, const int32_t *__restrict__ sid_kv, \
      float *__restrict__ dq_acc, __nv_bfloat16 *__restrict__ dk,            \
      __nv_bfloat16 *__restrict__ dv, int h, int sq, int sk, int causal,     \
      float scale
#define KV_PASS q, k, v, dout, lse, delta, sid_q, sid_kv, dq_acc, dk, dv, h, \
                sq, sk, causal, scale

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_kernel(KV_ARGS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  kv_block<D, true>(smem_raw, KV_PASS);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_dkdv_kernel(KV_ARGS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  kv_block<D, false>(smem_raw, KV_PASS);
}

// One block of 64 q rows of one (batch, head): dq, no atomics.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ sid_q,
                const int32_t* __restrict__ sid_kv,
                __nv_bfloat16* __restrict__ dq, int h, int sq, int sk,
                int causal, float scale) {
  constexpr int LDR = DqSmem<D>::LDR;
  constexpr int LDT = DqSmem<D>::LDT;
  constexpr int KSTEPS = D / 16;         // k-steps of S = Q K^T over d
  constexpr int DTILES = D / 8;          // n-tiles of dq over d
  constexpr int NTILES = BLOCK_N / 8;    // n-tiles of S (key columns)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + 64 * LDR;
  __nv_bfloat16* sK = sDO + 64 * LDR;
  __nv_bfloat16* sV = sK + 64 * LDR;
  __nv_bfloat16* sKt = sV + 64 * LDR;              // [d][key]
  int32_t* sSidK = reinterpret_cast<int32_t*>(sKt + D * LDT);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * BLOCK_M;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const long bh = (long)bi * h + hh;
  const __nv_bfloat16* kb = k + bh * sk * D;
  const __nv_bfloat16* vb = v + bh * sk * D;
  const int offset = sk - sq;
  const bool use_seg = sid_q != nullptr;

  load_tile<D>(q + bh * sq * D, m0, sq, sQ, nullptr);
  load_tile<D>(dout + bh * sq * D, m0, sq, sDO, nullptr);

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
    __syncthreads();  // every warp is done with the previous k tile
    load_tile<D>(kb, n0, sk, sK, sKt);
    load_tile<D>(vb, n0, sk, sV, nullptr);
    for (int r = tid; r < 64; r += THREADS)
      sSidK[r] =
          (use_seg && n0 + r < sk) ? sid_kv[(long)bi * sk + n0 + r] : -1;
    __syncthreads();

    // ---- S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[NTILES][4], dp[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t aq[4], ad[4];
      const int c = kk * 16 + tig * 2;
      aq[0] = ld32(sQ + (qw + g) * LDR + c);
      aq[1] = ld32(sQ + (qw + g + 8) * LDR + c);
      aq[2] = ld32(sQ + (qw + g) * LDR + c + 8);
      aq[3] = ld32(sQ + (qw + g + 8) * LDR + c + 8);
      ad[0] = ld32(sDO + (qw + g) * LDR + c);
      ad[1] = ld32(sDO + (qw + g + 8) * LDR + c);
      ad[2] = ld32(sDO + (qw + g) * LDR + c + 8);
      ad[3] = ld32(sDO + (qw + g + 8) * LDR + c + 8);
#pragma unroll
      for (int j = 0; j < NTILES; ++j) {
        const __nv_bfloat16* pk = sK + (j * 8 + g) * LDR + c;
        mma_m16n8k16(s[j], aq, ld32(pk), ld32(pk + 8));
        const __nv_bfloat16* pv = sV + (j * 8 + g) * LDR + c;
        mma_m16n8k16(dp[j], ad, ld32(pv), ld32(pv + 8));
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

    // ---- dQ += dS K (k-steps over the 64 keys; dS rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const __nv_bfloat16* pk = sKt + (t * 8 + g) * LDT + kk * 16 + tig * 2;
        mma_m16n8k16(dqa[t], a, ld32(pk), ld32(pk + 8));
      }
    }
  }

  // ---- finish: dq (scaled), once, in bf16
  __nv_bfloat16* dqb = dq + bh * sq * D;
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + tig * 2;
    if (in0)
      *reinterpret_cast<uint32_t*>(dqb + (long)row0 * D + col) =
          pack_bf16x2(dqa[t][0] * scale, dqa[t][1] * scale);
    if (in1)
      *reinterpret_cast<uint32_t*>(dqb + (long)row1 * D + col) =
          pack_bf16x2(dqa[t][2] * scale, dqa[t][3] * scale);
  }
}

template <int D, bool WITH_DQ>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* sid_q, const void* sid_kv, void* dq_acc,
                      void* dk, void* dv, int b, int h, int sq, int sk,
                      int causal, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  auto kernel = WITH_DQ ? flash_bwd_kernel<D> : flash_dkdv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + BLOCK_N - 1) / BLOCK_N, h, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(sid_q), static_cast<const int32_t*>(sid_kv),
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), h, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* sid_q, const void* sid_kv, void* dq, int b,
                      int h, int sq, int sk, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(sid_q), static_cast<const int32_t*>(sid_kv),
      static_cast<__nv_bfloat16*>(dq), h, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <bool WITH_DQ>
int dispatch_kv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* sid_q, const void* sid_kv, void* dq_acc, void* dk,
                void* dv, int b, int h, int sq, int sk, int d, int causal,
                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sk <= 0 || b <= 0 || h <= 0) return cudaSuccess;
  switch (d) {
    case 32:
      return launch_kv<32, WITH_DQ>(q, k, v, dout, lse, delta, sid_q, sid_kv,
                                    dq_acc, dk, dv, b, h, sq, sk, causal,
                                    scale, st);
    case 64:
      return launch_kv<64, WITH_DQ>(q, k, v, dout, lse, delta, sid_q, sid_kv,
                                    dq_acc, dk, dv, b, h, sq, sk, causal,
                                    scale, st);
    case 128:
      return launch_kv<128, WITH_DQ>(q, k, v, dout, lse, delta, sid_q,
                                     sid_kv, dq_acc, dk, dv, b, h, sq, sk,
                                     causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous tensors:
// q, dout [b,h,sq,d] and k, v [b,h,sk,d] bf16; lse, delta [b,h,sq] f32;
// sid_q [b,sq] and sid_kv [b,sk] int32, or both null. Each returns the
// launch's cudaError_t (cudaErrorInvalidValue for an unsupported head dim).
//
// The single pass: dq_acc [b,h,sq,d] f32, ZEROED by the caller (the kernel
// adds into it, scale applied); dk, dv [b,h,sk,d] bf16 (every element
// written).
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* sid_q,
                              const void* sid_kv, void* dq_acc, void* dk,
                              void* dv, int b, int h, int sq, int sk, int d,
                              int causal, float scale, void* stream) {
  return dispatch_kv<true>(q, k, v, dout, lse, delta, sid_q, sid_kv, dq_acc,
                           dk, dv, b, h, sq, sk, d, causal, scale, stream);
}

// The split, dk/dv half: dk, dv [b,h,sk,d] bf16 (every element written).
extern "C" int apex_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* sid_q, const void* sid_kv,
                                   void* dk, void* dv, int b, int h, int sq,
                                   int sk, int d, int causal, float scale,
                                   void* stream) {
  return dispatch_kv<false>(q, k, v, dout, lse, delta, sid_q, sid_kv, nullptr,
                            dk, dv, b, h, sq, sk, d, causal, scale, stream);
}

// The split, dq half: dq [b,h,sq,d] bf16 (every element written).
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* sid_q,
                                 const void* sid_kv, void* dq, int b, int h,
                                 int sq, int sk, int d, int causal,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || b <= 0 || h <= 0) return cudaSuccess;
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, sid_q, sid_kv, dq, b, h,
                           sq, sk, causal, scale, st);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, sid_q, sid_kv, dq, b, h,
                           sq, sk, causal, scale, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, sid_q, sid_kv, dq, b,
                            h, sq, sk, causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
