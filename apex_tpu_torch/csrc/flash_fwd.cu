// Flash-attention forward for Hopper (sm_90a): bf16, fp16 or fp32 operands,
// fp32 online softmax, outputs `out` [b, h, sq, d] (the operands' dtype) and
// `lse` [b, h, sq] (fp32).
//
// Replaces the Pallas kernel `_fwd_kernel` of apex_tpu/ops/flash_attention.py
// (:251, launched by `_flash_fwd_impl` :426): causal masking with the
// end-aligned offset `sk - sq`, segment ids whose negative values are
// padding (they match nothing, not even each other, and give an exact zero
// row), the -1e30 masked fill and the dead-row guard (p = 0 wherever the
// mask is false, so a row whose max is the fill sums to 0 and normalizes by
// 1 instead of by its count). Like the Pallas kernel it keeps each
// operand's own dtype: p is rounded to the dtype of v before the PV
// product. Over operands of mixed dtypes the wrapper promotes q, k and v to
// their common dtype (exact; it is fp32 for any mix) and passes v's own
// dtype, to which the fp32 kernel rounds p (`p_round`); the output takes
// q's dtype. Head dims 32, 64, 128, 256 and 512 are instantiated; the
// wrapper (ops/flash_attention.py) zero-pads any other d up to the next of
// them, which changes no score and no output column it keeps.
//
// Bound on the H100: the causal products do 4 d h s(s+1)/2 flops over
// 4 s d h * 2 bytes (q, k, v read once, out written once), i.e. ~s/4 flops
// per byte against the card's ~295 flop/byte balance: bytes bound below
// s ~ 1200 and the tensor cores above. At the serve prefill shape (b1 h16
// s512 d64) that is 1.3 us of bytes against 0.5 us of operations — both far
// below what 128 blocks of a single launch take, so the kernel is bound by
// its own latency there. The online softmax keeps the [sq, sk] scores out of
// HBM, so the bytes stay q, k, v, out once each at every length. fp32 runs
// the SIMT product of frag.cuh (exact fp32 products, ~1/30 of the bf16
// rate): it serves O0, where correctness, not speed, is the point.
//
// Design. One thread block per (q tile of 64 rows, head, batch, output
// chunk) with four warps, each owning 16 q rows. The Pallas grid's
// sequential k-block axis becomes a loop inside the block over 64-key
// tiles; the loop stops at the causal limit of the tile's last row, which
// skips the dead blocks that `_causal_block_live` skips. Both products run
// through the m16n8k16 fragments of frag.cuh: S = Q K^T, then O += P V with
// P converted from the S accumulator fragments to A fragments in registers
// (the layout of the m16n8 accumulator equals that of the m16k16 A operand
// pairwise). For 16-bit operands with d <= 128, Q's fragments stay in
// registers for the whole loop; otherwise they are read from shared memory
// at each step. Past 128 columns (d 256) the output is split in chunks of
// 128, one block each, which recompute the scores (registers bound the
// accumulators, not shared memory). The contraction of S = Q K^T is staged
// in chunks of KC = min(d, 256) columns: up to d 256 the whole of K's tile
// is in shared memory at once (and Q's for the whole loop), past it (d 512)
// S accumulates in registers over the chunks, Q's and K's chunks staged
// together, so shared memory is set by the chunk, not by d. V is stored
// transposed in shared memory so that each B fragment is one pair load;
// rows are padded by 8 elements so the fragment loads spread over the
// banks. Tiles are loaded synchronously, one at a time: wgmma, TMA and a
// multi-stage pipeline are later work. Shared memory: (64 (KC + 8) * 2 +
// DC * 72) elements + 256 B: 86 KB for bf16 at d 256 and d 512, 172 KB for
// fp32 at d 256 and 154 KB at d 512 (64 output columns a block there).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frag.cuh"

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
struct Cfg {
  // output columns a block (64 for fp32 at d 512, whose [16, 128]
  // accumulator a warp would spill)
  static constexpr int DC = D <= 128 ? D : (sizeof(T) == 4 && D > 256 ? 64
                                                                       : 128);
  static constexpr int NCH = D / DC;
  // contraction columns of q and k staged at once (S sums over D / KC)
  static constexpr int KC = D <= 256 ? D : 256;
  static constexpr int NKC = D / KC;
  static constexpr bool Q_REGS = sizeof(T) == 2 && D <= 128;
  // the fp32 (SIMT) product of S is rolled over its k-steps (Q_REGS, the
  // one register array indexed by the step, is 16-bit only)
  static constexpr int KUNROLL = sizeof(T) == 4 ? 1 : KC / 16;
  // blocks an SM must hold: four for the 16-bit d <= 64 kernels (128
  // registers a thread; left free, the GPT's d 64 took 135 registers,
  // three blocks, and ran 11 % slower)
  static constexpr int MIN_BLOCKS = sizeof(T) == 2 && D <= 64 ? 4 : 1;
  static constexpr int LDQ = KC + PAD;       // sQ, sK: [row][KC + PAD]
  static constexpr int LDV = BLOCK_N + PAD;  // sVt:    [DC][BLOCK_N + PAD]
  static constexpr size_t bytes =
      (size_t)(BLOCK_M * LDQ + BLOCK_N * LDQ + DC * LDV) * sizeof(T) +
      (size_t)BLOCK_N * 4;
};

// Row-major copy of columns [c0, c0 + KC) of rows [r0, r0 + 64) of src
// ([rows, D], zero past `rows`) into dst [64][KC + PAD], consecutive
// threads on consecutive 16-byte chunks.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* src, int r0, int rows,
                                          int c0, T* dst) {
  using C = Cfg<T, D>;
  constexpr int VEC = kVec<T>;
  constexpr int CHUNKS = C::KC / VEC;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * D + c0 +
                                            c * VEC);
    *reinterpret_cast<uint4*>(dst + r * C::LDQ + c * VEC) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Cfg<T, D>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ sid_q,
                 const int32_t* __restrict__ sid_kv, T* __restrict__ out,
                 float* __restrict__ lse, int h, int sq, int sk, int causal,
                 float scale, int p_round) {
  using F = Frag<T>;
  using P = typename F::pair;
  using C = Cfg<T, D>;
  constexpr int LDQ = C::LDQ;
  constexpr int LDV = C::LDV;
  constexpr int DC = C::DC;
  constexpr int KSTEPS = C::KC / 16;  // k-steps of S = Q K^T a chunk
  constexpr int DTILES = DC / 8;      // n-tiles of O
  constexpr int NTILES = BLOCK_N / 8; // n-tiles of S
  constexpr int VEC = kVec<T>;
  constexpr int VCHUNKS = DC / VEC;   // 16-byte chunks a row of V's slice

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BLOCK_M * LDQ;
  T* sVt = sK + BLOCK_N * LDQ;
  int32_t* sSid = reinterpret_cast<int32_t*>(sVt + DC * LDV);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * BLOCK_M;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z / C::NCH, c0 = (blockIdx.z % C::NCH) * DC;
  const long bh = (long)bi * h + hh;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  const int offset = sk - sq;       // aligns the sequence ends (causal)
  const bool use_seg = sid_q != nullptr;

  // ---- Q tile -> shared (-> registers: A fragments kept for the loop);
  // past one contraction chunk, Q's chunks are staged with K's in the loop
  if constexpr (C::NKC == 1) load_tile<T, D>(qb, q0, sq, 0, sQ);
  __syncthreads();
  const int rw = warp * 16;
  P qf[C::Q_REGS ? KSTEPS : 1][4];
  if constexpr (C::Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const T* p0 = sQ + (rw + g) * LDQ + kk * 16 + tig * 2;
      const T* p1 = p0 + 8 * LDQ;
      qf[kk][0] = F::load(p0);
      qf[kk][1] = F::load(p1);
      qf[kk][2] = F::load(p0 + 8);
      qf[kk][3] = F::load(p1 + 8);
    }
  }

  // this thread's two rows: r0 = q0 + rw + g, r1 = r0 + 8
  const int row0 = q0 + rw + g, row1 = row0 + 8;
  int sid0 = -1, sid1 = -1;
  if (use_seg) {
    if (row0 < sq) sid0 = sid_q[(long)bi * sq + row0];
    if (row1 < sq) sid1 = sid_q[(long)bi * sq + row1];
  }

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  int n_blocks = (sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last_key = q0 + BLOCK_M - 1 + offset;
    n_blocks = last_key < 0 ? 0 : min(n_blocks, last_key / BLOCK_N + 1);
  }

  for (int nb = 0; nb < n_blocks; ++nb) {
    const int n0 = nb * BLOCK_N;
    float s[NTILES][4];
    // ---- S = Q K^T for this warp's 16 rows x 64 keys, summed over the
    // contraction chunks (one chunk up to d 256, where K is staged whole)
#pragma unroll
    for (int kc = 0; kc < C::NKC; ++kc) {
      __syncthreads();  // every warp is done with the previous tiles
      if constexpr (C::NKC > 1) load_tile<T, D>(qb, q0, sq, kc * C::KC, sQ);
      load_tile<T, D>(kb, n0, sk, kc * C::KC, sK);
      if (kc == 0) {
        // V (this block's columns): transposed; consecutive threads on
        // consecutive keys, so a warp's element stores fall in distinct
        // banks
        for (int idx = tid; idx < BLOCK_N * VCHUNKS; idx += THREADS) {
          const int vr = idx % BLOCK_N, vc = idx / BLOCK_N;
          uint4 vv = make_uint4(0, 0, 0, 0);
          if (n0 + vr < sk)
            vv = *reinterpret_cast<const uint4*>(vb + (long)(n0 + vr) * D +
                                                 c0 + vc * VEC);
          const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) sVt[(vc * VEC + e) * LDV + vr] = ve[e];
        }
        if (use_seg)
          for (int r = tid; r < BLOCK_N; r += THREADS)
            sSid[r] = n0 + r < sk ? sid_kv[(long)bi * sk + n0 + r] : -1;
      }
      __syncthreads();
      if (kc == 0) {    // zeroed after the loads: s is not live across them
#pragma unroll
        for (int j = 0; j < NTILES; ++j)
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }

#pragma unroll (C::KUNROLL)
      for (int kk = 0; kk < KSTEPS; ++kk) {
        P a[4];
        if constexpr (C::Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          const T* p0 = sQ + (rw + g) * LDQ + kk * 16 + tig * 2;
          a[0] = F::load(p0);
          a[1] = F::load(p0 + 8 * LDQ);
          a[2] = F::load(p0 + 8);
          a[3] = F::load(p0 + 8 * LDQ + 8);
        }
#pragma unroll
        for (int j = 0; j < NTILES; ++j) {
          const T* pk = sK + (j * 8 + g) * LDQ + kk * 16 + tig * 2;
          F::mma(s[j], a, F::load(pk), F::load(pk + 8));
        }
      }
    }

    // ---- scale, mask (bit 4j+e of `live`), row max
    uint32_t live = 0;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col_l = j * 8 + tig * 2 + (e & 1);
        const int col = n0 + col_l;
        const int row = e < 2 ? row0 : row1;
        bool ok = col < sk && (!causal || col <= row + offset);
        if (use_seg) {
          const int sr = e < 2 ? sid0 : sid1;
          ok = ok && sr >= 0 && sr == sSid[col_l];
        }
        float val = s[j][e] * scale;
        val = ok ? val : NEG_INF;
        s[j][e] = val;
        live |= (ok ? 1u : 0u) << (4 * j + e);
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);

    // ---- p = exp(s - m_new), zero where masked (the dead-row guard)
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mref = e < 2 ? mn0 : mn1;
        const float p = (live >> (4 * j + e)) & 1u ? __expf(s[j][e] - mref)
                                                   : 0.f;
        s[j][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int t = 0; t < DTILES; ++t) {
      o[t][0] *= a0; o[t][1] *= a0;
      o[t][2] *= a1; o[t][3] *= a1;
    }

    // ---- O += P V (P rounded to the operands' dtype, as the Pallas
    // kernel rounds p to the dtype of v before its MXU product; over mixed
    // operands the fp32 kernel rounds it to v's own dtype, p_round)
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < NTILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = round_to(s[j][e], p_round);
    }
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      P pa[4];
      pa[0] = F::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = F::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = F::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = F::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const T* pv = sVt + (t * 8 + g) * LDV + kk * 16 + tig * 2;
        F::mma(o[t], pa, F::load(pv), F::load(pv + 8));
      }
    }
  }

  // ---- epilogue: normalize by the (guarded) row sum, write out and lse
  const float sl0 = l0 > 0.f ? l0 : 1.f, sl1 = l1 > 0.f ? l1 : 1.f;
  const float inv0 = 1.f / sl0, inv1 = 1.f / sl1;
  T* ob = out + bh * sq * D + c0;
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + tig * 2;
    if (row0 < sq)
      *reinterpret_cast<P*>(ob + (long)row0 * D + col) =
          F::pack(o[t][0] * inv0, o[t][1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<P*>(ob + (long)row1 * D + col) =
          F::pack(o[t][2] * inv1, o[t][3] * inv1);
  }
  if (tig == 0 && c0 == 0) {
    if (row0 < sq) lse[bh * sq + row0] = m0 + logf(sl0);
    if (row1 < sq) lse[bh * sq + row1] = m1 + logf(sl1);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* sid_q, const void* sid_kv, void* out,
                   void* lse, int b, int h, int sq, int sk, int causal,
                   float scale, int p_round, cudaStream_t stream) {
  const size_t smem = Cfg<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b * Cfg<T, D>::NCH);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(sid_q),
      static_cast<const int32_t*>(sid_kv), static_cast<T*>(out),
      static_cast<float*>(lse), h, sq, sk, causal, scale, p_round);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* sid_q, const void* sid_kv, void* out,
                     void* lse, int b, int h, int sq, int sk, int d,
                     int causal, float scale, int pr, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                           causal, scale, pr, st);
    case 64:
      return launch<T, 64>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                           causal, scale, pr, st);
    case 128:
      return launch<T, 128>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                            causal, scale, pr, st);
    case 256:
      return launch<T, 256>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                            causal, scale, pr, st);
    case 512:
      return launch<T, 512>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                            causal, scale, pr, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: q [b,h,sq,d], k/v [b,h,sk,d] of one dtype (`dtype`
// 0 bf16, 1 fp16, 2 fp32); sid_q [b,sq] and sid_kv [b,sk] int32, or both
// null; out [b,h,sq,d] in the operands' dtype; lse [b,h,sq] f32. `pr`: the
// dtype code p is rounded to before the PV product in the fp32 kernels (v's
// own dtype when the caller promoted mixed operands; 2 rounds nothing).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a head dim
// other than 32, 64, 128, 256, 512 or an unknown dtype).
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* sid_q, const void* sid_kv,
                              void* out, void* lse, int b, int h, int sq,
                              int sk, int d, int causal, float scale,
                              int dtype, int pr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || b <= 0 || h <= 0) return cudaSuccess;
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return dispatch<__nv_bfloat16>(q, k, v, sid_q, sid_kv, out, lse, b, h,
                                     sq, sk, d, causal, scale, pr, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return dispatch<__half>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                              d, causal, scale, pr, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 2:
#if APEX_HAS_DTYPE(2)
      return dispatch<float>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                             d, causal, scale, pr, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}
