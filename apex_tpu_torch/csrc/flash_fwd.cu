// Flash-attention forward for Hopper (sm_90a): bf16 operands, fp32 online
// softmax, outputs `out` [b, h, sq, d] (bf16) and `lse` [b, h, sq] (fp32).
//
// Replaces the Pallas kernel `_fwd_kernel` of apex_tpu/ops/flash_attention.py
// (:251, launched by `_flash_fwd_impl` :426) on the serve path: causal
// masking with the end-aligned offset `sk - sq`, segment ids whose negative
// values are padding (they match nothing, not even each other, and give an
// exact zero row), the -1e30 masked fill and the dead-row guard
// (p = 0 wherever the mask is false, so a row whose max is the fill sums to
// 0 and normalizes by 1 instead of by its count).
//
// Bound on the H100: the causal products do 4 d h s(s+1)/2 flops over
// 4 s d h * 2 bytes (q, k, v read once, out written once), i.e. ~s/4 flops
// per byte against the card's ~295 flop/byte balance: bytes bound below
// s ~ 1200 and the tensor cores above. At the serve prefill shape (b1 h16
// s512 d64) that is 1.3 us of bytes against 0.5 us of operations — both far
// below what 128 blocks of a single launch take, so the kernel is bound by
// its own latency there. The online softmax keeps the [sq, sk] scores out of
// HBM, so the bytes stay q, k, v, out once each at every length.
//
// Design. One thread block per (q tile of 64 rows, head, batch) with four
// warps, each owning 16 q rows. The Pallas grid's sequential k-block axis
// becomes a loop inside the block over 64-key tiles; the loop stops at the
// causal limit of the tile's last row, which skips the dead blocks that
// `_causal_block_live` skips. Both products run on the tensor cores through
// `mma.sync.m16n8k16` (bf16 in, fp32 accumulate): S = Q K^T with Q held in
// registers for the whole loop, then O += P V with P converted from the S
// accumulator fragments to bf16 A fragments in registers (the layout of the
// m16n8 accumulator equals that of the m16k16 A operand pairwise). V is
// stored transposed in shared memory so that each B fragment is one 32-bit
// load; rows are padded by 8 elements so the fragment loads hit 32 distinct
// banks. Tiles are loaded synchronously, one at a time: wgmma, TMA and a
// multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
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

template <int D>
struct Smem {
  static constexpr int LDQ = D + PAD;        // sQ, sK: [row][D + PAD]
  static constexpr int LDV = BLOCK_N + PAD;  // sVt:    [D][BLOCK_N + PAD]
  static constexpr size_t bytes =
      (size_t)(BLOCK_M * LDQ + BLOCK_N * LDQ + D * LDV) * 2 +
      (size_t)BLOCK_N * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int32_t* __restrict__ sid_q,
                 const int32_t* __restrict__ sid_kv,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int h, int sq, int sk, int causal, float scale) {
  constexpr int LDQ = Smem<D>::LDQ;
  constexpr int LDV = Smem<D>::LDV;
  constexpr int KSTEPS = D / 16;      // k-steps of S = Q K^T
  constexpr int DTILES = D / 8;       // n-tiles of O
  constexpr int NTILES = BLOCK_N / 8; // n-tiles of S
  constexpr int CHUNKS = D / 8;       // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * LDQ;
  __nv_bfloat16* sVt = sK + BLOCK_N * LDQ;
  int32_t* sSid = reinterpret_cast<int32_t*>(sVt + D * LDV);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * BLOCK_M;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const long bh = (long)bi * h + hh;
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * sk * D;
  const __nv_bfloat16* vb = v + bh * sk * D;
  const int offset = sk - sq;       // aligns the sequence ends (causal)
  const bool use_seg = sid_q != nullptr;

  // ---- Q tile -> shared -> registers (A fragments, kept for the loop)
  for (int idx = tid; idx < BLOCK_M * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < sq)
      val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c * 8) = val;
  }
  __syncthreads();
  const int rw = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p0 = sQ + (rw + g) * LDQ + kk * 16 + tig * 2;
    const __nv_bfloat16* p1 = p0 + 8 * LDQ;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
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
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int idx = tid; idx < BLOCK_N * CHUNKS; idx += THREADS) {
      // K: row-major, consecutive threads on consecutive 16-byte chunks
      const int r = idx / CHUNKS, c = idx % CHUNKS;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (n0 + r < sk)
        val = *reinterpret_cast<const uint4*>(kb + (long)(n0 + r) * D + c * 8);
      *reinterpret_cast<uint4*>(sK + r * LDQ + c * 8) = val;
      // V: transposed; consecutive threads on consecutive keys, so the
      // 2-byte stores of a warp fall in distinct banks
      const int vr = idx % BLOCK_N, vc = idx / BLOCK_N;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (n0 + vr < sk)
        vv = *reinterpret_cast<const uint4*>(vb + (long)(n0 + vr) * D +
                                             vc * 8);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(vc * 8 + e) * LDV + vr] = ve[e];
    }
    if (use_seg)
      for (int r = tid; r < BLOCK_N; r += THREADS)
        sSid[r] = n0 + r < sk ? sid_kv[(long)bi * sk + n0 + r] : -1;
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys
    float s[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* pk = sK + (j * 8 + g) * LDQ + kk * 16 + tig * 2;
        mma_m16n8k16(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(pk),
                     *reinterpret_cast<const uint32_t*>(pk + 8));
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

    // ---- O += P V (P rounded to bf16, as the Pallas kernel rounds p to
    // the dtype of v before its MXU product)
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; ++t) {
        const __nv_bfloat16* pv = sVt + (t * 8 + g) * LDV + kk * 16 + tig * 2;
        mma_m16n8k16(o[t], pa, *reinterpret_cast<const uint32_t*>(pv),
                     *reinterpret_cast<const uint32_t*>(pv + 8));
      }
    }
  }

  // ---- epilogue: normalize by the (guarded) row sum, write out and lse
  const float sl0 = l0 > 0.f ? l0 : 1.f, sl1 = l1 > 0.f ? l1 : 1.f;
  const float inv0 = 1.f / sl0, inv1 = 1.f / sl1;
  __nv_bfloat16* ob = out + bh * sq * D;
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + tig * 2;
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long)row0 * D + col) =
          pack_bf16x2(o[t][0] * inv0, o[t][1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long)row1 * D + col) =
          pack_bf16x2(o[t][2] * inv1, o[t][3] * inv1);
  }
  if (tig == 0) {
    if (row0 < sq) lse[bh * sq + row0] = m0 + logf(sl0);
    if (row1 < sq) lse[bh * sq + row1] = m1 + logf(sl1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* sid_q, const void* sid_kv, void* out,
                   void* lse, int b, int h, int sq, int sk, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(sid_q), static_cast<const int32_t*>(sid_kv),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), h, sq, sk,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: q [b,h,sq,d], k/v [b,h,sk,d] bf16; sid_q [b,sq] and
// sid_kv [b,sk] int32, or both null; out [b,h,sq,d] bf16; lse [b,h,sq] f32.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an
// unsupported head dim).
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* sid_q, const void* sid_kv,
                              void* out, void* lse, int b, int h, int sq,
                              int sk, int d, int causal, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq <= 0 || b <= 0 || h <= 0) return cudaSuccess;
  switch (d) {
    case 32:
      return launch<32>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                        causal, scale, st);
    case 64:
      return launch<64>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                        causal, scale, st);
    case 128:
      return launch<128>(q, k, v, sid_q, sid_kv, out, lse, b, h, sq, sk,
                         causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
