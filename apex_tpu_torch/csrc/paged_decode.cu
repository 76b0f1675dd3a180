// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over a paged KV pool, GQA-aware, fp32 online softmax; bf16, fp16 or fp32
// queries over pages of bf16, fp16, fp32 (any of them with any query dtype)
// or e4m3.
//
// Replaces the Pallas kernel `_paged_decode_kernel` of
// apex_tpu/ops/flash_attention.py (:986, launched by `paged_decode_attention`
// :1056), both of its modes. Contract (shared with apex_tpu_torch.serve.cache):
//   q            [b, kv, group, d]          bf16, fp16 or fp32
//   k/v pages    [kv, num_pages, page, d]   bf16, fp16, fp32, or e4m3 in
//                                           fp8 mode
//   k/v scales   [kv, num_pages] fp32       fp8 mode only (else null)
//   block_tables [b, m] int32  (page 0 is the null page)
//   seq_lens     [b] int32     (0 = inactive slot: exact zero output)
//   out          [b, kv, group, d]          q's dtype
// with any head dim d up to 512. Pages wholly past seq_lens[b] are never
// read; keys past seq_lens[b] in a partly live page are left out of the max
// and the sum (the Pallas kernel masks them to -1e30 and zeroes their p: the
// same result). Scores and p are fp32 whatever the dtypes (p is not rounded
// to the pool's dtype before the PV product, as in the plain versions of
// both packages; the Pallas kernel rounds it in its 16-bit mode).
//
// fp8 mode (the JAX kernel's `fp8=True`, :1004-1035): a stored page holds
// clip(x * page_scale) in e4m3, one scale per (kv head, page). The score is
// s = (q . k) / ks[kh, page] * scale, and the value term (p . v) / vs[kh,
// page] with p kept in fp32 (folded here as p / vs into the p that
// multiplies v). The bf16 mode's arithmetic is untouched. The kernel's
// divides (these two and the final acc / sum) are div.approx.f32
// (__fdividef, within 2 fp32 ulps): the IEEE divide's slow path is a
// subroutine call, whose calling convention spills registers to local
// memory.
//
// Bound on the H100: HBM bytes. Each live K and V row is read once and used
// for 2*group flops per element, so at group 1 the kernel does ~1 flop per
// byte (~2 in fp8 mode): the time is the live pages' bytes over the memory
// rate.
//
// Design: flash-decoding, one launch. Each (kv head, sequence, chunk of up to
// 8 query rows of the group) is a thread-block cluster of `splits` blocks
// along x (at most 8; the wrapper takes 4); the row's live keys are cut into
// `splits` pieces of c = ceil(n_live / splits) keys rounded up to `granule`,
// block r taking keys [r c, (r + 1) c). The cut depends on the row's own
// seq_len and on (splits, granule), which the wrapper fixes from (page_size,
// d, pool dtype) alone: never on b, on the other rows or on how many are
// active, so a row's result is bitwise the same whatever rows come with it
// (decode replay after a preemption, a speculative-verify row against the
// plain-decode row). A block past its row's live keys leaves at once; a row of
// one piece writes its output from its block directly.
//
// A block: four consumer warps and one producer warp. The producer warp reads
// the row's length and its first 32 block-table entries in one round trip,
// keeps the piece's pages in shared memory and, on the exact path (d equal to
// its instantiation DP, a pool of q's dtype or e4m3: the serve engine's case),
// one of its lanes at once streams the piece's K and V rows into a 4-stage
// shared-memory ring with cp.async.bulk (1-D TMA, one copy per page part: a
// page of one head is contiguous in the pool), one mbarrier a stage, ~8 KB a
// stage, refilling a stage when its consumers release it; the fp8 scales are
// fetched while the rows are in flight and handed over by a named barrier.
// Consumers score from shared memory. On the general path (a runtime d, or a
// pool dtype other than q's) the consumers read K and V from the pool
// directly, by vector loads while d % 8 == 0 and masked element loads
// otherwise (rows then start at any element); the pool is read in place, never
// padded.
//
// DP/8 lanes share one key row (32 at DP 512, each holding two 8-element
// pieces), so a warp scores 32 / (DP/8) keys at a time ("slots"); key i of
// the piece goes to warp (i % (4 slots)) / slots, slot i % slots, and a
// lane takes two keys a step where its registers allow. The lanes of a key
// sum their partial scores through shared memory in lane order (no warp
// shuffles: their divergent-warp fallback code spilled registers). Each
// slot keeps its own running max, sum and fp32 accumulators per query row
// (the online softmax), so no block-wide barrier runs per page. At the end
// the block merges its slots in slot order through shared memory, and,
// for a row of more than one piece, every other piece's block stores its
// (max, sum, accumulators) into rank 0's shared memory (st.async,
// completing on rank 0's mbarrier: no cluster-wide barrier on the way
// out), and rank 0 sums them in rank order, each weighted by exp(its max -
// the row's max). p and every accumulator stay fp32. No atomics: a rerun
// is bitwise the same. A group of more than 8 rows runs in chunks of 8 (4
// at DP 512): the accumulators
// of 8 rows x 8 columns a lane are what the registers hold.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "dtype.cuh"
#include "dsmem.cuh"        // the cluster's pushes
#include "wgmma_gemm.cuh"   // mbarrier primitives

namespace {

constexpr int WARPS = 4;                    // consumer warps
constexpr int THREADS = 32 * (WARPS + 1);   // + the producer warp
constexpr int RING = 4;                     // stages of the exact path
constexpr int STAGE_BYTES = 8192;           // K + V bytes a stage aims at
constexpr int MAX_SPLITS = 8;               // a portable cluster
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void f16x8_to_float(const uint4& u, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void e4m3x8_to_float(const uint2& u, float* f) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * j)) & 0xffffu);
      const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3));
      const float2 t = __half22float2(h);
      f[4 * i + 2 * j] = t.x;
      f[4 * i + 2 * j + 1] = t.y;
    }
  }
}

// The e4m3 pool's element type
struct E4M3 {};

template <typename P>
__device__ __forceinline__ float elem_to_float(const void* base, long i) {
  if constexpr (std::is_same<P, E4M3>::value) {
    const __half h = __half(__nv_cvt_fp8_to_halfraw(
        static_cast<const __nv_fp8_storage_t*>(base)[i], __NV_E4M3));
    return __half2float(h);
  } else if constexpr (std::is_same<P, float>::value) {
    return static_cast<const float*>(base)[i];
  } else if constexpr (std::is_same<P, __half>::value) {
    return __half2float(static_cast<const __half*>(base)[i]);
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  }
}

// 8 consecutive elements of type P from element offset `idx`, as fp32: one
// vector load (16 bytes of bf16/fp16, 32 of fp32, 8 of e4m3), which needs
// idx % 8 == 0
template <typename P>
__device__ __forceinline__ void load8(const void* base, long idx, float* f) {
  if constexpr (std::is_same<P, E4M3>::value) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(base) + idx);
    e4m3x8_to_float(u, f);
  } else if constexpr (std::is_same<P, float>::value) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + idx);
    const float4 a = p[0], b = p[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (std::is_same<P, __half>::value) {
    f16x8_to_float(*reinterpret_cast<const uint4*>(
                       static_cast<const __half*>(base) + idx), f);
  } else {
    bf16x8_to_float(*reinterpret_cast<const uint4*>(
                        static_cast<const __nv_bfloat16*>(base) + idx), f);
  }
}

// Columns [col, col + 8) of the row at element offset `row` of a [.., d]
// tensor, zeros past d: the vector load while d % 8 == 0 (`vec`), masked
// element loads otherwise (a row then starts at any element).
template <typename P>
__device__ __forceinline__ void load_cols(const void* base, long row,
                                          int col, int d, bool vec,
                                          float* f) {
  if (vec && col < d) {
    load8<P>(base, row + col, f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = col + e < d ? elem_to_float<P>(base, row + col + e) : 0.f;
}

// The same from a pool whose 16-bit or fp32 dtype is known at run time
// (code 0 bf16, 1 fp16, 2 fp32): a warp-uniform branch per row piece.
template <bool FP8>
__device__ __forceinline__ void load_pool(const void* base, int code,
                                          long row, int col, int d, bool vec,
                                          float* f) {
  if constexpr (FP8) {
    load_cols<E4M3>(base, row, col, d, vec, f);
  } else if (code == 0) {
    load_cols<__nv_bfloat16>(base, row, col, d, vec, f);
  } else if (code == 1) {
    load_cols<__half>(base, row, col, d, vec, f);
  } else {
    load_cols<float>(base, row, col, d, vec, f);
  }
}

// A K or V piece: the general path reads a pool of a runtime dtype at a
// runtime d; the exact path (d == DP, a pool of q's dtype or e4m3, the
// serve engine's case) knows both at compile time.
template <typename T, bool FP8, bool GENERAL>
__device__ __forceinline__ void load_kv(const void* base, int code, long row,
                                        int col, int d, bool vec, float* f) {
  if constexpr (GENERAL)
    load_pool<FP8>(base, code, row, col, d, vec, f);
  else
    load_cols<typename std::conditional<FP8, E4M3, T>::type>(base, row, col,
                                                             d, true, f);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// DP: the head dim's instantiation (the next of 32 .. 512 at or above the
// runtime d); G: query rows a block. GENERAL: a runtime d and pool dtype
// (else d == DP and the pool is q's dtype or e4m3).
template <typename T, int DP, int G, bool FP8, bool GENERAL>
struct Cfg {
  static constexpr int NV = DP > 256 ? 2 : 1;     // 8-element pieces a lane
  static constexpr int TPK = DP / (8 * NV);       // lanes a key row
  static constexpr int SLOTS = 32 / TPK;          // keys a warp step
  static constexpr int STEP = WARPS * SLOTS;      // keys a block step
  static constexpr int E = 8 * NV;                // elements a lane of a row
  using P = typename std::conditional<FP8, E4M3, T>::type;  // exact pool
  static constexpr int ELEM = FP8 ? 1 : (int)sizeof(T);
  static constexpr int ROW = DP * ELEM;           // bytes of a pool row
  // keys a ring stage: ~STAGE_BYTES of K and V, whole block steps
  static constexpr int KEYS =
      STAGE_BYTES / (2 * ROW) > STEP ? STAGE_BYTES / (2 * ROW) : STEP;
  static constexpr int RING_BYTES = GENERAL ? 0 : RING * 2 * KEYS * ROW;
  // a piece's state: max [G], sum [G], acc [G][DP] fp32, in 16-byte units
  static constexpr int SLOT_BYTES = (G * (DP + 2) * 4 + 15) / 16 * 16;
  // keys a lane takes per step: two where the registers allow
  static constexpr int NK = G * E <= 32 ? 2 : 1;
  static constexpr int NS = WARPS * SLOTS;          // slots of a block
  // the ring; the pieces' states (rank 0 gathers them, slot r from rank r;
  // every block builds its own in slot 0); the slots' states [NS][G] max,
  // sum, [NS][G][DP] acc; the lanes' partial scores [WARPS][2][32][G][NK];
  // the block-table prefetch [32]; the piece's pages and scales [pg_cap]
  // each; the barriers (ring full and empty, the gather)
  static size_t smem_bytes(int pg_cap) {
    const size_t b = (size_t)RING_BYTES + (size_t)MAX_SPLITS * SLOT_BYTES +
                     (size_t)NS * G * (DP + 2) * 4 +
                     (size_t)WARPS * 2 * 32 * G * NK * 4 + 32 * 4 +
                     (size_t)pg_cap * 12;
    return (b + 7) / 8 * 8 + (2 * RING + 1) * 8;
  }
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(wg::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(wg::smem_u32(bar))
      : "memory");
}

// Stage s of a piece (keys [k_lo, k_hi)) into the ring: its K and V rows,
// one bulk copy a page part each, on the stage's full barrier
template <int KEYS, int ROW>
__device__ __forceinline__ void issue_stage(
    int s, const void* kp, const void* vp, uint8_t* ring_k, uint8_t* ring_v,
    uint64_t* full, const int* pages, int k_lo, int k_hi, int pg_lo, int kh,
    int num_pages, int page_size) {
  const int st = s % RING;
  const int key0 = k_lo + s * KEYS;
  const int key1 = min(k_hi, key0 + KEYS);
  wg::mbar_expect_tx(&full[st], (uint32_t)(key1 - key0) * 2 * ROW);
  for (int k = key0; k < key1;) {
    const int off = k % page_size;
    const int n = min(key1 - k, page_size - off);
    const long row =
        ((long)kh * num_pages + pages[k / page_size - pg_lo]) * page_size +
        off;
    const long dst = ((long)st * KEYS + (k - key0)) * ROW;
    bulk_load(ring_k + dst, static_cast<const uint8_t*>(kp) + row * ROW,
              n * ROW, &full[st]);
    bulk_load(ring_v + dst, static_cast<const uint8_t*>(vp) + row * ROW,
              n * ROW, &full[st]);
    k += n;
  }
}

// The (max, sum, accumulator) merge of two softmax states: the other's
// weight is exp(its max - the new max).
__device__ __forceinline__ void merge_into(float& m, float& l, float& acc,
                                           float mo, float lo, float acco) {
  const float mn = fmaxf(m, mo);
  const float a = __expf(m - mn), b = __expf(mo - mn);
  l = l * a + lo * b;
  acc = acc * a + acco * b;
  m = mn;
}

template <typename T, int DP, int G, bool FP8, bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1)
paged_decode_kernel(const T* __restrict__ q,
                    const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ seq_lens,
                    T* __restrict__ out, int kv, int num_pages,
                    int page_size, int m, int group_all, int d_rt,
                    int pool_code, float scale, int granule, int pg_cap) {
  using C = Cfg<T, DP, G, FP8, GENERAL>;
  constexpr int NV = C::NV, TPK = C::TPK, SLOTS = C::SLOTS, E = C::E;
  constexpr int KEYS = C::KEYS;

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring_k = smem;                               // [RING][KEYS][ROW]
  uint8_t* ring_v = smem + C::RING_BYTES / 2;
  uint8_t* gst = smem + C::RING_BYTES;                  // [splits][SLOT]
  constexpr int NS = C::NS, NK = C::NK;
  float* wm = reinterpret_cast<float*>(gst + MAX_SPLITS * C::SLOT_BYTES);
  float* wl = wm + NS * G;                              // [NS][G]
  float* wacc = wl + NS * G;                            // [NS][G][DP]
  float* part_s = wacc + NS * G * DP;                   // [WARPS][2][32][G][NK]
  int* bt_pre = reinterpret_cast<int*>(part_s + WARPS * 2 * 32 * G * NK);
  int* pages = bt_pre + 32;                             // [pg_cap]
  float* pks = reinterpret_cast<float*>(pages + pg_cap);
  float* pvs = pks + pg_cap;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(pvs + pg_cap) + 7) & ~uintptr_t(7));
  uint64_t* empty = full + RING;
  uint64_t* gbar = empty + RING;
  float* bm = reinterpret_cast<float*>(gst);            // this piece's state
  float* bl = bm + G;
  float* bacc = bl + G;

  const int rank = blockIdx.x, splits = gridDim.x;      // the cluster
  const int kh = blockIdx.y % kv, chunk = blockIdx.y / kv;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = GENERAL ? d_rt : DP;
  const bool vec = !GENERAL || d % 8 == 0;
  const int g0 = chunk * G;                 // rows [g0, g0 + group)
  const int group = min(G, group_all - g0);
  const long qrow = ((long)bi * kv + kh) * group_all + g0;

  // the row's length and, speculatively, its first 32 block-table entries
  // (one round trip for both); the queries
  const int seq_len = seq_lens[bi];
  if (warp == WARPS && lane < m)
    bt_pre[lane] = block_tables[(long)bi * m + lane];
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], WARPS);
    }
    wg::mbar_init(gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int kl = lane / TPK, cc = lane % TPK;
  float qf[G][E];
  if (warp < WARPS) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (gi < group) {
          load_cols<T>(q, (qrow + gi) * d, (j * TPK + cc) * 8, d, vec,
                       qf[gi] + 8 * j);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) qf[gi][8 * j + e] = 0.f;
        }
      }
    }
  }
  __syncthreads();

  const int n_live = min(seq_len, m * page_size);
  if (n_live <= 0) {                        // inactive slot: exact zeros
    if (rank == 0)
      for (int i = tid; i < group * d; i += THREADS)
        out[qrow * d + i] = from_float<T>(0.f);
    return;
  }
  // this row's pieces: c keys each, whole granules
  int c = (n_live + splits - 1) / splits;
  c = (c + granule - 1) / granule * granule;
  const int busy = (n_live + c - 1) / c;
  if (rank >= busy) return;
  const int k_lo = rank * c, k_hi = min(n_live, k_lo + c);
  const int pg_lo = k_lo / page_size;
  const int npg = (k_hi - 1) / page_size - pg_lo + 1;
  const int nst = (k_hi - k_lo + KEYS - 1) / KEYS;
  if (busy > 1) dsmem::cluster_arrive();    // the pieces meet at rank 0
  // consumers need the pages (general path) or the scales (fp8) in shared
  // memory: named barrier 1, which the producer warp arrives at
  constexpr bool META = FP8 || GENERAL;

  if (warp == WARPS) {
    // ---- producer warp: the piece's pages, clamped like an XLA gather
    for (int i = lane; i < npg; i += 32) {
      const int pslot = pg_lo + i;
      const int page = pslot < 32 ? bt_pre[pslot]
                                  : block_tables[(long)bi * m + pslot];
      pages[i] = min(max(page, 0), num_pages - 1);
    }
    __syncwarp();
    // exact path: lane 0 streams the piece's K and V rows through the ring
    if constexpr (!GENERAL) {
      if (lane == 0)
        for (int s = 0; s < min(nst, RING); ++s)
          issue_stage<C::KEYS, C::ROW>(s, kp, vp, ring_k, ring_v, full, pages,
                                       k_lo, k_hi, pg_lo, kh, num_pages,
                                       page_size);
    }
    if constexpr (FP8) {          // the scales, while the rows are in flight
      for (int i = lane; i < npg; i += 32) {
        pks[i] = k_scales[(long)kh * num_pages + pages[i]];
        pvs[i] = v_scales[(long)kh * num_pages + pages[i]];
      }
    }
    if constexpr (META) {
      __syncwarp();
      asm volatile("bar.arrive 1, %0;\n" ::"n"(THREADS) : "memory");
    }
    if constexpr (!GENERAL) {     // deeper pieces: refill freed stages
      if (lane == 0)
        for (int s = RING; s < nst; ++s) {
          wg::mbar_wait(&empty[s % RING], ((s / RING) - 1) & 1);
          issue_stage<C::KEYS, C::ROW>(s, kp, vp, ring_k, ring_v, full, pages,
                                       k_lo, k_hi, pg_lo, kh, num_pages,
                                       page_size);
        }
    }
  } else {
    if constexpr (META)
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
    // ---- consumers: key i of a stage to warp (i % STEP) / SLOTS, slot kl
    float mx[G], sl[G], acc[G][E];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      mx[gi] = NEG_INF;
      sl[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
    }
    int it = 0;                      // the warp's steps, for parity
    for (int s = 0; s < nst; ++s) {
      const int st = s % RING;
      if constexpr (!GENERAL) wg::mbar_wait(&full[st], (s / RING) & 1);
      const int key0 = k_lo + s * KEYS;
      const int nkeys = min(KEYS, k_hi - key0);
      // NK keys a lane at a time (i, i + STEP, ...): independent chains.
      // A lane past the live keys reads the stage's first key and selects
      // zeros and a zero weight.
      for (int i0 = warp * SLOTS; i0 < nkeys; i0 += NK * C::STEP) {
        float kf[NK][E], vf[NK][E], ks[NK], vs[NK];
        bool live[NK];
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int i_live = i0 + n * C::STEP + kl;
          live[n] = i_live < nkeys;
          const int i = live[n] ? i_live : 0;
          const int key = key0 + i;
          const int slot = key / page_size - pg_lo;
          ks[n] = FP8 ? pks[slot] : 1.f;
          vs[n] = FP8 ? pvs[slot] : 1.f;
#pragma unroll
          for (int v8 = 0; v8 < NV; ++v8) {
            const int col = (v8 * TPK + cc) * 8;
            float* kd = kf[n] + 8 * v8;
            float* vd = vf[n] + 8 * v8;
            if constexpr (GENERAL) {
              const long row = (((long)kh * num_pages + pages[slot]) *
                                page_size + key % page_size) * d;
              load_kv<T, FP8, true>(kp, pool_code, row, col, d, vec, kd);
              load_kv<T, FP8, true>(vp, pool_code, row, col, d, vec, vd);
            } else {
              const long at = ((long)st * KEYS + i) * C::ROW;
              load8<typename C::P>(ring_k + at, col, kd);
              load8<typename C::P>(ring_v + at, col, vd);
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              kd[e] = live[n] ? kd[e] : 0.f;
              vd[e] = live[n] ? vd[e] : 0.f;
            }
          }
        }
        // the partial scores of the key's lanes, summed in lane order
        // through shared memory; two buffers by step parity
        float* ps = part_s + ((warp * 2 + (it & 1)) * 32) * G * NK;
        ++it;
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) part += qf[gi][e] * kf[n][e];
            ps[(lane * G + gi) * NK + n] = part;
          }
        __syncwarp();
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float sc[NK];
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            float tot = 0.f;
#pragma unroll
            for (int l = 0; l < TPK; ++l)
              tot += ps[((kl * TPK + l) * G + gi) * NK + n];
            sc[n] = tot;
          }
          if (gi < group) {              // uniform across the warp
            // a dead key: score -inf and weight 0, so the state is kept
            float mn = mx[gi];
#pragma unroll
            for (int n = 0; n < NK; ++n) {
              sc[n] = !live[n] ? NEG_INF
                      : FP8    ? __fdividef(sc[n], ks[n]) * scale
                               : sc[n] * scale;
              mn = fmaxf(mn, sc[n]);
            }
            const float a = __expf(mx[gi] - mn);
            float l = sl[gi] * a;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[gi][e] *= a;
#pragma unroll
            for (int n = 0; n < NK; ++n) {
              const float p = live[n] ? __expf(sc[n] - mn) : 0.f;
              l += p;
              const float pv = FP8 ? __fdividef(p, vs[n]) : p;
#pragma unroll
              for (int e = 0; e < E; ++e) acc[gi][e] += pv * vf[n][e];
            }
            sl[gi] = l;
            mx[gi] = mn;
          }
        }
      }
      if constexpr (!GENERAL) {
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(&empty[st]);
      }
    }
    // each slot's state to shared memory (its lanes' columns; the max and
    // the sum from the slot's first lane)
    const int slot_id = warp * SLOTS + kl;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int v8 = 0; v8 < NV; ++v8)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wacc[(slot_id * G + gi) * DP + (v8 * TPK + cc) * 8 + e] =
              acc[gi][8 * v8 + e];
      if (cc == 0) {
        wm[slot_id * G + gi] = mx[gi];
        wl[slot_id * G + gi] = sl[gi];
      }
    }
  }
  __syncthreads();

  // ---- the piece's state: its slots in slot order; a row of one piece
  // writes its output, the other pieces' states go to rank 0's slots
  if (busy > 1) dsmem::cluster_wait();      // every piece's block started
  float* slot = reinterpret_cast<float*>(gst + rank * C::SLOT_BYTES);
  for (int o = tid; o < group * DP; o += THREADS) {
    const int gi = o / DP, col = o % DP;
    float M = wm[gi], L = wl[gi], A = wacc[gi * DP + col];
#pragma unroll
    for (int w = 1; w < NS; ++w)
      merge_into(M, L, A, wm[w * G + gi], wl[w * G + gi],
                 wacc[(w * G + gi) * DP + col]);
    if (busy == 1) {                        // one piece: the output
      if (col < d)
        out[(qrow + gi) * d + col] = from_float<T>(__fdividef(A, L));
    } else if (rank == 0) {
      bacc[gi * DP + col] = A;
      if (col == 0) {
        bm[gi] = M;
        bl[gi] = L;
      }
    } else {
      dsmem::store_to_rank(slot + 2 * G + gi * DP + col, A, gbar, 0);
      if (col == 0) {
        dsmem::store_to_rank(slot + gi, M, gbar, 0);
        dsmem::store_to_rank(slot + G + gi, L, gbar, 0);
      }
    }
  }
  if (busy == 1 || rank > 0) return;

  // ---- rank 0: the row's pieces, summed in rank order
  if (tid == 0)
    wg::mbar_expect_tx(gbar, (uint32_t)((busy - 1) * group * (DP + 2) * 4));
  __syncthreads();
  wg::mbar_wait(gbar, 0);
  for (int o = tid; o < group * d; o += THREADS) {
    const int gi = o / d, col = o % d;
    // every piece's state, weighted by exp(its max - the row's max) and
    // summed in rank order
    float mr[MAX_SPLITS], lr[MAX_SPLITS], ar[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      mr[r] = NEG_INF;
      lr[r] = ar[r] = 0.f;
      if (r < busy) {
        const float* rb = reinterpret_cast<const float*>(
            gst + r * C::SLOT_BYTES);
        mr[r] = rb[gi];
        lr[r] = rb[G + gi];
        ar[r] = rb[2 * G + gi * DP + col];
      }
    }
    float M = mr[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r) M = fmaxf(M, mr[r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < busy) {
        const float e = __expf(mr[r] - M);
        L += lr[r] * e;
        A += ar[r] * e;
      }
    }
    out[(qrow + gi) * d + col] = from_float<T>(__fdividef(A, L));
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *bt, *sl;
  void* out;
  int b, kv, num_pages, page_size, m, group, d, pool_code;
  float scale;
  int splits, granule, pg_cap;
  cudaStream_t stream;
};

template <typename T, int DP, int G, bool FP8, bool GENERAL>
cudaError_t launch(const Args& a) {
  using C = Cfg<T, DP, G, FP8, GENERAL>;
  auto kernel = paged_decode_kernel<T, DP, G, FP8, GENERAL>;
  const size_t smem = C::smem_bytes(a.pg_cap);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.kv * ((a.group + G - 1) / G), a.b);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), a.kp, a.vp,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.sl),
      static_cast<T*>(a.out), a.kv, a.num_pages, a.page_size, a.m, a.group,
      a.d, a.pool_code, a.scale, a.granule, a.pg_cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// query rows a block: up to 8 (4 at DP 512, whose rows take twice the
// registers), larger groups in chunks of that many
template <typename T, int DP, bool FP8, bool GENERAL>
cudaError_t dispatch_group(const Args& a) {
  if (a.group <= 1) return launch<T, DP, 1, FP8, GENERAL>(a);
  if (a.group <= 2) return launch<T, DP, 2, FP8, GENERAL>(a);
  if constexpr (DP > 256) {
    return launch<T, DP, 4, FP8, GENERAL>(a);
  } else {
    if (a.group <= 4) return launch<T, DP, 4, FP8, GENERAL>(a);
    return launch<T, DP, 8, FP8, GENERAL>(a);
  }
}

template <typename T, int DP, bool FP8>
cudaError_t dispatch_path(const Args& a, int code) {
  const bool exact = a.d == DP && (FP8 || a.pool_code == code);
  return exact ? dispatch_group<T, DP, FP8, false>(a)
               : dispatch_group<T, DP, FP8, true>(a);
}

// `code`: q's dtype code
template <typename T, bool FP8>
cudaError_t dispatch_dim(const Args& a, int code) {
  if (a.d <= 0) return cudaErrorInvalidValue;
  if (a.d <= 32) return dispatch_path<T, 32, FP8>(a, code);
  if (a.d <= 64) return dispatch_path<T, 64, FP8>(a, code);
  if (a.d <= 128) return dispatch_path<T, 128, FP8>(a, code);
  if (a.d <= 256) return dispatch_path<T, 256, FP8>(a, code);
  if (a.d <= 512) return dispatch_path<T, 512, FP8>(a, code);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_pool(const Args& a, bool fp8, int code) {
  return fp8 ? dispatch_dim<T, true>(a, code)
             : dispatch_dim<T, false>(a, code);
}

}  // namespace

// C interface (loaded with ctypes); see the contract at the top. `dtype` is
// q's (0 bf16, 1 fp16, 2 fp32). Null k_scales/v_scales select a pool of
// `pool_dtype` (0 bf16, 1 fp16, 2 fp32; any of them with any q dtype),
// non-null the e4m3 pool. Any head dim d up to 512. `splits` (1 to 8, the
// blocks of a cluster) and `granule` (> 0) cut each row's live keys (see
// the design note). Returns the launch's cudaError_t (cudaErrorInvalidValue
// for d past 512, an unknown dtype or a cut outside those bounds).
extern "C" int apex_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales,
                                 const void* block_tables,
                                 const void* seq_lens, void* out, int b,
                                 int kv, int group, int d, int num_pages,
                                 int page_size, int m, float scale,
                                 int dtype, int pool_dtype, int splits,
                                 int granule, void* stream) {
  if (b <= 0 || kv <= 0 || group <= 0) return cudaSuccess;
  if (pool_dtype < 0 || pool_dtype > 2) return cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS || granule < 1 || page_size < 1 ||
      m < 1)
    return cudaErrorInvalidValue;
  // the most pages a piece spans: its keys (at most c of the longest row a
  // table holds) across page boundaries
  const long c_max =
      ((long)m * page_size + splits - 1) / splits;
  const long c_round = (c_max + granule - 1) / granule * granule;
  const int pg_cap =
      (int)std::min<long>(m, (c_round + page_size - 1) / page_size + 1);
  const Args a{q, k_pages, v_pages, k_scales, v_scales, block_tables,
               seq_lens, out, b, kv, num_pages, page_size, m, group, d,
               pool_dtype, scale, splits, granule, pg_cap,
               static_cast<cudaStream_t>(stream)};
  if ((k_scales == nullptr) != (v_scales == nullptr))
    return cudaErrorInvalidValue;
  const bool fp8 = k_scales != nullptr;
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return dispatch_pool<__nv_bfloat16>(a, fp8, 0);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return dispatch_pool<__half>(a, fp8, 1);
#else
      return cudaErrorInvalidValue;
#endif
    case 2:
#if APEX_HAS_DTYPE(2)
      return dispatch_pool<float>(a, fp8, 2);
#else
      return cudaErrorInvalidValue;
#endif
    default: return cudaErrorInvalidValue;
  }
}
