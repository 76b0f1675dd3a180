// The flash-attention backward for Hopper (sm_90a), bf16 and fp16 operands
// at head dims 64 and 128, on wgmma and TMA (wgmma_attn.cuh over
// wgmma_gemm.cuh's primitives): the two-kernel split and the single pass.
//
// - flash_dkdv_sm90 replaces `_dkdv_kernel` (apex_tpu/ops/flash_attention.py
//   :558, launched at :805): dk, dv [b, h, sk, d];
// - flash_dq_sm90 replaces `_dq_kernel` (:671, launched at :820): dq
//   [b, h, sq, d];
// - flash_bwd_fused_sm90 replaces the single-pass `_bwd_fused_kernel`
//   (:604, launched at :787): dk, dv, and dq summed in a fixed order into
//   an fp32 workspace [b, h, sq, d] that the wrapper zeroes and casts;
// all from q, do [b, h, sq, d], k, v [b, h, sk, d], the forward's lse and
// delta = rowsum(do * out) [b, h, sq] (fp32). The wrapper
// (ops/flash_attention.py, `sm90_route`) sends the backward here by dtype
// and kernel head dim alone; fp32, mixed operands (promoted to fp32) and
// head dims 32, 256 and 512 stay on flash_bwd.cu.
//
// Numerics as in the Pallas kernels (:585-597) and flash_bwd.cu: p =
// exp(s * scale - lse) in fp32, zero wherever the mask is false; p rounded
// to do's dtype before the dv product; ds = p * (dp - delta) rounded once to
// q's dtype before the dk and dq products; fp32 accumulation; the softmax
// scale applied to dk and dq at the finish. Masks: causal with the
// end-aligned offset sk - sq (rows with no key when sq > sk), segment ids
// whose negative values are padding (such rows get exactly zero dq and add
// nothing to dk or dv), ragged sq and sk (TMA fills rows past s with zeros;
// lse, delta and the segment ids are masked by index). The split has no
// atomics: every output element is written once, by the block that owns
// it, so dq, dk and dv are the same bits from run to run. The single pass
// writes dk and dv once and adds each block's dq partials into the fp32
// workspace by TMA bulk reductions in a fixed order (turns.cuh: the key
// blocks that reach a query tile in descending order), so its dq is the
// same bits from run to run too.
//
// Bound on the H100, per live (q, k) pair at head dim d: dk/dv does four
// products of 2 d flops (s, dp, dv, dk), dq three (s, dp, dq), the single
// pass five (s, dp, dv, dk, dq). At b2 h16 s4096 d64 causal (268 M live
// pairs) the split's are 137 and 103 GFLOP, 0.139 and 0.104 ms at 989
// TFLOP/s, against 0.02 ms of bytes: bound by operations; at b8 h16 s1024
// (67 M pairs) the single pass's 43 GFLOP take 0.0435 ms.
//
// Design. A block is one warpgroup of producer (warp 0 issues the TMA loads
// and stages lse, delta and segment ids; setmaxnreg 40) and two consumer
// warpgroups of 64 rows each (setmaxnreg 232):
//
// - dk/dv: a block owns 128 keys of one (batch, head). K and V are resident
//   in shared memory, loaded once by TMA. Query tiles (128 rows at d 64, 64
//   at d 128) stream through a ring of STAGES stages (Q, dO, and the tile's
//   lse, delta and segment ids), with full/empty mbarriers. Per tile each
//   consumer computes S^T = K Q^T and dP^T = V dO^T (m64nN, N the tile's
//   rows, both operands from shared memory, K-major), forms P^T and dS^T in
//   registers, and accumulates dV += P^T dO and dK += dS^T Q with A from
//   registers and B read MN-major through the transpose bit from the same
//   swizzled Q and dO tiles: no transposed copy. Accumulators: S^T, dP^T,
//   dV, dK, 192 fp32 a thread at either head dim.
// - dq: a block owns 128 query rows. Q and dO are resident; K and V stream
//   in tiles of the same widths. Per tile S = Q K^T and dP = dO V^T from
//   shared memory, dS in registers, then dQ += dS K with K read MN-major.
// - The S and dP products of a tile are one group in flight: their first
//   k-step overwrites the accumulators (scale-d 0) instead of adding to
//   zeroed registers, which would have made ptxas wait for S before
//   issuing dP. p and ds are computed by one straight-line loop a tile,
//   its masked or its unmasked version.
// - Causal blocks visit only the tiles at or past the diagonal (dk/dv) or
//   at or before it (dq), a consumer skips a tile it has no live pair in,
//   and only the diagonal, ragged and segment tiles evaluate the mask. The
//   grid puts the (batch, head) on its fast axis and the longest loops
//   first (dk/dv: the first keys; dq: the last rows), so the blocks that
//   launch last are the short ones.
// - The delta fold: given the forward's output, the dq kernel computes
//   delta for its own rows in its prologue (each consumer thread a quarter
//   of its two rows' columns, summed over its quad; fp32) and writes it
//   out, and the wrapper launches dq before dk/dv, which reads it: the
//   separate delta pass (two fp32 copies and a reduction, 13 % of the
//   first version's pair at b2 h16 s4096 d64 on an H100) is gone.
// - The single pass is the dk/dv kernel with a fifth product: a block owns
//   128 keys (K, V resident), query tiles of 64 rows stream through the
//   ring, each consumer forms P^T and dS^T in registers and accumulates dV
//   and dK as above. dS^T also goes to shared memory, 128-byte swizzled as
//   TMA lays a tile out, and dQ_tile = dS K runs from shared memory with
//   both operands MN-major (the two transpose bits): at d 64 each
//   warpgroup over its own 64 keys, after a barrier of its own 128
//   threads, both adding their partial; at d 128 over the block's 128
//   keys, after a barrier of both warpgroups, warpgroup cw taking the
//   columns 64 cw .. 64 cw + 63 (dS^T in two alternating buffers, so a
//   warpgroup can write the next tile's while the other still reads
//   this one's; dV and dK complete before dQ is issued, whose
//   accumulators and their A fragments do not fit in a thread's
//   registers together). The partial, times the scale, goes to shared
//   memory in the layout of an fp32 TMA map over the workspace; per-thread
//   vector reductions of each element pair were a first version's
//   largest cost.
// - The dq writer: warp 1 of the producer warpgroup adds the partials
//   into the workspace in the block's turn, so the consumers never wait
//   for a turn or a reduction. Per tile it waits until the partials are
//   in (an mbarrier each; at d 64 warpgroup 1 has added warpgroup 0's
//   into its own, in registers: one region, one reduction, no pass of a
//   single warp over shared memory), waits for the block's turn on the
//   tile (turns.cuh: key block j after
//   key block j + 1, which the grid dispatches before it and which, under
//   a causal mask, starts two query tiles later: in one wave it runs ahead
//   of j, across waves it has long finished), adds by one bulk reduction
//   a 32-column box
//   (`cp.reduce.async.bulk.tensor`), frees the partial buffers once the
//   reduction has read them, and passes the turn as soon as it has
//   completed (a turn passed a tile later, to hide that latency, held
//   back the key blocks that wait for it when they share a wave). The
//   order costs the single pass a few percent at the train cells' shape,
//   about half of it the reversed dispatch (PERF.md).
//   64-row tiles at both head dims: at d 64 the 128-row tiles of the
//   split's dk/dv kernel left S^T, dP^T, dK, dV and dQ too few registers
//   (ptxas serialized every product and spilled).
// - The 3-D TMA map over [b h, s, d] keeps a tile inside its head and
//   zero-fills past s. lse is kept as lse * log2(e), so p = 2^(s * scale *
//   log2(e) - lse * log2(e)) is one FMA and one ex2.
//
// Attention dropout: the `_p_dp_ds` rule (:526-555), in the single pass
// and in both kernels of the split. A variant of each kernel (DROP, chosen
// by its C entry when the keep threshold is not 0; the code without
// dropout is unchanged) regenerates the forward's keep bit of each (query
// row, key) element from dropout_hash.cuh, by global positions (the tiles
// here are not the forward's), takes dp = keep ? dp / (1 - rate) : 0
// before ds = p (dp - delta) with the undropped p, and, where dV is formed,
// puts the dropped p (0, or p / (1 - rate)) in S^T's registers for the dV
// product. delta is rowsum(do * out) of the dropped output: given to the
// single pass and to dk/dv, folded by the dq kernel from that output
// unchanged. Each consumer thread hashes its own elements in the
// probabilities loop; the terms of its resident positions (dk/dv: its two
// keys; dq: its two query rows; the single pass: its two keys, once a
// tile) are xored once a block, so an element costs one xor of the
// streamed position's term and one fmix32. Registers: each DROP variant
// takes 240 a consumer thread and leaves the producer warpgroup 24 (the
// same total; at 232 the single pass spilled with the hash at d 128; 32
// and 240, which fill the register file exactly, hung setmaxnreg.inc).
// The split's variants (compared on an H100 at b2 h16 s4096, PERF.md):
// - the keep bits of a tile computed while its S and dP products run, as
//   the forward does, or before the products were slower than hashing in
//   the loop and spilled more;
// - dk/dv takes 64-row tiles at d 64 (at 128 rows it spilled); its
//   producer splits the work, warp 0's lane 0 issuing the loads and warp 1
//   staging lse, delta and the segment ids (the full barriers count 33
//   arrivals), and its consumers read the keys' segment ids in each masked
//   tile: one producer warp doing both at 24 registers, and the ids held
//   across the loop, each spilled at d 128;
// - dq keeps its tiles (64-row ones were slower).
// Hashing on the producer's two idle warps instead, into a word of keep
// bits a consumer thread and stage, was slower in the single pass: two
// warps at 24 registers fell behind the consumers.
//
// The additive bias (`_recompute_p` with its bias, :500-523, as
// `_bwd_fused_kernel`, `_dkdv_kernel` and `_dq_kernel` call it; the split's
// kernels read bias_ref at :563 and :676), in the single pass and in both
// kernels of the split: a variant of each (BIAS, chosen by the C entry when
// the bias pointer is not null; the code without it is the parent's SASS)
// recomputes p = 2^((s + bias / scale) scale log2(e) - lse log2(e)) with
// bias[b', h', q, k] (fp32 [b|1, h|1, sq, sk], the last two dims
// contiguous, broadcast by zero strides), the mask as without it. As in
// the forward, each thread loads its elements of a live tile's bias, times
// 1 / scale, into S's accumulators while it waits for the tile, and the S
// product's first k-step adds to them: the probabilities loop is the code
// without a bias, and no register is held beyond S's (holding the bias in
// registers of its own spilled at head dim 128). In the single pass and
// dk/dv a thread's rows are keys and its columns queries, so each element
// is a scalar load (a query's row of the bias is sk floats from the next;
// keys past sk and rows past sq clamped to the last, both masked); in dq
// its rows are queries and its columns key pairs, one 8-byte load a pair
// where sk is even and the tile lies inside sk, else a load an element.
// A -inf element gives p = ex2(-inf) = +0 on the unmasked path too, and ds
// 0; a row whose bias is -inf everywhere has lse -1e30 from the forward,
// so its p is 0 everywhere: its dq and its share of dk and dv are exactly
// 0. The bias variants round s * scale (`__fmul_rn`) before taking it to
// base 2, p = 2^(fl(s scale) log2(e) - lse log2(e)): the forward's bias
// variant writes lse = m + log(l) from the same rounded score in natural
// units, so a row whose biased scores sit at the -1e30 fill, or just above
// it, on every kept key (lse = that score: log(l) is lost at 1e30) gets p =
// 2^0 = 1 on each, as the Pallas backward and the plain version take it (an
// FMA of s by scale log2(e) would keep its product's rounding error, ~1e23
// there, and give 0 or inf). The single pass's variant with both takes the
// two products in place over S^T before its probabilities loop (inside the
// loop they spilled at d 128); the split's bias variants of dk/dv at d 128
// stream 48-row tiles for them. The delta pass and fold and the ordered dq
// are unchanged; no dbias is computed (the JAX op returns zeros for it).
// Registers and loads
// (variants timed on an H100, PERF.md): the
// single pass loads at d 128 in batches of four column groups
// (kBiasUnroll); the split's variants issue a tile's loads at once
// (batches of a partly unrolled loop put S in local memory, and were far
// slower). dk/dv takes 64-row tiles at d 64 (at 128 rows the loads spilled
// more than its twin) and at d 128 the dropout variant's register split,
// 240/24 (at 232 it spilled, its twin not), with one pointer for the rows
// of a tile inside sq, and 48-row tiles as the variant with both (at 64
// rows it spilled once its scores were rounded before the exponent, for
// the rows at the -1e30 fill, below). dq keeps its twin's tiles and
// registers and chooses its loads once a tile (8-byte pairs where sk is
// even: a choice per pair made the loads wait for one another, several
// times slower).
//
// The bias with dropout (`_p_dp_ds` over `_recompute_p` with its bias,
// :500-555): in both kernels of the split, a variant with both (DROP and
// BIAS, chosen by the C entry when the bias pointer is set and the
// threshold is above 0) composes the two above: p recomputed from the
// biased scores, dp = keep ? dp / (1 - rate) : 0, ds = p (dp - delta) with
// the undropped p, and in dk/dv the dropped p in S^T's registers for the
// dV product. It takes the dropout variant's register split and the bias
// variant's loads (dk/dv: 240/24 and the producer's two warps; dq:
// 240/24), and the dropout variant's 64-row tiles, but for dk/dv at d 128:
// there 48-row tiles (m64n48 score products, 24 accumulators each), since
// at 64 rows it spilled whatever held the hash's terms, the bias's
// offsets or the keys' segment ids (in registers, a tile at a time or in
// shared memory: variants compiled on an H100, PERF.md); at 32 rows it
// was slower. The single pass's variant with both composes the same two
// paths in its 64-row query tiles (the bias / scale in S^T's accumulators
// before the S^T product; dp = keep ? dp / (1 - rate) : 0, ds = p (dp -
// delta) with the undropped p, the dropped p for the dV product) at its
// variants' 240/24, and its dq goes through the ordered turns unchanged.
// At d 128 it spilled, beside S^T's accumulators in local memory (the
// bias variant's loads in batches index them at run time); variants
// compiled side by side on an H100 (PERF.md) took it to no spill and no
// stack frame together: every bias load unrolled, a tile inside sq read
// from one row pointer, the bias base pointer and key step and the keys'
// segment ids kept in shared memory and read a tile at a time, lse, delta
// and the rows' segment ids read by shared-window addresses, and the
// probabilities in two halves of the tile with a warp barrier between
// them (without it ptxas hashed the whole tile's keep bits at once). Each
// alone still spilled; packing the tile's keep bits into a word, before
// or during the S^T product, spilled far more.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "dtype.cuh"
#include "turns.cuh"
#include "wgmma_attn.cuh"

namespace {

constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int STAGES = 3;
constexpr int RES_ROWS = 128;      // the resident side's rows a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr cudaError_t MAP_REFUSED = cudaErrorNotSupported;

// rows of a streamed tile of the split: 128 at d 64 (half the waits and
// barrier round trips per flop), 64 at d 128, where the accumulators of a
// wider tile would not fit in a consumer's registers
template <int D>
struct SplitTile {
  static constexpr int value = D == 64 ? 128 : 64;
};

// the dk/dv kernel's: 64 rows in the dropout and bias variants at d 64 (at
// 128 the hash's registers, or the bias's loads, beside S^T, dP^T, dV and
// dK spilled); 48 in the bias variants at d 128 (at 64 the variant with
// both spilled, in the probabilities loop too, and the bias variant spilled
// once its scores were rounded before the exponent; at 32 it was slower)
template <int D, bool DROP, bool BIAS>
struct DkdvTile {
  static constexpr int value =
      D == 64 && (DROP || BIAS)
          ? 64
          : (D == 128 && BIAS ? 48 : SplitTile<D>::value);
};

template <int D, int TILE_ROWS = SplitTile<D>::value>
struct Layout {
  static constexpr int TILE = TILE_ROWS;
  static constexpr int RES_BYTES = RES_ROWS * D * 2;   // one resident operand
  static constexpr int TILE_BYTES = TILE * D * 2;      // one streamed operand
  // two resident operands, STAGES x two streamed ones, STAGES x three
  // 64-entry side arrays, 2 STAGES + 1 barriers, 1 KB of alignment
  static constexpr size_t SMEM = (size_t)2 * RES_BYTES +
                                 (size_t)STAGES * 2 * TILE_BYTES +
                                 STAGES * 3 * TILE * 4 +
                                 (2 * STAGES + 1) * 8 + 1024;
};

struct Params {
  const float* lse;
  float* delta;        // written by the dq kernel when `o` is set
  const int32_t* sid_q;
  const int32_t* sid_kv;
  void* out0;          // dk (dk/dv, single pass) or dq (dq)
  void* out1;          // dv (dk/dv, single pass)
  void* out2;          // the single pass: dq_acc, fp32 [b, h, sq, d]
  int* turns;          // the single pass: a turn counter a query tile
  const void* o;       // dq: the forward's output, or null (delta given)
  const void* dout;    // dq: do, for delta
  int h, sq, sk, causal;
  float scale;
  // dropout (the DROP variants): the seed, the keep threshold, 1 / (1 -
  // rate)
  uint32_t seed, threshold;
  float inv;
};

// a kernel's parameters: the BIAS variants' add the bias, fp32 [b|1, h|1,
// sq, sk], its batch and head strides in elements (0 for a broadcast dim)
// and 1 / scale; the others' are Params alone (fields added to Params made
// the variants without a bias spill)
template <bool BIAS>
struct BiasParams : Params {};
template <>
struct BiasParams<true> : Params {
  const float* bias;
  long bias_sb, bias_sh;
  float inv_scale;
};


__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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

// S = A B^T and dP = A' B'^T of one consumer warpgroup (m64n64, both
// products in one group): A and A' its 64 rows of the resident tiles, B
// and B' the streamed tiles, all K-major; the first k-step writes the
// accumulators, the rest add (with S_ADD, S's first adds too: S holds the
// bias).
template <typename T, int ACCUM, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 48)
    wg::mma_ss48<T, ACCUM>(d, da, db);
  else if constexpr (N == 64)
    wg::mma_ss64<T, ACCUM>(d, da, db);
  else
    wg::mma_ss128<T, ACCUM>(d, da, db);
}

template <typename T, int D, int N, bool S_ADD = false>
__device__ __forceinline__ void scores(float (&s)[N / 2], float (&dp)[N / 2],
                                       const uint8_t* a, const uint8_t* a2,
                                       const uint8_t* b, const uint8_t* b2,
                                       int cw) {
  mma_ss<T, S_ADD ? 1 : 0, N>(s, wg::kmajor_desc<RES_ROWS>(a, 64 * cw, 0),
                              wg::kmajor_desc<N>(b, 0, 0));
#pragma unroll
  for (int j = 1; j < D / 16; ++j)
    mma_ss<T, 1, N>(s, wg::kmajor_desc<RES_ROWS>(a, 64 * cw, j),
                    wg::kmajor_desc<N>(b, 0, j));
  mma_ss<T, 0, N>(dp, wg::kmajor_desc<RES_ROWS>(a2, 64 * cw, 0),
                  wg::kmajor_desc<N>(b2, 0, 0));
#pragma unroll
  for (int j = 1; j < D / 16; ++j)
    mma_ss<T, 1, N>(dp, wg::kmajor_desc<RES_ROWS>(a2, 64 * cw, j),
                    wg::kmajor_desc<N>(b2, 0, j));
}

// Writes this thread's two rows of an m64nD accumulator, row0 and row0 + 8
// (those below n), into out [n, D], times `mul`.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 2],
                                           int row0, int n, float mul) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<uint32_t*>(out + (long)row * D + 8 * nb +
                                     2 * tig) =
            Frag<T>::pack(acc[4 * nb + 2 * r] * mul,
                          acc[4 * nb + 2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: a block owns 128 keys; query tiles stream
// ---------------------------------------------------------------------------

template <typename T, int D, bool DROP, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkdv_sm90(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const BiasParams<BIAS> p) {
  using L = Layout<D, DkdvTile<D, DROP, BIAS>::value>;
  constexpr int TILE = L::TILE;
  // the dropout variant, and the bias variant at d 128, give the consumers
  // 240 registers a thread and the producer 24 (at 232 they spilled): the
  // producer then splits its work over two warps, and the consumers read
  // the keys' segment ids in each masked tile
  constexpr bool WIDE = DROP || (BIAS && D == 128);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* sK = base;
  uint8_t* sV = base + L::RES_BYTES;
  uint8_t* ring = base + 2 * L::RES_BYTES;   // stage s: Q then dO
  float* sLse = reinterpret_cast<float*>(ring + STAGES * 2 * L::TILE_BYTES);
  float* sDelta = sLse + STAGES * TILE;
  int32_t* sSid = reinterpret_cast<int32_t*>(sDelta + STAGES * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sSid + STAGES * TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;

  const int bh = blockIdx.x, bi = bh / p.h;
  const int n0 = blockIdx.y * RES_ROWS;
  const int sq = p.sq, sk = p.sk, offset = sk - sq;
  const bool causal = p.causal != 0, use_seg = p.sid_q != nullptr;
  const int n_qt = (sq + TILE - 1) / TILE;
  // the first query row that sees key n0 is n0 - offset
  const int qt_begin = causal ? min(n_qt, max(0, n0 - offset) / TILE) : 0;

  if (threadIdx.x == 0) {
    wg::prefetch_map(&map_q);
    wg::prefetch_map(&map_k);
    wg::prefetch_map(&map_v);
    wg::prefetch_map(&map_do);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the producer warp's lanes (WIDE: warp 0's lane 0 and warp 1)
      wg::mbar_init(&full[s], WIDE ? 33 : 32);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    wg::mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: warp 0 keeps the ring full. At 24 registers a thread
    // (WIDE) it splits the work: warp 0's lane 0 issues the loads, warp 1
    // stages lse, delta and the segment ids (one warp doing both spilled
    // at 24 registers)
    wg::setmaxnreg_dec<WIDE ? 24 : 40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        wg::mbar_expect_tx(res, 2 * L::RES_BYTES);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          wg::tma_load_3d(sK + a * RES_ROWS * 128, &map_k, res, 64 * a, n0,
                          bh);
          wg::tma_load_3d(sV + a * RES_ROWS * 128, &map_v, res, 64 * a, n0,
                          bh);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < n_qt; ++qt) {
        if (WIDE && lane != 0) break;
        wg::mbar_wait(&empty[stage], phase ^ 1);
        const int q0 = qt * TILE;
        if constexpr (!WIDE) {
          for (int r = lane; r < TILE; r += 32) {
            const int row = q0 + r;
            const bool in = row < sq;
            const long at = (long)bh * sq + row;
            sLse[stage * TILE + r] = in ? p.lse[at] * LOG2E : 0.f;
            sDelta[stage * TILE + r] = in ? p.delta[at] : 0.f;
            sSid[stage * TILE + r] =
                (use_seg && in) ? p.sid_q[(long)bi * sq + row] : -1;
          }
        }
        uint8_t* tq = ring + stage * 2 * L::TILE_BYTES;
        if (lane == 0) {
          wg::mbar_expect_tx(&full[stage], 2 * L::TILE_BYTES);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            wg::tma_load_3d(tq + a * TILE * 128, &map_q, &full[stage],
                            64 * a, q0, bh);
            wg::tma_load_3d(tq + L::TILE_BYTES + a * TILE * 128, &map_do,
                            &full[stage], 64 * a, q0, bh);
          }
        } else {
          wg::mbar_arrive(&full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (WIDE && threadIdx.x < 64) {
      const int lane = threadIdx.x - 32;
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < n_qt; ++qt) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        const int q0 = qt * TILE;
        // every lane's loads issued before its stores (a tile of 48 rows:
        // the lanes below 16 take a second row)
        constexpr int PER = (TILE + 31) / 32;
        float lv[PER], dv_[PER];
        int32_t sv[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int row = q0 + lane + 32 * i;
          const bool in = row < sq;
          const long at = (long)bh * sq + row;
          lv[i] = in ? p.lse[at] * LOG2E : 0.f;
          dv_[i] = in ? p.delta[at] : 0.f;
          sv[i] = (use_seg && in) ? p.sid_q[(long)bi * sq + row] : -1;
        }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          if (TILE % 32 == 0 || lane + 32 * i < TILE) {
            sLse[stage * TILE + lane + 32 * i] = lv[i];
            sDelta[stage * TILE + lane + 32 * i] = dv_[i];
            sSid[stage * TILE + lane + 32 * i] = sv[i];
          }
        }
        wg::mbar_arrive(&full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each
    wg::setmaxnreg_inc<WIDE ? 240 : 232>();
    const int cw = wgi - 1, t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, tig = t % 4;
    const int n0w = n0 + 64 * cw;
    const int key0 = n0w + 16 * warp + g, key1 = key0 + 8;
    // the keys' segment ids (WIDE reads them in each masked tile: held
    // across the loop they spilled at d 128)
    int sid0 = -1, sid1 = -1;
    if (use_seg && !WIDE) {
      if (key0 < sk) sid0 = p.sid_kv[(long)bi * sk + key0];
      if (key1 < sk) sid1 = p.sid_kv[(long)bi * sk + key1];
    }
    // dropout: the hash's (seed, batch, head, key) terms of the thread's
    // two keys, for the whole block
    uint32_t dkey[2];
    if constexpr (DROP) {
      const uint32_t hb = dropout::base(p.seed, bi, bh - bi * p.h);
      dkey[0] = hb ^ dropout::k_term(key0);
      dkey[1] = hb ^ dropout::k_term(key1);
    }
    const float sl2 = p.scale * LOG2E;
    float dv[D / 2], dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

    wg::mbar_wait(res, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * TILE;
      float s[TILE / 2], dp[TILE / 2];
      if constexpr (BIAS) {
        // a live tile's bias / scale into S^T (element 4 nb + 2 r + e: key
        // key0 + 8 r, query row q0 + 8 nb + 2 tig + e: the bias's row is
        // the query, its column the key), which the S^T product adds to;
        // keys past sk and rows past sq clamped to the last (both masked)
        if (n0w < sk && !(causal && n0w > q0 + TILE - 1 + offset)) {
          const int k0 = min(key0, sk - 1), d1 = min(key1, sk - 1) - k0;
          const float* b0 = p.bias + (long)bi * p.bias_sb +
                            (long)(bh - bi * p.h) * p.bias_sh + k0;
          if (q0 + TILE <= sq) {
            // the tile inside sq: its rows from one pointer (the clamped
            // offsets' registers spilled at d 128)
            const float* r0 = b0 + (long)(q0 + 2 * tig) * sk;
#pragma unroll
            for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float* at = r0 + (long)(8 * nb + e) * sk;
                s[4 * nb + e] = __ldg(at) * p.inv_scale;
                s[4 * nb + 2 + e] = __ldg(at + d1) * p.inv_scale;
              }
          } else {
#pragma unroll
            for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int off = min(q0 + 8 * nb + 2 * tig + e, sq - 1) * sk;
                s[4 * nb + e] = __ldg(b0 + off) * p.inv_scale;
                s[4 * nb + 2 + e] = __ldg(b0 + off + d1) * p.inv_scale;
              }
          }
        }
      }
      wg::mbar_wait(&full[stage], phase);
      // a live pair: a key of this warpgroup below sk that the tile's last
      // row reaches
      const bool live =
          n0w < sk && !(causal && n0w > q0 + TILE - 1 + offset);
      if (live) {
        const uint8_t* tq = ring + stage * 2 * L::TILE_BYTES;
        const uint8_t* tdo = tq + L::TILE_BYTES;
        wg::wgmma_fence();
        scores<T, D, TILE, BIAS>(s, dp, sK, sV, tq, tdo, cw);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(s);
        wg::fence_regs(dp);

        // p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - delta); the
        // mask only on diagonal, ragged or segment tiles
        const float* lse = sLse + stage * TILE;
        const float* dl = sDelta + stage * TILE;
        const int32_t* sidq = sSid + stage * TILE;
        // one straight-line version each, chosen once a tile
        auto probs = [&](auto masked) {
          int ks0 = sid0, ks1 = sid1;
          if constexpr (WIDE && decltype(masked)::value) {
            if (use_seg) {
              ks0 = key0 < sk ? p.sid_kv[(long)bi * sk + key0] : -1;
              ks1 = key1 < sk ? p.sid_kv[(long)bi * sk + key1] : -1;
            }
          }
#pragma unroll
          for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ql = 8 * nb + 2 * tig + e;
              const float l = lse[ql], de = dl[ql];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * nb + 2 * r + e;
                float pv;   // the bias variants: s * scale rounded first
                if constexpr (BIAS)
                  pv = ex2(__fmul_rn(__fmul_rn(s[i], p.scale), LOG2E) -
                           l);
                else
                  pv = ex2(fmaf(s[i], sl2, -l));
                if constexpr (decltype(masked)::value) {
                  const int key = r ? key1 : key0, qrow = q0 + ql;
                  bool ok = qrow < sq && key < sk &&
                            (!causal || key <= qrow + offset);
                  if (use_seg) {
                    const int sr = sidq[ql];
                    ok = ok && sr >= 0 && sr == (r ? ks1 : ks0);
                  }
                  pv = ok ? pv : 0.f;
                }
                if constexpr (DROP) {   // dV takes p dropped, ds p undropped
                  const bool kept = dropout::keep(
                      dkey[r] ^ dropout::q_term(q0 + ql), p.threshold);
                  dp[i] = pv * ((kept ? dp[i] * p.inv : 0.f) - de);
                  s[i] = kept ? pv * p.inv : 0.f;
                } else {
                  s[i] = pv;
                  dp[i] = pv * (dp[i] - de);
                }
              }
            }
        };
        if (use_seg || q0 + TILE > sq || n0w + 64 > sk ||
            (causal && n0w + 63 > q0 + offset))
          probs(std::true_type{});
        else
          probs(std::false_type{});

        // dV += P^T dO (p rounded to do's dtype), dK += dS^T Q (ds to q's)
        uint32_t pa[TILE / 16][4], da[TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          wg::acc_to_a<T>(s, kk, pa[kk]);
          wg::acc_to_a<T>(dp, kk, da[kk]);
        }
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk)
          wg::mma_rs<T, D, 1>(dv, pa[kk], wg::mnmajor_desc<TILE>(tdo, kk));
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk)
          wg::mma_rs<T, D, 1>(dk, da[kk], wg::mnmajor_desc<TILE>(tq, kk));
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(dv);
        wg::fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          wg::fence_frag(pa[kk]);
          wg::fence_frag(da[kk]);
        }
      }
      wg_sync(cw);             // every thread is done with the stage
      if (t == 0) wg::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- finish: dk (scaled) and dv, once
    const long at = (long)bh * sk * D;
    store_rows<T, D>(static_cast<T*>(p.out0) + at, dk, key0, sk, p.scale);
    store_rows<T, D>(static_cast<T*>(p.out1) + at, dv, key0, sk, 1.f);
  }
}

// ---------------------------------------------------------------------------
// dq: a block owns 128 query rows; key tiles stream
// ---------------------------------------------------------------------------

template <typename T, int D, bool DROP, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_sm90(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const BiasParams<BIAS> p) {
  using L = Layout<D>;
  constexpr int TILE = L::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* sQ = base;
  uint8_t* sDO = base + L::RES_BYTES;
  uint8_t* ring = base + 2 * L::RES_BYTES;   // stage s: K then V
  int32_t* sSid =
      reinterpret_cast<int32_t*>(ring + STAGES * 2 * L::TILE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sSid + STAGES * 3 * TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;

  const int bh = blockIdx.x, bi = bh / p.h;
  // the longest causal loops (the last rows) first
  const int m0 = (gridDim.y - 1 - blockIdx.y) * RES_ROWS;
  const int sq = p.sq, sk = p.sk, offset = sk - sq;
  const bool causal = p.causal != 0, use_seg = p.sid_q != nullptr;
  const int n_kt = (sk + TILE - 1) / TILE;
  int kt_end = n_kt;
  if (causal) {     // the last key the block's last row sees
    const int last = min(sq - 1, m0 + RES_ROWS - 1) + offset;
    kt_end = last < 0 ? 0 : min(n_kt, last / TILE + 1);
  }

  if (threadIdx.x == 0) {
    wg::prefetch_map(&map_q);
    wg::prefetch_map(&map_k);
    wg::prefetch_map(&map_v);
    wg::prefetch_map(&map_do);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    wg::mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    wg::setmaxnreg_dec<DROP ? 24 : 40>();   // as in the dk/dv kernel
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        wg::mbar_expect_tx(res, 2 * L::RES_BYTES);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          wg::tma_load_3d(sQ + a * RES_ROWS * 128, &map_q, res, 64 * a, m0,
                          bh);
          wg::tma_load_3d(sDO + a * RES_ROWS * 128, &map_do, res, 64 * a,
                          m0, bh);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        const int n0 = kt * TILE;
        if (use_seg)
          for (int r = lane; r < TILE; r += 32)
            sSid[stage * TILE + r] =
                n0 + r < sk ? p.sid_kv[(long)bi * sk + n0 + r] : -1;
        uint8_t* tk = ring + stage * 2 * L::TILE_BYTES;
        if (lane == 0) {
          wg::mbar_expect_tx(&full[stage], 2 * L::TILE_BYTES);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            wg::tma_load_3d(tk + a * TILE * 128, &map_k, &full[stage],
                            64 * a, n0, bh);
            wg::tma_load_3d(tk + L::TILE_BYTES + a * TILE * 128, &map_v,
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
    wg::setmaxnreg_inc<DROP ? 240 : 232>();
    const int cw = wgi - 1, t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, tig = t % 4;
    const int m0w = m0 + 64 * cw;
    const int row0 = m0w + 16 * warp + g;
    float lse[2], dl[2];
    int sid[2];
    // dropout: the hash's (seed, batch, head, row) terms of the thread's
    // two rows, for the whole block
    uint32_t drow[2];
    if constexpr (DROP) {
      const uint32_t hb = dropout::base(p.seed, bi, bh - bi * p.h);
      drow[0] = hb ^ dropout::q_term(row0);
      drow[1] = hb ^ dropout::q_term(row0 + 8);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool in = row < sq;
      const long at = (long)bh * sq + row;
      lse[r] = in ? p.lse[at] * LOG2E : 0.f;
      sid[r] = (use_seg && in) ? p.sid_q[(long)bi * sq + row] : -1;
      if (p.o == nullptr) {
        dl[r] = in ? p.delta[at] : 0.f;
      } else {
        // the delta fold: rowsum(do * o) in fp32 over this thread's quarter
        // of the columns, summed over the quad that shares the row
        float acc = 0.f;
        if (in) {
          const uint4* po = reinterpret_cast<const uint4*>(
              static_cast<const T*>(p.o) + at * D + tig * (D / 4));
          const uint4* pd = reinterpret_cast<const uint4*>(
              static_cast<const T*>(p.dout) + at * D + tig * (D / 4));
#pragma unroll
          for (int c = 0; c < D / 32; ++c) {
            const uint4 vo = po[c], vd = pd[c];
            const T* eo = reinterpret_cast<const T*>(&vo);
            const T* ed = reinterpret_cast<const T*>(&vd);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc = fmaf(to_f32(ed[e]), to_f32(eo[e]), acc);
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        dl[r] = acc;
        if (in && tig == 0) p.delta[at] = acc;
      }
    }
    // the last key this warpgroup's rows see (causal)
    const int last_w = min(sq - 1, m0w + 63) + offset;
    const float sl2 = p.scale * LOG2E;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    wg::mbar_wait(res, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < kt_end; ++kt) {
      const int n0 = kt * TILE;
      float s[TILE / 2], dp[TILE / 2];
      if constexpr (BIAS) {
        // a live tile's bias / scale into S (element 4 nb + 2 r + e: row
        // row0 + 8 r, key n0 + 8 nb + 2 tig + e; a row past sq clamped to
        // the last: it is masked), which the S product adds to
        if (m0w < sq && !(causal && n0 > last_w)) {
          const float* bb = p.bias + (long)bi * p.bias_sb +
                            (long)(bh - bi * p.h) * p.bias_sh;
          const float* brow[2] = {bb + (long)min(row0, sq - 1) * sk,
                                  bb + (long)min(row0 + 8, sq - 1) * sk};
          if ((sk & 1) == 0 && n0 + TILE <= sk) {
            // one 8-byte load a key pair (sk even: the pair and the row
            // 8-byte aligned), chosen once a tile (chosen a pair at a time,
            // the loads waited for one another)
#pragma unroll
            for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float2 bv = __ldg(reinterpret_cast<const float2*>(
                    brow[r] + n0 + 8 * nb + 2 * tig));
                s[4 * nb + 2 * r] = bv.x * p.inv_scale;
                s[4 * nb + 2 * r + 1] = bv.y * p.inv_scale;
              }
          } else {
            // odd sk or the ragged last tile: a load an element, keys past
            // sk clamped to the last (they are masked)
#pragma unroll
            for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
              for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  s[4 * nb + 2 * r + e] =
                      __ldg(brow[r] + min(n0 + 8 * nb + 2 * tig + e,
                                          sk - 1)) * p.inv_scale;
          }
        }
      }
      wg::mbar_wait(&full[stage], phase);
      const bool live = m0w < sq && !(causal && n0 > last_w);
      if (live) {
        const uint8_t* tk = ring + stage * 2 * L::TILE_BYTES;
        const uint8_t* tv = tk + L::TILE_BYTES;
        wg::wgmma_fence();
        scores<T, D, TILE, BIAS>(s, dp, sQ, sDO, tk, tv, cw);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(s);
        wg::fence_regs(dp);

        const int32_t* sidk = sSid + stage * TILE;
        auto probs = [&](auto masked) {
#pragma unroll
          for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kl = 8 * nb + 2 * tig + e, key = n0 + kl;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * nb + 2 * r + e;
                float pv;   // the bias variants: s * scale rounded first
                if constexpr (BIAS)
                  pv = ex2(__fmul_rn(__fmul_rn(s[i], p.scale), LOG2E) -
                           lse[r]);
                else
                  pv = ex2(fmaf(s[i], sl2, -lse[r]));
                if constexpr (decltype(masked)::value) {
                  const int row = row0 + 8 * r;
                  bool ok = row < sq && key < sk &&
                            (!causal || key <= row + offset);
                  if (use_seg)
                    ok = ok && sid[r] >= 0 && sid[r] == sidk[kl];
                  pv = ok ? pv : 0.f;
                }
                if constexpr (DROP) {   // dp dropped, ds p undropped
                  const bool kept = dropout::keep(
                      drow[r] ^ dropout::k_term(key), p.threshold);
                  s[i] = pv * ((kept ? dp[i] * p.inv : 0.f) - dl[r]);
                } else {
                  s[i] = pv * (dp[i] - dl[r]);
                }
              }
            }
        };
        if (use_seg || m0w + 64 > sq || n0 + TILE > sk ||
            (causal && n0 + TILE - 1 > m0w + offset))
          probs(std::true_type{});
        else
          probs(std::false_type{});

        // dQ += dS K (ds rounded to k's dtype)
        uint32_t a[TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) wg::acc_to_a<T>(s, kk, a[kk]);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk)
          wg::mma_rs<T, D, 1>(dq, a[kk], wg::mnmajor_desc<TILE>(tk, kk));
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) wg::fence_frag(a[kk]);
      }
      wg_sync(cw);
      if (t == 0) wg::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- finish: dq (scaled), once
    store_rows<T, D>(static_cast<T*>(p.out0) + (long)bh * sq * D, dq, row0,
                     sq, p.scale);
  }
}

// ---------------------------------------------------------------------------
// the single pass: a block owns 128 keys; query tiles stream; dq is summed
// into an fp32 workspace
// ---------------------------------------------------------------------------

// column groups of the bias's loads issued together in the single pass's
// BIAS variant: all 8 at d 64; at d 128 two batches of 4 (one batch of 32
// loads spilled beside dV's and dK's accumulators; batches were slower at
// d 64, PERF.md). The variant with both issues all 8 at both head dims
// (a loop of batches indexes S's accumulators at run time, which puts them
// in local memory)
template <int D>
constexpr int kBiasUnroll = D == 64 ? 8 : 4;

// the single pass's variant with both keeps in shared memory, after the
// barriers, what it would otherwise hold in registers across its loop:
// each consumer thread's bias base pointer and key step (two 8-byte words
// a thread, 256 threads) and the block's 128 keys' segment ids
constexpr size_t kBothSideBytes = 2 * 256 * 8 + 128 * 4;

__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ int lds_s32(uint32_t a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_s32(uint32_t a, int v) {
  asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(a), "r"(v));
}

template <int D>
struct FusedLayout {
  // 64-row query tiles at both head dims: five products' operands and
  // accumulators in a consumer's registers (at d 64 a 128-row tile's S^T
  // and dP^T alone take 128 of them, and ptxas serialized the products
  // and spilled)
  static constexpr int TILE = 64;
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int RES_BYTES = Layout<D>::RES_BYTES;
  static constexpr int TILE_BYTES = TILE * D * 2;
  // dS^T: at d 64 one 64 x 64 tile a warpgroup (its keys x the tile's
  // rows), at d 128 the block's 128 keys x the tile's rows, two buffers
  static constexpr int DS_BYTES = 2 * 64 * TILE * 2;
  static constexpr int DS_BUFFERS = D == 64 ? 1 : 2;
  // a warpgroup's fp32 dQ partial, [64 rows, 64 columns] as two 32-column
  // boxes of the accumulator's map
  static constexpr int DQ_BYTES = 64 * 64 * 4;
  // K, V, STAGES x (Q, dO), dS^T, the dQ partials, STAGES x three side
  // arrays, barriers (the ring's, the resident operands', the partials'
  // full and free), alignment
  static constexpr size_t SMEM =
      (size_t)2 * RES_BYTES + (size_t)STAGES * 2 * TILE_BYTES +
      DS_BUFFERS * DS_BYTES + CONSUMERS * DQ_BYTES + STAGES * 3 * TILE * 4 +
      (2 * STAGES + 1 + 2 * CONSUMERS) * 8 + 1024;
};

// the two consumer warpgroups (named barrier 3, 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

template <typename T, int D, bool DROP, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fused_sm90(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dq,
                     const BiasParams<BIAS> p) {
  using FL = FusedLayout<D>;
  constexpr int TILE = FL::TILE, ST = FL::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint8_t* sK = base;
  uint8_t* sV = base + FL::RES_BYTES;
  uint8_t* ring = base + 2 * FL::RES_BYTES;   // stage s: Q then dO
  uint8_t* sDS = ring + ST * 2 * FL::TILE_BYTES;        // 1024-aligned
  uint8_t* sDQ = sDS + FL::DS_BUFFERS * FL::DS_BYTES;   // 1024-aligned
  float* sLse = reinterpret_cast<float*>(sDQ + CONSUMERS * FL::DQ_BYTES);
  float* sDelta = sLse + ST * TILE;
  int32_t* sSid = reinterpret_cast<int32_t*>(sDelta + ST * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sSid + ST * TILE);
  uint64_t* empty = full + ST;
  uint64_t* res = empty + ST;
  uint64_t* dq_full = res + 1;              // a consumer's partial is in
  uint64_t* dq_free = dq_full + CONSUMERS;  // ... and has been read
  // the variant with both: [consumer thread] its bias base pointer, [256 +
  // consumer thread] its key step; then the keys' segment ids (kBothSideBytes)
  uint64_t* sBiasRow = dq_free + CONSUMERS;
  const uint32_t sSidK = wg::smem_u32(sBiasRow + 512);

  // the key blocks in reverse on the grid's slow axis: the shortest
  // causal loops first, each wave's blocks of one length (a grid of
  // several waves ends with the longest, all together), and the block a
  // turn waits for dispatched before the one waiting
  const int bh = blockIdx.x, bi = bh / p.h;
  const int n_kb = gridDim.y, kb = n_kb - 1 - blockIdx.y;
  const int n0 = kb * RES_ROWS;
  const int sq = p.sq, sk = p.sk, offset = sk - sq;
  const bool causal = p.causal != 0, use_seg = p.sid_q != nullptr;
  const int n_qt = (sq + TILE - 1) / TILE;
  const int qt_begin = causal ? min(n_qt, max(0, n0 - offset) / TILE) : 0;

  if (threadIdx.x == 0) {
    wg::prefetch_map(&map_q);
    wg::prefetch_map(&map_k);
    wg::prefetch_map(&map_v);
    wg::prefetch_map(&map_do);
    wg::prefetch_map(&map_dq);
#pragma unroll
    for (int c = 0; c < CONSUMERS; ++c) {
      wg::mbar_init(&dq_full[c], 1);
      wg::mbar_init(&dq_free[c], 1);
    }
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    wg::mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: warp 0 keeps the ring full (as in the dk/dv kernel),
    // warp 1 adds the dQ partials into dq_acc in the block's turn. The
    // dropout and bias variants move 8 registers a thread from the
    // producer (24) to the consumers (240): with the hash, or the bias's
    // loads, they spilled at 232 at d 128
    wg::setmaxnreg_dec<DROP || BIAS ? 24 : 40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        wg::mbar_expect_tx(res, 2 * FL::RES_BYTES);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          wg::tma_load_3d(sK + a * RES_ROWS * 128, &map_k, res, 64 * a, n0,
                          bh);
          wg::tma_load_3d(sV + a * RES_ROWS * 128, &map_v, res, 64 * a, n0,
                          bh);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int qt = qt_begin; qt < n_qt; ++qt) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        const int q0 = qt * TILE;
        // the tile's lse, delta and segment ids: every lane's loads issued
        // before its stores
        float lv[TILE / 32], dv_[TILE / 32];
        int32_t sv[TILE / 32];
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
          const int row = q0 + lane + 32 * i;
          const bool in = row < sq;
          const long at = (long)bh * sq + row;
          lv[i] = in ? p.lse[at] * LOG2E : 0.f;
          dv_[i] = in ? p.delta[at] : 0.f;
          sv[i] = (use_seg && in) ? p.sid_q[(long)bi * sq + row] : -1;
        }
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
          sLse[stage * TILE + lane + 32 * i] = lv[i];
          sDelta[stage * TILE + lane + 32 * i] = dv_[i];
          sSid[stage * TILE + lane + 32 * i] = sv[i];
        }
        uint8_t* tq = ring + stage * 2 * FL::TILE_BYTES;
        if (lane == 0) {
          wg::mbar_expect_tx(&full[stage], 2 * FL::TILE_BYTES);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            wg::tma_load_3d(tq + a * TILE * 128, &map_q, &full[stage],
                            64 * a, q0, bh);
            wg::tma_load_3d(tq + FL::TILE_BYTES + a * TILE * 128, &map_do,
                            &full[stage], 64 * a, q0, bh);
          }
        } else {
          wg::mbar_arrive(&full[stage]);
        }
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (threadIdx.x < 64) {
      const int lane = threadIdx.x - 32;
      uint32_t ph = 0;
      for (int qt = qt_begin; qt < n_qt; ++qt) {
        // the key blocks that reach the tile add in descending order, the
        // last (causal: the tile's last row + offset over 128) first
        int* turn = p.turns + (long)bh * n_qt + qt;
        if (lane == 0) {
          const int last = causal ? min(n_kb - 1, (qt * TILE + TILE - 1 +
                                                   offset) / RES_ROWS)
                                  : n_kb - 1;
          turns::wait(turn, last - kb);
        }
        // the partials to add: at d 64 warpgroup 1's (it holds the pair's
        // sum), at d 128 both (their own columns)
        constexpr int C0 = D == 64 ? 1 : 0;
#pragma unroll
        for (int c = C0; c < CONSUMERS; ++c) wg::mbar_wait(&dq_full[c], ph);
        if (lane == 0) {
          turns::fence_async_global();
          const int q0 = qt * TILE;
#pragma unroll
          for (int c = C0; c < CONSUMERS; ++c) {
            const uint8_t* src = sDQ + c * FL::DQ_BYTES;
            const int col = D == 64 ? 0 : 64 * c;
            wg::tma_reduce_add_3d(&map_dq, src, col, q0, bh);
            wg::tma_reduce_add_3d(&map_dq, src + 64 * 128, col + 32, q0, bh);
          }
          wg::bulk_commit();
          wg::bulk_wait_read<0>();
#pragma unroll
          for (int c = C0; c < CONSUMERS; ++c) wg::mbar_arrive(&dq_free[c]);
          // the reduction has completed: pass the turn at once (the next
          // key block may be waiting for it)
          wg::bulk_wait<0>();
          turns::fence_async_global();
          turns::pass(turn);
        }
        __syncwarp();
        ph ^= 1;
      }
    }
  } else {
    // ---- consumers: 64 keys each
    wg::setmaxnreg_inc<DROP || BIAS ? 240 : 232>();
    const int cw = wgi - 1, t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, tig = t % 4;
    const int n0w = n0 + 64 * cw;
    const int key0 = n0w + 16 * warp + g, key1 = key0 + 8;
    // the keys' segment ids, held across the loop; the variant with both
    // keeps them, and its bias base and key step, in shared memory and
    // reads them a tile at a time (held in registers they spilled at d 128)
    int sid0 = -1, sid1 = -1;
    if (use_seg && !(DROP && BIAS)) {
      if (key0 < sk) sid0 = p.sid_kv[(long)bi * sk + key0];
      if (key1 < sk) sid1 = p.sid_kv[(long)bi * sk + key1];
    }
    if constexpr (DROP && BIAS) {
      sBiasRow[threadIdx.x - 128] = reinterpret_cast<uint64_t>(
          p.bias + (long)bi * p.bias_sb + (long)(bh - bi * p.h) * p.bias_sh +
          min(key0, sk - 1));
      sBiasRow[threadIdx.x + 128] =
          (uint64_t)(min(key1, sk - 1) - min(key0, sk - 1));
      if (use_seg) {
        sts_s32(sSidK + 4 * (key0 - n0),
                key0 < sk ? p.sid_kv[(long)bi * sk + key0] : -1);
        sts_s32(sSidK + 4 * (key1 - n0),
                key1 < sk ? p.sid_kv[(long)bi * sk + key1] : -1);
      }
    }
    const float sl2 = p.scale * LOG2E;
    uint8_t* dqs = sDQ + cw * FL::DQ_BYTES;    // this warpgroup's partial
    float dv[D / 2], dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

    wg::mbar_wait(res, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * TILE;
      // S^T = K Q^T and dP^T = V dO^T. No warpgroup skips a tile of the
      // block's range: at d 128 the dQ product needs both halves of dS^T,
      // and a half whose keys no row of the tile sees is zero by the mask.
      float s[TILE / 2], dp[TILE / 2];
      if constexpr (BIAS) {
        // the tile's bias / scale into S^T (element 4 nb + 2 r + e: key
        // key0 + 8 r, query row q0 + 8 nb + 2 tig + e), which the S^T
        // product adds to; keys past sk and rows past sq clamped to the
        // last (both masked)
        const float* b0;
        int d1;
        if constexpr (DROP) {
          b0 = reinterpret_cast<const float*>(
              ((volatile uint64_t*)sBiasRow)[threadIdx.x - 128]);
          d1 = (int)((volatile uint64_t*)sBiasRow)[threadIdx.x + 128];
        } else {
          b0 = p.bias + (long)bi * p.bias_sb +
               (long)(bh - bi * p.h) * p.bias_sh + min(key0, sk - 1);
          d1 = min(key1, sk - 1) - min(key0, sk - 1);
        }
        if (DROP && q0 + TILE <= sq) {
          // the variant with both, the tile inside sq: its rows from one
          // pointer
          const float* r0 = b0 + (long)(q0 + 2 * tig) * sk;
#pragma unroll
          for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float* at = r0 + (long)(8 * nb + e) * sk;
              s[4 * nb + e] = __ldg(at) * p.inv_scale;
              s[4 * nb + 2 + e] = __ldg(at + d1) * p.inv_scale;
            }
        } else {
#pragma unroll (DROP ? TILE / 8 : kBiasUnroll<D>)
          for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int off = min(q0 + 8 * nb + 2 * tig + e, sq - 1) * sk;
              s[4 * nb + e] = __ldg(b0 + off) * p.inv_scale;
              s[4 * nb + 2 + e] = __ldg(b0 + off + d1) * p.inv_scale;
            }
        }
      }
      wg::mbar_wait(&full[stage], phase);
      const uint8_t* tq = ring + stage * 2 * FL::TILE_BYTES;
      const uint8_t* tdo = tq + FL::TILE_BYTES;
      wg::wgmma_fence();
      scores<T, D, TILE, BIAS>(s, dp, sK, sV, tq, tdo, cw);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(s);
      wg::fence_regs(dp);
      // the variant with both: s * scale rounded, then taken to base 2, in
      // place before its probabilities loop (the two products inside the
      // loop spilled at d 128)
      if constexpr (DROP && BIAS) {
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i)
          s[i] = __fmul_rn(__fmul_rn(s[i], p.scale), LOG2E);
      }

      // p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - delta); the mask
      // only on diagonal, ragged or segment tiles
      const float* lse = sLse + stage * TILE;
      const float* dl = sDelta + stage * TILE;
      const int32_t* sidq = sSid + stage * TILE;
      // (the variant with both reads them by shared-window addresses)
      const uint32_t lse_a = wg::smem_u32(lse), dl_a = wg::smem_u32(dl),
                     sid_a = wg::smem_u32(sidq);
      // dropout: the hash's (seed, batch, head, key) terms of the two keys,
      // a tile at a time (held across the loop they cost registers)
      uint32_t dkey[2];
      if constexpr (DROP) {
        const uint32_t hb = dropout::base(p.seed, bi, bh - bi * p.h);
        dkey[0] = hb ^ dropout::k_term(key0);
        dkey[1] = hb ^ dropout::k_term(key1);
      }
      auto probs = [&](auto masked) {
#pragma unroll
        for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ql = 8 * nb + 2 * tig + e;
            const float l = lse[ql], de = dl[ql];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * nb + 2 * r + e;
              float pv;   // the bias variants: s * scale rounded first
              if constexpr (BIAS)
                pv = ex2(__fmul_rn(__fmul_rn(s[i], p.scale), LOG2E) -
                         l);
              else
                pv = ex2(fmaf(s[i], sl2, -l));
              if constexpr (decltype(masked)::value) {
                const int key = r ? key1 : key0, qrow = q0 + ql;
                bool ok = qrow < sq && key < sk &&
                          (!causal || key <= qrow + offset);
                if (use_seg) {
                  const int sr = sidq[ql];
                  ok = ok && sr >= 0 && sr == (r ? sid1 : sid0);
                }
                pv = ok ? pv : 0.f;
              }
              if constexpr (DROP) {   // dV takes p dropped, ds p undropped
                const bool kept = dropout::keep(
                    dkey[r] ^ dropout::q_term(q0 + ql), p.threshold);
                dp[i] = pv * ((kept ? dp[i] * p.inv : 0.f) - de);
                s[i] = kept ? pv * p.inv : 0.f;
              } else {
                s[i] = pv;
                dp[i] = pv * (dp[i] - de);
              }
            }
          }
      };
      // the variant with both: the same, reading lse, delta and the rows'
      // segment ids by shared-window addresses and the keys' ids from
      // shared memory, and at d 128 in two halves of the tile with a warp
      // barrier between them (ptxas otherwise hashes the whole tile's keep
      // bits at once, and spilled)
      auto probs_both = [&](auto masked) {
        constexpr int HALVES = D == 128 ? 2 : 1;
        int ks0 = -1, ks1 = -1;
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf) {
          if (decltype(masked)::value && use_seg) {
            ks0 = lds_s32(sSidK + 4 * (key0 - n0));
            ks1 = lds_s32(sSidK + 4 * (key1 - n0));
          }
#pragma unroll
          for (int nb = hf * TILE / 8 / HALVES;
               nb < (hf + 1) * TILE / 8 / HALVES; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ql = 8 * nb + 2 * tig + e;
              const float l = lds_f32(lse_a + 4 * ql);
              const float de = lds_f32(dl_a + 4 * ql);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 4 * nb + 2 * r + e;
                float pv = ex2(s[i] - l);   // s in base 2 already
                if constexpr (decltype(masked)::value) {
                  const int key = r ? key1 : key0, qrow = q0 + ql;
                  bool ok = qrow < sq && key < sk &&
                            (!causal || key <= qrow + offset);
                  if (use_seg) {
                    const int sr = lds_s32(sid_a + 4 * ql);
                    ok = ok && sr >= 0 && sr == (r ? ks1 : ks0);
                  }
                  pv = ok ? pv : 0.f;
                }
                const bool kept = dropout::keep(
                    dkey[r] ^ dropout::q_term(q0 + ql), p.threshold);
                dp[i] = pv * ((kept ? dp[i] * p.inv : 0.f) - de);
                s[i] = kept ? pv * p.inv : 0.f;
              }
            }
          if (HALVES == 2 && hf == 0) __syncwarp();
        }
      };
      if (use_seg || q0 + TILE > sq || n0w + 64 > sk ||
          (causal && n0w + 63 > q0 + offset)) {
        if constexpr (DROP && BIAS)
          probs_both(std::true_type{});
        else
          probs(std::true_type{});
      } else {
        if constexpr (DROP && BIAS)
          probs_both(std::false_type{});
        else
          probs(std::false_type{});
      }

      // p rounded to do's dtype, ds once to q's (it feeds dK and dQ)
      uint32_t pa[TILE / 16][4], da[TILE / 16][4];
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        wg::acc_to_a<T>(s, kk, pa[kk]);
        wg::acc_to_a<T>(dp, kk, da[kk]);
      }
      // dS^T to shared memory, 128-byte swizzled as TMA would lay it out:
      // a row a key, the tile's 64 query rows its columns; word (nb, r) of
      // this thread is da[nb / 2][2 (nb % 2) + r], columns 8 nb + 2 tig
      // and + 1 of its key row. At d 64 a warpgroup's own 64 keys (rows
      // 0..63 of its tile), at d 128 the block's 128 (one buffer a tile,
      // alternating).
      const int kr0 = (D == 64 ? 0 : 64 * cw) + 16 * warp + g;
      uint8_t* ds = D == 64 ? sDS + cw * FL::DS_BYTES / 2
                            : sDS + ((qt - qt_begin) & 1) * FL::DS_BYTES;
#pragma unroll
      for (int nb = 0; nb < TILE / 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = kr0 + 8 * r;
          *reinterpret_cast<uint32_t*>(ds + kr * 128 +
                                       ((nb ^ (kr % 8)) << 4) + 4 * tig) =
              da[nb / 2][2 * (nb % 2) + r];
        }
      wg::fence_proxy_async();
      // the writer has read this warpgroup's previous partial before the
      // barrier lets anyone write the buffer again
      if (t == 0) wg::mbar_wait(&dq_free[cw], ((qt - qt_begin) & 1) ^ 1);
      if constexpr (D == 64)
        wg_sync(cw);               // the warpgroup's dS^T is in
      else
        consumers_sync();          // both halves of dS^T are in

      // dV += P^T dO, dK += dS^T Q (A in registers, B MN-major), then
      // dQ_tile = dS K with both operands MN-major: at d 64 each
      // warpgroup over its own 64 keys (both add their partial), at d 128
      // over the block's 128 keys, warpgroup cw the columns 64 cw ..
      // 64 cw + 63, issued once dV and dK are done (their A fragments and
      // dQ's accumulators do not fit in a thread's registers together)
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wg::mma_rs<T, D, 1>(dv, pa[kk], wg::mnmajor_desc<TILE>(tdo, kk));
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wg::mma_rs<T, D, 1>(dk, da[kk], wg::mnmajor_desc<TILE>(tq, kk));
      if constexpr (D == 128) {
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(dv);
        wg::fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          wg::fence_frag(pa[kk]);
          wg::fence_frag(da[kk]);
        }
        wg::wgmma_fence();
      }
      float dq[32];
      constexpr int DQ_ROWS = D == 64 ? 64 : RES_ROWS;   // keys summed
      const uint8_t* b_k = D == 64 ? sK + cw * 64 * 128
                                   : sK + cw * (RES_ROWS * 128);
      wg::mma_ss64_tt<T, 0>(dq, wg::mnmajor_desc<DQ_ROWS>(ds, 0),
                            wg::mnmajor_desc<RES_ROWS>(b_k, 0));
#pragma unroll
      for (int j = 1; j < DQ_ROWS / 16; ++j)
        wg::mma_ss64_tt<T, 1>(dq, wg::mnmajor_desc<DQ_ROWS>(ds, j),
                              wg::mnmajor_desc<RES_ROWS>(b_k, j));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(dv);
      wg::fence_regs(dk);
      wg::fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        wg::fence_frag(pa[kk]);
        wg::fence_frag(da[kk]);
      }

      // scale * dQ_tile to the partial buffer, laid out as the accumulator
      // map's two 32-column boxes (128-byte swizzled); the writer adds it
      // into dq_acc (rows past sq are not written). At d 64 both
      // warpgroups' partials cover the tile's 64 columns: warpgroup 1 adds
      // warpgroup 0's (the same positions it writes) before writing, so
      // the writer has one region to add, and hands buffer 0 back.
      const bool pair = D == 64 && cw == 1;
      if (pair) wg::mbar_wait(&dq_full[0], (qt - qt_begin) & 1);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;
          const int chunk = 2 * (nb % 4) + tig / 2;
          const int at_ = (nb / 4) * (64 * 128) + row * 128 +
                          ((chunk ^ (row % 8)) << 4) + 8 * (tig % 2);
          float2 v = make_float2(dq[4 * nb + 2 * r] * p.scale,
                                 dq[4 * nb + 2 * r + 1] * p.scale);
          if (pair) {
            const float2 o = *reinterpret_cast<const float2*>(sDQ + at_);
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *reinterpret_cast<float2*>(dqs + at_) = v;
        }
      wg::fence_proxy_async();
      wg_sync(cw);             // the partial is in; the stage is read
      if (t == 0) {
        wg::mbar_arrive(&dq_full[cw]);
        if (pair) wg::mbar_arrive(&dq_free[0]);   // buffer 0 is read
        wg::mbar_arrive(&empty[stage]);
      }
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- finish: dk (scaled) and dv, once
    const long at = (long)bh * sk * D;
    store_rows<T, D>(static_cast<T*>(p.out0) + at, dk, key0, sk, p.scale);
    store_rows<T, D>(static_cast<T*>(p.out1) + at, dv, key0, sk, 1.f);
  }
}

// ---------------------------------------------------------------------------
// the register-A product alone (the card test of its descriptors)
// ---------------------------------------------------------------------------

// c [64, N] fp32 = A B for one warpgroup: A [64, K] row-major, loaded into
// the register fragments of m64k16; B [N, K] (K-major) or [K, N] (BMN,
// MN-major) by one TMA into shared memory.
template <typename T, int N, int K, bool BMN>
__global__ void __launch_bounds__(128, 1)
rs_probe_kernel(const __grid_constant__ CUtensorMap map_b,
                const T* __restrict__ a, float* __restrict__ c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + N * K * 2);
  const int t = threadIdx.x, warp = t / 32, g = (t % 32) / 4, tig = t % 4;
  if (t == 0) {
    wg::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    wg::mbar_expect_tx(bar, N * K * 2);
    constexpr int ATOMS = (BMN ? N : K) / 64, ROWS = BMN ? K : N;
#pragma unroll
    for (int i = 0; i < ATOMS; ++i)
      wg::tma_load_3d(base + i * ROWS * 128, &map_b, bar, 64 * i, 0, 0);
  }
  uint32_t fa[K / 16][4];
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int r = 16 * warp + g, col = 16 * kk + 2 * tig;
    fa[kk][0] = a32[(r * K + col) / 2];
    fa[kk][1] = a32[((r + 8) * K + col) / 2];
    fa[kk][2] = a32[(r * K + col + 8) / 2];
    fa[kk][3] = a32[((r + 8) * K + col + 8) / 2];
  }
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wg::mbar_wait(bar, 0);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wg::mma_rs<T, N, BMN ? 1 : 0>(
        d, fa[kk],
        BMN ? wg::mnmajor_desc<K>(base, kk) : wg::kmajor_desc<N>(base, 0, kk));
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(d);
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[(16 * warp + g + 8 * (i / 2)) * N + 8 * nb + 2 * tig + (i % 2)] =
          d[4 * nb + i];
}

template <typename T, int N, int K, bool BMN>
cudaError_t rs_probe(const void* a, const void* b, void* c,
                     cudaStream_t st) {
  CUtensorMap mb;
  // B as a one-head [rows, cols] tensor: [K, N] MN-major, [N, K] K-major
  if (!(BMN ? wg::attn_map<T>(&mb, b, 1, K, N, K)
            : wg::attn_map<T>(&mb, b, 1, N, K, N)))
    return MAP_REFUSED;
  const size_t smem = (size_t)N * K * 2 + 8 + 1024;
  auto kern = rs_probe_kernel<T, N, K, BMN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<1, 128, smem, st>>>(mb, static_cast<const T*>(a),
                             static_cast<float*>(c));
  return cudaGetLastError();
}

template <typename T>
cudaError_t rs_probe_of(const void* a, const void* b, void* c, int N, int K,
                        int b_mn, cudaStream_t st) {
#define PROBE(NN, KK)                                                     \
  if (N == NN && K == KK)                                                 \
    return b_mn ? rs_probe<T, NN, KK, true>(a, b, c, st)                  \
                : rs_probe<T, NN, KK, false>(a, b, c, st);
  PROBE(64, 64)
  PROBE(64, 128)
  PROBE(128, 64)
  PROBE(128, 128)
#undef PROBE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse;
  void* delta;          // written by the dq kernel when `o` is set
  const void *sid_q, *sid_kv;
  void *out0, *out1;    // dk, dv (dk/dv, single pass) or dq (dq)
  void* out2;           // the single pass: dq_acc
  void* turns;          // the single pass: its turn counters
  const void* o;        // dq: the forward's output (the delta fold), or null
  int b, h, sq, sk, causal;
  float scale;
  cudaStream_t stream;
  uint32_t seed = 0, threshold = 0;   // dropout (0: none)
  float inv = 1.f;
  const void* bias = nullptr;         // the bias, or null
  long bias_sb = 0, bias_sh = 0;
};

// which kernel: the split's two, or the single pass
enum Kind { DKDV, DQ, FUSED };

template <typename T, int D, Kind K, bool DROP = false, bool BIAS = false>
cudaError_t launch(const Args& a) {
  const long bh = (long)a.b * a.h;
  // the resident side's boxes are 128 rows, the streamed side's its TILE
  constexpr int TILE = K == FUSED  ? FusedLayout<D>::TILE
                       : K == DKDV ? DkdvTile<D, DROP, BIAS>::value
                                   : SplitTile<D>::value;
  const int rows_q = K == DQ ? RES_ROWS : TILE;
  const int rows_k = K == DQ ? TILE : RES_ROWS;
  CUtensorMap mq, mk, mv, mdo;
  if (!wg::attn_map<T>(&mq, a.q, bh, a.sq, D, rows_q) ||
      !wg::attn_map<T>(&mdo, a.dout, bh, a.sq, D, rows_q) ||
      !wg::attn_map<T>(&mk, a.k, bh, a.sk, D, rows_k) ||
      !wg::attn_map<T>(&mv, a.v, bh, a.sk, D, rows_k))
    return MAP_REFUSED;
  const Params p{static_cast<const float*>(a.lse),
                 static_cast<float*>(a.delta),
                 static_cast<const int32_t*>(a.sid_q),
                 static_cast<const int32_t*>(a.sid_kv),
                 a.out0, a.out1, a.out2, static_cast<int*>(a.turns), a.o,
                 a.dout, a.h, a.sq, a.sk, a.causal, a.scale, a.seed,
                 a.threshold, a.inv};
  BiasParams<BIAS> bp;
  static_cast<Params&>(bp) = p;
  if constexpr (BIAS) {
    bp.bias = static_cast<const float*>(a.bias);
    bp.bias_sb = a.bias_sb;
    bp.bias_sh = a.bias_sh;
    bp.inv_scale = 1.f / a.scale;
  }
  const int s = K == DQ ? a.sq : a.sk;
  const dim3 grid((unsigned)bh, (s + RES_ROWS - 1) / RES_ROWS);
  if constexpr (K == FUSED) {
    CUtensorMap mdq;
    if (!wg::acc_map(&mdq, static_cast<const float*>(a.out2), bh, a.sq, D,
                     64))
      return MAP_REFUSED;
    const size_t smem =
        FusedLayout<D>::SMEM + (DROP && BIAS ? kBothSideBytes : 0);
    auto kern = flash_bwd_fused_sm90<T, D, DROP, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, a.stream>>>(mq, mk, mv, mdo, mdq, bp);
  } else {
    const size_t smem = Layout<D, TILE>::SMEM;
    auto kern = K == DQ ? flash_dq_sm90<T, D, DROP, BIAS>
                        : flash_dkdv_sm90<T, D, DROP, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, a.stream>>>(mq, mk, mv, mdo, bp);
  }
  return cudaGetLastError();
}

// the kernel of kind K and variant DROP, BIAS of the operands' dtype and
// head dim
template <Kind K, bool DROP, bool BIAS = false>
int launch_of(const Args& a, int d, int dtype) {
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return d == 64 ? launch<__nv_bfloat16, 64, K, DROP, BIAS>(a)
                     : launch<__nv_bfloat16, 128, K, DROP, BIAS>(a);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return d == 64 ? launch<__half, 64, K, DROP, BIAS>(a)
                     : launch<__half, 128, K, DROP, BIAS>(a);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

template <Kind K>
int dispatch(const Args& a, int d, int dtype) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const long bh = (long)a.b * a.h;
  const int own = K == DQ ? a.sq : a.sk, other = K == DQ ? a.sk : a.sq;
  if (bh <= 0 || own <= 0) return cudaSuccess;
  if (other <= 0) {       // no pair: the gradients are zero (and no
                          // kernel reads delta; dq_acc stays zero)
    const size_t bytes = (size_t)bh * own * d * 2;
    cudaError_t err = cudaMemsetAsync(a.out0, 0, bytes, a.stream);
    if (err == cudaSuccess && K != DQ)
      err = cudaMemsetAsync(a.out1, 0, bytes, a.stream);
    return err;
  }
  // the variant with the bias where there is one; with dropout too, the
  // variant with both
  if (a.bias) {
    if (!a.threshold) return launch_of<K, false, true>(a, d, dtype);
    return launch_of<K, true, true>(a, d, dtype);
  }
  // the variant with dropout where the threshold keeps fewer than all
  if (a.threshold) return launch_of<K, true>(a, d, dtype);
  return launch_of<K, false>(a, d, dtype);
}

}  // namespace

// C interface (loaded with ctypes). Device pointers of contiguous tensors:
// q, dout [b,h,sq,d] and k, v [b,h,sk,d] of one dtype (`dtype` 0 bf16,
// 1 fp16; a build holds one, ops/_build.py), d 64 or 128; lse, delta
// [b,h,sq] f32; sid_q [b,sq] and sid_kv [b,sk] int32, or both null. Each
// returns the launch's cudaError_t: cudaErrorInvalidValue for another d or
// dtype, cudaErrorNotSupported (801) when the driver refuses a TMA map (a
// base address not 16-byte aligned).

// The bias as the forward's C entry takes it: `bias` fp32 [b|1, h|1, sq,
// sk] with its last two dims contiguous and an 8-byte aligned base, or
// null (none); `bias_sb` and `bias_sh` its batch and head strides in
// elements (0 for a broadcast dim). Dropout as the forward's C entry takes
// it: `seed`, `threshold` (0: no dropout) and `inv` = 1 / (1 - rate).
// Every entry takes a bias with dropout (the variant with both).

// dk, dv [b,h,sk,d] (every element written)
extern "C" int apex_flash_bwd_sm90_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* sid_q,
    const void* sid_kv, void* dk, void* dv, int b, int h, int sq, int sk,
    int d, int causal, float scale, int dtype, const void* bias,
    long bias_sb, long bias_sh, unsigned int seed, unsigned int threshold,
    float inv, void* stream) {
  Args a{q, k, v, dout, lse, const_cast<void*>(delta), sid_q, sid_kv,
         dk, dv, nullptr, nullptr, nullptr, b, h, sq, sk, causal,
         scale, static_cast<cudaStream_t>(stream), seed, threshold, inv};
  a.bias = bias;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  return dispatch<DKDV>(a, d, dtype);
}

// dq [b,h,sq,d] (every element written). With `out` (the forward's output
// [b,h,sq,d], q's dtype; the dropped output under dropout) the kernel
// computes delta = rowsum(do * out) itself and writes it into `delta` for
// the dk/dv kernel launched after it; with `out` null it reads `delta`.
extern "C" int apex_flash_bwd_sm90_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, const void* sid_q, const void* sid_kv,
    void* dq, const void* out, int b, int h, int sq, int sk, int d,
    int causal, float scale, int dtype, const void* bias, long bias_sb,
    long bias_sh, unsigned int seed, unsigned int threshold, float inv,
    void* stream) {
  Args a{q, k, v, dout, lse, delta, sid_q, sid_kv, dq, nullptr,
         nullptr, nullptr, out, b, h, sq, sk, causal, scale,
         static_cast<cudaStream_t>(stream), seed, threshold, inv};
  a.bias = bias;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  return dispatch<DQ>(a, d, dtype);
}

// The single pass: dk, dv [b,h,sk,d] (every element written) and dq added,
// times `scale`, in a fixed order into dq_acc [b,h,sq,d] fp32, which the
// caller zeroes, as it zeroes `turns` (b * h * ceil(sq / 64) int32, one
// counter a 64-row query tile, left at the tile's count of key blocks);
// from a given delta (rowsum(do * out), computed outside as the JAX
// package computes it); the bias and dropout as the split's entries take
// them.
extern "C" int apex_flash_bwd_sm90_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* sid_q,
    const void* sid_kv, void* dq_acc, void* turns, void* dk, void* dv, int b,
    int h, int sq, int sk, int d, int causal, float scale, int dtype,
    const void* bias, long bias_sb, long bias_sh, unsigned int seed,
    unsigned int threshold, float inv, void* stream) {
  Args a{q, k, v, dout, lse, const_cast<void*>(delta), sid_q, sid_kv,
         dk, dv, dq_acc, turns, nullptr, b, h, sq, sk, causal, scale,
         static_cast<cudaStream_t>(stream), seed, threshold, inv};
  a.bias = bias;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  return dispatch<FUSED>(a, d, dtype);
}

// The register-A product alone: c [64, n] fp32 = a [64, k] b with b [n, k]
// (b_mn 0) or [k, n] (b_mn 1); n and k 64 or 128.
extern "C" int apex_wgmma_rs_probe(const void* a, const void* b, void* c,
                                   int n, int k, int b_mn, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
#if APEX_HAS_DTYPE(0)
      return rs_probe_of<__nv_bfloat16>(a, b, c, n, k, b_mn, st);
#else
      return cudaErrorInvalidValue;
#endif
    case 1:
#if APEX_HAS_DTYPE(1)
      return rs_probe_of<__half>(a, b, c, n, k, b_mn, st);
#else
      return cudaErrorInvalidValue;
#endif
    default:
      return cudaErrorInvalidValue;
  }
}
