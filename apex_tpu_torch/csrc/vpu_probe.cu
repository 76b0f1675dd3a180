// Per-op cost probe for Hopper (sm_90a): REPS = 64 chained applications of
// one elementwise fp32 op to every element of x [grid, 512, 512].
//
// Replaces the Pallas kernel `make_kernel(op)` of scripts/vpu_probe.py
// (:17, launched by `probe` :41), which times the TPU's vector unit on a
// VMEM-resident block. Ops (the `op` code of the C interface):
//   0 mul             acc = acc * 1.0000001
//   1 max             acc = max(acc, acc * 0.999999)
//   2 where           acc = acc > 0 ? acc : acc * 0.999
//   3 iota_cmp_where  acc = row >= col ? acc : acc * 0.999, (row, col) the
//                     element's place in its 512 x 512 block
//   4 exp             acc = exp(acc * 1e-9)
//   5 exp2            acc = exp2(acc * 1e-9)
// The constants are the script's, as fp32 values. Each product is
// __fmul_rn (never contracted), and expf / exp2f are the accurate library
// functions (no fast-math: the build passes no --use_fast_math), so which
// instructions run is fixed here and not by a compiler's choice; the 64
// applications form one dependent chain per element, which no compiler may
// fold or hoist (floating-point multiplication does not reassociate).
//
// Bound on the H100. The TPU kernel's premise — no HBM traffic — does not
// hold on a GPU: one launch reads and writes x, 2 * 64 MB at grid 64, which
// is 40 us at 3.35 TB/s. Its 64 * 16.8 M = 1.07 G element-ops take ~32 us at
// the fp32 issue rate (132 SMs x 128 lanes x ~1.98 GHz), so mul, max and
// where are bound by bytes; exp and exp2 by the special-function units
// (16 results per clock per SM for ex2, plus the range reduction's FMAs).
//
// Design. A grid-stride loop, one float4 (four independent chains, which
// the scheduler interleaves) per thread per step, 16-byte loads and stores
// with neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int REPS = 64;
constexpr int BQ = 512, BK = 512;
constexpr int THREADS = 256;

template <int OP>
__device__ __forceinline__ float apply(float acc, bool lower) {
  if constexpr (OP == 0) return __fmul_rn(acc, 1.0000001f);
  if constexpr (OP == 1) return fmaxf(acc, __fmul_rn(acc, 0.999999f));
  if constexpr (OP == 2) return acc > 0.f ? acc : __fmul_rn(acc, 0.999f);
  if constexpr (OP == 3) return lower ? acc : __fmul_rn(acc, 0.999f);
  if constexpr (OP == 4) return expf(__fmul_rn(acc, 1e-9f));
  if constexpr (OP == 5) return exp2f(__fmul_rn(acc, 1e-9f));
  return acc;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
vpu_probe_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                 long n4) {
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += (long)gridDim.x * THREADS) {
    const float4 v = x[i];
    float a[4] = {v.x, v.y, v.z, v.w};
    bool lower[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long e = i * 4 + j;
      const int col = (int)(e % BK), row = (int)((e / BK) % BQ);
      lower[j] = row >= col;
    }
#pragma unroll
    for (int r = 0; r < REPS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = apply<OP>(a[j], lower[j]);
    out[i] = make_float4(a[0], a[1], a[2], a[3]);
  }
}

template <int OP>
cudaError_t launch(const void* x, void* out, long n, cudaStream_t st) {
  const long n4 = n / 4;
  const long blocks = (n4 + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132L * 16 ? blocks : 132L * 16);
  vpu_probe_kernel<OP><<<grid, THREADS, 0, st>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n4);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes): x and out [grid, 512, 512] fp32,
// contiguous and 16-byte aligned, n = grid * 512 * 512 elements; `op` as
// listed above. Returns the launch's cudaError_t (cudaErrorInvalidValue
// for an unknown op or n not a multiple of 512 * 512).
extern "C" int apex_vpu_probe(const void* x, void* out, long n, int op,
                              void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n % ((long)BQ * BK) != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return launch<0>(x, out, n, st);
    case 1: return launch<1>(x, out, n, st);
    case 2: return launch<2>(x, out, n, st);
    case 3: return launch<3>(x, out, n, st);
    case 4: return launch<4>(x, out, n, st);
    case 5: return launch<5>(x, out, n, st);
    default: return cudaErrorInvalidValue;
  }
}
