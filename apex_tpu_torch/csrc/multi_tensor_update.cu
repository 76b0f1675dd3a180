// Fused multi-tensor optimizer update for Hopper (sm_90a): one Adam(W) step,
// or LAMB's pre-trust-ratio term, over a flat fp32 buffer that holds every
// parameter of a ZeRO shard, in one launch.
//
// Replaces the Pallas kernel `_mtu_kernel` of apex_tpu/zero/fused_update.py
// (:54, launched by `fused_shard_update` :141); the apex analog is
// csrc/multi_tensor_apply.cuh (many tensors, one launch, one sweep).
// Contract (shared with apex_tpu_torch.zero.fused_update):
//   p, g, m, v   [n] fp32, contiguous (n any size, no padding)
//   scal         [3] fp32 on the device: lr, 1 - b1^t, 1 - b2^t
//   skip         one byte on the device (a torch.bool), or null
//   upd          [n] fp32, LAMB mode only
// Adam mode reads p, g, m, v once and writes p, m, v once, in place. LAMB
// mode writes the update term to `upd` and m, v in place (p is only read;
// the trust ratio stays with the caller, whose layout knows the leaves).
// When *skip is set nothing is written (LAMB writes zeros to `upd`), so an
// overflow step leaves every buffer bitwise unchanged without a select pass.
//
// Numerics: the body is the op sequence of apex_tpu_torch/zero/update.py
// (the JAX zero/update.py), each step rounded once to fp32 with the _rn
// intrinsics, which never contract into an FMA, so the kernel is bitwise the
// plain version's eager torch ops fed the same scalars. Built without
// --use_fast_math.
//
// Bound: bytes. Adam moves 7 x 4 bytes an element (4 reads, 3 writes), LAMB
// the same (p read, upd written), ~15 flops an element: at 3.35 TB/s the
// 185.8 M-element GPT shard needs 1.55 ms. The design is a plain grid-stride
// sweep with 16-byte (float4) loads and stores, about 16 blocks of 256
// threads per SM in flight, and a scalar loop for the ragged tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float b1, beta3, b2, omb2, eps, wd;
  int l2, decoupled, bias_correction, lamb;
};

__device__ __forceinline__ void update_one(float& p, float g, float& m,
                                           float& v, float& out,
                                           const Hyper& h, float lr, float c1,
                                           float c2) {
  if (h.l2) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.beta3, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float mhat = m, vhat = v;
  if (h.bias_correction) {
    mhat = __fdiv_rn(m, c1);
    vhat = __fdiv_rn(v, c2);
  }
  float u = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (h.decoupled) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  out = h.lamb ? u : __fsub_rn(p, __fmul_rn(lr, u));
}

template <bool VEC>
__global__ void __launch_bounds__(256)
mtu_kernel(float* p, const float* __restrict__ g, float* __restrict__ m,
           float* __restrict__ v, float* upd, const float* __restrict__ scal,
           const uint8_t* __restrict__ skip, long long n, Hyper h) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (skip != nullptr && *skip) {
    if (h.lamb)
      for (long long i = tid; i < n; i += stride) upd[i] = 0.0f;
    return;
  }
  const float lr = scal[0], c1 = scal[1], c2 = scal[2];
  float* out = h.lamb ? upd : p;
  long long head = 0;
  if (VEC) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float4 pp = reinterpret_cast<const float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<const float4*>(m)[i];
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      float4 oo;
      update_one(pp.x, gg.x, mm.x, vv.x, oo.x, h, lr, c1, c2);
      update_one(pp.y, gg.y, mm.y, vv.y, oo.y, h, lr, c1, c2);
      update_one(pp.z, gg.z, mm.z, vv.z, oo.z, h, lr, c1, c2);
      update_one(pp.w, gg.w, mm.w, vv.w, oo.w, h, lr, c1, c2);
      reinterpret_cast<float4*>(out)[i] = oo;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    head = n4 * 4;
  }
  for (long long i = head + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i], oo;
    update_one(pp, g[i], mm, vv, oo, h, lr, c1, c2);
    out[i] = oo;
    m[i] = mm;
    v[i] = vv;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

}  // namespace

// kind: 0 adam, 1 lamb. l2: weight decay added to the gradient (Adam, not
// AdamW); decoupled: AdamW decay added to the update term.
extern "C" int apex_multi_tensor_update(
    void* p, const void* g, void* m, void* v, void* upd, const void* scal,
    const void* skip, long long n, int lamb, float b1, float beta3, float b2,
    float omb2, float eps, float wd, int l2, int decoupled,
    int bias_correction, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (lamb && upd == nullptr) return cudaErrorInvalidValue;
  Hyper h{b1, beta3, b2, omb2, eps, wd, l2, decoupled, bias_correction, lamb};
  const bool vec =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
        (lamb ? reinterpret_cast<uintptr_t>(upd) : 0)) & 15) == 0;
  const int threads = 256;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 16LL * sm_count();
  if (blocks > cap) blocks = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  float* uf = static_cast<float*>(upd);
  const float* sf = static_cast<const float*>(scal);
  const uint8_t* kf = static_cast<const uint8_t*>(skip);
  if (vec)
    mtu_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(pf, gf, mf, vf, uf,
                                                           sf, kf, n, h);
  else
    mtu_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(pf, gf, mf, vf,
                                                            uf, sf, kf, n, h);
  return cudaGetLastError();
}
