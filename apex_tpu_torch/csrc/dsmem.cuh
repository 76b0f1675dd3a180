// Thread-block-cluster primitives (sm_90): the split cluster barrier and
// the asynchronous store from a thread's registers into the shared memory
// of another block of the cluster, completing on that block's mbarrier.
// Shared by the decode kernels (fp8_matmul.cu, paged_decode.cu), whose K
// splits or key pieces hand their partial results to the block that sums
// them.
//
// The protocol: every block initialises its mbarriers, makes them visible
// to the cluster (fence.mbarrier_init.release.cluster) and arrives on the
// cluster barrier at its start (cluster_arrive: relaxed, it waits for
// nothing); a thread that stores into another block waits on the cluster
// barrier first (cluster_wait: every block has started and initialised its
// barriers), then issues store_to_rank. The receiving block arms its
// barrier with the bytes it expects (mbarrier.arrive.expect_tx) and waits
// on it, so it cannot exit before the last byte lands; a store reads its
// registers at issue, so the sender needs no wait of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dsmem {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `p` (a shared address of this block) in
// block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// `v` into block `rank`'s shared memory at the address `dst` has in this
// block (16-byte aligned), completing 16 bytes on block `rank`'s mbarrier
// at the address `bar` has in this block
__device__ __forceinline__ void store_to_rank(const void* dst, float4 v,
                                              uint64_t* bar, int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(map_rank(dst, rank)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(map_rank(bar, rank))
      : "memory");
}

// the same for one float (4 bytes)
__device__ __forceinline__ void store_to_rank(const void* dst, float v,
                                              uint64_t* bar, int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
      "[%0], %1, [%2];\n" ::"r"(map_rank(dst, rank)),
      "f"(v), "r"(map_rank(bar, rank))
      : "memory");
}

}  // namespace dsmem
