// Ordered accumulation across the blocks of one grid: turn counters.
//
// Several blocks add partials into one fp32 output tile (the single-pass
// flash backward's dq: every key tile adds its share of a query tile).
// Added with atomics, or with TMA bulk reductions issued as soon as a
// partial is ready, the sum's order, and so its last bits, vary from run
// to run. Instead each output tile gets an int32 turn counter in a zeroed
// workspace; the block whose turn number is n waits until the counter
// reads n, adds its partial with plain loads and stores (or one bulk
// reduction it waits for), makes the writes visible at device scope and
// adds one to the counter. The order is a function of the shape alone,
// so the sum is the same bits on every run, in any company of other
// batches and heads (FlashAttention-3's deterministic backward does the
// same).
//
// Forward progress: a block only ever waits for blocks of a smaller
// linear index in its grid, which the hardware dispatched before it, so a
// waiting block never holds back the block it waits for.

#pragma once

#include <stdint.h>

namespace turns {

// one thread spins until the counter at `turn` reads `mine` (acquire: the
// writes released with the counter are visible to it, and after a block
// barrier to the block)
__device__ __forceinline__ void wait(const int* turn, int mine) {
  int v;
  while (true) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(turn)
                 : "memory");
    if (v == mine) break;
    __nanosleep(64);
  }
}

// one thread hands the turn on, after the writes it must publish (release
// at device scope: every write the thread has observed, the block's after
// a barrier, is visible before the counter moves)
__device__ __forceinline__ void pass(int* turn) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(turn)
               : "memory");
}

// the async proxy's global accesses (TMA reductions) ordered with the
// generic proxy's (the counter's loads and stores)
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

}  // namespace turns
