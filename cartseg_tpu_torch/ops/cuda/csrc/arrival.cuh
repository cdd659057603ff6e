// The arrival count by which the last CTA of a group finishes a fixed-
// order reduction in the launch that wrote its partials: each CTA stores
// its partial, then counts itself in; the CTA that arrives last reads
// every partial and writes the result. Included by csrc/channel_sums.cu
// and csrc/soft_dice.cu, whose wrappers hand each kernel its own zeroed
// counters (ops/cuda/counters.py).

#pragma once

namespace {

// Thread 0 counts the CTA in on *count once every thread's partial
// stores are done (the barrier), by an acquire-release increment at GPU
// scope: its release publishes the CTA's stores, its acquire (and the
// barrier after it) lets the last CTA read every other CTA's. True in the
// CTA that arrived last of `arrivals`, where the counter wraps back to 0,
// so the next call on the stream finds it zero: no memset.
__device__ __forceinline__ bool arrived_last(unsigned* count,
                                             unsigned arrivals) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(count), "r"(arrivals - 1)
                 : "memory");
    last = old == arrivals - 1;
  }
  __syncthreads();
  return last;
}

}  // namespace
