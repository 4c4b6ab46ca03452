// A grid-wide barrier for a cooperative launch, written out, beside
// cooperative_groups' grid.sync (K-P1 times the two; csrc/matvec_probe.cu).
//
// grid.sync fences, adds to a counter with an atomic whose old value it
// reads back, spins, and fences again.  Here, after a block barrier,
// thread 0 of each block adds one to `count` with a release reduction at
// GPU scope (nothing waits on its return), spins with acquire loads until
// every block has arrived at this barrier — the gen-th of the launch, so
// count ≥ gen·nblocks — and a block barrier releases the other threads.
// The writes a block made before the barrier are visible to every block
// after it through the release/acquire pair; values other blocks wrote
// are still read past L1 (__ldcg), as after grid.sync.  `count` is zero
// at launch (the wrapper's scratch); each thread keeps its own `gen`, the
// barriers it has arrived at.  A spin that lasts 10 s traps: an arrival was
// lost, which no slow block explains.
#pragma once

#include <cuda_runtime.h>

namespace fasta {

// The barrier in two halves: grid_arrive publishes this block's writes
// and its arrival, grid_wait waits for every block's.  Work between them
// (loads whose results the block needs only after the barrier) overlaps
// the wait; it must not write what other blocks read after the barrier.
__device__ __forceinline__ void grid_arrive(unsigned* count, unsigned& gen) {
  __syncthreads();
  gen += 1;
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count), "r"(1u) : "memory");
}

__device__ __forceinline__ void grid_wait(const unsigned* count, unsigned nblocks, unsigned gen) {
  if (threadIdx.x == 0) {
    const unsigned target = gen * nblocks;
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
      if ((int)(v - target) >= 0) break;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t - t0 > 10000000000ull) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned nblocks, unsigned& gen) {
  grid_arrive(count, gen);
  grid_wait(count, nblocks, gen);
}

// The end of a launch that keeps its counter in a buffer shared by every
// launch on its stream (the wrapper's stream scratch, zeroed once): after
// its last barrier each block takes a ticket from count[1]; the last
// block to take one sets both words back to zero.  Every other block has
// passed its last grid_wait before taking its ticket, so nothing reads the
// counter after the reset, and the next launch on the stream finds both
// at zero.
__device__ __forceinline__ void grid_exit(unsigned* count, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(count + 1, 1u) == nblocks - 1) {
    count[0] = 0u;
    count[1] = 0u;
  }
}

}  // namespace fasta
