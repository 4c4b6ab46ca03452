// K-B2: fixed-order reductions for the decision scalars.
//
// Replaces: fasta_tpu/kernels/ddreduce.py (dd_reduce, dd_dot_rows,
// dd_dot_rows2) — the compensated double-word (Sum2) trees the TPU
// kernels inline because their chip has no float64.
//
// Bound on this card: latency, not bytes — a handful of shuffles and one
// shared-memory round per block for a few scalars.
//
// Design: Hopper has native FP64, so the compensated float32 arithmetic
// becomes a plain sum in the accumulation type Acc: double for the
// high-precision scalars (a product of two float32 values is exact in
// double, so the error is far below the Sum2 bound of 0.8-9.2e-10 of
// sum|p| that tests/unit/test_ddreduce.py pins), float otherwise.  Every
// sum runs in a fixed order — lane-strided partials, a shuffle tree, then
// the warps (or blocks) in index order — so results are identical from
// run to run and, when every block reduces the same inputs, identical in
// every block.  No atomics.
#pragma once

#include <cuda_runtime.h>

namespace fasta {

// Sum over the 32 lanes of a warp; the result is valid in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; the result is valid in every thread.  `scratch`
// holds one T per warp in shared memory.  Every thread must call it.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = T(0);
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  return total;
}

// Sum of `count` values stored as double in global memory (written by
// other blocks before a grid-wide barrier), accumulated in T by one warp
// in a fixed order; the result is valid in lane 0.  The loads bypass L1,
// which does not see other SMs' writes.
template <typename T>
__device__ __forceinline__ T warp_sum_global(const double* p, int count) {
  const int lane = threadIdx.x & 31;
  T v = T(0);
  for (int i = lane; i < count; i += 32) v += static_cast<T>(__ldcg(p + i));
  return warp_sum(v);
}

}  // namespace fasta
