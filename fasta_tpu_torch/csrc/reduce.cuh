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

// Sums over the block of NF floats and NA values of type T at once: a
// shuffle tree on each value (the trees interleave), one shared-memory
// round and one __syncthreads, then thread k < NF + NA adds up the k-th
// value's warp sums in warp order (the floats first, then the Ts) and
// returns that total as a double; the other threads return 0.  fs holds
// NF floats and ts NA Ts per warp.  Every thread must call it, and no
// thread may write fs or ts again before the block has passed another
// barrier (a grid barrier is one).
template <int NF, int NA, typename T>
__device__ __forceinline__ double block_sums(float (&f)[NF], T (&t)[NA], float* fs, T* ts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(f[k]);
#pragma unroll
  for (int k = 0; k < NA; ++k) t[k] = warp_sum(t[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) fs[warp * NF + k] = f[k];
#pragma unroll
    for (int k = 0; k < NA; ++k) ts[warp * NA + k] = t[k];
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < NF) {
    float s = 0.f;
#pragma unroll 16
    for (int w = 0; w < nwarps; ++w) s += fs[w * NF + k];
    return s;
  }
  if (k < NF + NA) {
    T s = T(0);
#pragma unroll 16
    for (int w = 0; w < nwarps; ++w) s += ts[w * NA + k - NF];
    return double(s);
  }
  return 0.0;
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
