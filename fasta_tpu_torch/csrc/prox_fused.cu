// K-B4: the fused shrink step of an L1 line-search trial, over R rows,
//     x̂₁ = x₀ − τ g,   x₁ = shrink(x̂₁, τμ),   Δx = x₁ − x₀,
//     and per row ‖Δx‖², ⟨Δx, g⟩, ‖x₁ − x̂₁‖²  (float64),
// x₀, g and x₁ float32 (R, n), τ and μ per row (or shared) read from the
// card, so that a caller holding τ on the card needs no host sync.
//
// Replaces: fasta_tpu/kernels/prox_fused.py, fused_shrink_step
// (pallas_call at :101) — the TPU kernel that walks the vector as a
// sequential grid of lane tiles and carries the three sums in SMEM from
// tile to tile.
//
// Bound on this card: bytes.  The step reads x₀ and g once and writes x₁
// once, 12·R·n bytes (at R·n = 2²⁴, 0.2 GB: 60 µs at 3.35 TB/s); its 20
// operations per entry are far below the float32 rate.  At the loop's
// sizes (R·n of a few thousand) the launch itself dominates.
//
// Design:
//  * A grid of (blocks per row, R): a block-strided loop over the row
//    replaces the TPU's sequential grid.  Rows whose length is a multiple
//    of 4 (or a single row) are read and written as float4, the ragged
//    tail masked; other rows fall back to scalar loads.
//  * The sums: each product of two float32 values is exact in float64;
//    each block sums its FP64 partials in a fixed order and writes them
//    to the call's own scratch.  The last block to finish (an integer
//    ticket in the same scratch, zeroed on the launch's stream — K-B5's
//    design, C-2) adds every row's partials in block order.  No float
//    atomics, so every run gives the same sums.
//  * Elementwise formulas use the _rn intrinsics, which the compiler
//    never contracts into FMAs, so x₁ rounds exactly like the plain
//    PyTorch version's separate multiply and subtract; the shrink keeps
//    NaN (nanmax), so the caller's nonfinite guard still fires.
#include <cuda_runtime.h>

#include "prox.cuh"
#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// at most this many blocks in all (8 per SM on 132 SMs, rounded)
constexpr int kMaxBlocks = 1024;

// blocks per row: enough for one float4 per thread, within kMaxBlocks
int blocks_per_row(int R, int n) {
  const long long want = ((long long)n + 4 * kThreads - 1) / (4 * kThreads);
  const long long cap = kMaxBlocks / R > 0 ? kMaxBlocks / R : 1;
  return (int)(want < cap ? want : cap);  // n ≥ 1, so want ≥ 1
}

struct Step {
  float tau, thr;
  double dx2 = 0.0, rdg = 0.0, gm2 = 0.0;
  __device__ __forceinline__ float operator()(float xv, float gv) {
    const float xh = __fsub_rn(xv, __fmul_rn(tau, gv));
    const float xn = fasta::shrink(xh, thr);
    const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, xh);
    dx2 += double(dx) * double(dx);
    rdg += double(dx) * double(gv);
    gm2 += double(sm) * double(sm);
    return xn;
  }
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads) shrink_step_kernel(
    const float* __restrict__ x0, const float* __restrict__ g, const float* __restrict__ tau,
    int tau_stride, const float* __restrict__ mu, int mu_stride, int n,
    float* __restrict__ x1, double* part, unsigned int* ticket, double* __restrict__ sums) {
  __shared__ double scratch[kWarps];
  __shared__ bool last;
  const int row = blockIdx.y, bx = blockIdx.x, gx = gridDim.x, tid = threadIdx.x;
  Step step;
  step.tau = __ldg(tau + (size_t)row * tau_stride);
  step.thr = __fmul_rn(step.tau, __ldg(mu + (size_t)row * mu_stride));
  const float* xr = x0 + (size_t)row * n;
  const float* gr = g + (size_t)row * n;
  float* yr = x1 + (size_t)row * n;
  const int stride = gx * kThreads, first = bx * kThreads + tid;
  int tail0 = 0;
  if (VEC) {
    const int nq = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int q = first; q < nq; q += stride) {
      const float4 a = __ldg(x4 + q), b = __ldg(g4 + q);
      float4 o;
      o.x = step(a.x, b.x);
      o.y = step(a.y, b.y);
      o.z = step(a.z, b.z);
      o.w = step(a.w, b.w);
      y4[q] = o;
    }
    tail0 = nq << 2;
  }
  for (int j = tail0 + first; j < n; j += stride) yr[j] = step(__ldg(xr + j), __ldg(gr + j));

  // the block's partials, then the last block sums every row's in block
  // order
  const double s0 = fasta::block_sum(step.dx2, scratch);
  const double s1 = fasta::block_sum(step.rdg, scratch);
  const double s2 = fasta::block_sum(step.gm2, scratch);
  if (tid == 0) {
    double* p = part + ((size_t)row * gx + bx) * 3;
    p[0] = s0;
    p[1] = s1;
    p[2] = s2;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned int)(gx * gridDim.y - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = tid & 31, warp = tid >> 5;
  const int items = 3 * gridDim.y;  // (row, sum) pairs, one warp each
  for (int it = warp; it < items; it += kWarps) {
    const int r = it / 3, k = it - 3 * r;
    double s = 0.0;
    for (int b = lane; b < gx; b += 32) s += __ldcg(part + ((size_t)r * gx + b) * 3 + k);
    s = fasta::warp_sum(s);
    if (lane == 0) sums[it] = s;
  }
}

}  // namespace

// The doubles of scratch a launch over R rows of n needs: three FP64
// partials per block, then one double that holds the last-block ticket.
extern "C" int fasta_shrink_step_work(int R, int n, int* ndoubles) {
  if (R < 1 || n < 1 || R > 65535) return cudaErrorInvalidValue;
  *ndoubles = 3 * R * blocks_per_row(R, n) + 1;
  return cudaSuccess;
}

// x1 (R, n) and sums (R, 3) = (‖Δx‖², ⟨Δx,g⟩, ‖x₁−x̂₁‖²) per row for x0
// and g (R, n) on `stream`; tau and mu are read at row·stride (stride 0:
// one value for every row).  work holds fasta_shrink_step_work(R, n)
// doubles.
extern "C" int fasta_shrink_step(const float* x0, const float* g, const float* tau,
                                 int tau_stride, const float* mu, int mu_stride, int R, int n,
                                 float* x1, double* sums, double* work, void* stream) {
  if (R < 1 || n < 1 || R > 65535 || tau_stride < 0 || mu_stride < 0)
    return cudaErrorInvalidValue;
  const int gx = blocks_per_row(R, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work + 3 * (size_t)R * gx);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  const bool aligned = ((reinterpret_cast<size_t>(x0) | reinterpret_cast<size_t>(g) |
                         reinterpret_cast<size_t>(x1)) & 15) == 0;
  const dim3 grid(gx, R);
  if (aligned && (R == 1 || (n & 3) == 0))
    shrink_step_kernel<true><<<grid, kThreads, 0, s>>>(x0, g, tau, tau_stride, mu, mu_stride, n,
                                                       x1, work, ticket, sums);
  else
    shrink_step_kernel<false><<<grid, kThreads, 0, s>>>(x0, g, tau, tau_stride, mu, mu_stride, n,
                                                        x1, work, ticket, sums);
  return cudaGetLastError();
}
