// K-B5: the fused TV-dual gradient map in one launch,
//     d = μ·div p,   f = ½‖d − b‖²,   g = μ·grad(d − b),
// for a dual field p (2, H, W) (channel 0 vertical, channel 1 horizontal)
// and an image b (H, W), float32, with the stencil conventions of
// reference_oracle/generators.py: grad leaves the last row (channel 0)
// and the last column (channel 1) at zero, div is its adjoint.
//
// Replaces: fasta_tpu/kernels/tv_fused.py, fused_tv_gradmap (pallas_call
// at :82) — the TPU kernel that holds the whole state in VMEM and runs
// the stencils as rolls with edge masks.
//
// Bound on this card: bytes.  Each pixel reads p (8 B) and b (4 B) and
// writes d (4 B) and g (8 B): 24 B per pixel, 6.29 MB at 512×512 (1.9 µs
// at 3.35 TB/s).  At that size one launch's latency dominates; at
// 4096×4096 (403 MB) the kernel streams.
//
// Design: one launch over 2-D tiles of kTileH × kTileW pixels.  A block
// computes r = d − b on its tile plus a one-pixel halo below and to the
// right (g at (i, j) needs r at (i+1, j) and (i, j+1)) into shared memory,
// reading p and b straight from device memory (the halo re-reads hit L1
// and L2), then writes d and g on its tile and one FP64 partial of ‖r‖².
// The last block to finish (an integer ticket, no float atomics) sums the
// partials in block order, so f is the same from run to run.  The ticket
// lives in the call's own scratch, after the partials, and the launcher
// zeroes it on the launch's stream, so launches on any streams never
// share one.  Elementwise
// formulas use the _rn intrinsics, which round like the plain PyTorch
// version's separate operations; any H × W works, ragged edges and H or W
// of 1 included.
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 64;
constexpr int kThreads = 256;

// μ·div p at (i, j) (generators.tv_div_2d: the vertical difference plus
// the horizontal one, terms outside the image being zero)
__device__ __forceinline__ float div_at(const float* __restrict__ pv, const float* __restrict__ ph,
                                        int i, int j, int H, int W, float mu) {
  const size_t o = (size_t)i * W + j;
  const float up = i > 0 ? pv[o - W] : 0.f;
  const float here_v = i < H - 1 ? pv[o] : 0.f;
  const float left = j > 0 ? ph[o - 1] : 0.f;
  const float here_h = j < W - 1 ? ph[o] : 0.f;
  return __fmul_rn(mu, __fadd_rn(__fsub_rn(up, here_v), __fsub_rn(left, here_h)));
}

__global__ void __launch_bounds__(kThreads) tv_gradmap_kernel(
    const float* __restrict__ p, const float* __restrict__ b, int H, int W, float mu,
    float* __restrict__ d, float* __restrict__ g, double* part, unsigned int* ticket,
    float* __restrict__ f) {
  __shared__ float rs[kTileH + 1][kTileW + 1];
  __shared__ double scratch[kThreads / 32];
  __shared__ bool last;
  const float* pv = p;
  const float* ph = p + (size_t)H * W;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;

  double acc = 0.0;
  for (int q = tid; q < (kTileH + 1) * (kTileW + 1); q += kThreads) {
    const int li = q / (kTileW + 1), lj = q % (kTileW + 1);
    const int i = i0 + li, j = j0 + lj;
    if (i < H && j < W) {
      const float dv = div_at(pv, ph, i, j, H, W, mu);
      const float r = __fsub_rn(dv, b[(size_t)i * W + j]);
      rs[li][lj] = r;
      if (li < kTileH && lj < kTileW) {
        d[(size_t)i * W + j] = dv;
        acc += double(r) * double(r);
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < kTileH * kTileW; q += kThreads) {
    const int li = q / kTileW, lj = q % kTileW;
    const int i = i0 + li, j = j0 + lj;
    if (i < H && j < W) {
      const float r = rs[li][lj];
      const size_t o = (size_t)i * W + j;
      g[o] = i < H - 1 ? __fmul_rn(mu, __fsub_rn(rs[li + 1][lj], r)) : 0.f;
      g[(size_t)H * W + o] = j < W - 1 ? __fmul_rn(mu, __fsub_rn(rs[li][lj + 1], r)) : 0.f;
    }
  }

  // one partial per block, then the last block sums them in block order
  acc = fasta::block_sum(acc, scratch);
  const int nblocks = gridDim.x * gridDim.y;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    part[blk] = acc;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned int)(nblocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int k = tid; k < nblocks; k += kThreads) s += __ldcg(part + k);
  s = fasta::block_sum(s, scratch);
  if (tid == 0) *f = float(0.5 * s);
}

int grid_blocks(int H, int W) { return ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH); }

}  // namespace

// The doubles of scratch a launch for H × W needs: one FP64 partial per
// block, then one double that holds the last-block ticket.
extern "C" int fasta_tv_gradmap_work(int H, int W, int* ndoubles) {
  if (H < 1 || W < 1) return cudaErrorInvalidValue;
  *ndoubles = grid_blocks(H, W) + 1;
  return cudaSuccess;
}

// (d, f, g) for p (2, H, W) and b (H, W) on `stream`; work holds
// fasta_tv_gradmap_work(H, W) doubles.
extern "C" int fasta_tv_gradmap(const float* p, const float* b, int H, int W, float mu, float* d,
                                float* f, float* g, double* work, void* stream) {
  if (H < 1 || W < 1) return cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work + grid_blocks(H, W));
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  tv_gradmap_kernel<<<grid, kThreads, 0, s>>>(p, b, H, W, mu, d, g, work, ticket, f);
  return cudaGetLastError();
}
