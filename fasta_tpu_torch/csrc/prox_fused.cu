// K-B4: the fused shrink step of an L1 line-search trial, over R rows,
//     x̂₁ = x₀ − τ g,   x₁ = shrink(x̂₁, τμ),   Δx = x₁ − x₀,
// and per row ‖Δx‖², ⟨Δx, g⟩, ‖x₁ − x̂₁‖²  (float64),
// x₀, g and x₁ float32 (R, n); τ and μ per row or shared, each passed by
// value or read on the card (float32 or float64, rounded to float32 as
// the plain version rounds them), so that a caller holding τ on the card
// needs no host sync and no conversion.
//
// Replaces: fasta_tpu/kernels/prox_fused.py, fused_shrink_step
// (pallas_call at :101) — the TPU kernel that walks the vector as a
// sequential grid of lane tiles and carries the three sums in SMEM from
// tile to tile.
//
// Bound on this card: bytes.  The step reads x₀ and g once and writes x₁
// once, 12·R·n bytes (at R·n = 2²⁴, 0.2 GB: 60 µs at 3.35 TB/s); its 20
// operations per entry are far below the float32 rate.  At the loop's
// sizes (R·n of a few thousand) a call is one launch's latency.
//
// Design: one launch a call and nothing else on the stream — no memset,
// and no scratch at all where a row fits one block.  Two routes, chosen
// by the wrapper (kernels/prox_fused.py, shrink_plan):
//  * row: one block of kRowThreads per row (the loop's case), a vector a
//    thread at the loop's sizes.  The block finishes its row's three sums
//    itself in one exchange: every warp shuffles its three doubles, then
//    one shared-memory round, thread k adding the warp sums of value k in
//    warp order.  No global partials.  (Spreading a row over a thread-
//    block cluster, its sums added through distributed shared memory, was
//    measured and is slower at the loop's sizes: PERF.md, K-B4.)
//  * stream: a grid sized to the card (kStreamBlocksPerSm resident blocks
//    an SM, one wave), blocks_per_row blocks per row, each walking its
//    share of the row grid-strided, four vectors in flight a thread, with
//    streaming (evict-first) loads and stores.  Each block writes three
//    FP64 partials; the last block to finish (an integer ticket) adds
//    every row's partials in block order and sets the ticket back to
//    zero, so the next launch on the stream — or a CUDA-graph replay —
//    finds it zeroed.  The partials and the ticket live in a buffer the
//    wrapper keeps per (device, stream), so launches on two streams never
//    share a ticket (C-2).
//  Rows whose length is a multiple of 4 (or a single row) are read and
//  written as float4, the ragged tail masked; other rows take masked
//  scalars.  Each product of two float32 values is exact in float64 and
//  every sum runs in a fixed order: no float atomics, so every run gives
//  the same sums.  Elementwise formulas use the _rn intrinsics, which the
//  compiler never contracts into FMAs, so x₁ rounds exactly like the
//  plain PyTorch version's separate multiply and subtract; the shrink
//  keeps NaN (nanmax), so the caller's nonfinite guard still fires.
#include <cuda_runtime.h>

#include "prox.cuh"
#include "reduce.cuh"

namespace {

constexpr int kRowThreads = 512;
constexpr int kStreamThreads = 256;
constexpr int kStreamBlocksPerSm = 3;
constexpr int kUnroll = 4;  // vectors (or scalars) in flight a thread

// how τ or μ reaches the kernel: bit 0 read from a pointer (else the
// value), bit 1 the pointer holds doubles, bit 2 one value per row
constexpr int kFromPtr = 1, kDouble = 2, kPerRow = 4;

__device__ __forceinline__ float param(const void* p, float v, int mode, int row) {
  if (!(mode & kFromPtr)) return v;
  const int i = (mode & kPerRow) ? row : 0;
  return (mode & kDouble) ? __double2float_rn(__ldg(static_cast<const double*>(p) + i))
                          : __ldg(static_cast<const float*>(p) + i);
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
  __device__ __forceinline__ float4 operator()(float4 a, float4 b) {
    float4 o;
    o.x = (*this)(a.x, b.x);
    o.y = (*this)(a.y, b.y);
    o.z = (*this)(a.z, b.z);
    o.w = (*this)(a.w, b.w);
    return o;
  }
};

// loads and stores: through the caches, or streaming (evict-first, for
// data read and written once)
template <bool CS, typename T>
__device__ __forceinline__ T ld(const T* p) {
  return CS ? __ldcs(p) : __ldg(p);
}
template <bool CS, typename T>
__device__ __forceinline__ void st(T* p, T v) {
  if (CS)
    __stcs(p, v);
  else
    *p = v;
}

// One row's share for thread position `first` of `stride`: items (float4
// or float) first, first + stride, …, kUnroll of them loaded before any
// is used; then, for VEC, the scalar tail past the last whole vector.
template <bool VEC, bool CS>
__device__ __forceinline__ void walk(const float* __restrict__ xr, const float* __restrict__ gr,
                                     float* __restrict__ yr, int n, int first, int stride,
                                     Step& step) {
  if (VEC) {
    const int nq = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int base = first; base < nq; base += kUnroll * stride) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = base + k * stride;
        if (q < nq) {
          a[k] = ld<CS>(x4 + q);
          b[k] = ld<CS>(g4 + q);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = base + k * stride;
        if (q < nq) st<CS>(y4 + q, step(a[k], b[k]));
      }
    }
    for (int j = (nq << 2) + first; j < n; j += stride)
      st<CS>(yr + j, step(ld<CS>(xr + j), ld<CS>(gr + j)));
    return;
  }
  for (int base = first; base < n; base += kUnroll * stride) {
    float a[kUnroll], b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = base + k * stride;
      if (j < n) {
        a[k] = ld<CS>(xr + j);
        b[k] = ld<CS>(gr + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = base + k * stride;
      if (j < n) st<CS>(yr + j, step(a[k], b[k]));
    }
  }
}

// The block's three sums in one exchange: each warp shuffles its three
// doubles, lane 0 stores them, one barrier, then thread k < 3 adds the
// warp sums of value k in warp order and returns them (others 0).
template <int WARPS>
__device__ __forceinline__ double block_sum3(const Step& s, double (*ws)[WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double a = fasta::warp_sum(s.dx2), b = fasta::warp_sum(s.rdg),
               c = fasta::warp_sum(s.gm2);
  if (lane == 0) {
    ws[0][warp] = a;
    ws[1][warp] = b;
    ws[2][warp] = c;
  }
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x < 3) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += ws[threadIdx.x][w];
  }
  return t;
}

struct Args {
  const float* x0;
  const float* g;
  const void* tau;
  const void* mu;
  float tau_v, mu_v;
  int modes;  // τ's mode in bits 0-3, μ's in bits 4-7
  int R, n;
  float* x1;
  double* sums;  // (3, R): sums[k·R + row]
};

__device__ __forceinline__ Step row_step(const Args& a, int row) {
  Step s;
  s.tau = param(a.tau, a.tau_v, a.modes & 15, row);
  s.thr = __fmul_rn(s.tau, param(a.mu, a.mu_v, a.modes >> 4, row));
  return s;
}

template <bool VEC>
__global__ void __launch_bounds__(kRowThreads) shrink_row_kernel(const Args a) {
  __shared__ double ws[3][kRowThreads / 32];
  const int row = blockIdx.x;
  Step s = row_step(a, row);
  const size_t off = (size_t)row * a.n;
  walk<VEC, false>(a.x0 + off, a.g + off, a.x1 + off, a.n, threadIdx.x, kRowThreads, s);
  const double t = block_sum3<kRowThreads / 32>(s, ws);
  if (threadIdx.x < 3) a.sums[threadIdx.x * a.R + row] = t;
}

// work: the ticket in work[0] (an unsigned int, zero between launches),
// then 3 FP64 partials per block from work + 1
template <bool VEC>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksPerSm)
    shrink_stream_kernel(const Args a, double* work) {
  __shared__ double ws[3][kStreamThreads / 32];
  __shared__ bool last;
  const int row = blockIdx.y, bx = blockIdx.x, gx = gridDim.x, tid = threadIdx.x;
  Step s = row_step(a, row);
  const size_t off = (size_t)row * a.n;
  walk<VEC, true>(a.x0 + off, a.g + off, a.x1 + off, a.n, bx * kStreamThreads + tid,
                  gx * kStreamThreads, s);
  const double t = block_sum3<kStreamThreads / 32>(s, ws);
  double* part = work + 1;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work);
  if (tid < 3) {
    part[((size_t)row * gx + bx) * 3 + tid] = t;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned int)(gx * gridDim.y - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a warp per (row, sum); each lane's partials loaded kUnroll·2 at a time
  // before any is added, then added in block order
  constexpr int kBatch = 2 * kUnroll;
  const int lane = tid & 31, warp = tid >> 5;
  for (int it = warp; it < 3 * a.R; it += kStreamThreads / 32) {
    const int r = it / 3, k = it - 3 * r;
    const double* pr = part + (size_t)r * gx * 3 + k;
    double v = 0.0;
    for (int b0 = lane; b0 < gx; b0 += 32 * kBatch) {
      double q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = b0 + 32 * u;
        q[u] = b < gx ? __ldcg(pr + (size_t)b * 3) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v += q[u];
    }
    v = fasta::warp_sum(v);
    if (lane == 0) a.sums[k * a.R + r] = v;
  }
  if (tid == 0) *ticket = 0u;  // every block has taken its ticket
}

}  // namespace

// x1 (R, n) and sums (3, R) = (‖Δx‖², ⟨Δx,g⟩, ‖x₁−x̂₁‖²) per row for x0
// and g (R, n) on `stream`.  τ and μ: each a pointer and a value with its
// mode (see kFromPtr, kDouble, kPerRow; τ's in bits 0-3 of `modes`, μ's
// in bits 4-7).  blocks_per_row 0: the row route, no work buffer; else
// the stream route over a (blocks_per_row, R) grid, with `work` the
// stream's buffer: a zero ticket, then 3·R·blocks_per_row doubles.
extern "C" int fasta_shrink_step(const float* x0, const float* g, const void* tau, float tau_v,
                                 const void* mu, float mu_v, int modes, int R, int n,
                                 int blocks_per_row, float* x1, double* sums, double* work,
                                 void* stream) {
  if (R < 1 || n < 1 || R > 65535 || blocks_per_row < 0 ||
      (blocks_per_row > 0 && work == nullptr) || ((modes & kFromPtr) && tau == nullptr) ||
      (((modes >> 4) & kFromPtr) && mu == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x0, g, tau, mu, tau_v, mu_v, modes, R, n, x1, sums};
  const bool vec = ((reinterpret_cast<size_t>(x0) | reinterpret_cast<size_t>(g) |
                     reinterpret_cast<size_t>(x1)) & 15) == 0 &&
                   (R == 1 || (n & 3) == 0);
  if (blocks_per_row == 0) {
    if (vec)
      shrink_row_kernel<true><<<R, kRowThreads, 0, s>>>(a);
    else
      shrink_row_kernel<false><<<R, kRowThreads, 0, s>>>(a);
  } else {
    const dim3 grid(blocks_per_row, R);
    if (vec)
      shrink_stream_kernel<true><<<grid, kStreamThreads, 0, s>>>(a, work);
    else
      shrink_stream_kernel<false><<<grid, kStreamThreads, 0, s>>>(a, work);
  }
  return cudaGetLastError();
}
