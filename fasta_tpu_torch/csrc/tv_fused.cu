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
// at 3.35 TB/s).  At that size a call is one launch's latency; at
// 4096×4096 (403 MB) the kernel streams.
//
// Design: one launch a call and nothing else on the stream (no memset).
// The grid is (strips, bands), sized to the card by the wrapper
// (kernels/tv_fused.py, tv_plan): a block owns the rows of one band
// within a strip of 4·blockDim columns, a thread 4 adjacent columns.  The
// block walks its band top to bottom.  A ring of kStages rows of p and b
// (with a one-column halo each side) sits in shared memory, filled by
// cp.async kDepth rows ahead of the row computed, so each value of p and
// b is read from device memory once (and one row above and one below the
// band).  Step k computes r = d − b on row k from the ring (r at (i, j+1)
// comes from the thread beside, through a row of r in shared memory, r at
// (i+1, j) from the step after), and writes d and g of row k − 1: one
// barrier a row.  Rows whose width is a multiple of 4 are copied and
// written as float4; other widths take masked scalars.  f: one FP64
// partial per block; the last block to finish (an integer ticket, no float
// atomics) adds the partials in block order and sets the ticket back to
// zero, so the next launch on the stream, or a CUDA-graph replay, finds it
// zeroed.  The ticket lives in a buffer the wrapper keeps per (device,
// stream): launches on two streams never share one (C-2).  Elementwise
// formulas use the _rn intrinsics, which round like the plain PyTorch
// version's separate operations; any H × W works, ragged edges and H or W
// of 1 included.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kDepth = 3;            // rows in flight ahead of the row computed
constexpr int kStages = kDepth + 2;  // those, the row computed and the row above it
// a row of the ring: slot 3 the column left of the strip, slots 4 … 4+cw−1
// the strip, slot 4+cw the column right of it (and padding to 16 bytes)
constexpr int kPad = 8;

__host__ __device__ constexpr int row_len(int threads) { return 4 * threads + kPad; }
__host__ __device__ constexpr int smem_bytes(int threads) {
  return (3 * kStages + 2) * row_len(threads) * (int)sizeof(float);
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

// Queue the copy of one row of p's vertical channel (and, unless pv_only,
// of its horizontal channel and of b), given by its three row pointers,
// into ring row `st`: the thread's four columns, then the halo columns by
// the block's first and last threads.
template <bool VEC>
__device__ __forceinline__ void load_row(float* st, const float* __restrict__ pv,
                                         const float* __restrict__ ph,
                                         const float* __restrict__ b, int W, int j0, int L,
                                         bool pv_only) {
  const int c = 4 * threadIdx.x, j = j0 + c, cw = L - kPad;
  if (VEC) {
    if (j < W) {
      __pipeline_memcpy_async(st + 4 + c, pv + j, 16);
      if (!pv_only) {
        __pipeline_memcpy_async(st + L + 4 + c, ph + j, 16);
        __pipeline_memcpy_async(st + 2 * L + 4 + c, b + j, 16);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j + e < W) {
        copy4(st + 4 + c + e, pv + j + e);
        if (!pv_only) {
          copy4(st + L + 4 + c + e, ph + j + e);
          copy4(st + 2 * L + 4 + c + e, b + j + e);
        }
      }
    }
  }
  if (threadIdx.x == 0 && j0 > 0 && !pv_only) copy4(st + L + 3, ph + j0 - 1);
  if (threadIdx.x == blockDim.x - 1 && j0 + cw < W) {
    copy4(st + 4 + cw, pv + j0 + cw);
    if (!pv_only) {
      copy4(st + L + 4 + cw, ph + j0 + cw);
      copy4(st + 2 * L + 4 + cw, b + j0 + cw);
    }
  }
}

// The rows the kernel reads: rows 0 … H − 1 of p and b; in the band form
// also row −1 (`above`, p's vertical channel only) and row H (`below_*`).
struct Rows {
  const float* pv;
  const float* ph;
  const float* b;
  const float* above;
  const float* below_pv;
  const float* below_ph;
  const float* b_below;
  int H, W;
  bool top, bottom;  // the band's first (last) row is the image's
};

// queue row k (−1 ≤ k ≤ H) into ring row `st`
template <bool VEC, bool BAND>
__device__ __forceinline__ void load(float* st, const Rows& R, int k, int j0, int L, bool pv_only) {
  if (BAND && k < 0) {
    load_row<VEC>(st, R.above, nullptr, nullptr, R.W, j0, L, true);
  } else if (BAND && k >= R.H) {
    load_row<VEC>(st, R.below_pv, R.below_ph, R.b_below, R.W, j0, L, pv_only);
  } else {
    const size_t o = (size_t)k * R.W;
    load_row<VEC>(st, R.pv + o, R.ph + o, R.b + o, R.W, j0, L, pv_only);
  }
}

// d = μ·div p and r = d − b at (k, j0 + slot − 4) from ring rows `up`
// (row k − 1) and `cur` (row k); terms outside the image are zero
// (generators.tv_div_2d): the row above row 0 unless it is a halo row
// (!top), the vertical dual of the image's last row (bottom)
__device__ __forceinline__ float residual(const float* up, const float* cur, int L, int slot,
                                          int k, int j, int H, int W, float mu, bool top,
                                          bool bottom, float& d) {
  const float u = (k > 0 || !top) ? up[slot] : 0.f;
  const float hv = (k < H - 1 || !bottom) ? cur[slot] : 0.f;
  const float left = j > 0 ? cur[L + slot - 1] : 0.f;
  const float hh = j < W - 1 ? cur[L + slot] : 0.f;
  d = __fmul_rn(mu, __fadd_rn(__fsub_rn(u, hv), __fsub_rn(left, hh)));
  return __fsub_rn(d, cur[2 * L + slot]);
}

// residual at the thread's four columns j … j + 3 (ring slots 4 + c …),
// the ring read as float4 (and the column left of them alone)
__device__ __forceinline__ void residual4(const float* up, const float* cur, int L, int c, int k,
                                          int j, int H, int W, float mu, bool top, bool bottom,
                                          float (&r)[4], float (&d)[4]) {
  const float4 u4 = *reinterpret_cast<const float4*>(up + 4 + c);
  const float4 v4 = *reinterpret_cast<const float4*>(cur + 4 + c);
  const float4 h4 = *reinterpret_cast<const float4*>(cur + L + 4 + c);
  const float4 b4 = *reinterpret_cast<const float4*>(cur + 2 * L + 4 + c);
  const float uu[4] = {u4.x, u4.y, u4.z, u4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
  const float hh[5] = {cur[L + 3 + c], h4.x, h4.y, h4.z, h4.w};
  const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float u = (k > 0 || !top) ? uu[e] : 0.f;
    const float hv = (k < H - 1 || !bottom) ? vv[e] : 0.f;
    const float left = j + e > 0 ? hh[e] : 0.f;
    const float hr = j + e < W - 1 ? hh[e + 1] : 0.f;
    d[e] = __fmul_rn(mu, __fadd_rn(__fsub_rn(u, hv), __fsub_rn(left, hr)));
    r[e] = __fsub_rn(d[e], bb[e]);
  }
}

// Write d and g of row i for the thread's four columns from r and d of row
// i (ri, di), r of row i + 1 (rb, unread on the image's last row) and
// `rrow`, row i's r in shared memory (for the column right of the
// thread's); add r² to acc.
template <bool VEC>
__device__ __forceinline__ void emit(int i, const float (&ri)[4], const float (&di)[4],
                                     const float (&rb)[4], const float* rrow, int H, int W,
                                     bool bottom, int j0, float mu, float* __restrict__ d,
                                     float* __restrict__ g, double& acc) {
  const int c = 4 * threadIdx.x, j = j0 + c;
  if (j >= W) return;
  float g0[4], g1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float right = e < 3 ? ri[e + 1] : rrow[4 + c + 4];
    g0[e] = (i < H - 1 || !bottom) ? __fmul_rn(mu, __fsub_rn(rb[e], ri[e])) : 0.f;
    g1[e] = j + e < W - 1 ? __fmul_rn(mu, __fsub_rn(right, ri[e])) : 0.f;
    if (j + e < W) acc += double(ri[e]) * double(ri[e]);
  }
  const size_t o = (size_t)i * W + j, plane = (size_t)H * W;
  if (VEC) {
    *reinterpret_cast<float4*>(d + o) = make_float4(di[0], di[1], di[2], di[3]);
    *reinterpret_cast<float4*>(g + o) = make_float4(g0[0], g0[1], g0[2], g0[3]);
    *reinterpret_cast<float4*>(g + plane + o) = make_float4(g1[0], g1[1], g1[2], g1[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j + e < W) {
        d[o + e] = di[e];
        g[o + e] = g0[e];
        g[plane + o + e] = g1[e];
      }
    }
  }
}

// work: the ticket in work[0] (an unsigned int, zero between launches),
// then one FP64 partial per block from work + 1 (unused by a one-block
// grid).  BAND: the band form (R's halo rows and flags read); else the
// whole image (top and bottom set, no halo rows).
template <bool VEC, bool BAND>
__global__ void __launch_bounds__(kMaxThreads) tv_gradmap_kernel(
    Rows R, float mu, float* __restrict__ d, float* __restrict__ g, double* work,
    float* __restrict__ f) {
  extern __shared__ __align__(16) float sm[];
  __shared__ double scratch[kMaxThreads / 32];
  __shared__ bool last;
  const int t = threadIdx.x, L = row_len(blockDim.x), cw = L - kPad;
  const int H = R.H, W = R.W;
  const bool top = BAND ? R.top : true, bottom = BAND ? R.bottom : true;
  const int j0 = blockIdx.x * cw;
  const int nb = gridDim.y, band = blockIdx.y;
  const int r0 = (int)((long long)band * H / nb), r1 = (int)((long long)(band + 1) * H / nb);
  // the last row whose r the block needs: the row below its rows, which
  // past the last row is the halo row unless that row is the image's
  const int kend = r1 < H ? r1 : (bottom ? H - 1 : H);
  auto ring = [&](int k) { return sm + ((k + kStages) % kStages) * 3 * L; };
  auto rrow = [&](int k) { return sm + 3 * kStages * L + (k & 1) * L; };

  // rows r0 − 1 (p's vertical channel only) and r0 in one group, then one
  // group a row up to r0 + kDepth − 1
  if (r0 > 0 || !top) load<VEC, BAND>(ring(r0 - 1), R, r0 - 1, j0, L, true);
  for (int q = 0; q < kDepth; ++q) {
    if (r0 + q <= kend) load<VEC, BAND>(ring(r0 + q), R, r0 + q, j0, L, false);
    __pipeline_commit();
  }

  float rp[4], dp[4], rc[4], dc[4];
  double acc = 0.0;
  for (int k = r0; k <= kend; ++k) {
    __pipeline_wait_prior(kDepth - 1);  // row k has landed
    __syncthreads();                    // … for every thread; step k − 1 is done
    if (k + kDepth <= kend) load<VEC, BAND>(ring(k + kDepth), R, k + kDepth, j0, L, false);
    __pipeline_commit();
    const float* up = ring(k - 1);
    const float* cur = ring(k);
    residual4(up, cur, L, 4 * t, k, j0 + 4 * t, H, W, mu, top, bottom, rc, dc);
    float* rr = rrow(k);
    *reinterpret_cast<float4*>(rr + 4 + 4 * t) = make_float4(rc[0], rc[1], rc[2], rc[3]);
    if (t == blockDim.x - 1 && j0 + cw < W) {
      float dh;
      rr[4 + cw] = residual(up, cur, L, 4 + cw, k, j0 + cw, H, W, mu, top, bottom, dh);
    }
    if (k > r0) emit<VEC>(k - 1, rp, dp, rc, rrow(k - 1), H, W, bottom, j0, mu, d, g, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rp[e] = rc[e];
      dp[e] = dc[e];
    }
  }
  if (r1 == H && bottom) {  // the image's last row: no row below it
    __syncthreads();
    emit<VEC>(H - 1, rp, dp, rc, rrow(H - 1), H, W, bottom, j0, mu, d, g, acc);
  }

  // one partial per block, then the last block sums them in block order
  acc = fasta::block_sum(acc, scratch);
  const int nblocks = gridDim.x * gridDim.y;
  if (nblocks == 1) {
    if (t == 0) *f = float(0.5 * acc);
    return;
  }
  double* part = work + 1;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work);
  if (t == 0) {
    part[blockIdx.y * gridDim.x + blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned int)(nblocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int k = t; k < nblocks; k += blockDim.x) s += __ldcg(part + k);
  s = fasta::block_sum(s, scratch);
  if (t == 0) {
    *f = float(0.5 * s);
    *ticket = 0u;  // every block has taken its ticket
  }
}

// the kernels that need more than 48 KB of shared memory, opted in once
// per device
template <bool VEC, bool BAND>
cudaError_t allow_smem() {
  static unsigned long long done = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(tv_gradmap_kernel<VEC, BAND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(kMaxThreads));
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

bool aligned16(const void* q) { return (reinterpret_cast<size_t>(q) & 15) == 0; }

template <bool BAND>
int launch(const Rows& R, float mu, int threads, int nbands, float* d, float* f, float* g,
           double* work, void* stream) {
  const int H = R.H, W = R.W;
  if (H < 1 || W < 1 || nbands < 1 || nbands > H || nbands > 65535 ||
      (threads != 32 && threads != 64 && threads != 128 && threads != 256))
    return cudaErrorInvalidValue;
  const long long strips = ((long long)W + 4 * threads - 1) / (4 * threads);
  if (strips > 0x7fffffff || (strips * nbands > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool vec = aligned16(R.pv) && aligned16(R.b) && aligned16(d) && aligned16(g) && (W & 3) == 0;
  if (BAND) {
    if (!R.top) vec = vec && aligned16(R.above);
    if (!R.bottom) vec = vec && aligned16(R.below_pv) && aligned16(R.below_ph) &&
                         aligned16(R.b_below);
  }
  const dim3 grid((unsigned)strips, nbands);
  const int smem = smem_bytes(threads);
  cudaError_t err = vec ? allow_smem<true, BAND>() : allow_smem<false, BAND>();
  if (err != cudaSuccess) return err;
  if (vec)
    tv_gradmap_kernel<true, BAND><<<grid, threads, smem, s>>>(R, mu, d, g, work, f);
  else
    tv_gradmap_kernel<false, BAND><<<grid, threads, smem, s>>>(R, mu, d, g, work, f);
  return cudaGetLastError();
}

}  // namespace

// (d, f, g) for p (2, H, W) and b (H, W) on `stream`, over a grid of
// ⌈W / (4·threads)⌉ strips × nbands bands (threads 32, 64, 128 or 256;
// 1 ≤ nbands ≤ min(H, 65535)); work: the stream's buffer, a zero ticket
// then one double a block (unused, and may be null, for a one-block grid).
extern "C" int fasta_tv_gradmap(const float* p, const float* b, int H, int W, float mu,
                                int threads, int nbands, float* d, float* f, float* g,
                                double* work, void* stream) {
  const Rows R{p, p + (size_t)H * W, b, nullptr, nullptr, nullptr, nullptr, H, W, true, true};
  return launch<false>(R, mu, threads, nbands, d, f, g, work, stream);
}

// The band form: (d, f, g) over a band p (2, Hb, W), b (Hb, W) of a taller
// image.  above (W,): the row of p's vertical channel above the band,
// read unless top; below (2, W): the vertical and horizontal channels of
// the row below it, and b_below (W,) its image row, read unless bottom;
// the caller zeroes below's vertical row when that row is the image's
// last.  f: ½ Σ r² over the band's own rows.  With top and bottom set this
// is fasta_tv_gradmap's launch (halo pointers unread, may be null).
extern "C" int fasta_tv_gradmap_band(const float* p, const float* b, int Hb, int W, float mu,
                                     const float* above, const float* below,
                                     const float* b_below, int top, int bottom, int threads,
                                     int nbands, float* d, float* f, float* g, double* work,
                                     void* stream) {
  if ((!top && above == nullptr) || (!bottom && (below == nullptr || b_below == nullptr)))
    return cudaErrorInvalidValue;
  if (top && bottom) return fasta_tv_gradmap(p, b, Hb, W, mu, threads, nbands, d, f, g, work, stream);
  const Rows R{p, p + (size_t)Hb * W, b, above, below, below == nullptr ? nullptr : below + W,
               b_below, Hb, W, top != 0, bottom != 0};
  return launch<true>(R, mu, threads, nbands, d, f, g, work, stream);
}
