// K-B7: the fused planar-complex gradient map in one read of (Ar, Ai),
//     d = [Ar xr − Ai xi,  Ar xi + Ai xr]          (m, 2)
//     f = Σᵢ ℓ(dᵢ)                                  (scalar)
//     g = [Arᵀℓr + Aiᵀℓi,  Arᵀℓi − Aiᵀℓr]          (n, 2)
// for the planar least-squares loss ℓ = ½|d − b|², b (m, 2), and the
// PhaseMax hinge ℓ = ½ max(|d| − b, 0)², b (m,) magnitudes, whose
// gradient weight is (ℓr, ℓi) = max(|d| − b, 0)/max(|d|, 1e-30) · d.
//
// Replaces: fasta_tpu/kernels/planar_fused.py, _fused_planar (pallas_call
// at :197) behind fused_planar_lstsq_gradmap and fused_planar_hinge_gradmap
// — the TPU kernel that walks row tiles of both channel matrices in a
// sequential grid and carries g in VMEM scratch from step to step.
//
// Bound on this card: device-memory bytes.  The two-pass form reads both
// channel matrices twice (A x, then Aᴴℓ); this kernel reads them once:
// 2·m·n·4 bytes, 33.6 MB at 16384×256 (10.0 µs at 3.35 TB/s, less when
// the matrices sit in the 50 MB L2), against 16·m·n operations (1.0 µs at
// 67 TFLOP/s).
//
// Design:
//  * Rows are owned by groups of threads: a warp per row for n ≤ 512
//    (route 1; no block barrier in the row loop), the whole block per row
//    for n ≤ 8192 (route 2).  A thread owns CPT fixed groups of VEC
//    columns; its slice of x and its share of the gradient stay in
//    registers for the whole call, and the row's values it loads serve
//    both the row dots and the gradient: each matrix is read once.
//  * A group sums its row dots by a shuffle butterfly (and, on route 2,
//    across warps through shared memory in warp order), so every thread
//    of the group holds the same d and applies the loss itself.
//  * Per-block partials — g as a (2n,) row of a (nblocks, 2n) scratch, f
//    as an FP64 partial — and a second kernel that sums them in block
//    order: no float atomics, the same result on every run.  On route 1
//    the block's warps add their gradient shares into shared memory one
//    warp after another, in warp order.
//  * Route 3, rows wider than 8192 floats (2048 when n % 4 ≠ 0): a block
//    per tile of up to 8 rows, x read through the read-only cache, the
//    gradient share kept in the block's scratch row; the gradient pass
//    reads the tile a second time (from L1 or L2), as K-B3's wide kernel.
//  * Ragged m and n (n % 4 ≠ 0: 4-byte loads) are masked in the kernel;
//    nothing is padded or copied.  Elementwise formulas use the _rn
//    intrinsics, so they round like the plain version's separate steps.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "losses.cuh"
#include "planar_rows.cuh"
#include "reduce.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWideTile = 8;

// losses, in the order of kernels.planar_fused.LOSSES
enum PlanarLoss { kPlanarLstsq = 0, kPlanarHinge = 1 };

template <int VEC>
struct Cols;
template <>
struct Cols<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float& at(T& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ float get(const T& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};
template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float& at(T& v, int) { return v; }
  static __device__ __forceinline__ float get(const T& v, int) { return v; }
};

// The loss at row value (dr, di): gradient weight (lr, li) and f term e
// (summed as given; the finished sum is halved).
__device__ __forceinline__ void planar_loss(int loss, float dr, float di, const float* b, int i,
                                            float& lr, float& li, float& e) {
  if (loss == kPlanarHinge) {
    float r;
    fasta::phase_hinge(dr, di, __ldg(b + i), lr, li, r);
    e = __fmul_rn(r, r);
  } else {
    lr = __fsub_rn(dr, __ldg(b + 2 * i));
    li = __fsub_rn(di, __ldg(b + 2 * i + 1));
    e = __fadd_rn(__fmul_rn(lr, lr), __fmul_rn(li, li));
  }
}

// Routes 1 (GROUP = 32) and 2 (GROUP = kThreads).  A thread owns the
// column groups q = lane + s·GROUP, s < CPT, of VEC columns each.
template <int VEC, int CPT, int GROUP>
__global__ void __launch_bounds__(kThreads) planar_rows(
    const float* __restrict__ Ar, const float* __restrict__ Ai, const float* __restrict__ x,
    const float* __restrict__ b, int m, int n, int loss, float* __restrict__ d,
    float* __restrict__ gpart, double* __restrict__ fpart) {
  using C = Cols<VEC>;
  using T = typename C::T;
  constexpr int kGroups = kThreads / GROUP;
  __shared__ float red[kWarps][2];
  __shared__ double fw[kWarps];
  extern __shared__ __align__(16) float gsum[];  // route 1: (2n,) block gradient

  const int tid = threadIdx.x, lane = tid % GROUP, grp = tid / GROUP;
  const int warp = tid >> 5;
  const int ng = n / VEC;
  T xr[CPT], xi[CPT], gr[CPT], gi[CPT];
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int q = lane + s * GROUP;
    gr[s] = gi[s] = C::zero();
    xr[s] = xi[s] = C::zero();
    if (q < ng)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        C::at(xr[s], k) = __ldg(x + 2 * (q * VEC + k));
        C::at(xi[s], k) = __ldg(x + 2 * (q * VEC + k) + 1);
      }
  }

  double facc = 0.0;  // this group's f terms, in row order
  const int stride = gridDim.x * kGroups;
  // on route 2 i depends on the block alone, so the barriers are uniform
  for (int i = blockIdx.x * kGroups + grp; i < m; i += stride) {
    const T* ar = reinterpret_cast<const T*>(Ar + (size_t)i * n);
    const T* ai = reinterpret_cast<const T*>(Ai + (size_t)i * n);
    T va[CPT], vb[CPT];
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int q = lane + s * GROUP;
      va[s] = q < ng ? __ldg(ar + q) : C::zero();
      vb[s] = q < ng ? __ldg(ai + q) : C::zero();
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float a = C::at(va[s], k), c = C::at(vb[s], k);
        sr = fmaf(a, C::at(xr[s], k), fmaf(-c, C::at(xi[s], k), sr));
        si = fmaf(a, C::at(xi[s], k), fmaf(c, C::at(xr[s], k), si));
      }
    }
    sr = fasta::warp_allsum(sr);
    si = fasta::warp_allsum(si);
    if (GROUP == kThreads) {
      // across warps, in warp order; every thread reads the same totals
      if ((tid & 31) == 0) {
        red[warp][0] = sr;
        red[warp][1] = si;
      }
      __syncthreads();
      sr = si = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sr += red[w][0];
        si += red[w][1];
      }
      __syncthreads();
    }
    float lr, li, e;
    planar_loss(loss, sr, si, b, i, lr, li, e);
    if (lane == 0) {
      d[2 * i] = sr;
      d[2 * i + 1] = si;
      facc += double(e);
    }
#pragma unroll
    for (int s = 0; s < CPT; ++s)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float a = C::at(va[s], k), c = C::at(vb[s], k);
        C::at(gr[s], k) = fmaf(a, lr, fmaf(c, li, C::at(gr[s], k)));
        C::at(gi[s], k) = fmaf(a, li, fmaf(-c, lr, C::at(gi[s], k)));
      }
  }

  float* out = gpart + (size_t)blockIdx.x * 2 * n;
  if (GROUP == kThreads) {
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int q = lane + s * GROUP;
      if (q < ng)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          out[q * VEC + k] = C::at(gr[s], k);
          out[n + q * VEC + k] = C::at(gi[s], k);
        }
    }
    if (tid == 0) fpart[blockIdx.x] = facc;
    return;
  }
  // route 1: the warps add their shares into gsum in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w)
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int q = lane + s * GROUP;
        if (q < ng)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const int j = q * VEC + k;
            gsum[j] = w == 0 ? C::at(gr[s], k) : gsum[j] + C::at(gr[s], k);
            gsum[n + j] = w == 0 ? C::at(gi[s], k) : gsum[n + j] + C::at(gi[s], k);
          }
      }
    __syncthreads();
  }
  for (int j = tid; j < 2 * n; j += kThreads) out[j] = gsum[j];
  if ((tid & 31) == 0) fw[warp] = facc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += fw[w];
    fpart[blockIdx.x] = s;
  }
}

// Route 3: a block per tile of up to kWideTile rows; the gradient pass
// reads the tile again and keeps the block's share in its scratch row.
template <int VEC>
__global__ void __launch_bounds__(kThreads) planar_rows_wide(
    const float* __restrict__ Ar, const float* __restrict__ Ai, const float* __restrict__ x,
    const float* __restrict__ b, int m, int n, int loss, float* __restrict__ d,
    float* __restrict__ gpart, double* __restrict__ fpart) {
  using C = Cols<VEC>;
  using T = typename C::T;
  __shared__ float red[kWarps][2 * kWideTile];
  __shared__ float lw[kWideTile][2];
  __shared__ double es[kWideTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = n / VEC;
  float* gp = gpart + (size_t)blockIdx.x * 2 * n;
  const int ntiles = (m + kWideTile - 1) / kWideTile;
  double facc = 0.0;
  bool first = true;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = t * kWideTile, rows = min(kWideTile, m - r0);
    float sr[kWideTile], si[kWideTile];
#pragma unroll
    for (int r = 0; r < kWideTile; ++r) sr[r] = si[r] = 0.f;
    for (int q = tid; q < ng; q += kThreads) {
      T x_r, x_i;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        C::at(x_r, k) = __ldg(x + 2 * (q * VEC + k));
        C::at(x_i, k) = __ldg(x + 2 * (q * VEC + k) + 1);
      }
#pragma unroll
      for (int r = 0; r < kWideTile; ++r) {
        if (r < rows) {
          const T a = __ldg(reinterpret_cast<const T*>(Ar + (size_t)(r0 + r) * n) + q);
          const T c = __ldg(reinterpret_cast<const T*>(Ai + (size_t)(r0 + r) * n) + q);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float av = C::get(a, k), cv = C::get(c, k);
            sr[r] = fmaf(av, C::at(x_r, k), fmaf(-cv, C::at(x_i, k), sr[r]));
            si[r] = fmaf(av, C::at(x_i, k), fmaf(cv, C::at(x_r, k), si[r]));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kWideTile; ++r) {
      const float a = fasta::warp_allsum(sr[r]), c = fasta::warp_allsum(si[r]);
      if (lane == 0) {
        red[warp][2 * r] = a;
        red[warp][2 * r + 1] = c;
      }
    }
    __syncthreads();
    if (tid < rows) {
      float a = 0.f, c = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        a += red[w][2 * tid];
        c += red[w][2 * tid + 1];
      }
      float lr, li, e;
      planar_loss(loss, a, c, b, r0 + tid, lr, li, e);
      d[2 * (r0 + tid)] = a;
      d[2 * (r0 + tid) + 1] = c;
      lw[tid][0] = lr;
      lw[tid][1] = li;
      es[tid] = double(e);
    }
    __syncthreads();
    if (tid == 0)
      for (int r = 0; r < rows; ++r) facc += es[r];
    for (int j = tid; j < n; j += kThreads) {
      float g_r = first ? 0.f : gp[j], g_i = first ? 0.f : gp[n + j];
      for (int r = 0; r < rows; ++r) {
        const float a = __ldg(Ar + (size_t)(r0 + r) * n + j);
        const float c = __ldg(Ai + (size_t)(r0 + r) * n + j);
        g_r = fmaf(a, lw[r][0], fmaf(c, lw[r][1], g_r));
        g_i = fmaf(a, lw[r][1], fmaf(-c, lw[r][0], g_i));
      }
      gp[j] = g_r;
      gp[n + j] = g_i;
    }
    first = false;
    __syncthreads();  // red, lw and es are rewritten by the next tile
  }
  if (tid == 0) fpart[blockIdx.x] = facc;
}

// Pass 2: g (n, 2) from the (nparts, 2n) partials and f = ½ Σ fpart, in a
// fixed order: thread row y sums parts y, y + kChains, ... of its column,
// then the kChains sums are added in y order; f by one thread in part
// order.  Independent chains keep several loads in flight per column.
constexpr int kChains = 16;
constexpr int kReduceCols = 32;

__global__ void __launch_bounds__(kReduceCols * kChains) planar_reduce(
    const float* __restrict__ gpart, const double* __restrict__ fpart, int nparts, int n,
    float* __restrict__ g, float* __restrict__ f) {
  __shared__ float part[kChains][kReduceCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kReduceCols + tx;
  float s = 0.f;
  if (j < 2 * n) {
#pragma unroll 4
    for (int p = ty; p < nparts; p += kChains) s += __ldg(gpart + (size_t)p * 2 * n + j);
  }
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < 2 * n) {
    float t = 0.f;
    for (int y = 0; y < kChains; ++y) t += part[y][tx];
    // column j < n is the real channel of g's row j, j ≥ n the imaginary
    g[j < n ? 2 * j : 2 * (j - n) + 1] = t;
  }
  if (blockIdx.x == 0 && tx == 0 && ty == 1) {
    double t = 0.0;
    for (int p = 0; p < nparts; ++p) t += fpart[p];
    *f = float(0.5 * t);
  }
}

using RowsKernel = void (*)(const float*, const float*, const float*, const float*, int, int,
                           int, float*, float*, double*);

// the kernel of a route and its column slots per thread (route 3: cpt 0)
RowsKernel pick(int route, int vec, int cpt) {
  if (route == 1) {
    if (vec == 4) {
      if (cpt == 1) return planar_rows<4, 1, 32>;
      if (cpt == 2) return planar_rows<4, 2, 32>;
      if (cpt == 4) return planar_rows<4, 4, 32>;
    } else {
      if (cpt == 1) return planar_rows<1, 1, 32>;
      if (cpt == 2) return planar_rows<1, 2, 32>;
      if (cpt == 4) return planar_rows<1, 4, 32>;
      if (cpt == 8) return planar_rows<1, 8, 32>;
      if (cpt == 16) return planar_rows<1, 16, 32>;
    }
  } else if (route == 2) {
    if (vec == 4) {
      if (cpt == 1) return planar_rows<4, 1, kThreads>;
      if (cpt == 2) return planar_rows<4, 2, kThreads>;
      if (cpt == 4) return planar_rows<4, 4, kThreads>;
    } else {
      if (cpt == 2) return planar_rows<1, 2, kThreads>;
      if (cpt == 4) return planar_rows<1, 4, kThreads>;
    }
  } else if (route == 3) {
    return vec == 4 ? planar_rows_wide<4> : planar_rows_wide<1>;
  }
  return nullptr;
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

// Plan an m×n call on the current device: the route (1 warp rows, 2 block
// rows, 3 wide), the column slots per thread, the blocks (also the row
// count of the gradient scratch) and the dynamic shared bytes.
extern "C" int fasta_planar_gradmap_plan(int m, int n, int* route, int* cpt, int* nblocks,
                                         int* smem_bytes) {
  if (m < 1 || n < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int vec = n % 4 == 0 ? 4 : 1, ng = n / vec;
  int r, c;
  if (ng <= 32 * (vec == 4 ? 4 : 16)) {
    r = 1;
    c = pow2_at_least((ng + 31) / 32);
  } else if (ng <= kThreads * 4) {
    r = 2;
    c = pow2_at_least((ng + kThreads - 1) / kThreads);
    if (vec == 1 && c < 2) c = 2;
  } else {
    r = 3;
    c = 0;
  }
  const RowsKernel fn = pick(r, vec, c);
  if (fn == nullptr) return cudaErrorInvalidConfiguration;
  const int smem = r == 1 ? 2 * n * (int)sizeof(float) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // enough blocks to fill the card, no more than the rows give work to
  const int rows_per_block = r == 1 ? kWarps : r == 2 ? 1 : kWideTile;
  const int need = (m + rows_per_block - 1) / rows_per_block;
  const int fill = (r == 3 ? 1 : per_sm) * sms;
  *route = r;
  *cpt = c;
  *nblocks = need < fill ? need : fill;
  *smem_bytes = smem;
  return cudaSuccess;
}

// Launch both passes on `stream`.  b is (m, 2) for the least-squares loss
// and (m,) for the hinge; gpart holds nblocks·2n floats, fpart nblocks
// doubles.
extern "C" int fasta_planar_gradmap(const float* Ar, const float* Ai, const float* x,
                                    const float* b, int m, int n, int loss, int route, int cpt,
                                    int nblocks, int smem_bytes, float* d, float* f, float* g,
                                    float* gpart, double* fpart, void* stream) {
  if (m < 1 || n < 1 || nblocks < 1 || loss < kPlanarLstsq || loss > kPlanarHinge)
    return cudaErrorInvalidValue;
  const RowsKernel fn = pick(route, n % 4 == 0 ? 4 : 1, cpt);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<nblocks, kThreads, smem_bytes, s>>>(Ar, Ai, x, b, m, n, loss, d, gpart, fpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  planar_reduce<<<(2 * n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kChains), 0, s>>>(
      gpart, fpart, nblocks, n, g, f);
  return cudaGetLastError();
}
