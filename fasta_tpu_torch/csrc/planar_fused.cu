// K-B7: the fused planar-complex gradient map in one read of (Ar, Ai),
//     d = [Ar xr − Ai xi,  Ar xi + Ai xr]          (m, 2)
//     f = ½ Σᵢ ℓ(dᵢ)                                (scalar)
//     g = [Arᵀℓr + Aiᵀℓi,  Arᵀℓi − Aiᵀℓr]          (n, 2)
// for the planar least-squares loss ℓ = |d − b|², b (m, 2), and the
// PhaseMax hinge ℓ = max(|d| − b, 0)², b (m,) magnitudes, whose gradient
// weight is (ℓr, ℓi) = max(|d| − b, 0)/max(|d|, 1e-30) · d.
//
// Replaces: fasta_tpu/kernels/planar_fused.py, _fused_planar (pallas_call
// at :197) behind fused_planar_lstsq_gradmap and fused_planar_hinge_gradmap
// — the TPU kernel that walks row tiles of both channel matrices in a
// sequential grid and carries g in VMEM scratch from step to step.
//
// Ar and Ai are stored as float32 or bfloat16 (the TPU kernel admits
// both, planar_fused.py:69): a bfloat16 value is upcast to float32 right
// after its load; x, b, d, f and g are float32 either way.
//
// Bound on this card: device-memory bytes.  The two-pass form reads both
// channel matrices twice (A x, then Aᴴℓ); this kernel reads them once:
// 2·m·n·4 bytes in float32, 33.6 MB at 16384×256 (10.0 µs at 3.35 TB/s,
// less when the matrices sit in the 50 MB L2), against 16·m·n operations
// (1.0 µs at 67 TFLOP/s); half the bytes in bfloat16.
//
// Design: one kernel a call and nothing else on the stream — no second
// kernel, no memset, no allocation but the outputs.
//  * Rows are owned by groups of threads: a warp per row for n ≤ 512
//    (route 1; no block barrier in the row loop), the whole block per row
//    for n ≤ 8192 (route 2).  A thread owns CPT fixed groups of VEC
//    columns; its slice of x and its share of the gradient stay in
//    registers for the whole call, and the row's values it loads serve
//    both the row dots and the gradient: each matrix is read once.
//  * A group sums its row dots by a shuffle butterfly (and, on route 2,
//    across warps through shared memory in warp order), so every thread
//    of the group holds the same d and applies the loss itself.
//  * Route 3, rows wider than 8192 values (2048 when rows are not 16-byte
//    aligned): a block per tile of up to 8 rows, x read through the
//    read-only cache, the gradient share kept in the block's row of the
//    scratch; the gradient pass reads the tile a second time (from L1 or
//    L2), as K-B3's wide kernel.  The routes count columns, not bytes, in
//    both types: x and the gradient share are float32 registers per column.
//  * The block's gradient share (2n floats) is formed in its shared
//    memory: route 1's warps store their shares side by side and, after
//    one barrier, each thread adds a column's 16 in warp order; route 2's
//    threads own disjoint columns.
//  * The grid is a whole number of thread-block clusters of kCluster
//    blocks (a block with no rows adds zeros), no more than the card holds
//    at once (fasta_planar_gradmap_plan; kernels/planar_fused.py,
//    gradmap_plan, is its pure mirror).  Block rank r adds column slice r
//    of its cluster's kCluster shares in rank order — over distributed
//    shared memory, on route 3 from L2 — into the cluster's partial in the
//    stream's scratch, and rank 0 the f sums in FP64.
//  * Each block publishes its slice with __threadfence(); after a cluster
//    barrier rank 0 takes a ticket.  The cluster that takes the last adds
//    the clusters' partials in cluster order, its blocks splitting the 2n
//    columns (several chains a column, added in chain order), and f in
//    FP64 in cluster order, reading them past L1; it sets the ticket back
//    to zero, so that the next launch on the stream (K-B1, K-B4, K-B5 and
//    K-B8 share the buffer) or a CUDA-graph replay finds it zeroed.  No
//    float atomics: every sum runs in an order fixed by the plan, and
//    every call gives the same bits.
//  * Ragged m and n are masked in the kernel; nothing is padded or
//    copied.  A column group is one 16-byte load (4 floats, 8 bfloat16
//    values) when every row starts 16-byte aligned (n % 4 == 0 in
//    float32, n % 8 == 0 in bfloat16), else one value.  Elementwise
//    formulas use the _rn intrinsics, so they round like the plain
//    version's separate steps.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "losses.cuh"
#include "planar_rows.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWideTile = 8;
constexpr int kCluster = 8;  // the portable cluster size
// the end of a call: columns a thread loads at once, partials a column
constexpr int kBatch = 4, kChain = 8;
// the widest rows of routes 1 and 2, which bound their shared memory
constexpr int kRoute1MaxN = 512, kRoute2MaxN = 8192;

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
  static __device__ __forceinline__ void put(float* p, int q, const T& v) {
    reinterpret_cast<float4*>(p)[q] = v;
  }
  static __device__ __forceinline__ T take(const float* p, int q) {
    return reinterpret_cast<const float4*>(p)[q];
  }
};
template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float& at(T& v, int) { return v; }
  static __device__ __forceinline__ float get(const T& v, int) { return v; }
  static __device__ __forceinline__ void put(float* p, int q, const T& v) { p[q] = v; }
  static __device__ __forceinline__ T take(const float* p, int q) { return p[q]; }
};
struct Float8 {
  float4 lo, hi;
};
template <>
struct Cols<8> {
  using T = Float8;
  static __device__ __forceinline__ T zero() { return T{Cols<4>::zero(), Cols<4>::zero()}; }
  static __device__ __forceinline__ float& at(T& v, int k) {
    return k < 4 ? Cols<4>::at(v.lo, k) : Cols<4>::at(v.hi, k - 4);
  }
  static __device__ __forceinline__ float get(const T& v, int k) {
    return k < 4 ? Cols<4>::get(v.lo, k) : Cols<4>::get(v.hi, k - 4);
  }
  static __device__ __forceinline__ void put(float* p, int q, const T& v) {
    Cols<4>::put(p, 2 * q, v.lo);
    Cols<4>::put(p, 2 * q + 1, v.hi);
  }
  static __device__ __forceinline__ T take(const float* p, int q) {
    return T{Cols<4>::take(p, 2 * q), Cols<4>::take(p, 2 * q + 1)};
  }
};

// Column group q of a row stored as E, VEC values, as float32.
template <typename E, int VEC>
struct Load;
template <int VEC>
struct Load<float, VEC> {
  static __device__ __forceinline__ typename Cols<VEC>::T get(const float* row, int q) {
    return __ldg(reinterpret_cast<const typename Cols<VEC>::T*>(row) + q);
  }
};
template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ Float8 get(const __nv_bfloat16* row, int q) {
    using fasta::bf16_hi;
    using fasta::bf16_lo;
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row) + q);
    return Float8{make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y)),
                  make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w))};
  }
};
template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* row, int q) {
    return fasta::bf16_up(__ldg(reinterpret_cast<const unsigned short*>(row) + q));
  }
};

// values of E per 16-byte load
template <typename E>
constexpr int kWideVec = 16 / sizeof(E);

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


// The stream scratch of a launch of ncl clusters, in doubles: the ticket
// in the first word (an unsigned int, zero between launches), the
// clusters' f partials from word 1, then from the next even word (16-byte
// aligned) the clusters' (2n,) gradient partials and, on route 3, the
// blocks' rows.
struct Scratch {
  unsigned* ticket;
  double* fpart;
  float* cpart;
  float* brow;
};

__device__ __forceinline__ Scratch scratch_of(double* work, int ncl, int n) {
  Scratch s;
  s.ticket = reinterpret_cast<unsigned*>(work);
  s.fpart = work + 1;
  s.cpart = reinterpret_cast<float*>(work + ((ncl + 2) & ~1));
  s.brow = s.cpart + (size_t)ncl * 2 * n;
  return s;
}

// The end of every route: the block's (2n,) gradient share — in its shared
// memory (`share`), or on route 3 (GLOBAL) in its row of the scratch — and
// its f sum `fblk` (thread 0's) become g and f.  Columns j < n of a share
// are the real channel of g's row j, j ≥ n the imaginary.
template <bool GLOBAL>
__device__ __forceinline__ void finish(float* share, double fblk, int n, float* __restrict__ f,
                                       float* __restrict__ g, double* __restrict__ work) {
  __shared__ float red[kThreads];
  __shared__ double fsh;
  __shared__ int last;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cl.block_rank();
  const int cid = blockIdx.x / kCluster, ncl = gridDim.x / kCluster, w = 2 * n;
  const Scratch s = scratch_of(work, ncl, n);
  if (tid == 0) fsh = fblk;
  if (GLOBAL) __threadfence();
  cl.sync();  // every share of the cluster is complete
  // rank r: the cluster's partial over columns [c0, c1), the shares added
  // in rank order, kBatch columns' loads in flight a thread
  const int cs = (w + kCluster - 1) / kCluster;
  const int c0 = min(w, rank * cs), c1 = min(w, c0 + cs);
  float* part = s.cpart + (size_t)cid * w;
  for (int j0 = c0 + tid; j0 < c1; j0 += kBatch * kThreads) {
    float v[kBatch][kCluster];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = min(j0 + u * kThreads, c1 - 1);
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        if constexpr (GLOBAL)
          v[u][r] = __ldcg(s.brow + (size_t)(cid * kCluster + r) * w + j);
        else
          v[u][r] = cl.map_shared_rank(share, r)[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) t += v[u][r];
      if (j0 + u * kThreads < c1) part[j0 + u * kThreads] = t;
    }
  }
  if (rank == 0 && tid == 0) {
    double t = 0.0;
    for (int r = 0; r < kCluster; ++r) t += *cl.map_shared_rank(&fsh, r);
    s.fpart[cid] = t;
  }
  __threadfence();
  cl.sync();  // the cluster's partial is out, and no block reads a peer's share again
  if (rank == 0 && tid == 0) {
    const int mine = atomicAdd(s.ticket, 1u) == (unsigned)(ncl - 1);
    __threadfence();
    for (int r = 0; r < kCluster; ++r) *cl.map_shared_rank(&last, r) = mine;
  }
  cl.sync();
  if (!last) return;
  __threadfence();
  // The last cluster: rank r adds columns [c0, c1) of the clusters'
  // partials in cluster order.  Up to kThreads columns a rank: Y chains a
  // column (thread (y, x) adds partials y, y + Y, …), then the chains in y
  // order; wider slices: a thread a column, kBatch columns at a time.
  // kChain partials in flight a column either way.
  auto column = [&](int j) { return j < n ? 2 * j : 2 * (j - n) + 1; };
  if (cs <= kThreads) {
    int P = 1;
    while (P < cs) P <<= 1;
    const int Y = kThreads / P, y = tid / P, x = tid - y * P, j = c0 + x;
    float t = 0.f;
    if (j < c1)
      for (int k0 = y; k0 < ncl; k0 += kChain * Y) {
        float v[kChain];
#pragma unroll
        for (int u = 0; u < kChain; ++u)
          v[u] = k0 + u * Y < ncl ? __ldcg(s.cpart + (size_t)(k0 + u * Y) * w + j) : 0.f;
#pragma unroll
        for (int u = 0; u < kChain; ++u)
          if (k0 + u * Y < ncl) t += v[u];
      }
    red[tid] = t;
    __syncthreads();
    if (y == 0 && j < c1) {
      float u = 0.f;
      for (int c = 0; c < Y; ++c) u += red[c * P + x];
      g[column(j)] = u;
    }
  } else {
    for (int j0 = c0 + tid; j0 < c1; j0 += kBatch * kThreads) {
      float t[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) t[u] = 0.f;
      for (int k0 = 0; k0 < ncl; k0 += kChain) {
        float v[kBatch][kChain];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = min(j0 + u * kThreads, c1 - 1);
#pragma unroll
          for (int c = 0; c < kChain; ++c)
            v[u][c] = k0 + c < ncl ? __ldcg(s.cpart + (size_t)(k0 + c) * w + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int c = 0; c < kChain; ++c)
            if (k0 + c < ncl) t[u] += v[u][c];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j0 + u * kThreads < c1) g[column(j0 + u * kThreads)] = t[u];
    }
  }
  if (rank == 0 && tid < 32) {
    double t = 0.0;
    for (int k = tid; k < ncl; k += 32) t += __ldcg(s.fpart + k);
    t = fasta::warp_sum(t);
    if (tid == 0) {
      *f = float(0.5 * t);
      *s.ticket = 0u;  // every cluster has taken its ticket
    }
  }
}

// Routes 1 (GROUP = 32) and 2 (GROUP = kThreads).  A thread owns the
// column groups q = lane + s·GROUP, s < CPT, of VEC columns each.
// Dynamic shared memory: route 1 the warps' (2n,) shares side by side,
// then the block's; route 2 the block's.  Two blocks an SM where a thread
// holds at most 8 columns of a channel, as the rows need the warps.
template <typename E, int VEC, int CPT, int GROUP>
__global__ void __launch_bounds__(kThreads, CPT * VEC <= 8 ? 2 : 1) planar_rows(
    const E* __restrict__ Ar, const E* __restrict__ Ai, const float* __restrict__ x,
    const float* __restrict__ b, int m, int n, int /* tm: a row a group */, int loss,
    float* __restrict__ d, float* __restrict__ f, float* __restrict__ g,
    double* __restrict__ work) {
  using C = Cols<VEC>;
  using T = typename C::T;
  constexpr int kGroups = kThreads / GROUP;
  __shared__ float red[kWarps][2];
  __shared__ double fw[kWarps];
  extern __shared__ __align__(16) float sm[];

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
    const E* ar = Ar + (size_t)i * n;
    const E* ai = Ai + (size_t)i * n;
    T va[CPT], vb[CPT];
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int q = lane + s * GROUP;
      va[s] = q < ng ? Load<E, VEC>::get(ar, q) : C::zero();
      vb[s] = q < ng ? Load<E, VEC>::get(ai, q) : C::zero();
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

  const int w2 = 2 * n;
  float* share = GROUP == kThreads ? sm : sm + kWarps * w2;
  float* mine = GROUP == kThreads ? sm : sm + warp * w2;  // where this thread's columns go
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int q = lane + s * GROUP;
    if (q < ng) {
      C::put(mine, q, gr[s]);
      C::put(mine + n, q, gi[s]);
    }
  }
  double fblk = facc;  // route 2: thread 0 holds the block's f
  if (GROUP == 32) {
    // the warps' shares added column by column in warp order
    if ((tid & 31) == 0) fw[warp] = facc;
    __syncthreads();
    for (int j = tid; j < w2; j += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) t += sm[v * w2 + j];
      share[j] = t;
    }
    fblk = 0.0;
    if (tid == 0)
      for (int v = 0; v < kWarps; ++v) fblk += fw[v];
  }
  finish<false>(share, fblk, n, f, g, work);
}

// Route 3: a block per tile of tm ≤ kWideTile rows (the plan balances
// the tiles over the blocks); the gradient pass reads the tile again, in
// the same column groups, and keeps the block's share in its scratch row.
// Two blocks an SM in float32; one in bfloat16, whose 16-byte groups of 8
// values would spill under two blocks' registers.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads, sizeof(E) == 4 ? 2 : 1) planar_rows_wide(
    const E* __restrict__ Ar, const E* __restrict__ Ai, const float* __restrict__ x,
    const float* __restrict__ b, int m, int n, int tm, int loss, float* __restrict__ d,
    float* __restrict__ f, float* __restrict__ g, double* __restrict__ work) {
  using C = Cols<VEC>;
  using T = typename C::T;
  __shared__ float red[kWarps][2 * kWideTile];
  __shared__ float lw[kWideTile][2];
  __shared__ double es[kWideTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = n / VEC;
  float* gp = scratch_of(work, gridDim.x / kCluster, n).brow + (size_t)blockIdx.x * 2 * n;
  const int ntiles = (m + tm - 1) / tm;
  double facc = 0.0;
  bool first = true;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = t * tm, rows = min(tm, m - r0);
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
          const T a = Load<E, VEC>::get(Ar + (size_t)(r0 + r) * n, q);
          const T c = Load<E, VEC>::get(Ai + (size_t)(r0 + r) * n, q);
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
    for (int q = tid; q < ng; q += kThreads) {
      T g_r = first ? C::zero() : C::take(gp, q), g_i = first ? C::zero() : C::take(gp + n, q);
#pragma unroll
      for (int r = 0; r < kWideTile; ++r) {
        if (r < rows) {
          const T a = Load<E, VEC>::get(Ar + (size_t)(r0 + r) * n, q);
          const T c = Load<E, VEC>::get(Ai + (size_t)(r0 + r) * n, q);
          const float l_r = lw[r][0], l_i = lw[r][1];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float av = C::get(a, k), cv = C::get(c, k);
            C::at(g_r, k) = fmaf(av, l_r, fmaf(cv, l_i, C::at(g_r, k)));
            C::at(g_i, k) = fmaf(av, l_i, fmaf(-cv, l_r, C::at(g_i, k)));
          }
        }
      }
      C::put(gp, q, g_r);
      C::put(gp + n, q, g_i);
    }
    first = false;
    __syncthreads();  // red, lw and es are rewritten by the next tile
  }
  if (first)  // a block with no tile adds zeros
    for (int j = tid; j < 2 * n; j += kThreads) gp[j] = 0.f;
  finish<true>(nullptr, facc, n, f, g, work);
}

template <typename E>
using RowsKernel = void (*)(const E*, const E*, const float*, const float*, int, int, int, int,
                           float*, float*, float*, double*);

// the kernel of a route and its column slots per thread (route 3: cpt 0)
template <typename E>
RowsKernel<E> pick(int route, int vec, int cpt) {
  constexpr int v = kWideVec<E>;
  if (route == 1) {
    if (vec == v) {
      if (cpt == 1) return planar_rows<E, v, 1, 32>;
      if (cpt == 2) return planar_rows<E, v, 2, 32>;
      if constexpr (v == 4) {
        if (cpt == 4) return planar_rows<E, v, 4, 32>;
      }
    } else {
      if (cpt == 1) return planar_rows<E, 1, 1, 32>;
      if (cpt == 2) return planar_rows<E, 1, 2, 32>;
      if (cpt == 4) return planar_rows<E, 1, 4, 32>;
      if (cpt == 8) return planar_rows<E, 1, 8, 32>;
      if (cpt == 16) return planar_rows<E, 1, 16, 32>;
    }
  } else if (route == 2) {
    if (vec == v) {
      if (cpt == 1) return planar_rows<E, v, 1, kThreads>;
      if (cpt == 2) return planar_rows<E, v, 2, kThreads>;
      if constexpr (v == 4) {
        if (cpt == 4) return planar_rows<E, v, 4, kThreads>;
      }
    } else {
      if (cpt == 2) return planar_rows<E, 1, 2, kThreads>;
      if (cpt == 4) return planar_rows<E, 1, 4, kThreads>;
    }
  } else if (route == 3) {
    return vec == v ? planar_rows_wide<E, v> : planar_rows_wide<E, 1>;
  }
  return nullptr;
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// dynamic shared memory of a route for rows of n columns
int smem_of(int route, int n) {
  return route == 1 ? (kWarps + 1) * 2 * n * (int)sizeof(float)
                    : route == 2 ? 2 * n * (int)sizeof(float) : 0;
}

cudaLaunchConfig_t cluster_config(int nblocks, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename E>
cudaError_t plan(int m, int n, int* route, int* cpt, int* nblocks, int* smem_bytes, int* tm,
                 int* slots) {
  constexpr int v = kWideVec<E>;
  const int vec = n % v == 0 ? v : 1, ng = n / vec;
  // route 1 up to 512 columns, route 2 up to 8192 (2048 one value a
  // group): the float32 registers of a thread's columns bound both
  const int warp_slots = 16 / vec, block_slots = vec == 1 ? 4 : 16 / vec;
  int r, c;
  if (ng <= 32 * warp_slots) {
    r = 1;
    c = pow2_at_least((ng + 31) / 32);
  } else if (ng <= kThreads * block_slots) {
    r = 2;
    c = pow2_at_least((ng + kThreads - 1) / kThreads);
    if (vec == 1 && c < 2) c = 2;
  } else {
    r = 3;
    c = 0;
  }
  const RowsKernel<E> fn = pick<E>(r, vec, c);
  if (fn == nullptr) return cudaErrorInvalidConfiguration;
  const int smem = smem_of(r, n);
  // the cap is the kernel's, set at the route's widest rows, so that a
  // plan for narrower rows never lowers it under another's launch
  const int cap = smem_of(r, r == 1 ? kRoute1MaxN : kRoute2MaxN);
  cudaError_t err = cudaSuccess;
  if (cap > 48 * 1024)
    err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(kCluster, smem, nullptr, &attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, (const void*)fn, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  // enough clusters to fill the card, no more than the rows give work to
  // (route 3 a row a block at the least); route 3's tiles then as even as
  // kWideTile rows allow
  const int rows_per_block = r == 1 ? kWarps : 1;
  const long long per_cluster = (long long)rows_per_block * kCluster;
  const long long need = (m + per_cluster - 1) / per_cluster;
  int nb = kCluster * (int)(need < active ? need : active), t = 1;
  if (r == 3) {  // then only the clusters the tiles need
    const long long rounds = (m + (long long)nb * kWideTile - 1) / ((long long)nb * kWideTile);
    t = (int)((m + nb * rounds - 1) / (nb * rounds));
    const long long per = ((m + t - 1) / t + rounds - 1) / rounds;
    nb = kCluster * (int)((per + kCluster - 1) / kCluster);
  }
  *route = r;
  *cpt = c;
  *nblocks = nb;
  *smem_bytes = smem;
  *tm = t;
  *slots = active;
  return cudaSuccess;
}

template <typename E>
cudaError_t launch(const E* Ar, const E* Ai, const float* x, const float* b, int m, int n,
                   int loss, int route, int cpt, int nblocks, int smem_bytes, int tm, float* d,
                   float* f, float* g, double* work, cudaStream_t s) {
  constexpr int v = kWideVec<E>;
  const RowsKernel<E> fn = pick<E>(route, n % v == 0 ? v : 1, cpt);
  if (fn == nullptr || smem_bytes != smem_of(route, n) || tm < 1 || tm > kWideTile)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(nblocks, smem_bytes, s, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, fn, Ar, Ai, x, b, m, n, tm, loss, d, f, g, work);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// Plan an m×n call on the current device for channels stored as float32
// (bf16 = 0) or bfloat16 (bf16 = 1): the route (1 warp rows, 2 block rows,
// 3 wide), the column slots per thread, the blocks (a whole number of
// clusters of 8), the dynamic shared bytes, the rows of a route-3 tile (1
// on the others) and the clusters of 8 the card holds at once for that
// kernel.
extern "C" int fasta_planar_gradmap_plan(int m, int n, int bf16, int* route, int* cpt,
                                         int* nblocks, int* smem_bytes, int* tm, int* slots) {
  if (m < 1 || n < 1) return cudaErrorInvalidValue;
  return bf16 ? plan<__nv_bfloat16>(m, n, route, cpt, nblocks, smem_bytes, tm, slots)
              : plan<float>(m, n, route, cpt, nblocks, smem_bytes, tm, slots);
}

// One launch on `stream`.  Ar and Ai are float32 (bf16 = 0) or bfloat16
// (bf16 = 1); b is (m, 2) for the least-squares loss and (m,) for the
// hinge; work is the stream's scratch (kernels/planar_fused.py,
// gradmap_plan, sizes it), its first word zero.
extern "C" int fasta_planar_gradmap(const void* Ar, const void* Ai, const float* x,
                                    const float* b, int m, int n, int bf16, int loss, int route,
                                    int cpt, int nblocks, int smem_bytes, int tm, float* d,
                                    float* f, float* g, double* work, void* stream) {
  if (m < 1 || n < 1 || nblocks < kCluster || nblocks % kCluster || work == nullptr ||
      loss < kPlanarLstsq || loss > kPlanarHinge)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch(static_cast<const __nv_bfloat16*>(Ar),
                       static_cast<const __nv_bfloat16*>(Ai), x, b, m, n, loss, route, cpt,
                       nblocks, smem_bytes, tm, d, f, g, work, s)
              : launch(static_cast<const float*>(Ar), static_cast<const float*>(Ai), x, b, m,
                       n, loss, route, cpt, nblocks, smem_bytes, tm, d, f, g, work, s);
}
