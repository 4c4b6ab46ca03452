// K-B3 and K-B3p: fused gradient maps in one read of A,
//     lstsq:     (d, f, g) = (A x, ½‖A x − b‖², Aᵀ(A x − b)),
//     pointwise: (d, f, g) = (A x, Σᵢ ℓ((A x)ᵢ; yᵢ), Aᵀ ℓ′(A x))
// for the logistic loss and the squared hinge (losses.cuh).
//
// Replaces: fasta_tpu/kernels/lstsq_fused.py, fused_lstsq_gradmap (bodies
// _kernel_vpu and _make_kernel_mxu) and fused_pointwise_gradmap (body
// _make_kernel_pointwise) — the TPU kernels that walk row tiles of A in a
// sequential grid and accumulate Aᵀℓ′ in scratch.
//
// Bound on this card: device-memory bytes.  The two-pass form reads A
// twice (A x, then Aᵀ ℓ′); this kernel reads it once, so at 8192×16384
// f32 (512 MB) the floor is one read of A at the card's HBM bandwidth.
//
// Design:
//  * A cluster of C blocks (C = ⌈n / 16384⌉, at most 8) walks row tiles
//    of `tm` rows in a fixed round-robin order; block rank c of the
//    cluster holds a chunk of at most 16384 columns.  A thread owns a
//    fixed set of the chunk's columns (up to CPT groups of VEC floats);
//    its slice of x and its gradient partial stay in registers for the
//    whole call.
//  * Tiles stream from device memory into shared memory with cp.async,
//    kStages deep, so the next tiles are in flight while the current one
//    is used; A is read once.  A thread copies and reads only its own
//    columns, so no barrier guards the tiles.
//  * Each block reduces its partial row dots in a fixed order and leaves
//    them in its shared memory; after a cluster barrier every block sums
//    the C partials over distributed shared memory in rank order, so all
//    blocks hold bit-identical row values d_i = (A x)_i.  The loss code
//    (a runtime int, the same for the whole launch) turns each d_i into
//    the gradient weight ℓ′(d_i) and its f term, between the row dot and
//    the gradient partial, on all three routes (one block, cluster, wide).
//    Each thread then adds Σ_i A_ij ℓ′(d_i) to its gradient partial from
//    the tile.  Only real rows are reduced, so the pointwise losses, for
//    which ℓ(0) ≠ 0, need no padding mask.
//  * At the end each cluster writes its partial gradient to a
//    (clusters, n) scratch and its partial f sum to (clusters,).  A
//    second kernel sums both in a fixed order.  No float atomics: results
//    are deterministic from run to run.
//  * Ragged m (last tile) and n (n % 4 != 0: 4-byte copies) are masked
//    in the kernel; nothing is padded or copied.
//  * Rows wider than 8 chunks (131072 floats) take gradmap_rows_wide:
//    each thread walks its columns in strides of the block, reads x
//    through the read-only cache and keeps its gradient partial in the
//    block's own row of the scratch.  Its gradient pass reads each tile
//    of 8 rows a second time, so it moves about 2.25 times the bytes of
//    A (the plain form: 2 times).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "losses.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileMax = 8;
constexpr int kStages = 3;
constexpr int kChunkMax = 16384;  // CPT·VEC·kThreads at the largest instantiation
constexpr int kClusterMax = 8;    // the portable cluster size

// One thread's view of a column group: VEC consecutive floats.
template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float dot(T a, T b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
  }
  static __device__ __forceinline__ T axpy(T a, float r, T g) {
    return make_float4(fmaf(a.x, r, g.x), fmaf(a.y, r, g.y), fmaf(a.z, r, g.z),
                       fmaf(a.w, r, g.w));
  }
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float dot(T a, T b, float s) { return fmaf(a, b, s); }
  static __device__ __forceinline__ T axpy(T a, float r, T g) { return fmaf(a, r, g); }
  static __device__ __forceinline__ T zero() { return 0.f; }
};

// Sum of a tile's row dots over the block, in a fixed order: lanes by
// shuffle, then warps in index order into out[r] for threads r < rows.
__device__ __forceinline__ void tile_row_sums(const float* dot, int rows,
                                              float (*red)[kWarps], float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kTileMax; ++r) {
    if (r < rows) {
      const float s = fasta::warp_sum(dot[r]);
      if (lane == 0) red[r][warp] = s;
    }
  }
  __syncthreads();
  if (tid < rows) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[tid][w];
    out[tid] = s;
  }
}

// Pass 1.  Dynamic shared memory: kStages tiles of tm × cw/VEC groups;
// block rank c of a cluster holds columns [c·cw, min(n, (c+1)·cw)) and its
// thread tid the groups tid + k·kThreads, k < CPT.  CLUSTER = false is the
// launch without clusters (cw = n), which compiles without the cluster
// barrier and bookkeeping.
template <int VEC, int CPT, bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
gradmap_rows(const float* __restrict__ A, const float* __restrict__ x,
             const float* __restrict__ b, int m, int n, int tm, int cw, int loss,
             float* __restrict__ d, float* __restrict__ gpart,
             float* __restrict__ fpart) {
  using V = Vec<VEC>;
  using T = typename V::T;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kTileMax][kWarps];
  __shared__ float part[2][kTileMax];  // this block's row dots, by tile parity
  __shared__ float rs[kTileMax];       // the tile's gradient weights ℓ′(d)
  __shared__ float es[kTileMax];       // and f terms

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = CLUSTER ? (int)cluster.num_blocks() : 1;
  const int rank = CLUSTER ? (int)cluster.block_rank() : 0;
  const int cid = blockIdx.x / nc, ncl = gridDim.x / nc;
  const int tid = threadIdx.x;
  const int c0 = rank * cw;                      // first column of the chunk
  const int ng = max(0, min(cw, n - c0)) / VEC;  // its column groups
  const int sg = cw / VEC;                       // groups per staged row
  const size_t stage_groups = (size_t)tm * sg;
  T* stages = reinterpret_cast<T*>(smem);
  const int ntiles = (m + tm - 1) / tm;

  T xr[CPT], gacc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int q = tid + c * kThreads;
    xr[c] = q < ng ? __ldg(reinterpret_cast<const T*>(x + c0) + q) : V::zero();
    gacc[c] = V::zero();
  }

  // start the copy of this cluster's i-th tile into stage i % kStages; an
  // empty commit group past the last tile keeps the group count uniform
  auto prefetch = [&](int i) {
    const int t = cid + i * ncl;
    if (t < ntiles) {
      const int r0 = t * tm, rows = min(tm, m - r0);
      T* st = stages + (size_t)(i % kStages) * stage_groups;
      for (int r = 0; r < rows; ++r) {
        const T* src = reinterpret_cast<const T*>(A + (size_t)(r0 + r) * n + c0);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int q = tid + c * kThreads;
          if (q < ng) __pipeline_memcpy_async(st + (size_t)r * sg + q, src + q, sizeof(T));
        }
      }
    }
    __pipeline_commit();
  };

  for (int i = 0; i < kStages - 1; ++i) prefetch(i);
  float fblk = 0.f;  // thread 0 of rank 0: this cluster's f sum, in tile order
  for (int i = 0;; ++i) {
    const int t = cid + i * ncl;  // the same in every block of the cluster
    if (t >= ntiles) break;
    prefetch(i + kStages - 1);
    __pipeline_wait_prior(kStages - 1);  // tile i has landed
    const int r0 = t * tm, rows = min(tm, m - r0);
    const T* st = stages + (size_t)(i % kStages) * stage_groups;

    float dot[kTileMax];
#pragma unroll
    for (int r = 0; r < kTileMax; ++r) {
      dot[r] = 0.f;
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int q = tid + c * kThreads;
          if (q < ng) dot[r] = V::dot(st[(size_t)r * sg + q], xr[c], dot[r]);
        }
      }
    }
    // The partials of tile i go to part[i & 1].  A block writes that slot
    // again at tile i + 2, past the cluster barrier of tile i + 1, which
    // no block reaches before it has read the slot for tile i.  Without
    // clusters, thread r reads back only its own part[r]: no barrier.
    float* mine = part[i & 1];
    tile_row_sums(dot, rows, red, mine);
    if (CLUSTER) cluster.sync();
    if (tid < rows) {
      float s = 0.f;
      for (int c = 0; c < nc; ++c)
        s += (CLUSTER ? cluster.map_shared_rank(mine, c) : mine)[tid];
      if (rank == 0) d[r0 + tid] = s;
      fasta::loss_eval(loss, s, __ldg(b + r0 + tid), rs[tid], es[tid]);
    }
    __syncthreads();
    if (tid == 0 && rank == 0)
      for (int r = 0; r < rows; ++r) fblk = fasta::loss_accum(loss, es[r], fblk);
    // gradient partial from the tile in shared memory
    for (int r = 0; r < rows; ++r) {
      const float rr = rs[r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int q = tid + c * kThreads;
        if (q < ng) gacc[c] = V::axpy(st[(size_t)r * sg + q], rr, gacc[c]);
      }
    }
  }
  __pipeline_wait_prior(0);
  if (CLUSTER) cluster.sync();  // no block exits while another may read its `part`
  T* out = reinterpret_cast<T*>(gpart + (size_t)cid * n + c0);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int q = tid + c * kThreads;
    if (q < ng) out[q] = gacc[c];
  }
  if (tid == 0 && rank == 0) fpart[cid] = fblk;
}

// Pass 1 for rows wider than kClusterMax chunks.  A block takes row tiles
// of tm rows in the same round-robin order; the gradient pass reads the
// tile again.  A thread reads and
// writes only its own columns of the tile and of its block's gpart row,
// so only the row-dot reduction needs barriers.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
gradmap_rows_wide(const float* __restrict__ A, const float* __restrict__ x,
                  const float* __restrict__ b, int m, int n, int tm, int loss,
                  float* __restrict__ d, float* __restrict__ gpart,
                  float* __restrict__ fpart) {
  using V = Vec<VEC>;
  using T = typename V::T;
  __shared__ float red[kTileMax][kWarps];
  __shared__ float rs[kTileMax];
  __shared__ float es[kTileMax];

  const int tid = threadIdx.x;
  const int ng = n / VEC;
  const int ntiles = (m + tm - 1) / tm;
  const T* xv = reinterpret_cast<const T*>(x);
  T* gp = reinterpret_cast<T*>(gpart + (size_t)blockIdx.x * n);

  float fblk = 0.f;  // thread 0: this block's f sum, in tile order
  bool first = true;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = t * tm, rows = min(tm, m - r0);
    const T* At = reinterpret_cast<const T*>(A + (size_t)r0 * n);

    float dot[kTileMax];
#pragma unroll
    for (int r = 0; r < kTileMax; ++r) dot[r] = 0.f;
#pragma unroll 4
    for (int q = tid; q < ng; q += kThreads) {
      const T xq = __ldg(xv + q);
#pragma unroll
      for (int r = 0; r < kTileMax; ++r)
        if (r < rows) dot[r] = V::dot(At[(size_t)r * ng + q], xq, dot[r]);
    }
    tile_row_sums(dot, rows, red, rs);
    if (tid < rows) {
      const float s = rs[tid];
      d[r0 + tid] = s;
      fasta::loss_eval(loss, s, __ldg(b + r0 + tid), rs[tid], es[tid]);
    }
    __syncthreads();
    if (tid == 0)
      for (int r = 0; r < rows; ++r) fblk = fasta::loss_accum(loss, es[r], fblk);
    for (int q = tid; q < ng; q += kThreads) {
      T g = first ? V::zero() : gp[q];
      for (int r = 0; r < rows; ++r) g = V::axpy(At[(size_t)r * ng + q], rs[r], g);
      gp[q] = g;
    }
    first = false;
  }
  if (tid == 0) fpart[blockIdx.x] = fblk;
}

// Pass 2: g_j = Σ_parts gpart[p, j] and f = scale · Σ_parts fpart, in a fixed
// order: thread row y sums parts y, y + kChains, ... in turn, then the
// kChains partial sums are added in y order.  Independent chains keep
// several loads in flight per column.
constexpr int kChains = 8;
constexpr int kReduceCols = 32;

__global__ void __launch_bounds__(kReduceCols * kChains)
gradmap_reduce(const float* __restrict__ gpart, const float* __restrict__ fpart,
               int nparts, int n, float scale, float* __restrict__ g,
               float* __restrict__ f) {
  __shared__ float part[kChains][kReduceCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kReduceCols + tx;
  float s = 0.f;
  if (j < n)
    for (int p = ty; p < nparts; p += kChains) s += gpart[(size_t)p * n + j];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < n) {
    float t = 0.f;
    for (int y = 0; y < kChains; ++y) t += part[y][tx];
    g[j] = t;
  }
  if (blockIdx.x == 0 && ty == 1) {  // one warp: f in lane-strided order
    float v = 0.f;
    for (int p = tx; p < nparts; p += 32) v += fpart[p];
    v = fasta::warp_sum(v);
    if (tx == 0) *f = scale * v;
  }
}

using RowsKernel = void (*)(const float*, const float*, const float*, int, int, int, int, int,
                           float*, float*, float*);
using WideKernel = void (*)(const float*, const float*, const float*, int, int, int, int,
                           float*, float*, float*);

// Chunk width of a row of n floats split over `cluster` blocks: a
// multiple of 4 when n is, so that every chunk starts 16-byte aligned.
int chunk_width(int n, int cluster) {
  const int cw = (n + cluster - 1) / cluster;
  return n % 4 == 0 ? (cw + 3) / 4 * 4 : cw;
}

// The instantiation whose CPT·VEC·kThreads covers a chunk, or null.
template <bool CLUSTER>
RowsKernel pick_chunk(int n, int cw) {
  if (n % 4 == 0) {
    const int g = cw / 4;
    if (g <= kThreads) return gradmap_rows<4, 1, CLUSTER>;
    if (g <= 2 * kThreads) return gradmap_rows<4, 2, CLUSTER>;
    if (g <= 4 * kThreads) return gradmap_rows<4, 4, CLUSTER>;
    if (g <= 8 * kThreads) return gradmap_rows<4, 8, CLUSTER>;
    return nullptr;
  }
  if (cw <= kThreads) return gradmap_rows<1, 1, CLUSTER>;
  if (cw <= 2 * kThreads) return gradmap_rows<1, 2, CLUSTER>;
  if (cw <= 4 * kThreads) return gradmap_rows<1, 4, CLUSTER>;
  if (cw <= 8 * kThreads) return gradmap_rows<1, 8, CLUSTER>;
  if (cw <= 16 * kThreads) return gradmap_rows<1, 16, CLUSTER>;
  if (cw <= 32 * kThreads) return gradmap_rows<1, 32, CLUSTER>;
  return nullptr;
}

RowsKernel pick_kernel(int n, int cluster) {
  const int cw = chunk_width(n, cluster);
  if (cw > kChunkMax) return nullptr;
  return cluster == 1 ? pick_chunk<false>(n, cw) : pick_chunk<true>(n, cw);
}

WideKernel pick_wide(int n) {
  return n % 4 == 0 ? gradmap_rows_wide<4> : gradmap_rows_wide<1>;
}

cudaLaunchConfig_t cluster_config(int cluster, int nclusters, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * nclusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Plan an m×n problem on the current device.  *cluster ≥ 1: the clustered
// kernel, in clusters of that many blocks, with *tm rows per tile and
// *nparts clusters; *cluster = 0: the wide kernel with *nparts blocks.
// *nparts is also the row count of the gradient scratch.
extern "C" int fasta_gradmap_plan(int m, int n, int* cluster, int* tm, int* nparts,
                                        int* smem_bytes) {
  if (m < 1 || n < 1) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nc = (n + kChunkMax - 1) / kChunkMax;
  if (nc <= kClusterMax) {
    const int cw = chunk_width(n, nc);
    const RowsKernel fn = pick_kernel(n, nc);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, (const void*)fn);
    if (err != cudaSuccess) return err;
    // allow the whole opt-in budget, so that no plan lowers another's cap
    const int room = optin - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               room);
    if (err != cudaSuccess) return err;
    const size_t row = (size_t)cw * sizeof(float);
    const size_t fit = (size_t)room / (kStages * row);
    if (fit < 1) return cudaErrorInvalidConfiguration;
    const int t = fit < (size_t)kTileMax ? (int)fit : kTileMax;
    const int smem = (int)(kStages * row * t);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(nc, 1, smem, nullptr, &attr);
    int active = 0;
    if (nc == 1) {  // a launch without clusters: blocks per SM × SMs
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, (const void*)fn, kThreads,
                                                          smem);
      active *= sms;
    } else {
      err = cudaOccupancyMaxActiveClusters(&active, (const void*)fn, &cfg);
    }
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    const int ntiles = (m + t - 1) / t;
    *cluster = nc;
    *tm = t;
    *nparts = active < ntiles ? active : ntiles;
    *smem_bytes = smem;
    return cudaSuccess;
  }
  // the wide kernel: one block per SM, each with its own scratch row, and
  // ⌈m / SMs⌉ rows per tile up to kTileMax, so that short matrices still
  // spread over the SMs and no last round of tiles runs nearly empty
  const int per = (m + sms - 1) / sms;
  const int t = per < kTileMax ? per : kTileMax;
  const int ntiles = (m + t - 1) / t;
  *cluster = 0;
  *tm = t;
  *nparts = sms < ntiles ? sms : ntiles;
  *smem_bytes = 0;
  return cudaSuccess;
}

// Launch both passes on `stream` for the loss code `loss` (losses.cuh; b
// holds the measurements or labels).  gpart is (nparts, n), fpart
// (nparts,).
extern "C" int fasta_gradmap(const float* A, const float* x, const float* b, int m, int n,
                             int loss, int cluster, int tm, int nparts, int smem_bytes,
                             float* d, float* f, float* g, float* gpart, float* fpart,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || tm < 1 || tm > kTileMax || nparts < 1 || cluster < 0 ||
      cluster > kClusterMax || loss < fasta::kLstsq || loss > fasta::kSquaredHinge)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (cluster > 0) {
    const int cw = chunk_width(n, cluster);
    const RowsKernel fn = pick_kernel(n, cluster);
    if (fn == nullptr) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cluster, nparts, smem_bytes, s, &attr);
    if (cluster == 1) cfg.numAttrs = 0;  // a plain launch
    err = cudaLaunchKernelEx(&cfg, fn, A, x, b, m, n, tm, cw, loss, d, gpart, fpart);
  } else {
    pick_wide(n)<<<nparts, kThreads, 0, s>>>(A, x, b, m, n, tm, loss, d, gpart, fpart);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int rb = (n + kReduceCols - 1) / kReduceCols;
  gradmap_reduce<<<rb, dim3(kReduceCols, kChains), 0, s>>>(gpart, fpart, nparts, n,
                                                           fasta::loss_scale(loss), g, f);
  return cudaGetLastError();
}

extern "C" const char* fasta_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
