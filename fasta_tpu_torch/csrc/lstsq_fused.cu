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
// A is stored as float32 or bfloat16 (the mixed-precision path of
// fused_lstsq_gradmap, fasta_tpu/kernels/lstsq_fused.py:368-452): a
// bfloat16 tile is upcast to float32 in registers after the half-byte
// copy; x, b, d, f and g are float32 either way.
//
// Bound on this card: device-memory bytes.  The two-pass form reads A
// twice (A x, then Aᵀ ℓ′); this kernel reads it once, so at 8192×16384
// (537 MB in float32, 268 MB in bfloat16) the floor is one read of A at
// the card's HBM bandwidth.
//
// Design:
//  * A cluster of C blocks (C = ⌈n / 16384⌉, at most 8) walks row tiles
//    of `tm` rows in a fixed round-robin order; block rank c of the
//    cluster holds a chunk of at most 16384 columns.  A thread owns a
//    fixed set of the chunk's columns (up to CPT groups of VEC values);
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
//  * Ragged m (last tile) and n are masked in the kernel; nothing is
//    padded or copied.  A column group is 16 bytes (4 floats, 8 bfloat16
//    values) when every row starts 16-byte aligned (n % 4 == 0 in
//    float32, n % 8 == 0 in bfloat16), else one value: 4-byte copies in
//    float32, and in bfloat16 2-byte loads, which cp.async does not take,
//    so those tiles are copied by plain loads and stores.
//  * The chunk (16384 columns) and the wide route's threshold (8 chunks,
//    131072 columns) count columns in both types: a thread keeps x and
//    its gradient share in float32 registers per column, so the registers
//    bound the chunk, not its bytes.  A bfloat16 row is half the bytes,
//    so twice the tile rows fit the same shared memory.
//  * Rows wider than 8 chunks (131072 columns) take gradmap_rows_wide:
//    each thread walks its columns in strides of the block, reads x
//    through the read-only cache and keeps its gradient partial in the
//    block's own row of the scratch.  Its gradient pass reads each tile
//    of 8 rows a second time, so it moves about 2.25 times the bytes of
//    A (the plain form: 2 times).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "losses.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;
using fasta::bf16_hi;
using fasta::bf16_lo;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileMax = 8;
constexpr int kStages = 3;
constexpr int kChunkMax = 16384;  // CPT·VEC·kThreads at the largest instantiation
constexpr int kClusterMax = 8;    // the portable cluster size

// One thread's view of a column group: VEC consecutive values of A stored
// as E (storage type S, copied to shared memory by copy), and the group's
// float32 form X in registers (x and the gradient share).
struct Float8 {
  float4 lo, hi;
};

template <typename E, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using S = float4;
  using X = float4;
  static __device__ __forceinline__ float dot(S a, X b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
  }
  static __device__ __forceinline__ X axpy(S a, float r, X g) {
    return make_float4(fmaf(a.x, r, g.x), fmaf(a.y, r, g.y), fmaf(a.z, r, g.z),
                       fmaf(a.w, r, g.w));
  }
  static __device__ __forceinline__ X zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ X ldg(const float* p, int q) {
    return __ldg(reinterpret_cast<const float4*>(p) + q);
  }
  static __device__ __forceinline__ X ld(const float* p, int q) {
    return reinterpret_cast<const float4*>(p)[q];
  }
  static __device__ __forceinline__ void st(float* p, int q, X v) {
    reinterpret_cast<float4*>(p)[q] = v;
  }
  static __device__ __forceinline__ void copy(S* dst, const S* src) {
    __pipeline_memcpy_async(dst, src, sizeof(S));
  }
};
template <>
struct Vec<float, 1> {
  using S = float;
  using X = float;
  static __device__ __forceinline__ float dot(S a, X b, float s) { return fmaf(a, b, s); }
  static __device__ __forceinline__ X axpy(S a, float r, X g) { return fmaf(a, r, g); }
  static __device__ __forceinline__ X zero() { return 0.f; }
  static __device__ __forceinline__ X ldg(const float* p, int q) { return __ldg(p + q); }
  static __device__ __forceinline__ X ld(const float* p, int q) { return p[q]; }
  static __device__ __forceinline__ void st(float* p, int q, X v) { p[q] = v; }
  static __device__ __forceinline__ void copy(S* dst, const S* src) {
    __pipeline_memcpy_async(dst, src, sizeof(S));
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  using S = uint4;  // 8 bfloat16 values, element 2k in the low half of word k
  using X = Float8;
  static __device__ __forceinline__ float dot(S a, X b, float s) {
    s = fmaf(bf16_lo(a.x), b.lo.x, s);
    s = fmaf(bf16_hi(a.x), b.lo.y, s);
    s = fmaf(bf16_lo(a.y), b.lo.z, s);
    s = fmaf(bf16_hi(a.y), b.lo.w, s);
    s = fmaf(bf16_lo(a.z), b.hi.x, s);
    s = fmaf(bf16_hi(a.z), b.hi.y, s);
    s = fmaf(bf16_lo(a.w), b.hi.z, s);
    return fmaf(bf16_hi(a.w), b.hi.w, s);
  }
  static __device__ __forceinline__ X axpy(S a, float r, X g) {
    X o;
    o.lo = make_float4(fmaf(bf16_lo(a.x), r, g.lo.x), fmaf(bf16_hi(a.x), r, g.lo.y),
                       fmaf(bf16_lo(a.y), r, g.lo.z), fmaf(bf16_hi(a.y), r, g.lo.w));
    o.hi = make_float4(fmaf(bf16_lo(a.z), r, g.hi.x), fmaf(bf16_hi(a.z), r, g.hi.y),
                       fmaf(bf16_lo(a.w), r, g.hi.z), fmaf(bf16_hi(a.w), r, g.hi.w));
    return o;
  }
  static __device__ __forceinline__ X zero() {
    return X{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  static __device__ __forceinline__ X ldg(const float* p, int q) {
    const float4* v = reinterpret_cast<const float4*>(p) + 2 * q;
    return X{__ldg(v), __ldg(v + 1)};
  }
  static __device__ __forceinline__ X ld(const float* p, int q) {
    const float4* v = reinterpret_cast<const float4*>(p) + 2 * q;
    return X{v[0], v[1]};
  }
  static __device__ __forceinline__ void st(float* p, int q, X v) {
    float4* o = reinterpret_cast<float4*>(p) + 2 * q;
    o[0] = v.lo;
    o[1] = v.hi;
  }
  static __device__ __forceinline__ void copy(S* dst, const S* src) {
    __pipeline_memcpy_async(dst, src, sizeof(S));
  }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using S = unsigned short;  // the bits of one bfloat16 value
  using X = float;
  static __device__ __forceinline__ float dot(S a, X b, float s) {
    return fmaf(fasta::bf16_up(a), b, s);
  }
  static __device__ __forceinline__ X axpy(S a, float r, X g) {
    return fmaf(fasta::bf16_up(a), r, g);
  }
  static __device__ __forceinline__ X zero() { return 0.f; }
  static __device__ __forceinline__ X ldg(const float* p, int q) { return __ldg(p + q); }
  static __device__ __forceinline__ X ld(const float* p, int q) { return p[q]; }
  static __device__ __forceinline__ void st(float* p, int q, X v) { p[q] = v; }
  // cp.async copies 4, 8 or 16 bytes: a plain load and store, which the
  // thread alone reads back
  static __device__ __forceinline__ void copy(S* dst, const S* src) { *dst = *src; }
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
template <typename E, int VEC, int CPT, bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
gradmap_rows(const E* __restrict__ A, const float* __restrict__ x,
             const float* __restrict__ b, int m, int n, int tm, int cw, int loss,
             float* __restrict__ d, float* __restrict__ gpart,
             float* __restrict__ fpart) {
  using V = Vec<E, VEC>;
  using T = typename V::S;
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

  typename V::X xr[CPT], gacc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int q = tid + c * kThreads;
    xr[c] = q < ng ? V::ldg(x + c0, q) : V::zero();
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
          if (q < ng) V::copy(st + (size_t)r * sg + q, src + q);
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
  float* out = gpart + (size_t)cid * n + c0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int q = tid + c * kThreads;
    if (q < ng) V::st(out, q, gacc[c]);
  }
  if (tid == 0 && rank == 0) fpart[cid] = fblk;
}

// Pass 1 for rows wider than kClusterMax chunks.  A block takes row tiles
// of tm rows in the same round-robin order; the gradient pass reads the
// tile again.  A thread reads and
// writes only its own columns of the tile and of its block's gpart row,
// so only the row-dot reduction needs barriers.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads)
gradmap_rows_wide(const E* __restrict__ A, const float* __restrict__ x,
                  const float* __restrict__ b, int m, int n, int tm, int loss,
                  float* __restrict__ d, float* __restrict__ gpart,
                  float* __restrict__ fpart) {
  using V = Vec<E, VEC>;
  using T = typename V::S;
  __shared__ float red[kTileMax][kWarps];
  __shared__ float rs[kTileMax];
  __shared__ float es[kTileMax];

  const int tid = threadIdx.x;
  const int ng = n / VEC;
  const int ntiles = (m + tm - 1) / tm;
  float* gp = gpart + (size_t)blockIdx.x * n;

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
      const typename V::X xq = V::ldg(x, q);
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
      typename V::X g = first ? V::zero() : V::ld(gp, q);
      for (int r = 0; r < rows; ++r) g = V::axpy(At[(size_t)r * ng + q], rs[r], g);
      V::st(gp, q, g);
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

template <typename E>
using RowsKernel = void (*)(const E*, const float*, const float*, int, int, int, int, int,
                           float*, float*, float*);
template <typename E>
using WideKernel = void (*)(const E*, const float*, const float*, int, int, int, int, float*,
                           float*, float*);

// Values of E per 16 bytes: the wide group when a row starts 16-byte
// aligned.
template <typename E>
constexpr int kWideVec = 16 / sizeof(E);

// Chunk width of a row of n values split over `cluster` blocks: a
// multiple of the wide group when n is, so that every chunk starts
// 16-byte aligned.
template <typename E>
int chunk_width(int n, int cluster) {
  constexpr int v = kWideVec<E>;
  const int cw = (n + cluster - 1) / cluster;
  return n % v == 0 ? (cw + v - 1) / v * v : cw;
}

// The instantiation whose CPT·VEC·kThreads covers a chunk, or null.
template <typename E, bool CLUSTER>
RowsKernel<E> pick_chunk(int n, int cw) {
  constexpr int v = kWideVec<E>;
  if (n % v == 0) {
    const int g = cw / v;
    if (g <= kThreads) return gradmap_rows<E, v, 1, CLUSTER>;
    if (g <= 2 * kThreads) return gradmap_rows<E, v, 2, CLUSTER>;
    if (g <= 4 * kThreads) return gradmap_rows<E, v, 4, CLUSTER>;
    if constexpr (v == 4) {  // float32: a 16384-column chunk is 4096 groups
      if (g <= 8 * kThreads) return gradmap_rows<E, v, 8, CLUSTER>;
    }
    return nullptr;
  }
  if (cw <= kThreads) return gradmap_rows<E, 1, 1, CLUSTER>;
  if (cw <= 2 * kThreads) return gradmap_rows<E, 1, 2, CLUSTER>;
  if (cw <= 4 * kThreads) return gradmap_rows<E, 1, 4, CLUSTER>;
  if (cw <= 8 * kThreads) return gradmap_rows<E, 1, 8, CLUSTER>;
  if (cw <= 16 * kThreads) return gradmap_rows<E, 1, 16, CLUSTER>;
  if (cw <= 32 * kThreads) return gradmap_rows<E, 1, 32, CLUSTER>;
  return nullptr;
}

template <typename E>
RowsKernel<E> pick_kernel(int n, int cluster) {
  const int cw = chunk_width<E>(n, cluster);
  if (cw > kChunkMax) return nullptr;
  return cluster == 1 ? pick_chunk<E, false>(n, cw) : pick_chunk<E, true>(n, cw);
}

template <typename E>
WideKernel<E> pick_wide(int n) {
  constexpr int v = kWideVec<E>;
  return n % v == 0 ? gradmap_rows_wide<E, v> : gradmap_rows_wide<E, 1>;
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

// Plan an m×n problem of element type E on the current device.  *cluster
// ≥ 1: the clustered kernel, in clusters of that many blocks, with *tm
// rows per tile and *nparts clusters; *cluster = 0: the wide kernel with
// *nparts blocks.  *nparts is also the row count of the gradient scratch.
template <typename E>
cudaError_t plan(int m, int n, int* cluster, int* tm, int* nparts, int* smem_bytes) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nc = (n + kChunkMax - 1) / kChunkMax;
  if (nc <= kClusterMax) {
    const int cw = chunk_width<E>(n, nc);
    const RowsKernel<E> fn = pick_kernel<E>(n, nc);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, (const void*)fn);
    if (err != cudaSuccess) return err;
    // allow the whole opt-in budget, so that no plan lowers another's cap
    const int room = optin - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               room);
    if (err != cudaSuccess) return err;
    const size_t row = (size_t)cw * sizeof(E);
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

template <typename E>
cudaError_t launch(const E* A, const float* x, const float* b, int m, int n, int loss,
                   int cluster, int tm, int nparts, int smem_bytes, float* d, float* f,
                   float* g, float* gpart, float* fpart, cudaStream_t s) {
  cudaError_t err;
  if (cluster > 0) {
    const int cw = chunk_width<E>(n, cluster);
    const RowsKernel<E> fn = pick_kernel<E>(n, cluster);
    if (fn == nullptr) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cluster, nparts, smem_bytes, s, &attr);
    if (cluster == 1) cfg.numAttrs = 0;  // a plain launch
    err = cudaLaunchKernelEx(&cfg, fn, A, x, b, m, n, tm, cw, loss, d, gpart, fpart);
  } else {
    pick_wide<E>(n)<<<nparts, kThreads, 0, s>>>(A, x, b, m, n, tm, loss, d, gpart, fpart);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int rb = (n + kReduceCols - 1) / kReduceCols;
  gradmap_reduce<<<rb, dim3(kReduceCols, kChains), 0, s>>>(gpart, fpart, nparts, n,
                                                           fasta::loss_scale(loss), g, f);
  return cudaGetLastError();
}

}  // namespace

// Plan an m×n problem on the current device for A stored as float32
// (bf16 = 0) or bfloat16 (bf16 = 1); see plan above.
extern "C" int fasta_gradmap_plan(int m, int n, int bf16, int* cluster, int* tm, int* nparts,
                                  int* smem_bytes) {
  if (m < 1 || n < 1) return cudaErrorInvalidValue;
  return bf16 ? plan<__nv_bfloat16>(m, n, cluster, tm, nparts, smem_bytes)
              : plan<float>(m, n, cluster, tm, nparts, smem_bytes);
}

// Launch both passes on `stream` for the loss code `loss` (losses.cuh; b
// holds the measurements or labels), A float32 (bf16 = 0) or bfloat16
// (bf16 = 1).  gpart is (nparts, n), fpart (nparts,).
extern "C" int fasta_gradmap(const void* A, const float* x, const float* b, int m, int n,
                             int bf16, int loss, int cluster, int tm, int nparts, int smem_bytes,
                             float* d, float* f, float* g, float* gpart, float* fpart,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || tm < 1 || tm > kTileMax || nparts < 1 || cluster < 0 ||
      cluster > kClusterMax || loss < fasta::kLstsq || loss > fasta::kSquaredHinge)
    return cudaErrorInvalidValue;
  return bf16 ? launch(static_cast<const __nv_bfloat16*>(A), x, b, m, n, loss, cluster, tm,
                       nparts, smem_bytes, d, f, g, gpart, fpart, s)
              : launch(static_cast<const float*>(A), x, b, m, n, loss, cluster, tm, nparts,
                       smem_bytes, d, f, g, gpart, fpart, s);
}

extern "C" const char* fasta_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
