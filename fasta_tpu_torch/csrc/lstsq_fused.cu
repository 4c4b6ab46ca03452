// K-B3 and K-B3p: fused gradient maps in one read of A,
//     lstsq:     (d, f, g) = (A x, ½‖A x − b‖², Aᵀ(A x − b)),
//     pointwise: (d, f, g) = (A x, Σᵢ ℓ((A x)ᵢ; yᵢ), Aᵀ ℓ′(A x))
// for the logistic loss and the squared hinge (losses.cuh).
//
// Replaces: fasta_tpu/kernels/lstsq_fused.py, fused_lstsq_gradmap
// (pallas_call at :407, bodies _kernel_vpu and _make_kernel_mxu) and
// fused_pointwise_gradmap (pallas_call at :331, body
// _make_kernel_pointwise) — the TPU kernels that walk row tiles of A in a
// sequential grid and carry Aᵀℓ′ in VMEM scratch from step to step.
//
// A is stored as float32 or bfloat16 (the mixed-precision path,
// lstsq_fused.py:292-452): a bfloat16 value is upcast to float32 in
// registers right after its load; x, b, d, f and g are float32 either way.
//
// Bound on this card.  The function reads A once: at 8192×16384 (537 MB in
// float32, 268 MB in bfloat16) that is the floor, A's bytes at the HBM
// rate, and the streaming route (3) runs near it (1.15× in float32).  At
// the main paths' shapes A fits the 50 MB L2 (256×1024 1 MB, 1000×500
// 2 MB, 1000×2000 8 MB): the byte bound is 0.3–2.4 µs, and a call is
// bound instead by its serial chain — the launch (1.3–1.5 µs on this
// card, the kernel returning at once, in a CUDA graph), the rows (x and
// the rows loaded from L2, the row dots reduced, the loss, the axpy:
// 1.0 µs; at 1000×2000 the 8 MB from L2, 3.0 µs) and the end (the
// blocks' partials summed across the grid: 2.2–2.4 µs, 3.3 at 1000×2000)
// (tools/gradmap_split.py --phases, one H100).  At 8192×16384 the end
// costs 4.1 µs of the kernel's 182.9 in float32 (the parent's second
// kernel took 3.4), so the route runs 1.3% slower than the parent's two
// kernels there in float32 and alike in bfloat16 (PERF.md §6).
//
// Design: one kernel a call and nothing else on the stream — no second
// kernel, no memset, nothing allocated but d, g and f.  What held the
// former design (two kernels a call; ⌈m/8⌉ blocks of 512 threads, one
// block an SM; whole 16-byte column groups a thread, idle in narrow rows;
// f summed by one thread a tile; the scratch allocated every call) is
// answered so:
//  * Routes by row width (fasta_gradmap_plan; kernels/lstsq_fused.py,
//    gradmap_plan, is its pure mirror).  Route 1, rows of at most 512
//    values: a warp a row, four warps a block of 128 threads.  Route 2,
//    rows of at most 8192 values (2048 when rows are not 16-byte
//    aligned): a group of 128 threads a row up to 2048 columns (float32;
//    2048 bfloat16), of 512 past it, one group a block.  A thread owns CPT
//    column groups of VEC values; its slice of x and its share of the
//    gradient stay in registers for the whole call, and the row values it
//    loads serve both the row dot and the axpy (A is read once, no
//    shared-memory staging).
//  * A group takes TR ≤ 4 rows at once (64 values of A a thread in
//    registers in a block of 128, 32 in one of 512; a constant of the
//    kernel, rows_at_once): all TR rows are
//    loaded before any is reduced, their dots reduced together (one
//    shuffle butterfly each, interleaved, and on route 2 one round
//    across the group's warps in warp order through shared memory), so
//    every thread of the group holds the same d_i and applies the loss
//    itself.
//  * The grid is the fewest blocks that hold the rows in one step, at
//    most kBlocksPerSM (1) an SM: 256×1024 on 64 blocks, 1000×500 on 63,
//    800×100 on 50, 1000×2000 on all 132 SMs in two steps.  Fewer blocks
//    leave fewer partials to sum at the end, which costs more than the
//    idle SMs: at 256×1024, 64 blocks of 4 rows run 4.65 µs a call, 132
//    blocks of 1 row 5.58 µs, 256 blocks 6.94 (tools/gradmap_split.py
//    --sweep, one H100).
//  * The end, on every route: each block writes its (n,) gradient share
//    to its own row of the stream's scratch (_build.stream_scratch: its
//    first double holds the counters, which K-B1, K-B4, K-B5, K-B7, K-B8
//    and the probes share and leave at zero) — route 2's threads from
//    their registers, route 1's warps added in shared memory in warp
//    order first — and its f sum (FP64) beside it; then one grid barrier
//    (grid_barrier.cuh; every route is a cooperative launch, so the CUDA
//    driver holds the grid on the card at once or refuses it), and every
//    block adds its own 32-column-aligned slice of the columns over the
//    blocks' rows in block order (up to 64 loads in flight a chain, so
//    132 rows take one round trip), block 0 also the f sums.  Each block
//    takes its exit ticket right after the barrier, so its round trip
//    overlaps the sum; the last sets the counters back to zero.
//    Clusters of 8 blocks summing their shares over distributed shared
//    memory, with a last-cluster ticket or this barrier after them, ran
//    slower than the parent at 256×1024 in source edits tried while this
//    design was chosen (not kept; PERF.md §6); the ticket alone leaves
//    the whole sum to one cluster.  One kernel's split sum costs about
//    what the former second kernel did; what the single launch saves is
//    that kernel's launch and the clusters' serial chain.
//  * Route 3, rows of more than 8192 values (2048 ragged) up to 131072: a
//    cluster of C = ⌈n / 16384⌉ blocks of 512 threads walks row tiles of
//    `tm` rows in round-robin order, block rank c holding chunk c of the
//    columns; tiles stream from device memory into shared memory through
//    a cp.async ring kStages deep (A is read once from HBM), the row dots
//    are summed over the cluster's blocks by distributed shared memory;
//    each cluster's partial goes to the scratch and the same end sums
//    them — where a second kernel did.  Route 4, rows wider than 131072:
//    a block per tile of up to 8 rows, its gradient share kept in its row
//    of the scratch (the gradient pass reads the tile a second time, from
//    L1 or L2), the same end.
//  * Deterministic: every sum runs in an order fixed by the plan, with no
//    float atomics; the same inputs give the same bits on every call and
//    every CUDA-graph replay, whatever ran before on the stream.
//  * Ragged m and n are masked in the kernel; nothing is padded or
//    copied.  A column group is 16 bytes (4 floats, 8 bfloat16 values)
//    when every row starts 16-byte aligned (n % 4 == 0 in float32, n % 8
//    == 0 in bfloat16), else one value (route 3: bfloat16 tiles copied by
//    plain 2-byte loads, which cp.async does not take).  The routes count
//    columns, not bytes: x and the gradient share are float32 registers a
//    column in both types.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "grid_barrier.cuh"
#include "losses.cuh"
#include "planar_rows.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;
using fasta::bf16_hi;
using fasta::bf16_lo;

namespace {

// routes 1 and 2
constexpr int kRowThreads = 128;  // the block of route 1 and of route 2's narrower group
constexpr int kBlocksPerSM = 1;   // the grid's blocks an SM, at most
constexpr int kRowsMax = 4;       // the rows a group takes at once, at most
// the end of a call: columns a thread loads at once, partials a column,
// f sums a lane (160 parts in one round trip)
constexpr int kBatch = 4, kChain = 8, kFLoads = 5;

// routes 3 and 4
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileMax = 8;
constexpr int kStages = 3;
constexpr int kChunkMax = 16384;  // CPT·VEC·kThreads at the largest instantiation
constexpr int kClusterMax = 8;
constexpr int kStreamBudget = 224 * 1024;  // route 3's ring, bytes of shared memory at most

// One thread's view of a column group: VEC consecutive values of A stored
// as E (storage type S), and the group's float32 form X in registers (x
// and the gradient share).
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
  static __device__ __forceinline__ S szero() { return zero(); }
  static __device__ __forceinline__ S lda(const float* row, int q) {
    return __ldg(reinterpret_cast<const float4*>(row) + q);
  }
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
  static __device__ __forceinline__ S szero() { return 0.f; }
  static __device__ __forceinline__ S lda(const float* row, int q) { return __ldg(row + q); }
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
  static __device__ __forceinline__ S szero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ S lda(const __nv_bfloat16* row, int q) {
    return __ldg(reinterpret_cast<const uint4*>(row) + q);
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
  static __device__ __forceinline__ S szero() { return 0; }
  static __device__ __forceinline__ S lda(const __nv_bfloat16* row, int q) {
    return __ldg(reinterpret_cast<const unsigned short*>(row) + q);
  }
  static __device__ __forceinline__ X ldg(const float* p, int q) { return __ldg(p + q); }
  static __device__ __forceinline__ X ld(const float* p, int q) { return p[q]; }
  static __device__ __forceinline__ void st(float* p, int q, X v) { p[q] = v; }
  // cp.async copies 4, 8 or 16 bytes: a plain load and store, which the
  // thread alone reads back
  static __device__ __forceinline__ void copy(S* dst, const S* src) { *dst = *src; }
};

// --------------------------------------------------------------------------
// The end of a call, shared by every route
// --------------------------------------------------------------------------

// The stream scratch of a launch with `parts` partials (a block each, a
// cluster on route 3), in doubles: the grid barrier's two counters in the
// first word (zero between launches), the parts' f sums from word 1, then
// from the next even word (16-byte aligned) their (n,) gradient partials.
struct Scratch {
  unsigned* count;
  double* fpart;
  float* gpart;
};

__device__ __forceinline__ Scratch scratch_of(double* work, int parts) {
  Scratch s;
  s.count = reinterpret_cast<unsigned*>(work);
  s.fpart = work + 1;
  s.gpart = reinterpret_cast<float*>(work + ((parts + 2) & ~1));
  return s;
}

// g_j = Σ_p parts[p, j] for j in [c0, c1), p in order, by the block (T
// threads; every thread must call it, with the same c0 and c1).  Up to T
// columns: Y chains a column (thread (y, x) adds parts y, y + Y, … in
// order), then the chains in y order, kLanes<T> loads in flight a chain
// (64 in a block of 512: 132 parts of 128 columns in one round trip; 32
// in a block of 128, whose four-blocks-an-SM registers they would crowd);
// wider slices: a thread a column, kBatch columns of kChain loads at a
// time.  The partials are read past L1 (other SMs wrote them).
template <int T>
constexpr int kLanes = T == kThreads ? 64 : 32;

template <int T>
__device__ __forceinline__ void sum_columns(const float* __restrict__ parts, int nparts, int n,
                                            int c0, int c1, float* __restrict__ g) {
  __shared__ float red[T];
  const int tid = threadIdx.x, cs = c1 - c0;
  if (cs <= T) {
    int P = 1;
    while (P < cs) P <<= 1;
    const int Y = T / P, y = tid / P, x = tid - y * P, j = c0 + x;
    float t = 0.f;
    if (j < c1)
      for (int k0 = y; k0 < nparts; k0 += kLanes<T> * Y) {
        float v[kLanes<T>];
#pragma unroll
        for (int u = 0; u < kLanes<T>; ++u)
          v[u] = k0 + u * Y < nparts ? __ldcg(parts + (size_t)(k0 + u * Y) * n + j) : 0.f;
#pragma unroll
        for (int u = 0; u < kLanes<T>; ++u)
          if (k0 + u * Y < nparts) t += v[u];
      }
    red[tid] = t;
    __syncthreads();
    if (y == 0 && j < c1) {
      float u = 0.f;
      for (int c = 0; c < Y; ++c) u += red[c * P + x];
      g[j] = u;
    }
  } else {
    for (int j0 = c0 + tid; j0 < c1; j0 += kBatch * T) {
      float t[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) t[u] = 0.f;
      for (int k0 = 0; k0 < nparts; k0 += kChain) {
        float v[kBatch][kChain];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = min(j0 + u * T, c1 - 1);
#pragma unroll
          for (int c = 0; c < kChain; ++c)
            v[u][c] = k0 + c < nparts ? __ldcg(parts + (size_t)(k0 + c) * n + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int c = 0; c < kChain; ++c)
            if (k0 + c < nparts) t[u] += v[u][c];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j0 + u * T < c1) g[j0 + u * T] = t[u];
    }
  }
}

// The f sums of the parts, loaded by one warp in lane-strided order
// (kFLoads a lane in flight); sum_f finishes
// them: f = scale · Σ_p fpart[p].
struct FLoads {
  double v[kFLoads];
};

__device__ __forceinline__ FLoads load_f(const double* __restrict__ fpart, int nparts) {
  FLoads l;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kFLoads; ++u)
    l.v[u] = lane + 32 * u < nparts ? __ldcg(fpart + lane + 32 * u) : 0.0;
  return l;
}

__device__ __forceinline__ void sum_f(const FLoads& l, const double* __restrict__ fpart,
                                      int nparts, int loss, float* __restrict__ f) {
  const int lane = threadIdx.x & 31;
  double t = 0.0;
#pragma unroll
  for (int u = 0; u < kFLoads; ++u) t += l.v[u];
  for (int k = lane + 32 * kFLoads; k < nparts; k += 32) t += __ldcg(fpart + k);
  t = fasta::warp_sum(t);
  if (lane == 0) *f = float(double(fasta::loss_scale(loss)) * t);
}

// The end of every launch: the parts' partials are out (written before
// the grid barrier); every block takes its exit ticket at once (it reads
// the barrier's counter no more; the ticket's round trip overlaps the
// sum), adds its slice of the columns — whole 32-column runs — over the
// partials, block 0 also the f sums (their loads in flight beside the
// columns'), and the block that took the last ticket sets both counters
// back to zero (grid_barrier.cuh's grid_exit, taken early).
template <int T>
__device__ __forceinline__ void grid_end(double* __restrict__ work, int nparts, int n, int loss,
                                         float* __restrict__ f, float* __restrict__ g) {
  const Scratch s = scratch_of(work, nparts);
  unsigned gen = 0;
  fasta::grid_barrier(s.count, gridDim.x, gen);
  unsigned ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(s.count + 1, 1u);
  const bool fw = blockIdx.x == 0 && threadIdx.x < 32;
  FLoads fl;
  if (fw) fl = load_f(s.fpart, nparts);
  const int per = ((n + gridDim.x - 1) / gridDim.x + 31) / 32 * 32;
  const int c0 = min(n, (int)blockIdx.x * per), c1 = min(n, c0 + per);
  sum_columns<T>(s.gpart, nparts, n, c0, c1, g);
  if (fw) sum_f(fl, s.fpart, nparts, loss, f);
  if (threadIdx.x == 0 && ticket == gridDim.x - 1) {
    s.count[0] = 0u;
    s.count[1] = 0u;
  }
}

// --------------------------------------------------------------------------
// Routes 1 and 2: a group of GROUP threads a row
// --------------------------------------------------------------------------

template <int GROUP>
constexpr int kRowBlock = GROUP < kRowThreads ? kRowThreads : GROUP;

// The rows a group takes at once: 64 values of A a thread in registers
// in a block of 128 threads (at most 128 registers a thread, four blocks
// an SM), 32 in a block of 512, at least 1 and at most kRowsMax.
__host__ __device__ constexpr int rows_at_once(int cpt, int vec, int threads) {
  return (threads == kRowThreads ? 64 : 32) / (cpt * vec) >= kRowsMax
             ? kRowsMax
             : ((threads == kRowThreads ? 64 : 32) / (cpt * vec) < 1
                    ? 1
                    : (threads == kRowThreads ? 64 : 32) / (cpt * vec));
}

// A thread owns the column groups q = lane + s·GROUP, s < CPT.  The block
// (kRowBlock threads, R = kRowBlock / GROUP groups) takes steps of R·TR
// rows: at step k (blocks k·gridDim.x + blockIdx.x) its group r takes the
// TR = rows_at_once consecutive rows from (k·gridDim.x + blockIdx.x)·R·TR
// + r·TR, all loaded before any is reduced.  The walk depends on the block
// alone, so its barriers are uniform.  At the end the block's share goes
// to its own row of the scratch — route 2's threads store their columns
// from registers, route 1's warps add theirs in shared memory in warp
// order first (R rows of n floats of dynamic shared memory) — and the
// grid barrier's end sums the rows.
template <typename E, int VEC, int CPT, int GROUP>
__global__ void __launch_bounds__(kRowBlock<GROUP>, kRowBlock<GROUP> == kRowThreads ? 4 : 1)
    gradmap_groups(const E* __restrict__ A, const float* __restrict__ x,
                   const float* __restrict__ b, int m, int n, int loss,
                   float* __restrict__ d, float* __restrict__ f, float* __restrict__ g,
                   double* __restrict__ work) {
  using V = Vec<E, VEC>;
  using S = typename V::S;
  using X = typename V::X;
  constexpr int T = kRowBlock<GROUP>;
  constexpr int R = T / GROUP;      // groups a block
  constexpr int GW = GROUP / 32;    // warps a group
  constexpr int TR = rows_at_once(CPT, VEC, T);
  __shared__ float red[TR][T / 32];
  __shared__ double fw[T / 32];
  extern __shared__ __align__(16) float sm[];

  const int tid = threadIdx.x, lane = tid % GROUP, grp = tid / GROUP, warp = tid >> 5;
  const int ng = n / VEC;
  X xr[CPT], gacc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int q = lane + c * GROUP;
    xr[c] = q < ng ? V::ldg(x, q) : V::zero();
    gacc[c] = V::zero();
  }

  double facc = 0.0;  // this group's f terms, in row order (its lane 0's)
  constexpr int per = R * TR;
  for (int base = blockIdx.x * per; base < m; base += gridDim.x * per) {
    const int i0 = base + grp * TR;
    S v[TR][CPT];
    float bi[TR], s[TR];
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int i = i0 + t;
      const bool live = i < m;
      const E* row = A + (size_t)i * n;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int q = lane + c * GROUP;
        v[t][c] = live && q < ng ? V::lda(row, q) : V::szero();
      }
      bi[t] = live ? __ldg(b + i) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      s[t] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[t] = V::dot(v[t][c], xr[c], s[t]);
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) s[t] = fasta::warp_allsum(s[t]);
    if constexpr (GW > 1) {
      // across the group's warps, in warp order; every thread reads the
      // same totals
      if ((tid & 31) == 0)
#pragma unroll
        for (int t = 0; t < TR; ++t) red[t][warp] = s[t];
      __syncthreads();
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        s[t] = 0.f;
#pragma unroll
        for (int w = 0; w < GW; ++w) s[t] += red[t][grp * GW + w];
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int i = i0 + t;
      if (i < m) {
        float wgt, e;
        fasta::loss_eval(loss, s[t], bi[t], wgt, e);
        if (lane == 0) {
          d[i] = s[t];
          facc += fasta::loss_term<double>(loss, e);
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) gacc[c] = V::axpy(v[t][c], wgt, gacc[c]);
      }
    }
  }

  const Scratch sc = scratch_of(work, gridDim.x);
  float* row = sc.gpart + (size_t)blockIdx.x * n;
  if constexpr (R > 1) {
    // the groups' shares added column by column in group order
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int q = lane + c * GROUP;
      if (q < ng) V::st(sm + grp * n, q, gacc[c]);
    }
    if (lane == 0) fw[grp] = facc;
    __syncthreads();
    for (int j = tid; j < n; j += T) {
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) t += sm[r * n + j];
      row[j] = t;
    }
    if (tid == 0) {
      double t = 0.0;
#pragma unroll
      for (int r = 0; r < R; ++r) t += fw[r];
      sc.fpart[blockIdx.x] = t;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int q = lane + c * GROUP;
      if (q < ng) V::st(row, q, gacc[c]);
    }
    if (tid == 0) sc.fpart[blockIdx.x] = facc;
  }
  grid_end<T>(work, gridDim.x, n, loss, f, g);
}

// --------------------------------------------------------------------------
// Route 3: clusters of 512-thread blocks over a cp.async ring
// --------------------------------------------------------------------------

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

// Dynamic shared memory: kStages tiles of tm × cw/VEC groups; block rank c
// of a cluster holds columns [c·cw, min(n, (c+1)·cw)) and its thread tid
// the groups tid + k·kThreads, k < CPT.  CLUSTER = false is the launch
// without clusters (cw = n), which compiles without the cluster barrier
// and bookkeeping.
template <typename E, int VEC, int CPT, bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
gradmap_rows(const E* __restrict__ A, const float* __restrict__ x,
             const float* __restrict__ b, int m, int n, int tm, int cw, int loss,
             float* __restrict__ d, float* __restrict__ f, float* __restrict__ g,
             double* __restrict__ work) {
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
  double fblk = 0.0;  // thread 0 of rank 0: this cluster's f sum, in tile order
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
      for (int r = 0; r < rows; ++r) fblk += fasta::loss_term<double>(loss, es[r]);
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
  const Scratch s = scratch_of(work, ncl);
  float* out = s.gpart + (size_t)cid * n + c0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int q = tid + c * kThreads;
    if (q < ng) V::st(out, q, gacc[c]);
  }
  if (tid == 0 && rank == 0) s.fpart[cid] = fblk;
  grid_end<kThreads>(work, ncl, n, loss, f, g);
}

// Route 4, rows wider than kClusterMax chunks.  A block takes row tiles of
// tm rows in the same round-robin order; the gradient pass reads the tile
// again.  A thread reads and writes only its own columns of the tile and
// of its block's row of the scratch, so only the row-dot reduction needs
// barriers.  The plan gives every block a tile.
template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads)
gradmap_rows_wide(const E* __restrict__ A, const float* __restrict__ x,
                  const float* __restrict__ b, int m, int n, int tm, int loss,
                  float* __restrict__ d, float* __restrict__ f, float* __restrict__ g,
                  double* __restrict__ work) {
  using V = Vec<E, VEC>;
  using T = typename V::S;
  __shared__ float red[kTileMax][kWarps];
  __shared__ float rs[kTileMax];
  __shared__ float es[kTileMax];

  const int tid = threadIdx.x;
  const int ng = n / VEC;
  const int ntiles = (m + tm - 1) / tm;
  const Scratch s = scratch_of(work, gridDim.x);
  float* gp = s.gpart + (size_t)blockIdx.x * n;

  double fblk = 0.0;  // thread 0: this block's f sum, in tile order
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
      const float sum = rs[tid];
      d[r0 + tid] = sum;
      fasta::loss_eval(loss, sum, __ldg(b + r0 + tid), rs[tid], es[tid]);
    }
    __syncthreads();
    if (tid == 0)
      for (int r = 0; r < rows; ++r) fblk += fasta::loss_term<double>(loss, es[r]);
    for (int q = tid; q < ng; q += kThreads) {
      typename V::X gq = first ? V::zero() : V::ld(gp, q);
      for (int r = 0; r < rows; ++r) gq = V::axpy(At[(size_t)r * ng + q], rs[r], gq);
      V::st(gp, q, gq);
    }
    first = false;
    __syncthreads();  // red, rs and es are rewritten by the next tile
  }
  if (tid == 0) s.fpart[blockIdx.x] = fblk;
  grid_end<kThreads>(work, gridDim.x, n, loss, f, g);
}

// --------------------------------------------------------------------------
// Plan and launch
// --------------------------------------------------------------------------

template <typename E>
using GroupsKernel = void (*)(const E*, const float*, const float*, int, int, int, float*, float*,
                              float*, double*);
template <typename E>
using RowsKernel = void (*)(const E*, const float*, const float*, int, int, int, int, int,
                            float*, float*, float*, double*);
template <typename E>
using WideKernel = void (*)(const E*, const float*, const float*, int, int, int, int, float*,
                            float*, float*, double*);

// Values of E per 16 bytes: the wide group when a row starts 16-byte
// aligned.
template <typename E>
constexpr int kWideVec = 16 / sizeof(E);

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Routes 1 and 2: the row group of the smallest size whose threads hold a
// row, and the column slots a thread — 16 floats of x a thread (16 values
// a group of one in a warp, 4 in a larger group).  0 past 8192 columns
// (2048 ragged).
int row_group(int ng, int vec) {
  for (int group = 32; group <= 512; group *= 4) {
    const int slots = vec == 1 ? (group == 32 ? 16 : 4) : 16 / vec;
    if (ng <= group * slots) return group;
  }
  return 0;
}

template <typename E>
GroupsKernel<E> pick_groups(int vec, int cpt, int group) {
  constexpr int v = kWideVec<E>;
  if (vec == v) {
    if (group == 32) {
      if (cpt == 1) return gradmap_groups<E, v, 1, 32>;
      if (cpt == 2) return gradmap_groups<E, v, 2, 32>;
      if constexpr (v == 4) {
        if (cpt == 4) return gradmap_groups<E, v, 4, 32>;
      }
    } else if (group == 128) {
      if constexpr (v == 8) {
        if (cpt == 1) return gradmap_groups<E, v, 1, 128>;
      }
      if (cpt == 2) return gradmap_groups<E, v, 2, 128>;
      if constexpr (v == 4) {
        if (cpt == 4) return gradmap_groups<E, v, 4, 128>;
      }
    } else if (group == 512) {
      if constexpr (v == 8) {
        if (cpt == 1) return gradmap_groups<E, v, 1, 512>;
      }
      if (cpt == 2) return gradmap_groups<E, v, 2, 512>;
      if constexpr (v == 4) {
        if (cpt == 4) return gradmap_groups<E, v, 4, 512>;
      }
    }
  } else if (vec == 1) {
    if (group == 32) {
      if (cpt == 1) return gradmap_groups<E, 1, 1, 32>;
      if (cpt == 2) return gradmap_groups<E, 1, 2, 32>;
      if (cpt == 4) return gradmap_groups<E, 1, 4, 32>;
      if (cpt == 8) return gradmap_groups<E, 1, 8, 32>;
      if (cpt == 16) return gradmap_groups<E, 1, 16, 32>;
    } else if (group == 512) {
      if (cpt == 2) return gradmap_groups<E, 1, 2, 512>;
      if (cpt == 4) return gradmap_groups<E, 1, 4, 512>;
    }
  }
  return nullptr;
}

// Route 3: the chunk width of a row of n values split over `cluster`
// blocks — a multiple of the wide group when n is, so that every chunk
// starts 16-byte aligned — and the column slots a thread that cover it.
template <typename E>
int chunk_width(int n, int cluster) {
  constexpr int v = kWideVec<E>;
  const int cw = (n + cluster - 1) / cluster;
  return n % v == 0 ? (cw + v - 1) / v * v : cw;
}

template <typename E>
int chunk_cpt(int n, int cw) {
  constexpr int v = kWideVec<E>;
  const int vec = n % v == 0 ? v : 1;
  const int cpt = pow2_at_least((cw / vec + kThreads - 1) / kThreads);
  const int most = vec == 1 ? 32 : (v == 4 ? 8 : 4);
  return cpt <= most ? cpt : 0;
}

template <typename E, bool CLUSTER>
RowsKernel<E> pick_chunk(int vec, int cpt) {
  constexpr int v = kWideVec<E>;
  if (vec == v) {
    if (cpt == 1) return gradmap_rows<E, v, 1, CLUSTER>;
    if (cpt == 2) return gradmap_rows<E, v, 2, CLUSTER>;
    if (cpt == 4) return gradmap_rows<E, v, 4, CLUSTER>;
    if constexpr (v == 4) {
      if (cpt == 8) return gradmap_rows<E, v, 8, CLUSTER>;
    }
    return nullptr;
  }
  if (cpt == 1) return gradmap_rows<E, 1, 1, CLUSTER>;
  if (cpt == 2) return gradmap_rows<E, 1, 2, CLUSTER>;
  if (cpt == 4) return gradmap_rows<E, 1, 4, CLUSTER>;
  if (cpt == 8) return gradmap_rows<E, 1, 8, CLUSTER>;
  if (cpt == 16) return gradmap_rows<E, 1, 16, CLUSTER>;
  if (cpt == 32) return gradmap_rows<E, 1, 32, CLUSTER>;
  return nullptr;
}

template <typename E>
RowsKernel<E> pick_rows(int n, int cluster, int cpt) {
  const int vec = n % kWideVec<E> == 0 ? kWideVec<E> : 1;
  return cluster == 1 ? pick_chunk<E, false>(vec, cpt) : pick_chunk<E, true>(vec, cpt);
}

template <typename E>
WideKernel<E> pick_wide(int n) {
  constexpr int v = kWideVec<E>;
  return n % v == 0 ? gradmap_rows_wide<E, v> : gradmap_rows_wide<E, 1>;
}

// dynamic shared memory of routes 1 and 2: route 1 its warps' shares,
// route 2 none
int groups_smem(int group, int n) {
  return group == 32 ? kRowBlock<32> / 32 * n * (int)sizeof(float) : 0;
}

// A cooperative launch, so that the CUDA driver holds every block of the grid
// on the card at once (the grid barrier of the end needs it) or refuses
// the launch, in clusters of `cluster` blocks (of one: no clusters).
// attr holds two attributes.
cudaLaunchConfig_t launch_config(int nblocks, int threads, int cluster, int smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  return cfg;
}

// The plan of an m×n call (the outputs of fasta_gradmap_plan, in order).
struct Plan {
  int route, cpt, threads, blocks, cluster, smem, tm, slots;
};

template <typename E>
cudaError_t plan(int m, int n, Plan* p) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr int v = kWideVec<E>;
  const int vec = n % v == 0 ? v : 1, ng = n / vec;
  const int group = row_group(ng, vec);
  if (group > 0) {  // routes 1 and 2
    const int cpt = pow2_at_least((ng + group - 1) / group);
    const GroupsKernel<E> fn = pick_groups<E>(vec, cpt, group);
    if (fn == nullptr) return cudaErrorInvalidConfiguration;
    const int threads = group < kRowThreads ? kRowThreads : group;
    const int rows = threads / group, smem = groups_smem(group, n);
    int active = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, (const void*)fn, threads, smem);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    // the grid barrier needs every block on the card at once
    const int per_sm = active < kBlocksPerSM ? active : kBlocksPerSM;
    const int slots = per_sm * sms;
    const int tr = rows_at_once(cpt, vec, threads);
    const long long step = (long long)rows * tr;
    const long long need = (m + step - 1) / step;
    *p = Plan{group == 32 ? 1 : 2, cpt, threads, (int)(need < slots ? need : slots), 1, smem, tr,
              slots};
    return cudaSuccess;
  }
  const int nc = (n + kChunkMax - 1) / kChunkMax;
  if (nc <= kClusterMax) {  // route 3
    const int cw = chunk_width<E>(n, nc), cpt = chunk_cpt<E>(n, cw);
    const RowsKernel<E> fn = pick_rows<E>(n, nc, cpt);
    if (fn == nullptr) return cudaErrorInvalidConfiguration;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, (const void*)fn);
    if (err != cudaSuccess) return err;
    if ((int)fa.sharedSizeBytes + kStreamBudget > optin) return cudaErrorInvalidConfiguration;
    // the cap is the budget, the same for every plan of the kernel
    err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStreamBudget);
    if (err != cudaSuccess) return err;
    const int row = cw * (int)sizeof(E);
    const int fit = kStreamBudget / (kStages * row);
    if (fit < 1) return cudaErrorInvalidConfiguration;
    const int t = fit < kTileMax ? fit : kTileMax;
    const int smem = kStages * row * t;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = launch_config(nc, kThreads, nc, smem, nullptr, attr);
    cfg.attrs = attr + 1;  // the query takes the cluster's shape alone
    cfg.numAttrs = 1;
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
    const int parts = active < ntiles ? active : ntiles;
    *p = Plan{3, cpt, kThreads, parts * nc, nc, smem, t, active};
    return cudaSuccess;
  }
  // route 4: a block an SM, each with its own scratch row, and ⌈m / SMs⌉
  // rows a tile up to kTileMax, so that short matrices still spread over
  // the SMs and no last round of tiles runs nearly empty
  const int per = (m + sms - 1) / sms;
  const int t = per < kTileMax ? per : kTileMax;
  const int ntiles = (m + t - 1) / t;
  *p = Plan{4, 0, kThreads, sms < ntiles ? sms : ntiles, 1, 0, t, sms};
  return cudaSuccess;
}

template <typename E>
cudaError_t launch(const E* A, const float* x, const float* b, int m, int n, int loss,
                   const Plan& p, float* d, float* f, float* g, double* work, cudaStream_t s) {
  constexpr int v = kWideVec<E>;
  const int vec = n % v == 0 ? v : 1;
  cudaLaunchAttribute attr[2];
  cudaError_t err;
  if (p.route == 1 || p.route == 2) {
    const int group = p.route == 1 ? 32 : p.threads;
    const GroupsKernel<E> fn = pick_groups<E>(vec, p.cpt, group);
    if (fn == nullptr || p.threads != (group < kRowThreads ? kRowThreads : group) ||
        p.cluster != 1 || p.smem != groups_smem(group, n) ||
        p.tm != rows_at_once(p.cpt, vec, p.threads))
      return cudaErrorInvalidValue;
    const cudaLaunchConfig_t cfg = launch_config(p.blocks, p.threads, 1, p.smem, s, attr);
    err = cudaLaunchKernelEx(&cfg, fn, A, x, b, m, n, loss, d, f, g, work);
  } else if (p.route == 3) {
    const RowsKernel<E> fn = pick_rows<E>(n, p.cluster, p.cpt);
    if (fn == nullptr || p.cluster < 1 || p.cluster > kClusterMax ||
        p.cluster != (n + kChunkMax - 1) / kChunkMax || p.blocks % p.cluster ||
        p.tm < 1 || p.tm > kTileMax || p.threads != kThreads)
      return cudaErrorInvalidValue;
    const cudaLaunchConfig_t cfg =
        launch_config(p.blocks, kThreads, p.cluster, p.smem, s, attr);
    err = cudaLaunchKernelEx(&cfg, fn, A, x, b, m, n, p.tm, chunk_width<E>(n, p.cluster), loss,
                             d, f, g, work);
  } else if (p.route == 4) {
    if (p.tm < 1 || p.tm > kTileMax || p.cluster != 1 || p.threads != kThreads ||
        (long long)(p.blocks - 1) * p.tm >= m)
      return cudaErrorInvalidValue;
    const cudaLaunchConfig_t cfg = launch_config(p.blocks, kThreads, 1, 0, s, attr);
    err = cudaLaunchKernelEx(&cfg, pick_wide<E>(n), A, x, b, m, n, p.tm, loss, d, f, g, work);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// Plan an m×n call on the current device for A stored as float32 (bf16 =
// 0) or bfloat16 (bf16 = 1): the route (1 warp rows, 2 block rows, 3
// streamed tiles over clusters, 4 wide tiles), the column slots a thread
// (route 4: 0), the threads a block, the blocks, the cluster size (1 but
// on route 3), the dynamic shared bytes, the rows a group takes at once
// (routes 1 and 2) or a tile holds (3 and 4), and the slots the plan was
// sized to (routes 1 and 2: blocks the card holds at once, at most
// kBlocksPerSM an SM; route 3: clusters of the route's size, or blocks
// without clusters; route 4: SMs).
extern "C" int fasta_gradmap_plan(int m, int n, int bf16, int* route, int* cpt, int* threads,
                                  int* nblocks, int* cluster, int* smem_bytes, int* tm,
                                  int* slots) {
  if (m < 1 || n < 1) return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = bf16 ? plan<__nv_bfloat16>(m, n, &p) : plan<float>(m, n, &p);
  if (err != cudaSuccess) return err;
  *route = p.route;
  *cpt = p.cpt;
  *threads = p.threads;
  *nblocks = p.blocks;
  *cluster = p.cluster;
  *smem_bytes = p.smem;
  *tm = p.tm;
  *slots = p.slots;
  return cudaSuccess;
}

// One launch on `stream` for the loss code `loss` (losses.cuh; b holds the
// measurements or labels), A float32 (bf16 = 0) or bfloat16 (bf16 = 1), on
// a plan of fasta_gradmap_plan's form; work is the stream's scratch
// (kernels/lstsq_fused.py, gradmap_plan, sizes it), its first word zero.
// Every plan ends by a grid barrier: its blocks must fit the card at once.
extern "C" int fasta_gradmap(const void* A, const float* x, const float* b, int m, int n,
                             int bf16, int loss, int route, int cpt, int threads, int nblocks,
                             int cluster, int smem_bytes, int tm, float* d, float* f, float* g,
                             double* work, void* stream) {
  if (m < 1 || n < 1 || nblocks < 1 || work == nullptr || loss < fasta::kLstsq ||
      loss > fasta::kSquaredHinge)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p{route, cpt, threads, nblocks, cluster, smem_bytes, tm, 0};
  return bf16 ? launch(static_cast<const __nv_bfloat16*>(A), x, b, m, n, loss, p, d, f, g, work,
                       s)
              : launch(static_cast<const float*>(A), x, b, m, n, loss, p, d, f, g, work, s);
}

extern "C" const char* fasta_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
