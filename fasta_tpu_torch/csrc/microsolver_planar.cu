// K-B8: the whole planar PhaseMax FASTA solve in one launch,
//     min_x  ½ Σᵢ max(|(A x)ᵢ| − bᵢ, 0)²  −  ⟨c, x⟩,   prox(z, τ) = z + τ·c,
// A = Ar + i·Ai complex (m, n) in planar layout, x and c (n, 2), b (m,)
// magnitudes, float32, in adaptive (BB) or FISTA mode, for one instance
// (K-B8) or a batch of instances sharing A, each with its own b, x₀ and
// τ₀ and with one shared c or its own (K-B8b).
//
// Replaces: fasta_tpu/kernels/microsolver_planar.py,
// microsolve_planar_phasemax (pallas_call at :669), body _make_kernel —
// the TPU kernel that pins the transposed channel matrices in VMEM and
// runs the loop on one core; K-B8b replaces it under jax.vmap
// (fasta_tpu/micro.py:435).
//
// Bound on this card: operations and latency.  A trial does 16·m·n
// operations on the rows; the phases depend on one another through
// grid-wide barriers and decisions, whose floor a tiny shape measures
// (tools/planar_split.py; the times are in PERF.md).  As the TPU kernel
// pins the channel matrices in VMEM, every route but the column fallback
// keeps them on the chip for the whole launch.  That buys less than the
// reads' size suggests, because the row work is bound by the instructions
// a row takes, not by its bytes: PERF.md prices a plan that streams most
// of A from L2 against the one that keeps it all on the chip.
//
// The tile plan (kernels/microsolver_planar.py, tile_plan) reaches the
// kernel as a (4, nblocks) int32 table: block k owns the band of rows
// [r0, r1) and keeps its first nreg rows in registers and the next nsm in
// shared memory for the whole launch; the rest of its band (the streamed
// remainder) it reads from L2 once a trial, each thread with its own
// 16-byte loads as it comes to a row (a step of the wide rows puts up to
// 24 rows in flight at once).  There is no cp.async ring for them: one
// deep enough to hide L2's latency would take the shared memory of
// resident rows, and the streamed loads cost little (PERF.md, the
// streamed sweep of tools/planar_split.py).  The plan's three routes run
// three kernels:
//  * microsolve_planar_kernel, n ≤ 2048 (padded to a multiple of 4): the
//    n-sized state in every block's shared memory; up to 512 a warp a row
//    (the route for n ≤ 512), past it a row spread over the block's
//    threads (the wide rows below);
//  * microsolve_planar_wide_kernel, 2048 < n ≤ 8192 (the wide route with
//    microsolve_planar_kernel below it): the n-sized state in device
//    memory, the wide rows;
//  * microsolve_planar_columns_kernel past 8192 (the column fallback),
//    nothing of A on the chip, rows and columns in two passes.
// Each kernel's note follows below.  Common to all three:
//  * One persistent cooperative launch, one block of 512 threads per SM.
//  * The grid barrier is grid_barrier.cuh's (1.09 µs against grid.sync's
//    1.21, K-P1), its counter and exit ticket in the wrapper's stream
//    scratch, left at zero by the last block out (grid_exit): no memset a
//    call.
//  * Every n-sized sum is a fixed-order partial per block, reduced over
//    blocks in a fixed order, so every block takes bit-identical
//    decisions (fbs_control.cuh); with hp, f, the window, ⟨Δx,g⟩,
//    ⟨Δx,Δg⟩ and (restart_dd) the restart dot accumulate in FP64, as in
//    K-B1.  No atomics on values: two runs give the same bits.  The order
//    of every sum is fixed by the band, never by where a row lies, so a
//    plan that streams more rows gives the same bits.
//  * K-B8b runs the instances in turn inside the launch, each over the
//    whole grid as K-B8 runs its one (Points in fbs_control.cuh:
//    per-instance b, x₀ and τ₀; A shared and staged on the chip once a
//    launch; c shared, staged once a launch, or one an instance, staged
//    at the instance's start, at c + p·c_stride).  A grid barrier
//    separates instances, after which start_point resets the window, τ,
//    the counts and the halt code, so each instance is bit-identical to
//    its own K-B8 launch.
//  * Storage: the public split (Ar, Ai) row-major layout, which K-P5
//    measured fastest on the H100 (PERF.md); ragged n is padded to a
//    multiple of 4 with zero columns by the wrapper (zero columns of A, x
//    and c stay zero through the solve).
//  * Elementwise formulas use the _rn intrinsics, so they round like the
//    plain PyTorch version's separate operations.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "fbs_control.cuh"
#include "grid_barrier.cuh"
#include "losses.cuh"
#include "planar_rows.cuh"
#include "reduce.cuh"

using namespace fasta;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChains = kWarps;       // chains per column of a reduction over blocks
constexpr bool kInterleaved = false;  // K-P5's decision: the split layout
constexpr int kNarrowMax = 512;       // the widest n4 of microsolve_planar_kernel
constexpr int kWideMax = 8192;        // the widest n4 of microsolve_planar_wide_kernel
constexpr int kGw = 8;                // gradient buffers of a narrow block
constexpr int kRegRows = 32;          // rows a narrow block keeps in registers (n4 ≤ 256)
constexpr int kBatchRows = 8;         // wide rows: the most rows a row lane takes at a time
constexpr int kBandMax = 1024;        // the most rows of b a block stages in shared memory
constexpr int kStepRows = 24;         // the most rows a step of the wide rows takes (R·8 at S = 1)
constexpr int kStateMax = 2048;       // the widest n4 whose n-sized state every block keeps
constexpr int kChunks = 2 * kStateMax / 32;  // column chunks of g in microsolve_planar_kernel

// the kernels, as the wrapper names them
enum Route { kRouteRows, kRouteWide, kRouteColumns };

struct Args {
  const float* A0;   // Ar (m, n4)
  const float* A1;   // Ai (m, n4)
  Points pts;        // each instance's b (m,), cold x₀ (n4, 2) and τ₀
  const float* c;    // (n4, 2): instance p's anchor at c + p·c_stride
  long long c_stride;
  float* x_out;      // (npoints, n, 2)
  Records rec;
  float* its;        // (npoints, max_iters, n, 2) or null
  int* k_out;        // (npoints,)
  int* status_out;   // (npoints,)
  const int* tiles;  // (4, nblocks): first row, end row, rows in registers, rows in shared memory
  unsigned* bar;     // grid_barrier's counter and grid_exit's ticket, zero at launch
  float* gpart;      // (nblocks, 2·n4) the blocks' shares of Aᴴℓ (rows and wide)
  float* gvec;       // (2·n4,) the reduced g (rows)
  double* ftot;      // the reduced f of the last trial, beside g (rows)
  double* bbp;       // (kChunks, 2): each column chunk's BB sums ⟨Δx,Δg⟩, ‖Δg‖² (rows)
  float* X[2];       // (2·n4,) each, [xr | xi]; FISTA: y and x₁ (wide, columns)
  float* G[2];       // (2·n4,) each: g at X[k] (wide, columns)
  float* xacc;       // (2·n4,) FISTA: x_acc (wide, columns)
  float* lbuf;       // (m, 2) the rows' weights ℓ (columns)
  float* dbuf;       // (m, 2) FISTA: d₁ of the trial
  float* dacc;       // (m, 2) FISTA: A x_acc
  double* part;      // (3, kSlots, nblocks)
  Control ctl;
  int npoints, m, n, n4, rdd;
};

// What a pass over the rows does on each owned row.
enum Pass {
  kStart,     // d = A x, hinge, f, Aᴴℓ; FISTA: d_acc = d
  kAdaptive,  // d = A x₁, hinge, f, Aᴴℓ
  kFista,     // d = A x₁, hinge, f; d₁ stored
  kExtrap     // d_n = d₁ + β(d₁ − d_acc), d_acc = d₁, hinge, f, Aᴴℓ
};

// A block's rows: its band [r0, r0 + rows) of A, the first nreg kept in
// registers, the next nsm in shared memory, the rest read from L2.
struct Tile {
  int r0, rows, nreg, nsm;
};

__device__ __forceinline__ Tile tile_of(const int* tiles, int nb, int blk) {
  Tile t;
  t.r0 = __ldg(tiles + blk);
  t.rows = __ldg(tiles + nb + blk) - t.r0;
  t.nreg = __ldg(tiles + 2 * nb + blk);
  t.nsm = __ldg(tiles + 3 * nb + blk);
  return t;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 add4(float4 u, float4 v) {
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

// x₁ = (x − τg) + τc at one entry, rounded like the plain version's steps
__device__ __forceinline__ float trial_at(float x, float g, float c, float tau) {
  return __fadd_rn(step_hat(x, g, tau), __fmul_rn(tau, c));
}

// Copies `count` rows of A from row i0 into dst, each as [Ar row | Ai row]
// (2·n4 floats), and waits for the block.
__device__ void stage_rows(const Args& a, int i0, int count, float* dst) {
  const int nq = a.n4 / 4, per = 2 * nq;
  for (int e = threadIdx.x; e < count * per; e += kThreads) {
    const int l = e / per, q = e - l * per;
    const float* row = (q < nq ? a.A0 : a.A1) + (size_t)(i0 + l) * a.n4;
    reinterpret_cast<float4*>(dst)[e] =
        __ldg(reinterpret_cast<const float4*>(row) + (q < nq ? q : q - nq));
  }
  __syncthreads();
}

// Sums over the block of N values at once; every thread gets them (the
// column fallback).
template <typename T, int N>
__device__ __forceinline__ void block_sums(T (&v)[N], T (*scratch)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k][warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T t = T(0);
    for (int w = 0; w < kWarps; ++w) t += scratch[k][w];
    v[k] = t;
  }
}

// Sum of `count` doubles in global memory (per-block partials written
// before a grid barrier) in T by one warp: lane l adds entries l, l + 32,
// … in order, as warp_sum_global does, with eight loads a lane in flight
// at once; the result is valid in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum_blocks(const double* p, int count) {
  const int lane = threadIdx.x & 31;
  T v = T(0);
  for (int i0 = 0; i0 < count; i0 += 32 * 8) {
    double u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + lane + 32 * k;
      u[k] = i < count ? __ldcg(p + i) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v += static_cast<T>(u[k]);
  }
  return warp_sum(v);
}

// The block's sum of v, valid in thread 0: the warps' shuffle trees, one
// barrier, then warp 0's tree over the warps' sums.
template <typename T>
__device__ __forceinline__ T block_total(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp == 0 ? warp_sum(lane < kWarps ? scratch[lane] : T(0)) : T(0);
}

// Sums over the block of NF floats and NA values of type T at once: the
// warps' shuffle trees, one barrier, then warp k < NF + NA adds the warps'
// sums of the k-th value (the floats first) by a shuffle tree.  Lane 0 of
// warp k returns that total as a double; every other thread 0.  No thread
// may write fs or ts again before the block has passed another barrier.
template <int NF, int NA, typename T>
__device__ __forceinline__ double block_sums_warp(float (&f)[NF], T (&t)[NA], float* fs, T* ts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  double r = 0.0;
  if (warp < NF)
    r = warp_sum(lane < kWarps ? fs[lane * NF + warp] : 0.f);
  else if (warp < NF + NA)
    r = double(warp_sum(lane < kWarps ? ts[lane * NA + warp - NF] : T(0)));
  return lane == 0 ? r : 0.0;
}

// Σ over blocks of their shares at entry j of gpart (row stride N2),
// chain c adding blocks c, c + kChains, … in order with up to 16 loads in
// flight at once.
__device__ __forceinline__ float chain_sum(const float* gpart, int N2, int nb, int chain, int j) {
  float s = 0.f;
  for (int p0 = chain; p0 < nb; p0 += 16 * kChains) {
    float u[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int p = p0 + kChains * k;
      u[k] = p < nb ? __ldcg(gpart + (size_t)p * N2 + j) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) s += u[k];
  }
  return s;
}

// The block's band of b (rows r0 … r0 + rows), staged in bsh when it
// holds at most kBandMax rows (no barrier: the caller's follows), else
// read where it lies; either way indexed by the band's row.
__device__ __forceinline__ const float* stage_b(const float* bp, const Tile& t, float* bsh) {
  if (t.rows > kBandMax) return bp + t.r0;
  for (int l = threadIdx.x; l < t.rows; l += kThreads) bsh[l] = __ldg(bp + t.r0 + l);
  return bsh;
}

// ---------------------------------------------------------------------------
// microsolve_planar_kernel: the route for n ≤ 512, and with the wide rows
// (below) the wide route up to n = 2048.
//  * Every block keeps the whole n-sized state in shared memory — x
//    (FISTA: y), g, the trial x₁, c and FISTA's x_acc — and computes the
//    prox step z + τc and every n-sized sum itself, in the same order as
//    every other block: no barrier for the prox step.
//  * The block's band stays on the chip: at n4 ≤ 256 warp w keeps its
//    first two rows (w and w + 16 of the band) in registers, 32 rows a
//    block; the next rows, as many as the plan's budget holds, sit in
//    shared memory ([Ar row | Ai row] each); the rest of the band, if any,
//    each warp reads from L2 with its own 16-byte loads when it comes to
//    it, while the other warps work on rows on the chip.  At 16384×256
//    (124–125 rows a block) the whole band stays on the chip.
//  * A warp owns the band's rows w, w + 16, w + 32, … in order, two at a
//    time (one at n4 > 256): lane l holds the float4 column slots l + 32s
//    (planar_rows.cuh) of each, forms its share of the group's row dots,
//    and one transposed reduction (transpose_sum) leaves each row's
//    (A x)ᵢ with a 16-lane group, which applies the hinge once for the
//    group's rows; the weights ℓ reach every lane by a shuffle and the
//    lanes add the rows' shares of Aᴴℓ from the values they loaded.  The
//    row work is bound by instructions (see above): a butterfly of ten
//    shuffles and a hinge for every row cost more issue slots than the
//    row's 64 multiply-adds a slot pair; one reduction of six shuffles
//    and one hinge serve a group of two rows.
//  * The warps' shares meet in eight buffers in shared memory (warps
//    8–15 store, 0–7 add: 16 KB at n4 = 256, where sixteen took 32 KB of
//    what now holds rows); each block writes one (2n,) share, and after a
//    barrier the blocks reduce those shares column by column (16 chains
//    per column, all loads in flight, fixed order) into g; the blocks
//    that reduce a chunk of 32 columns also take its BB sums there, and
//    the last block sums the f partials meanwhile, so the second barrier
//    publishes g, f and the BB sums at once: every block copies g while
//    warp 0 decides.  b for the band sits in shared memory.
//  * The step's sums need no other block: they run between the halves of
//    the first barrier (grid_arrive, grid_wait), while the other blocks
//    finish their rows.
//  * Grid barriers per adaptive trial: 2 (publish the row partials; the
//    reduced g).  FISTA: 1 per trial (the trials need only f) plus 2 per
//    acceptance (the extrapolated d_n = d₁ + β(d₁ − d_acc) on the owned
//    rows with its adjoint, A being linear; the reduced g_n).
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int rows_in_flight(int cpt) { return cpt <= 2 ? 2 : 1; }
static_assert(rows_in_flight(2) * kWarps == kRegRows, "a warp keeps its first group of rows");

// The sums over the warp of V = 2^k values at once (V ≤ 16): halving
// steps hand half of a lane's values to the lane `o` away (o = 16, 8, …)
// and keep the other half, until each lane holds one value — value
// L >> (5 − k) in lane L — which the lanes that share it complete by a
// butterfly; every lane gets the bits its partners get.  2V − 2 shuffles
// where V separate butterflies take 5V.
template <int V>
__device__ __forceinline__ float transpose_sum(float (&v)[V]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = V, o = 16; c > 1; c >>= 1, o >>= 1) {
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < c / 2; ++i) {
      const float send = hi ? v[i] : v[c / 2 + i];
      const float keep = hi ? v[c / 2 + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = 16 / V; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// A group of a warp's rows l0 + u·kWarps (u < TM): the lanes hold their
// values (va, vc), lane l the float4 column slots l + 32s; after the
// group's transposed reduction the lanes of row u, a kGroup-lane group,
// hold its (A x)ᵢ.
template <int CPT>
struct Group {
  static constexpr int TM = rows_in_flight(CPT);
  static constexpr int kShift = TM == 2 ? 3 : 4;  // lane bit of the component
  static constexpr int kGroup = 2 << kShift;      // lanes a row
};

// This lane's row of the group at l0: (pr, pi) = (A x)ᵢ from the 2·TM row
// dots with x = [xr | xi] in shared memory, met in one transpose_sum; on
// kExtrap, d_n = d₁ + β(d₁ − d_acc) instead, with d_acc = d₁ stored.
template <int CPT, int PASS>
__device__ __forceinline__ void group_values(const Args& a, const Tile& t, int l0,
                                             const float* x, float beta,
                                             const float4 (&va)[rows_in_flight(CPT)][CPT],
                                             const float4 (&vc)[rows_in_flight(CPT)][CPT],
                                             float& pr, float& pi) {
  using Gr = Group<CPT>;
  constexpr int TM = Gr::TM;
  const int lane = threadIdx.x & 31, n4 = a.n4, nq = n4 / 4;
  const int l = l0 + lane / Gr::kGroup * kWarps, i = t.r0 + l;
  const bool valid = l < t.rows;
  if (PASS == kExtrap) {
    float d1r = 0.f, d1i = 0.f, dar = 0.f, dai = 0.f;
    if (valid) {
      d1r = __ldcg(a.dbuf + 2 * i);
      d1i = __ldcg(a.dbuf + 2 * i + 1);
      dar = __ldcg(a.dacc + 2 * i);
      dai = __ldcg(a.dacc + 2 * i + 1);
    }
    pr = __fadd_rn(d1r, __fmul_rn(beta, __fsub_rn(d1r, dar)));
    pi = __fadd_rn(d1i, __fmul_rn(beta, __fsub_rn(d1i, dai)));
    __syncwarp();
    if (valid && lane % Gr::kGroup == 0) {
      a.dacc[2 * i] = d1r;
      a.dacc[2 * i + 1] = d1i;
    }
    return;
  }
  float d[2 * TM];
#pragma unroll
  for (int k = 0; k < 2 * TM; ++k) d[k] = 0.f;
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int q = lane + 32 * s;
    const float4 xr = q < nq ? reinterpret_cast<const float4*>(x)[q] : zero4();
    const float4 xi = q < nq ? reinterpret_cast<const float4*>(x + n4)[q] : zero4();
#pragma unroll
    for (int w = 0; w < TM; ++w) slot_dot(va[w][s], vc[w][s], xr, xi, d[2 * w], d[2 * w + 1]);
  }
  const float mine = transpose_sum<2 * TM>(d);
  const float other = __shfl_xor_sync(0xffffffffu, mine, 1 << Gr::kShift);
  const bool im = (lane >> Gr::kShift) & 1;
  pr = im ? other : mine;
  pi = im ? mine : other;
}

// The hinge on this lane's row of the group at l0 (bb the band's b), once
// for the group's rows: the weight (lr, li), and from the row's first
// lane f's term and the stored d₁ (kFista) or d_acc (kStart).
template <typename Acc, int CPT, int PASS>
__device__ __forceinline__ void group_hinge(const Args& a, const Tile& t, const float* bb, int l0,
                                            float pr, float pi, float& lr, float& li,
                                            Acc& fsum) {
  using Gr = Group<CPT>;
  const int lane = threadIdx.x & 31;
  const int l = l0 + lane / Gr::kGroup * kWarps, i = t.r0 + l;
  const bool valid = l < t.rows;
  float r;
  phase_hinge(pr, pi, valid ? bb[l] : 0.f, lr, li, r);
  if (valid && lane % Gr::kGroup == 0) {
    fsum += Acc(r) * Acc(r);
    if (PASS == kFista) {
      a.dbuf[2 * i] = pr;
      a.dbuf[2 * i + 1] = pi;
    }
    if (PASS == kStart && a.dacc != nullptr) {
      a.dacc[2 * i] = pr;
      a.dacc[2 * i + 1] = pi;
    }
  }
}

// The group's share of Aᴴℓ, each row's weight from its first lane (an
// invalid row's weight is zero, its values too).
template <int CPT>
__device__ __forceinline__ void group_grad(const float4 (&va)[rows_in_flight(CPT)][CPT],
                                           const float4 (&vc)[rows_in_flight(CPT)][CPT], float lr,
                                           float li, float4 (&gr)[CPT], float4 (&gi)[CPT]) {
  using Gr = Group<CPT>;
#pragma unroll
  for (int w = 0; w < Gr::TM; ++w) {
    const float wr = __shfl_sync(0xffffffffu, lr, w * Gr::kGroup);
    const float wi = __shfl_sync(0xffffffffu, li, w * Gr::kGroup);
#pragma unroll
    for (int s = 0; s < CPT; ++s) slot_grad(va[w][s], vc[w][s], wr, wi, gr[s], gi[s]);
  }
}

// The values of a warp's rows l0 + u·kWarps past its register rows: from
// shared memory (sA, the band's rows nreg…nreg + nsm) or from L2.
template <int CPT>
__device__ __forceinline__ void load_group(const Args& a, const Tile& t, const float* sA, int l0,
                                           float4 (&va)[rows_in_flight(CPT)][CPT],
                                           float4 (&vc)[rows_in_flight(CPT)][CPT]) {
  constexpr int TM = rows_in_flight(CPT);
  const int lane = threadIdx.x & 31, n4 = a.n4, nq = n4 / 4;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int l = l0 + u * kWarps;
    const float4* srow = reinterpret_cast<const float4*>(sA + (size_t)(l - t.nreg) * 2 * n4);
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int q = lane + 32 * s;
      if (l < t.rows && q < nq) {
        if (l < t.nreg + t.nsm) {
          va[u][s] = srow[q];
          vc[u][s] = srow[nq + q];
        } else {
          load_slot<kInterleaved>(a.A0, a.A1, n4, t.r0 + l, q, va[u][s], vc[u][s]);
        }
      } else {
        va[u][s] = vc[u][s] = zero4();
      }
    }
  }
}

// One pass over the block's band (see Pass), x = [xr | xi] in shared
// memory (unused by kExtrap), bb the band's b, (ra, rc) the warp's
// register rows.  Returns the block's Σr² in Acc (valid in thread 0);
// with the adjoint, writes the block's (2·n4,) share of Aᴴℓ to gpart
// through gw.  (Three groups at a time — their values, then their
// hinges, then their adjoint from the values loaded again, so that the
// groups' dependent chains overlap — spilled 128 bytes a thread and took
// 12.9 µs an iteration at 16384×256 against 10.2, tools/planar_split.py.)
template <typename Acc, int CPT, int PASS>
__device__ __forceinline__ Acc rows_pass(const Args& a, const Tile& t, const float* sA,
                                         const float* bb, const float* x, float beta, float* gw,
                                         Acc* acc_scratch,
                                         const float4 (&ra)[rows_in_flight(CPT)][CPT],
                                         const float4 (&rc)[rows_in_flight(CPT)][CPT]) {
  constexpr bool kAdj = PASS != kFista;
  constexpr bool kReg = CPT <= 2;
  constexpr int TM = rows_in_flight(CPT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n4 = a.n4, nq = n4 / 4, N2 = 2 * n4;
  float4 gr[CPT], gi[CPT];
#pragma unroll
  for (int s = 0; s < CPT; ++s) gr[s] = gi[s] = zero4();
  Acc fsum = Acc(0);
  int l0 = warp;
  if (kReg && t.nreg > 0) {  // the first group: the rows in registers
    float pr, pi, lr, li;
    group_values<CPT, PASS>(a, t, l0, x, beta, ra, rc, pr, pi);
    group_hinge<Acc, CPT, PASS>(a, t, bb, l0, pr, pi, lr, li, fsum);
    if (kAdj) group_grad<CPT>(ra, rc, lr, li, gr, gi);
    l0 += TM * kWarps;
  }
  for (; l0 < t.rows; l0 += TM * kWarps) {  // uniform per warp
    float4 va[TM][CPT], vc[TM][CPT];
    float pr, pi, lr, li;
    load_group<CPT>(a, t, sA, l0, va, vc);
    group_values<CPT, PASS>(a, t, l0, x, beta, va, vc, pr, pi);
    group_hinge<Acc, CPT, PASS>(a, t, bb, l0, pr, pi, lr, li, fsum);
    if (kAdj) group_grad<CPT>(va, vc, lr, li, gr, gi);
  }
  fsum = block_total(fsum, acc_scratch);
  if (kAdj) {
    // the warps' shares into the block's: warps 8–15 store theirs in the
    // kGw buffers, then warps 0–7 add theirs
    for (int round = kWarps / kGw - 1; round >= 0; --round) {
      if (warp / kGw == round) {
        float4* dst = reinterpret_cast<float4*>(gw + (warp % kGw) * N2);
#pragma unroll
        for (int s = 0; s < CPT; ++s) {
          const int q = lane + 32 * s;
          if (q < nq) {
            const bool first = round == kWarps / kGw - 1;
            dst[q] = first ? gr[s] : add4(dst[q], gr[s]);
            dst[nq + q] = first ? gi[s] : add4(dst[nq + q], gi[s]);
          }
        }
      }
      __syncthreads();
    }
    float* out = a.gpart + (size_t)blockIdx.x * N2;
    for (int j = tid; j < N2; j += kThreads) {
      float s = gw[j];
      for (int w = 1; w < kGw; ++w) s += gw[w * N2 + j];
      out[j] = s;
    }
  }
  return fsum;
}

// After a grid barrier: g = Σ over blocks of their shares, each column by
// kChains chains (a warp each, lanes on neighbouring columns, all loads
// of a chain in flight) in a fixed order, into gvec; meanwhile the last
// block's last warp sums the blocks' f partials fp into ftot, so that the
// next barrier publishes f with g.  With BB (the adaptive trial) the
// warp that finishes a chunk of 32 columns also takes the chunk's BB sums
// from x (xc), its gradient gc and the trial x₁ (all in the block's
// shared memory) at stepsize tau, and publishes them in bbp.
template <typename Acc, bool BB>
__device__ __forceinline__ void reduce_shares(const Args& a, const double* fp, float (*red)[32],
                                              const float* xc, const float* gc, const float* x1,
                                              float tau) {
  const int tid = threadIdx.x, lane = tid & 31, chain = tid >> 5;
  const int N2 = 2 * a.n4, nb = gridDim.x;
  if ((int)blockIdx.x == nb - 1 && chain == kWarps - 1) {
    const Acc f = warp_sum_blocks<Acc>(fp, nb);
    if (lane == 0) *a.ftot = double(f);
  }
  for (int c0 = blockIdx.x * 32; c0 < N2; c0 += nb * 32) {  // uniform per block
    const int j = c0 + lane;
    red[chain][lane] = j < N2 ? chain_sum(a.gpart, N2, nb, chain, j) : 0.f;
    __syncthreads();
    if (chain == 0) {
      float g = 0.f;
      for (int k = 0; k < kChains; ++k) g += red[k][lane];
      if (j < N2) a.gvec[j] = g;
      if (BB) {
        Acc w = Acc(0);
        float v = 0.f;
        if (j < N2) {
          const float xv = xc[j];
          const float z = step_hat(xv, gc[j], tau);
          const float dx = __fsub_rn(x1[j], xv);
          // Δg = g₁ + (x̂₁ − x)/τ  (== g₁ − g, in the TPU kernel's rounding)
          const float dg = __fadd_rn(g, __fdiv_rn(__fsub_rn(z, xv), tau));
          w = Acc(dx) * Acc(dg);
          v = dg * dg;
        }
        w = warp_sum(w);
        v = warp_sum(v);
        if (lane == 0) {
          a.bbp[2 * (c0 / 32)] = double(w);
          a.bbp[2 * (c0 / 32) + 1] = double(v);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The wide rows (rows_wide, past n = 512) and microsolve_planar_wide_kernel
// (2048 < n ≤ 8192).
//  * Rows: the block's band stays in shared memory as far as the plan's
//    budget holds it ([Ar row | Ai row] each, 8 KB a row at n = 1024); the
//    rest of the band each thread reads from L2 as it comes to it.  A row
//    is spread over the block: tg threads (whole warps, tg = the row's
//    float4 slots rounded up to a warp, at most 512) side by side on its
//    columns, R = 512 / tg row lanes each taking the band's rows rl, rl +
//    R, … in order, a thread holding S ≤ 4 slots of its share of g in
//    registers.  A row lane takes 8 rows at a time (4 / S at S > 1): each
//    thread loads their slots once and forms its share of each row dot;
//    the warps' sums meet in shared memory; one thread a row adds them in
//    warp order and applies the hinge (every thread of the row doing so
//    took 12.2 µs a trial at 2048×1024 against 10.5, tools/planar_split.py);
//    after a second block barrier the row lanes read the weights and add
//    Aᴴℓ from the values they hold — one read of A a pass, from shared
//    memory.  The row lanes' shares of g meet in shared memory in lane
//    order and the block writes one (2n,) share.
//  * Up to n = 2048 microsolve_planar_kernel runs these rows beside the
//    n-sized state in shared memory.  Past it that state no longer fits
//    beside the rows, so microsolve_planar_wide_kernel keeps x (FISTA: y),
//    g, the trial x₁ and x_acc in device memory (in L2), each block owning
//    a contiguous range of column groups (4 columns each) for the prox
//    step, its sums and the BB sums; x₁ = (x − τg) + τc, which every row
//    needs whole, is formed once a block into shared memory from x and g
//    in L2.
//  * After a barrier each block reduces its own columns over the blocks'
//    shares (16 chains per column, fixed order) into g₁ and takes the BB
//    sums there; after a second barrier every block reduces the same
//    partials and decides.  Grid barriers per adaptive trial: 2 (the
//    column route took 3), the prox step on the own columns and its sums
//    between the halves of the first; FISTA: 1 per trial plus 2 per
//    acceptance (the column route: 2 and 1).
// ---------------------------------------------------------------------------

// Column and row lanes at width n4: tg threads on a row's float4 slots
// (whole warps), R row lanes, S slots a thread.
struct Lanes {
  int tg, R, S;
};

__host__ __device__ constexpr Lanes lanes_of(int n4) {
  const int nq = n4 / 4;
  const int w = (nq + 31) / 32 * 32;
  const int tg = w < kThreads ? w : kThreads;
  return Lanes{tg, kThreads / tg, (nq + tg - 1) / tg};
}

// past kStateMax (microsolve_planar_wide_kernel) a thread takes two or
// four slots of a row, never one
static_assert(lanes_of(kStateMax + 4).S == 2 && lanes_of(kWideMax).S == 4,
              "the wide kernel's widths take S = 2 or 4");

// the scratch a wide block keeps beside its rows: x₁, then the row lanes'
// shares of g (R − 1 of them), in floats
__host__ __device__ inline int wide_scratch(int n4) {
  const int R = lanes_of(n4).R;
  return 2 * n4 * (R > 2 ? R - 1 : 1);
}

// One pass over the block's band (see Pass) with a row spread over the
// block, bb the band's b.  With STAGE (n-sized state in device memory) x₁
// is formed from xs, gs and the anchor c at stepsize tau (kStart: xs
// itself) into the scratch, whence each thread reads its slots as it
// needs them; without, xs is x₁ in shared memory already.  kExtrap takes no dot.  The row
// lanes' shares meet in the scratch.  Returns the block's Σr² in Acc (valid in
// thread 0); with the adjoint, writes the block's (2·n4,) share of Aᴴℓ to
// gpart.
template <typename Acc, int S, int PASS, bool STAGE>
__device__ __forceinline__ Acc rows_wide(const Args& a, const Tile& t, const float* sA,
                                         const float* bb, const float* xs, const float* gs,
                                         const float* c, float tau, float beta, float* scratch,
                                         Acc* acc_scratch,
                                         float2 (*rowred)[kBatchRows][kWarps], float2* lrow) {
  constexpr int TB = S == 1 ? kBatchRows : 4 / S;  // rows a lane takes at a time
  constexpr bool kAdj = PASS != kFista;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n4 = a.n4, nq = n4 / 4, N2 = 2 * n4;
  const Lanes ln = lanes_of(n4);
  const int rl = tid / ln.tg, gl = tid - rl * ln.tg, wpr = ln.tg / 32;
  const bool active = rl < ln.R;
  float4* sx = reinterpret_cast<float4*>(scratch);
  if (STAGE && PASS != kExtrap) {
    // x₁ over all of x, once a block
    for (int e = tid; e < 2 * nq; e += kThreads) {
      const int h = e >= nq, q = e - h * nq;
      const float4 xv = __ldcg(reinterpret_cast<const float4*>(xs + h * n4) + q);
      if (PASS == kStart) {
        sx[e] = xv;
      } else {
        const float4 gv = __ldcg(reinterpret_cast<const float4*>(gs + h * n4) + q);
        const float4 c0 = __ldg(reinterpret_cast<const float4*>(c) + 2 * q);
        const float4 c1 = __ldg(reinterpret_cast<const float4*>(c) + 2 * q + 1);
        const float4 cv = h ? make_float4(c0.y, c0.w, c1.y, c1.w)
                            : make_float4(c0.x, c0.z, c1.x, c1.z);
        sx[e] = make_float4(trial_at(xv.x, gv.x, cv.x, tau), trial_at(xv.y, gv.y, cv.y, tau),
                            trial_at(xv.z, gv.z, cv.z, tau), trial_at(xv.w, gv.w, cv.w, tau));
      }
    }
    __syncthreads();
  }
  // x₁: staged in the scratch, or already in shared memory at xs
  const float4* xv4 = STAGE ? sx : reinterpret_cast<const float4*>(xs);
  float4 gr[S], gi[S];
#pragma unroll
  for (int s = 0; s < S; ++s) gr[s] = gi[s] = zero4();
  Acc fsum = Acc(0);
  const int per = ln.R * TB;  // rows a step
  const int steps = (t.rows + per - 1) / per;
  for (int b = 0; b < steps; ++b) {  // uniform per block
    float4 va[TB][S], vc[TB][S];
    float dr[TB], di[TB];
#pragma unroll
    for (int u = 0; u < TB; ++u) {
      const int l = (b * TB + u) * ln.R + rl;
      const bool on = active && l < t.rows;
      const float4* srow = reinterpret_cast<const float4*>(sA + (size_t)l * N2);
      dr[u] = di[u] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = gl + ln.tg * s;
        if (on && q < nq) {
          if (l < t.nsm) {
            va[u][s] = srow[q];
            vc[u][s] = srow[nq + q];
          } else {
            load_slot<kInterleaved>(a.A0, a.A1, n4, t.r0 + l, q, va[u][s], vc[u][s]);
          }
        } else {
          va[u][s] = vc[u][s] = zero4();
        }
      }
    }
    if (PASS != kExtrap) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = gl + ln.tg * s;
        const bool on = active && q < nq;
        const float4 xr = on ? xv4[q] : zero4(), xi = on ? xv4[nq + q] : zero4();
#pragma unroll
        for (int u = 0; u < TB; ++u) slot_dot(va[u][s], vc[u][s], xr, xi, dr[u], di[u]);
      }
#pragma unroll
      for (int u = 0; u < TB; ++u) {
        dr[u] = warp_sum(dr[u]);
        di[u] = warp_sum(di[u]);
      }
      if (lane == 0)
#pragma unroll
        for (int u = 0; u < TB; ++u) rowred[b & 1][u][warp] = make_float2(dr[u], di[u]);
    }
    __syncthreads();  // the warps' row sums are in
    // thread k < R·TB takes row k of the step (the u-th row of row lane
    // r): its total in warp order, the hinge, f's term and the stores; the
    // weights reach the row lanes through shared memory
    if (tid < per) {
      const int u = tid / ln.R, r = tid - u * ln.R, l = b * per + tid, i = t.r0 + l;
      float2 w = make_float2(0.f, 0.f);
      if (l < t.rows) {
        float pr = 0.f, pi = 0.f;
        if (PASS == kExtrap) {
          const float d1r = __ldcg(a.dbuf + 2 * i), d1i = __ldcg(a.dbuf + 2 * i + 1);
          const float dar = __ldcg(a.dacc + 2 * i), dai = __ldcg(a.dacc + 2 * i + 1);
          pr = __fadd_rn(d1r, __fmul_rn(beta, __fsub_rn(d1r, dar)));
          pi = __fadd_rn(d1i, __fmul_rn(beta, __fsub_rn(d1i, dai)));
          a.dacc[2 * i] = d1r;
          a.dacc[2 * i + 1] = d1i;
        } else {
          for (int v = r * wpr; v < (r + 1) * wpr; ++v) {
            const float2 d = rowred[b & 1][u][v];
            pr += d.x;
            pi += d.y;
          }
        }
        float r2;
        phase_hinge(pr, pi, bb[l], w.x, w.y, r2);
        fsum += Acc(r2) * Acc(r2);
        if (PASS == kFista) {
          a.dbuf[2 * i] = pr;
          a.dbuf[2 * i + 1] = pi;
        }
        if (PASS == kStart && a.dacc != nullptr) {
          a.dacc[2 * i] = pr;
          a.dacc[2 * i + 1] = pi;
        }
      }
      lrow[tid] = w;
    }
    __syncthreads();  // the step's weights are in
    if (kAdj && active)
#pragma unroll
      for (int u = 0; u < TB; ++u) {
        const float2 w = lrow[u * ln.R + rl];
#pragma unroll
        for (int s = 0; s < S; ++s) slot_grad(va[u][s], vc[u][s], w.x, w.y, gr[s], gi[s]);
      }
  }
  // (block_total's barrier also ends every read of x₁ in the scratch)
  fsum = block_total(fsum, acc_scratch);
  if (kAdj) {
    // the row lanes' shares: lanes 1…R−1 park theirs in the scratch, lane
    // 0 adds them in lane order and writes the block's share
    if (active && rl > 0)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = gl + ln.tg * s;
        if (q < nq) {
          sx[(rl - 1) * 2 * nq + q] = gr[s];
          sx[(rl - 1) * 2 * nq + nq + q] = gi[s];
        }
      }
    __syncthreads();
    if (active && rl == 0) {
      float4* out = reinterpret_cast<float4*>(a.gpart + (size_t)blockIdx.x * N2);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = gl + ln.tg * s;
        if (q < nq) {
          float4 sr = gr[s], si = gi[s];
          for (int k = 1; k < ln.R; ++k) {
            sr = add4(sr, sx[(k - 1) * 2 * nq + q]);
            si = add4(si, sx[(k - 1) * 2 * nq + nq + q]);
          }
          out[q] = sr;
          out[nq + q] = si;
        }
      }
    }
  }
  return fsum;
}

// After a grid barrier: the block's own entries of g — the 2·cnt entries
// from column c0 in each half — as the sum over blocks of their shares
// (kChains chains an entry in a fixed order, all of a chain's loads in
// flight), into gout.  With BB (the adaptive trial), also the block's
// ⟨Δx, Δg⟩ and ‖Δg‖² there from x (xc), its gradient gc and the trial x₁
// at stepsize tau, loaded beside the shares; thread 0 returns the
// second, thread 32 the first (as doubles).
template <typename Acc, bool BB>
__device__ __forceinline__ double reduce_own(const Args& a, int c0, int cnt, float* gout,
                                             const float* xc, const float* gc, const float* x1,
                                             float tau, float (*red)[32], float* fs, Acc* ts) {
  const int tid = threadIdx.x, lane = tid & 31, chain = tid >> 5;
  const int n4 = a.n4, N2 = 2 * n4, nb = gridDim.x;
  float v[1] = {0.f};
  Acc w[1] = {Acc(0)};
  for (int e0 = 0; e0 < 2 * cnt; e0 += 32) {  // uniform per block
    const int e = e0 + lane;
    const int h = e >= cnt, idx = h * n4 + c0 + e - h * cnt;
    const bool mine = chain == 0 && e < 2 * cnt;
    float xv = 0.f, gv = 0.f, x1v = 0.f;
    if (BB && mine) {
      xv = __ldcg(xc + idx);
      gv = __ldcg(gc + idx);
      x1v = __ldcg(x1 + idx);
    }
    red[chain][lane] = e < 2 * cnt ? chain_sum(a.gpart, N2, nb, chain, idx) : 0.f;
    __syncthreads();
    if (mine) {
      float g = 0.f;
      for (int k = 0; k < kChains; ++k) g += red[k][lane];
      gout[idx] = g;
      if (BB) {
        const float z = step_hat(xv, gv, tau);
        const float dx = __fsub_rn(x1v, xv);
        // Δg = g₁ + (x̂₁ − x)/τ  (== g₁ − g, in the TPU kernel's rounding)
        const float dg = __fadd_rn(g, __fdiv_rn(__fsub_rn(z, xv), tau));
        w[0] += Acc(dx) * Acc(dg);
        v[0] = fmaf(dg, dg, v[0]);
      }
    }
    __syncthreads();
  }
  return BB ? block_sums_warp<1, 1, Acc>(v, w, fs, ts) : 0.0;
}

// One pass over the band of microsolve_planar_kernel: a warp a row (S = 0)
// or a row spread over the block (S slots a thread, the wide rows).
template <typename Acc, int CPT, int S, int PASS>
__device__ __forceinline__ Acc rows_any(const Args& a, const Tile& t, const float* sA,
                                        const float* bb, const float* x, float beta, float* aux,
                                        Acc* acc_scratch,
                                        const float4 (&ra)[rows_in_flight(CPT)][CPT],
                                        const float4 (&rc)[rows_in_flight(CPT)][CPT],
                                        float2 (*rowred)[kBatchRows][kWarps], float2* lrow) {
  if constexpr (S == 0)
    return rows_pass<Acc, CPT, PASS>(a, t, sA, bb, x, beta, aux, acc_scratch, ra, rc);
  else
    return rows_wide<Acc, S, PASS, false>(a, t, sA, bb, x, nullptr, nullptr, 0.f, beta, aux,
                                          acc_scratch, rowred, lrow);
}

template <typename Acc, bool ACCEL, int CPT, int S>
__global__ void __launch_bounds__(kThreads, 1) microsolve_planar_kernel(Args a) {
  constexpr int TM = rows_in_flight(CPT);
  constexpr bool kReg = S == 0 && CPT <= 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ Acc fwin[kWinMax];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ float fs[kWarps * 5];
  __shared__ Acc ts[kWarps * 2];
  __shared__ float red[kChains][32];
  __shared__ float2 rowred[2][kBatchRows][kWarps];
  __shared__ float2 lrow[kStepRows];
  __shared__ float bsh[kBandMax];
  __shared__ double tot[kReduced];
  __shared__ float gobj;
  __shared__ State st;
  __shared__ Acc f1s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n4 = a.n4, nq = n4 / 4, N2 = 2 * n4, n = a.n;
  float* X[2] = {smem, smem + N2};          // [xr | xi] each; FISTA: y and x₁
  float* G[2] = {smem + 2 * N2, smem + 3 * N2};
  float* cs = smem + 4 * N2;
  float* xacc = smem + 5 * N2;
  // the warps' gradient buffers (kGw, N2), or the row lanes' (R − 1, N2)
  float* aux = smem + 6 * N2;
  float* sA = aux + (S == 0 ? kGw : lanes_of(n4).R - 1) * N2;  // the band's rows
  const Tile tile = tile_of(a.tiles, nb, blk);
  double* P0 = a.part;
  int trial = 0;
  unsigned gen = 0;
  auto barrier = [&]() { grid_barrier(a.bar, nb, gen); };

  // the band on the chip for the whole launch: each warp's first rows in
  // registers (n4 ≤ 256), the next in shared memory
  float4 ra[TM][CPT], rc[TM][CPT];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int l = warp + u * kWarps;
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int q = lane + 32 * s;
      if (kReg && l < tile.nreg && q < nq)
        load_slot<kInterleaved>(a.A0, a.A1, n4, tile.r0 + l, q, ra[u][s], rc[u][s]);
      else
        ra[u][s] = rc[u][s] = zero4();
    }
  }
  stage_rows(a, tile.r0 + tile.nreg, tile.nsm, sA);

  for (int p = 0; p < a.npoints; ++p) {
    const float* bb = stage_b(a.pts.b_at(p), tile, bsh);
    const float* x0 = a.pts.x0_at(p);
    const float* cp = a.c + p * a.c_stride;
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    for (int j = tid; j < n4; j += kThreads) {
      X[0][j] = x0[2 * j];
      X[0][n4 + j] = x0[2 * j + 1];
      // the anchor: once a launch when shared, else each instance's
      if (p == 0 || a.c_stride) {
        cs[j] = cp[2 * j];
        cs[n4 + j] = cp[2 * j + 1];
      }
      if (ACCEL) {
        xacc[j] = X[0][j];
        xacc[n4 + j] = X[0][n4 + j];
      }
    }
    __syncthreads();

    // ---- start: d₀ = A x₀, f₀, g₀ = Aᴴℓ(d₀); FISTA: d_acc = d₀
    {
      const Acc f = rows_any<Acc, CPT, S, kStart>(a, tile, sA, bb, X[0], 0.f, aux, acc_scratch,
                                                  ra, rc, rowred, lrow);
      if (tid == 0) P0[kF * nb + blk] = double(f);
      barrier();
      reduce_shares<Acc, false>(a, P0 + kF * nb, red, nullptr, nullptr, nullptr, 0.f);
      barrier();
      const double f0 = tid == 0 ? __ldcg(a.ftot) : 0.0;
      for (int j = tid; j < N2; j += kThreads) G[0][j] = __ldcg(a.gvec + j);
      if (tid == 0) start_point(st, fwin, Acc(0.5f) * Acc(f0), a.pts.tau0_at(p));
      __syncthreads();
    }

    for (;;) {
      ++trial;
      double* P = a.part + (size_t)(1 + (trial & 1)) * kSlots * nb;
      const float tau = st.tau;
      const int cur = st.cur;
      const float* xc = X[cur];
      const float* gc = G[cur];
      float* x1 = X[cur ^ 1];

      // ---- the trial step x₁ = (x − τg) + τc over all of x
      for (int j = tid; j < N2; j += kThreads) x1[j] = trial_at(xc[j], gc[j], cs[j], tau);
      __syncthreads();

      // ---- the rows at x₁: f (and the adaptive gradient's shares)
      {
        const Acc f = ACCEL ? rows_any<Acc, CPT, S, kFista>(a, tile, sA, bb, x1, 0.f, aux,
                                                             acc_scratch, ra, rc, rowred, lrow)
                            : rows_any<Acc, CPT, S, kAdaptive>(a, tile, sA, bb, x1, 0.f, aux,
                                                               acc_scratch, ra, rc, rowred, lrow);
        if (tid == 0) P[kF * nb + blk] = double(f);
      }
      grid_arrive(a.bar, gen);

      // ---- the step's sums, which need no other block, while the others
      // arrive: ‖Δx‖², ‖g‖², ‖x₁ − x̂‖², ⟨c, x₁⟩ and the float32 restart
      // dot; ⟨Δx, g⟩ and the FP64 restart dot
      {
        float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        Acc w[2] = {Acc(0), Acc(0)};
        for (int j = tid; j < N2; j += kThreads) {
          const float xv = xc[j], gv = gc[j], xn = x1[j];
          const float z = step_hat(xv, gv, tau);
          const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, z);
          v[0] = fmaf(dx, dx, v[0]);
          v[1] = fmaf(gv, gv, v[1]);
          v[2] = fmaf(sm, sm, v[2]);
          v[3] = fmaf(cs[j], xn, v[3]);
          w[0] += Acc(dx) * Acc(gv);
          if (ACCEL) {
            // the restart dot ⟨y − x₁, x₁ − x_acc⟩ (in FP64 with restart_dd,
            // which comes with hp: Acc is double)
            const float rda = __fsub_rn(xv, xn), rdb = __fsub_rn(xn, xacc[j]);
            if (a.rdd)
              w[1] += Acc(rda) * Acc(rdb);
            else
              v[4] = fmaf(rda, rdb, v[4]);
          }
        }
        // lane 0 of warp k < 7 gets the k-th sum
        const double r = block_sums_warp<5, 2, Acc>(v, w, fs, ts);
        if (lane == 0) {
          if (warp == 0) tot[kNd2] = r;
          if (warp == 1) tot[kNg2] = r;
          if (warp == 2) tot[kNsm2] = r;
          if (warp == 3) gobj = -float(r);
          if (warp == 4 && !a.rdd) tot[kRdot] = r;
          if (warp == 5) tot[kBtDot] = r;
          if (warp == 6 && a.rdd) tot[kRdot] = r;
        }
      }
      grid_wait(a.bar, nb, gen);

      if (!ACCEL) {
        // ---- g₁ reduced with f and the BB sums by chunks; every block
        // copies g₁ while warp 0 sums the chunks' BB sums in chunk order
        // and decides
        reduce_shares<Acc, true>(a, P + kF * nb, red, xc, gc, x1, tau);
        barrier();
        // warp 0's loads of the chunks' BB sums (lane l: chunks l, l + 32,
        // …) and f first, so that they travel with its share of g₁
        const int chunks = (N2 + 31) / 32;
        double bw[kChunks / 32], bv[kChunks / 32];
#pragma unroll
        for (int k = 0; k < kChunks / 32; ++k) {
          const int c = tid + 32 * k;
          const bool on = tid < 32 && c < chunks;
          bw[k] = on ? __ldcg(a.bbp + 2 * c) : 0.0;
          bv[k] = on ? __ldcg(a.bbp + 2 * c + 1) : 0.0;
        }
        const double f = tid == 0 ? __ldcg(a.ftot) : 0.0;
        float* g1 = G[cur ^ 1];
        for (int j = tid; j < N2; j += kThreads) g1[j] = __ldcg(a.gvec + j);
        if (tid < 32) {
          Acc w = Acc(0);
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < kChunks / 32; ++k) {
            w += Acc(bw[k]);
            v += float(bv[k]);
          }
          w = warp_sum(w);
          v = warp_sum(v);
          if (tid == 0) {
            tot[kF] = f;
            tot[kBbDot] = double(w);
            tot[kNdg2] = v;
            State s = st;
            decide<Acc, ACCEL>(s, tot, fwin, f1s, 0.5f, gobj, a.ctl, a.rec, rec0, blk == 0);
            st = s;
          }
        }
      } else if (tid < 32) {
        // ---- the decision, the same in every block
        const Acc f = warp_sum_blocks<Acc>(P + kF * nb, nb);
        if (tid == 0) {
          tot[kF] = double(f);
          State s = st;
          decide<Acc, ACCEL>(s, tot, fwin, f1s, 0.5f, gobj, a.ctl, a.rec, rec0, blk == 0);
          st = s;
        }
      }
      __syncthreads();
      if (a.its && st.accepted && blk == 0) {
        float* row = a.its + (rec0 + st.krec) * 2 * n;
        for (int j = tid; j < n; j += kThreads) {
          row[2 * j] = x1[j];
          row[2 * j + 1] = x1[n4 + j];
        }
      }

      if (ACCEL && st.post) {
        const float beta = st.beta;
        // ---- the rows at d_n = d₁ + β(d₁ − d_acc): f(d_n) and g_n's shares;
        // y_n = x₁ + β(x₁ − x_acc), x_acc = x₁ over all of x
        const Acc fn = rows_any<Acc, CPT, S, kExtrap>(a, tile, sA, bb, nullptr, beta, aux,
                                                      acc_scratch, ra, rc, rowred, lrow);
        if (tid == 0) P[kFn * nb + blk] = double(fn);
        float* y = X[cur];
        for (int j = tid; j < N2; j += kThreads) {
          const float xv1 = x1[j], xa = xacc[j];
          y[j] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
          xacc[j] = xv1;
        }
        barrier();
        reduce_shares<Acc, false>(a, P + kFn * nb, red, nullptr, nullptr, nullptr, 0.f);
        barrier();
        const double fpub = tid == 0 ? __ldcg(a.ftot) : 0.0;
        for (int j = tid; j < N2; j += kThreads) G[cur][j] = __ldcg(a.gvec + j);
        if (tid == 0) {
          State s = st;
          finish_fista(s, Acc(0.5f) * Acc(fpub), f1s, fwin, a.ctl, a.rec, rec0, blk == 0);
          st = s;
        }
        __syncthreads();
      }
      if (st.done) break;
    }

    // ---- the solution (FISTA: x₁ on a converged stop, else the
    // extrapolated y) and the counts
    if (blk == 0) {
      const float* xf = (ACCEL && st.status == 1) ? xacc : X[st.cur];
      float* xo = a.x_out + (size_t)p * 2 * n;
      for (int j = tid; j < n; j += kThreads) {
        xo[2 * j] = xf[j];
        xo[2 * j + 1] = xf[n4 + j];
      }
      if (tid == 0) {
        a.k_out[p] = st.k;
        a.status_out[p] = st.status;
      }
    }
    // every block is done with this instance's shared and global state
    if (p + 1 < a.npoints) barrier();
  }
  grid_exit(a.bar, nb);
}

template <typename Acc, bool ACCEL, int S>
__global__ void __launch_bounds__(kThreads, 1) microsolve_planar_wide_kernel(Args a) {
  static_assert(S == 2 || S == 4, "past kStateMax a thread takes 2 or 4 slots of a row");
  extern __shared__ __align__(16) float smem[];
  __shared__ Acc fwin[kWinMax];
  __shared__ float fs[kWarps * 5];
  __shared__ Acc ts[kWarps * 2];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ float2 rowred[2][kBatchRows][kWarps];
  __shared__ float2 lrow[kStepRows];
  __shared__ float red[kChains][32];
  __shared__ float bsh[kBandMax];
  __shared__ double tot[kReduced];
  __shared__ State st;
  __shared__ Acc f1s;

  const int tid = threadIdx.x;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n4 = a.n4, nq = n4 / 4, n = a.n;
  float* scratch = smem;                     // x₁, then the row lanes' shares
  float* sA = smem + wide_scratch(n4);       // the band's rows in shared memory
  const Tile tile = tile_of(a.tiles, nb, blk);
  // the block's own column groups [g0, g1) and their entries in each half
  const int per = (nq + nb - 1) / nb;
  const int g0 = min(nq, blk * per), g1 = min(nq, g0 + per);
  const int c0 = 4 * g0, cnt = 4 * (g1 - g0);
  double* P0 = a.part;
  int trial = 0;
  unsigned gen = 0;
  auto barrier = [&]() { grid_barrier(a.bar, nb, gen); };

  stage_rows(a, tile.r0, tile.nsm, sA);

  for (int p = 0; p < a.npoints; ++p) {
    const float* bb = stage_b(a.pts.b_at(p), tile, bsh);
    const float* x0 = a.pts.x0_at(p);
    const float* cp = a.c + p * a.c_stride;
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    for (int e = tid; e < 2 * cnt; e += kThreads) {
      const int h = e >= cnt, j = c0 + e - h * cnt, idx = h * n4 + j;
      a.X[0][idx] = x0[2 * j + h];
      if (ACCEL) a.xacc[idx] = x0[2 * j + h];
    }
    barrier();

    // ---- start: d₀ = A x₀, f₀, g₀ = Aᴴℓ(d₀); FISTA: d_acc = d₀
    {
      const Acc f = rows_wide<Acc, S, kStart, true>(a, tile, sA, bb, a.X[0], nullptr, cp, 0.f, 0.f,
                                              scratch, acc_scratch, rowred, lrow);
      if (tid == 0) P0[kF * nb + blk] = double(f);
      barrier();
      reduce_own<Acc, false>(a, c0, cnt, a.G[0], nullptr, nullptr, nullptr, 0.f, red, fs, ts);
      if (tid < 32) {
        const Acc f0 = warp_sum_blocks<Acc>(P0 + kF * nb, nb);
        if (tid == 0) start_point(st, fwin, Acc(0.5f) * f0, a.pts.tau0_at(p));
      }
      barrier();  // g₀ complete
    }

    for (;;) {
      ++trial;
      double* P = a.part + (size_t)(1 + (trial & 1)) * kSlots * nb;
      const float tau = st.tau;
      const int cur = st.cur;
      const float* xc = a.X[cur];
      const float* gc = a.G[cur];
      float* x1 = a.X[cur ^ 1];

      // ---- the trial step x₁ = (x − τg) + τc on the own columns, its sums
      // (adaptive: while the other blocks arrive at the barrier after the
      // rows, which form x₁ whole themselves; the decision reads the sums
      // after the next barrier)
      auto step = [&]() {
        // ‖Δx‖², ‖g‖², ‖x₁ − x̂‖², ⟨c, x₁⟩ and the float32 restart dot;
        // ⟨Δx, g⟩ and the FP64 restart dot
        float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        Acc w[2] = {Acc(0), Acc(0)};
        for (int e = tid; e < 2 * cnt; e += kThreads) {
          const int h = e >= cnt, j = c0 + e - h * cnt, idx = h * n4 + j;
          const float xv = __ldcg(xc + idx), gv = __ldcg(gc + idx), cv = __ldg(cp + 2 * j + h);
          const float z = step_hat(xv, gv, tau);
          const float xn = trial_at(xv, gv, cv, tau);
          x1[idx] = xn;
          const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, z);
          v[0] = fmaf(dx, dx, v[0]);
          v[1] = fmaf(gv, gv, v[1]);
          v[2] = fmaf(sm, sm, v[2]);
          v[3] = fmaf(cv, xn, v[3]);
          w[0] += Acc(dx) * Acc(gv);
          if (ACCEL) {
            // the restart dot ⟨y − x₁, x₁ − x_acc⟩ (in FP64 with restart_dd,
            // which comes with hp: Acc is double)
            const float rda = __fsub_rn(xv, xn), rdb = __fsub_rn(xn, a.xacc[idx]);
            if (a.rdd)
              w[1] += Acc(rda) * Acc(rdb);
            else
              v[4] = fmaf(rda, rdb, v[4]);
          }
        }
        // lane 0 of warp k < 7 gets the k-th sum and stores it in its slot
        const double r = block_sums_warp<5, 2, Acc>(v, w, fs, ts);
        const int k = tid >> 5;
        const int slot = k == 0 ? kNd2 : k == 1 ? kNg2 : k == 2 ? kNsm2
                       : k == 3 ? kGx : k == 5 ? kBtDot
                       : (k == 4 && !a.rdd) || (k == 6 && a.rdd) ? kRdot : -1;
        if ((tid & 31) == 0 && k < 7 && slot >= 0) P[slot * nb + blk] = r;
      };
      if (ACCEL) step();

      // ---- the rows at x₁: f (and the adaptive gradient's shares)
      {
        const Acc f = ACCEL ? rows_wide<Acc, S, kFista, true>(a, tile, sA, bb, xc, gc, cp, tau,
                                                              0.f, scratch, acc_scratch, rowred,
                                                              lrow)
                            : rows_wide<Acc, S, kAdaptive, true>(a, tile, sA, bb, xc, gc, cp,
                                                                 tau, 0.f, scratch, acc_scratch,
                                                                 rowred, lrow);
        if (tid == 0) P[kF * nb + blk] = double(f);
      }
      grid_arrive(a.bar, gen);
      if (!ACCEL) step();
      grid_wait(a.bar, nb, gen);

      if (!ACCEL) {
        // ---- g₁ on the own columns, then the BB sums there
        const double r =
            reduce_own<Acc, true>(a, c0, cnt, a.G[cur ^ 1], xc, gc, x1, tau, red, fs, ts);
        if (tid == 0) P[kNdg2 * nb + blk] = r;
        if (tid == 32) P[kBbDot * nb + blk] = r;
        barrier();
      }

      // ---- the decision, the same in every block: a warp a slot
      reduce_partials_wide<Acc, ACCEL>(P, nb, true, a.rdd, tot);
      __syncthreads();
      if (tid == 0) {
        State s = st;
        decide<Acc, ACCEL>(s, tot, fwin, f1s, 0.5f, -float(tot[kGx]), a.ctl, a.rec, rec0,
                           blk == 0);
        st = s;
      }
      __syncthreads();
      if (a.its && st.accepted) {
        float* row = a.its + (rec0 + st.krec) * 2 * n;
        for (int e = tid; e < 2 * cnt; e += kThreads) {
          const int h = e >= cnt, j = c0 + e - h * cnt;
          if (j < n) row[2 * j + h] = x1[h * n4 + j];
        }
      }

      if (ACCEL && st.post) {
        const float beta = st.beta;
        // ---- the rows at d_n = d₁ + β(d₁ − d_acc): f(d_n) and g_n's
        // shares; y_n = x₁ + β(x₁ − x_acc), x_acc = x₁ on the own columns
        const Acc fn = rows_wide<Acc, S, kExtrap, true>(a, tile, sA, bb, nullptr, nullptr, cp,
                                                        0.f, beta, scratch, acc_scratch, rowred,
                                                        lrow);
        if (tid == 0) P[kFn * nb + blk] = double(fn);
        float* y = a.X[cur];
        for (int e = tid; e < 2 * cnt; e += kThreads) {
          const int h = e >= cnt, idx = h * n4 + c0 + e - h * cnt;
          const float xv1 = x1[idx], xa = a.xacc[idx];
          y[idx] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
          a.xacc[idx] = xv1;
        }
        barrier();
        reduce_own<Acc, false>(a, c0, cnt, a.G[cur], nullptr, nullptr, nullptr, 0.f, red, fs, ts);
        if (tid < 32) {
          const Acc f = Acc(0.5f) * warp_sum_blocks<Acc>(P + kFn * nb, nb);
          if (tid == 0) {
            State s = st;
            finish_fista(s, f, f1s, fwin, a.ctl, a.rec, rec0, blk == 0);
            st = s;
          }
        }
        barrier();  // g_n complete
      }
      if (st.done) break;
    }

    // ---- the solution on the own columns (FISTA: x₁ on a converged
    // stop, else the extrapolated y) and the counts
    const float* xf = (ACCEL && st.status == 1) ? a.xacc : a.X[st.cur];
    float* xo = a.x_out + (size_t)p * 2 * n;
    for (int e = tid; e < 2 * cnt; e += kThreads) {
      const int h = e >= cnt, j = c0 + e - h * cnt;
      if (j < n) xo[2 * j + h] = xf[h * n4 + j];
    }
    if (blk == 0 && tid == 0) {
      a.k_out[p] = st.k;
      a.status_out[p] = st.status;
    }
    // every block is done with this instance's state
    if (p + 1 < a.npoints) barrier();
  }
  grid_exit(a.bar, nb);
}

// ---------------------------------------------------------------------------
// The column fallback past n = 8192 (microsolve_planar_columns_kernel):
// rows wider than a thread's four slots of x₁ and of g in registers
// (and, past about 25,000 columns, than a block's shared memory).
// Nothing of A stays on the chip; the n-sized state lives in device
// memory as on the wide route:
//  * Block b owns a contiguous range of column groups (4 columns each) of
//    x (FISTA: y), g, the trial x₁, c and x_acc, and does the prox step,
//    its sums and the BB sums on those columns only.
//  * Rows: a warp per row, its lanes striding over the row's column
//    groups (x read from device memory), the row dot summed by a shuffle
//    butterfly; lane 0 applies the hinge and stores the row's weight
//    ℓᵢ = (ℓr, ℓi) in device memory.
//  * Columns: Aᴴℓ on a block's own columns reads the matrices a second
//    time, by columns: threads are (row lane, column group) pairs, each
//    summing its rows in order, the row lanes' sums added by a fixed
//    pairwise tree in shared memory (a sequential sum of 256 lanes cost
//    the BB step's Δg = g₁ − g visible accuracy).  No gradient shares
//    cross blocks.
//  * Grid barriers per adaptive trial: 3 (after the step: x₁ complete;
//    after the rows: ℓ and f; after the columns: g₁ and the BB sums).
//    FISTA: 2 per trial (the trials need only f) plus 1 per acceptance
//    (d_n = d₁ + β(d₁ − d_acc) on the owned rows, then g_n by columns).
// ---------------------------------------------------------------------------

// One pass over the block's rows (see Pass), a warp per row, x = [xr | xi]
// in device memory (unused by kExtrap).  Returns the block's Σr² (valid
// in every thread) and, except for kFista, leaves each row's weight in
// lbuf.
template <typename Acc, int PASS>
__device__ __forceinline__ Acc rows_columns(const Args& a, const float* bp, const float* x,
                                            float beta, Acc* acc_scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n4 = a.n4, nq = n4 / 4;
  Acc fsum = Acc(0);
  // the loop is uniform per warp: no block barrier inside
  for (int i = blockIdx.x * kWarps + warp; i < a.m; i += gridDim.x * kWarps) {
    float pr, pi;
    if (PASS == kExtrap) {
      const float d1r = __ldcg(a.dbuf + 2 * i), d1i = __ldcg(a.dbuf + 2 * i + 1);
      const float dar = __ldcg(a.dacc + 2 * i), dai = __ldcg(a.dacc + 2 * i + 1);
      pr = __fadd_rn(d1r, __fmul_rn(beta, __fsub_rn(d1r, dar)));
      pi = __fadd_rn(d1i, __fmul_rn(beta, __fsub_rn(d1i, dai)));
      __syncwarp();
      if (lane == 0) {
        a.dacc[2 * i] = d1r;
        a.dacc[2 * i + 1] = d1i;
      }
    } else {
      float sr = 0.f, si = 0.f;
#pragma unroll 4
      for (int q = lane; q < nq; q += 32) {
        float4 va, vc;
        load_slot<kInterleaved>(a.A0, a.A1, n4, i, q, va, vc);
        const float4 xr = __ldcg(reinterpret_cast<const float4*>(x) + q);
        const float4 xi = __ldcg(reinterpret_cast<const float4*>(x + n4) + q);
        slot_dot(va, vc, xr, xi, sr, si);
      }
      pr = warp_allsum(sr);
      pi = warp_allsum(si);
    }
    if (lane == 0) {
      float lr, li, r;
      phase_hinge(pr, pi, __ldg(bp + i), lr, li, r);
      fsum += Acc(r) * Acc(r);
      if (PASS != kFista) {
        a.lbuf[2 * i] = lr;
        a.lbuf[2 * i + 1] = li;
      } else {
        a.dbuf[2 * i] = pr;
        a.dbuf[2 * i + 1] = pi;
      }
      if (PASS == kStart && a.dacc != nullptr) {
        a.dacc[2 * i] = pr;
        a.dacc[2 * i + 1] = pi;
      }
    }
  }
  return block_sum(fsum, acc_scratch);
}

// g = Aᴴℓ on the block's own column groups [g0, g1), into gout ([gr | gi]).
// With BB (the adaptive trial), also the block's ⟨Δx, Δg⟩ and ‖Δg‖² from
// x (xc), its gradient gc and the trial x₁ at stepsize tau, in thread 0.
template <typename Acc, bool BB>
__device__ __forceinline__ void columns_pass(const Args& a, int g0, int g1, float* gout,
                                             const float* xc, const float* gc, const float* x1,
                                             float tau, float4 (*colred)[kThreads],
                                             float (*f32_5)[kWarps], Acc (*acc2)[kWarps],
                                             Acc& bbdot, float& ndg2) {
  const int tid = threadIdx.x, n4 = a.n4;
  int tg = 1;  // column groups side by side: up to 32, as many as owned
  while (tg < 32 && tg < g1 - g0) tg <<= 1;
  const int R = kThreads / tg, rl = tid / tg, gl = tid % tg;
  float v[1] = {0.f};
  Acc w[1] = {Acc(0)};
  for (int gb = g0; gb < g1; gb += tg) {  // uniform per block
    const int q = gb + gl;
    float4 gr = zero4(), gi = gr;
    if (q < g1)
#pragma unroll 4
      for (int i = rl; i < a.m; i += R) {
        float4 va, vc;
        load_slot<kInterleaved>(a.A0, a.A1, n4, i, q, va, vc);
        slot_grad(va, vc, __ldcg(a.lbuf + 2 * i), __ldcg(a.lbuf + 2 * i + 1), gr, gi);
      }
    colred[0][tid] = gr;
    colred[1][tid] = gi;
    __syncthreads();
    // the row lanes' sums by a fixed pairwise tree (lane r takes r + s)
    for (int st = R >> 1; st > 0; st >>= 1) {
      if (rl < st)
        for (int k = 0; k < 2; ++k) colred[k][tid] = add4(colred[k][tid], colred[k][tid + st * tg]);
      __syncthreads();
    }
    if (tid < tg && q < g1) {
      const float4 sr = colred[0][tid], si = colred[1][tid];
      reinterpret_cast<float4*>(gout)[q] = sr;
      reinterpret_cast<float4*>(gout + n4)[q] = si;
      if (BB) {
        const float gs[8] = {sr.x, sr.y, sr.z, sr.w, si.x, si.y, si.z, si.w};
        for (int k = 0; k < 8; ++k) {
          const int idx = (k < 4 ? 0 : n4) + 4 * q + (k & 3);
          const float g = gs[k], xv = xc[idx];
          const float z = step_hat(xv, gc[idx], tau);
          const float dx = __fsub_rn(x1[idx], xv);
          // Δg = g₁ + (x̂₁ − x)/τ  (== g₁ − g, in the TPU kernel's rounding)
          const float dg = __fadd_rn(g, __fdiv_rn(__fsub_rn(z, xv), tau));
          w[0] += Acc(dx) * Acc(dg);
          v[0] = fmaf(dg, dg, v[0]);
        }
      }
    }
    __syncthreads();  // colred is rewritten by the next tile
  }
  if (BB) {
    block_sums(v, f32_5);
    block_sums(w, acc2);
    bbdot = w[0];
    ndg2 = v[0];
  }
}

template <typename Acc, bool ACCEL>
__global__ void __launch_bounds__(kThreads, 1) microsolve_planar_columns_kernel(Args a) {
  __shared__ Acc fwin[kWinMax];
  __shared__ Acc acc2[2][kWarps];
  __shared__ float f32_5[5][kWarps];
  __shared__ double f64_scratch[kWarps];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ float4 colred[2][kThreads];
  __shared__ double tot[kReduced];
  __shared__ State st;
  __shared__ Acc f1s;

  const int tid = threadIdx.x;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n4 = a.n4, nq = n4 / 4, n = a.n;
  // the block's own column groups [g0, g1) and their entries in each half
  const int per = (nq + nb - 1) / nb;
  const int g0 = min(nq, blk * per), g1 = min(nq, g0 + per);
  const int c0 = 4 * g0, cnt = 4 * (g1 - g0);
  double* P0 = a.part;
  int trial = 0;
  unsigned gen = 0;
  auto barrier = [&]() { grid_barrier(a.bar, nb, gen); };
  Acc bbdot;
  float ndg2;

  for (int p = 0; p < a.npoints; ++p) {
    const float* bp = a.pts.b_at(p);
    const float* x0 = a.pts.x0_at(p);
    const float* cp = a.c + p * a.c_stride;
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    for (int e = tid; e < 2 * cnt; e += kThreads) {
      const int h = e >= cnt, j = c0 + e - h * cnt, idx = h * n4 + j;
      a.X[0][idx] = x0[2 * j + h];
      if (ACCEL) a.xacc[idx] = x0[2 * j + h];
    }
    barrier();

    // ---- start: d₀ = A x₀, f₀, g₀ = Aᴴℓ(d₀); FISTA: d_acc = d₀
    {
      const Acc f = rows_columns<Acc, kStart>(a, bp, a.X[0], 0.f, acc_scratch);
      if (tid == 0) P0[kF * nb + blk] = double(f);
      barrier();
      columns_pass<Acc, false>(a, g0, g1, a.G[0], nullptr, nullptr, nullptr, 0.f, colred, f32_5,
                               acc2, bbdot, ndg2);
      if (tid < 32) {
        const Acc f0 = warp_sum_global<Acc>(P0 + kF * nb, nb);
        if (tid == 0) start_point(st, fwin, Acc(0.5f) * f0, a.pts.tau0_at(p));
      }
      __syncthreads();
    }

    for (;;) {
      ++trial;
      double* P = a.part + (size_t)(1 + (trial & 1)) * kSlots * nb;
      const float tau = st.tau;
      const int cur = st.cur;
      const float* xc = a.X[cur];
      const float* gc = a.G[cur];
      float* x1 = a.X[cur ^ 1];

      // ---- the trial step x₁ = (x − τg) + τc on the own columns, its sums
      {
        // ‖Δx‖², ‖g‖², ‖x₁ − x̂‖², ⟨c, x₁⟩ and the float32 restart dot
        float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        Acc w[1] = {Acc(0)};  // ⟨Δx, g⟩
        double rdot64 = 0.0;
        for (int e = tid; e < 2 * cnt; e += kThreads) {
          const int h = e >= cnt, j = c0 + e - h * cnt, idx = h * n4 + j;
          const float xv = xc[idx], gv = gc[idx], cv = __ldg(cp + 2 * j + h);
          const float z = step_hat(xv, gv, tau);
          const float xn = trial_at(xv, gv, cv, tau);
          x1[idx] = xn;
          const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, z);
          v[0] = fmaf(dx, dx, v[0]);
          v[1] = fmaf(gv, gv, v[1]);
          v[2] = fmaf(sm, sm, v[2]);
          v[3] = fmaf(cv, xn, v[3]);
          w[0] += Acc(dx) * Acc(gv);
          if (ACCEL) {
            // the restart dot ⟨y − x₁, x₁ − x_acc⟩
            const float ra = __fsub_rn(xv, xn), rb = __fsub_rn(xn, a.xacc[idx]);
            if (a.rdd)
              rdot64 += double(ra) * double(rb);
            else
              v[4] = fmaf(ra, rb, v[4]);
          }
        }
        block_sums(v, f32_5);
        block_sums(w, acc2);
        if (ACCEL && a.rdd) rdot64 = block_sum(rdot64, f64_scratch);
        if (tid == 0) {
          P[kNd2 * nb + blk] = v[0];
          P[kNg2 * nb + blk] = v[1];
          P[kNsm2 * nb + blk] = v[2];
          P[kGx * nb + blk] = v[3];
          P[kBtDot * nb + blk] = double(w[0]);
          P[kRdot * nb + blk] = a.rdd ? rdot64 : double(v[4]);
        }
      }
      barrier();

      // ---- the rows at x₁: f (and the adaptive gradient's weights)
      {
        const Acc f = ACCEL ? rows_columns<Acc, kFista>(a, bp, x1, 0.f, acc_scratch)
                            : rows_columns<Acc, kAdaptive>(a, bp, x1, 0.f, acc_scratch);
        if (tid == 0) P[kF * nb + blk] = double(f);
      }
      barrier();

      if (!ACCEL) {
        // ---- g₁ on the own columns, then the BB sums there
        columns_pass<Acc, true>(a, g0, g1, a.G[cur ^ 1], xc, gc, x1, tau, colred, f32_5, acc2,
                                bbdot, ndg2);
        if (tid == 0) {
          P[kBbDot * nb + blk] = double(bbdot);
          P[kNdg2 * nb + blk] = ndg2;
        }
        barrier();
      }

      // ---- the decision, the same in every block
      if (tid < 32) {
        reduce_partials<Acc, ACCEL>(P, nb, true, a.rdd, tot);
        if (tid == 0) {
          State s = st;
          decide<Acc, ACCEL>(s, tot, fwin, f1s, 0.5f, -float(tot[kGx]), a.ctl, a.rec, rec0,
                             blk == 0);
          st = s;
        }
      }
      __syncthreads();
      if (a.its && st.accepted) {
        float* row = a.its + (rec0 + st.krec) * 2 * n;
        for (int e = tid; e < 2 * cnt; e += kThreads) {
          const int h = e >= cnt, j = c0 + e - h * cnt;
          if (j < n) row[2 * j + h] = x1[h * n4 + j];
        }
      }

      if (ACCEL && st.post) {
        const float beta = st.beta;
        // ---- the rows at d_n = d₁ + β(d₁ − d_acc): f(d_n) and ℓ(d_n);
        // y_n = x₁ + β(x₁ − x_acc), x_acc = x₁ on the own columns
        const Acc fn = rows_columns<Acc, kExtrap>(a, bp, nullptr, beta, acc_scratch);
        if (tid == 0) P[kFn * nb + blk] = double(fn);
        float* y = a.X[cur];
        for (int e = tid; e < 2 * cnt; e += kThreads) {
          const int h = e >= cnt, idx = h * n4 + c0 + e - h * cnt;
          const float xv1 = x1[idx], xa = a.xacc[idx];
          y[idx] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
          a.xacc[idx] = xv1;
        }
        barrier();
        columns_pass<Acc, false>(a, g0, g1, a.G[cur], nullptr, nullptr, nullptr, 0.f, colred,
                                 f32_5, acc2, bbdot, ndg2);
        if (tid < 32) {
          const Acc f = Acc(0.5f) * warp_sum_global<Acc>(P + kFn * nb, nb);
          if (tid == 0) {
            State s = st;
            finish_fista(s, f, f1s, fwin, a.ctl, a.rec, rec0, blk == 0);
            st = s;
          }
        }
        __syncthreads();
      }
      if (st.done) break;
    }

    // ---- the solution on the own columns (FISTA: x₁ on a converged
    // stop, else the extrapolated y) and the counts
    const float* xf = (ACCEL && st.status == 1) ? a.xacc : a.X[st.cur];
    float* xo = a.x_out + (size_t)p * 2 * n;
    for (int e = tid; e < 2 * cnt; e += kThreads) {
      const int h = e >= cnt, j = c0 + e - h * cnt;
      if (j < n) xo[2 * j + h] = xf[h * n4 + j];
    }
    if (blk == 0 && tid == 0) {
      a.k_out[p] = st.k;
      a.status_out[p] = st.status;
    }
    // every block is done with this instance's state
    if (p + 1 < a.npoints) barrier();
  }
  grid_exit(a.bar, nb);
}

using Kernel = void (*)(Args);

// whether a launch at n4 keeps the n-sized state in every block's shared
// memory (microsolve_planar_kernel), the rows and the wide route up to
// kStateMax
bool state_on_chip(int route, int n4) {
  return route == kRouteRows || (route == kRouteWide && n4 <= kStateMax);
}

template <typename Acc, bool ACCEL>
Kernel pick_t(int route, int n4) {
  if (route == kRouteRows)
    return n4 <= 256 ? microsolve_planar_kernel<Acc, ACCEL, 2, 0>
                     : microsolve_planar_kernel<Acc, ACCEL, 4, 0>;
  if (state_on_chip(route, n4)) return microsolve_planar_kernel<Acc, ACCEL, 1, 1>;
  if (route == kRouteWide) {
    return lanes_of(n4).S == 2 ? microsolve_planar_wide_kernel<Acc, ACCEL, 2>
                               : microsolve_planar_wide_kernel<Acc, ACCEL, 4>;
  }
  return microsolve_planar_columns_kernel<Acc, ACCEL>;
}

Kernel pick(int route, int n4, bool hp, bool accel) {
  return hp ? (accel ? pick_t<double, true>(route, n4) : pick_t<double, false>(route, n4))
            : (accel ? pick_t<float, true>(route, n4) : pick_t<float, false>(route, n4));
}

// the kernel the wrapper's plan takes at padded width n4
int route_of(int n4) {
  return n4 <= kNarrowMax ? kRouteRows : n4 <= kWideMax ? kRouteWide : kRouteColumns;
}

// dynamic shared memory of a block besides its rows of A, in bytes: the
// n-sized state and the warps' (kGw) or the row lanes' (R − 1) gradient
// buffers, or the wide kernel's scratch
size_t state_bytes(int route, int n4) {
  const size_t N2 = 2 * (size_t)n4;
  if (route == kRouteRows) return (6 + kGw) * N2 * sizeof(float);
  if (state_on_chip(route, n4)) return (6 + lanes_of(n4).R - 1) * N2 * sizeof(float);
  if (route == kRouteWide) return (size_t)wide_scratch(n4) * sizeof(float);
  return 0;
}

size_t pad4(int v) { return ((size_t)v + 3) / 4 * 4; }

}  // namespace

// The cooperative grid at padded width n4 (a multiple of 4) on the
// current device — one block per SM, 0 blocks if one cannot be resident —
// and the shared memory a block of the route for n4 has for rows of A:
// the device's per-block opt-in (optin) less the kernels' static shared
// memory (fixed, the most of the four instantiations that may run at n4)
// and the block's state (0 on the column fallback;
// kernels/microsolver_planar.py, row_budget, is the same arithmetic).
// Raises every instantiation's dynamic shared-memory cap to what it may
// take.
extern "C" int fasta_microsolve_planar_grid(int n4, int* nblocks, int* budget, int* optin_out,
                                            int* fixed_out) {
  if (n4 < 4 || n4 % 4) return cudaErrorInvalidValue;
  const int route = route_of(n4);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  size_t fixed = 0;
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, (const void*)pick(route, n4, k & 1, k & 2));
    fixed = attr.sharedSizeBytes > fixed ? attr.sharedSizeBytes : fixed;
  }
  const int cap = optin > (int)fixed ? optin - (int)fixed : 0;
  const int dyn = route == kRouteColumns ? 0 : cap;
  int per_sm = 1 << 30;
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    const void* fn = (const void*)pick(route, n4, k & 1, k & 2);
    if (route != kRouteColumns)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    int per = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, kThreads, dyn);
    per_sm = per < per_sm ? per : per_sm;
  }
  if (err != cudaSuccess) return err;
  const long long left = (long long)dyn - (long long)state_bytes(route, n4);
  *nblocks = per_sm < 1 ? 0 : sms;
  *budget = route == kRouteColumns || left < 0 ? 0 : (int)left;
  *optin_out = optin;
  *fixed_out = (int)fixed;
  return cudaSuccess;
}

// The floats of work_f a launch needs on a route.  With the n-sized state
// on the chip: the blocks' shares, g, f and the chunks' BB sums, d₁ and
// d_acc; the wide kernel: x, g (two each), x_acc, the blocks' shares, d₁
// and d_acc; columns: x, g (two each), x_acc, ℓ, d₁ and d_acc.
extern "C" int fasta_microsolve_planar_work(int m, int n4, int nblocks, int route,
                                            int* nfloats) {
  if (m < 1 || n4 < 4 || nblocks < 1 || route < kRouteRows || route > kRouteColumns)
    return cudaErrorInvalidValue;
  const size_t N2 = 2 * (size_t)n4, M2 = pad4(2 * m);
  size_t nf;
  if (state_on_chip(route, n4))
    nf = (size_t)nblocks * N2 + N2 + 4 + 4 * kChunks + 2 * M2;
  else if (route == kRouteWide)
    nf = 5 * N2 + (size_t)nblocks * N2 + 2 * M2;
  else
    nf = 5 * N2 + 3 * M2;
  if (nf > (size_t)0x7fffffff) return cudaErrorInvalidValue;
  *nfloats = (int)nf;
  return cudaSuccess;
}

// Run npoints solves on `stream`, point p taking b + p·b_stride, the
// anchor c + p·c_stride, the cold start x0 + p·x0_stride and τ₀ tau0s[p]
// (tau0 when tau0s is null); see the option bits in Flag (kWarm is not
// taken).  A0 and A1 are Ar and Ai
// (m, n4), c and each x0 (n4, 2), all with n4 − n zero columns and 16-byte
// aligned; x_out is (npoints, n, 2), its (npoints, max_iters, n, 2) or
// null.  route is the plan's kernel, the one for n4 (0: n4 ≤ 512, 1: n4 ≤
// 8192, 2: the column fallback past it), tiles its (4, nblocks) table on the device (first row,
// end row, rows in registers — min(rows, 32) at n4 ≤ 256 on route 0, else
// 0 —, rows in shared memory; null on route 2) and smem_rows the most rows
// a block keeps in shared memory; bar two zeroed unsigned words that the
// launch leaves zeroed; work_f holds fasta_microsolve_planar_work floats,
// work_d fasta_fbs_work_doubles(nblocks) doubles.  fvals, bts, objs and
// nres may be null.
extern "C" int fasta_microsolve_planar(const float* A0, const float* A1, const float* b,
                                       int b_stride, const float* c, int c_stride,
                                       const float* x0, int x0_stride, const float* tau0s,
                                       int npoints, float tau0, int m, int n,
                                       int n4, int max_iters, int window, float tol,
                                       float shrink_factor, int max_backtracks, int stop_rule_code,
                                       int flags, float* x_out, float* taus, float* res,
                                       float* fvals, int* bts, float* objs, float* nres,
                                       float* its, int* k_out, int* status_out, const int* tiles,
                                       int route, int smem_rows, unsigned* bar, float* work_f,
                                       double* work_d, int nblocks, void* stream) {
  if (m < 1 || n < 1 || n4 < n || n4 % 4 || max_iters < 1 || window < 1 ||
      window > kWinMax || max_backtracks < 0 || stop_rule_code < kResidual ||
      stop_rule_code > kIterations || (flags & kWarm) || npoints < 1 || b_stride < 0 ||
      c_stride < 0 || x0_stride < 0 || route != route_of(n4) ||
      (route != kRouteColumns && !tiles) || smem_rows < 0 || !bar)
    return cudaErrorInvalidValue;
  int limit = 0, budget = 0, optin = 0, fixed = 0;
  if (fasta_microsolve_planar_grid(n4, &limit, &budget, &optin, &fixed) != cudaSuccess)
    return cudaErrorInvalidConfiguration;
  if (nblocks < 1 || nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  const bool accel = (flags & kAccel) != 0, hp = (flags & kHp) != 0;
  Args args{};
  args.A0 = A0;
  args.A1 = A1;
  args.pts = Points{b, x0, nullptr, tau0s, b_stride, x0_stride, 0, tau0};
  args.c = c;
  args.c_stride = c_stride;
  args.x_out = x_out;
  args.rec = Records{taus, res, fvals, bts, objs, nres};
  args.its = its;
  args.k_out = k_out;
  args.status_out = status_out;
  args.tiles = tiles;
  args.bar = bar;
  args.part = work_d;
  args.ctl = Control{max_iters, window, max_backtracks, stop_rule_code,
                     (flags & kRestart) != 0, tol, shrink_factor};
  args.npoints = npoints;
  args.m = m;
  args.n = n;
  args.n4 = n4;
  args.rdd = hp && (flags & kRestartDd);
  const size_t N2 = 2 * (size_t)n4, M2 = pad4(2 * m);
  float* w = work_f;
  if (state_on_chip(route, n4)) {
    args.gpart = w;
    args.gvec = w + (size_t)nblocks * N2;
    args.ftot = reinterpret_cast<double*>(args.gvec + N2);
    args.bbp = args.ftot + 2;
    w = args.gvec + N2 + 4 + 4 * kChunks;
  } else {
    for (int k = 0; k < 2; ++k) {
      args.X[k] = w + k * N2;
      args.G[k] = w + (2 + k) * N2;
    }
    args.xacc = w + 4 * N2;
    w += 5 * N2;
    if (route == kRouteWide) {
      args.gpart = w;
      w += (size_t)nblocks * N2;
    } else {
      args.lbuf = w;
      w += M2;
    }
  }
  args.dbuf = w;
  args.dacc = accel ? w + M2 : nullptr;
  const size_t smem =
      route == kRouteColumns ? 0 : state_bytes(route, n4) + (size_t)smem_rows * N2 * sizeof(float);
  if (route != kRouteColumns && (size_t)budget + state_bytes(route, n4) < smem)
    return cudaErrorInvalidValue;
  void* params[] = {&args};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)pick(route, n4, hp, accel), dim3(nblocks),
                                  dim3(kThreads), params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
