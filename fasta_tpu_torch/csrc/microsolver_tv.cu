// K-B6 and K-B6p: whole TV-dual FASTA solves in one launch,
//     min_p ½‖μ·div p − b‖²   s.t.  ‖p‖∞ ≤ 1,
// p a dual field (2, H, W) (channel 0 vertical, channel 1 horizontal), b
// an image (H, W), float32, in adaptive (BB) or FISTA mode, for one TV
// weight μ (K-B6), a path of weights, warm or cold (K-B6p), or a batch of
// images, each with its own start and τ₀, under one weight (K-B6b).  The
// stencils follow reference_oracle/generators.py: grad leaves the last
// row (channel 0) and column (channel 1) at zero, div is its adjoint.
//
// Replaces: fasta_tpu/kernels/microsolver_tv.py, microsolve_tv (pallas_call
// at :607) and microsolve_tv_path (:731), body _make_kernel — the TPU
// kernels that keep the state in VMEM and run the loop on one core, the
// path as a sequential grid with the warm carry in persistent scratch;
// K-B6b replaces microsolve_tv under jax.vmap (fasta_tpu/micro.py:435).
//
// Bound on this card: latency.  One adaptive iteration must read y, g and
// b and write x₁ and g₁, 36 B per pixel (9.4 MB at 512×512, 2.8 µs at
// 3.35 TB/s), but the phases depend on one another through the grid-wide
// decisions, so what a trial costs is its chain: phases, block
// reductions, grid barriers and the decision.
//
// Design, after K-B1 (microsolver.cu), whose rules it keeps:
//  * One persistent cooperative launch, at most one block per SM.  Each
//    block owns a band of whole image rows, both channels, in every phase:
//    the wrapper's band plan (kernels/microsolver_tv.py, band_plan) gives
//    block k the rows ⌊kH/nb⌋ to ⌊(k+1)H/nb⌋ and the blocks that own the
//    rows above and below its band.  A block without rows still joins
//    every barrier and reduction.
//  * Resident route: the band's state — the current field (FISTA: y) and
//    the trial x₁ with their gradients, r, b, and FISTA's d₁, d_acc and
//    x_acc, at most 12 floats a pixel — stays in shared memory for the
//    whole launch (512×512: 4 rows, 110 KB a block).  The wrapper takes it
//    for every image whose widest band fits the shared memory a block may
//    use; larger images take the global route, the same kernel with the
//    band's state in a work buffer in device memory (kStateSlots·H·W).
//  * Only band edges go through global memory.  div at (i, j) needs x₁ at
//    (i−1, j) and grad needs r at (i+1, j).  Each block publishes its
//    bottom row of (x_v, g_v), from which the block below recomputes x₁ at
//    (i−1, j), and its top row of r (start, FISTA), or, adaptive, its top
//    row of (x, g) in both channels, from which the block above recomputes
//    r at (i+1, j) (elementwise maps, so the values are bit-identical to
//    the owner's).  The edges of the fields a trial may make current are
//    double-buffered by parity, so a rejected trial leaves the current
//    ones intact.  On the resident route the warps that the decision's
//    sums leave free copy the edges a trial published into shared memory
//    while the decision is taken, so an accepted trial's successor finds
//    them on the chip (a rejected one's reads them from L2).
//  * An adaptive trial is one phase and one grid barrier: x₁ = clamp(y −
//    τg), d = μ·div x₁, r = d − b (and r on the row below the band), a
//    block barrier, then g₁ = μ·grad r with the BB partials.  FISTA: the
//    trial (phase T) has one barrier; after an acceptance, phase A (d_n =
//    d₁ + β(d₁ − d_acc), r_n) and phase B (g_n = μ·grad r_n, y_n, x_acc)
//    one each.  A point's start has two.
//  * Each phase reduces all its partials at once: a shuffle tree on each
//    value, one shared-memory round, one __syncthreads, and thread k adds
//    up the k-th value's warp sums and stores the block's partial
//    (reduce.cuh, block_sums).  Then every block reduces every block's
//    partials in one fixed order, one slot a warp with all loads in flight
//    (fbs_control.cuh, reduce_partials_wide), and takes the same decision
//    (fbs_control.cuh, shared with K-B1: uniform control flow around every
//    barrier; partials double-buffered by trial parity), thread 0
//    deciding.  With hp, f, the window, ⟨Δx,g⟩, ⟨Δx,Δg⟩ and (restart_dd)
//    the restart dot accumulate in FP64 (reduce.cuh), as in K-B1.  No
//    atomics: two runs give the same bits.
//  * The grid barrier is grid_barrier.cuh's: one release reduction a
//    block and an acquire spin, 1.06 µs a barrier against grid.sync's 1.20
//    (K-P1's barrier alone, matvec_probe.cu).
//  * 1024 threads a block: a trial's pixel work is bound by instruction
//    issue and latency, and at 512×512 and 2048×2048 twice 512's warps
//    hide more of it (at 16×16, all floor, 512 are faster).  A thread
//    walks its pixels of the band 1024 apart, stepping the row and column
//    with adds (no division a pixel).
//  * K-B6p runs the points in turn inside the launch, a grid barrier
//    between them; point i's solution is its output row, from which point
//    i+1 starts when the path is warm.  Adaptive mode also carries the
//    last genuinely accepted τ; FISTA restarts from the caller's τ₀; a
//    nonfinite point sends the next one back to x₀ (the JAX code's carry).
//    A single solve is a path of one point, so cold points are
//    bit-identical to separate K-B6 launches.
//  * K-B6b is the same loop over cold points that each take their own
//    image, start and τ₀ (Points in fbs_control.cuh) under a shared μ;
//    each runs over the whole grid, with the same bands, from reset state,
//    so every image is bit-identical to its own K-B6 launch.
//  * Elementwise formulas use the _rn intrinsics, so they round like the
//    plain PyTorch version's separate operations.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "fbs_control.cuh"
#include "grid_barrier.cuh"
#include "losses.cuh"
#include "reduce.cuh"

using namespace fasta;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// A band's state, one slot of floats a pixel each: the two fields
// (current, trial) and their gradients in both channels, r, b, and
// FISTA's d₁ and d_acc; FISTA's x_acc takes the trial gradient's slots,
// which FISTA does not use.
enum StateSlot { kX = 0, kG = 4, kR = 8, kB = 9, kD1 = 10, kDacc = 11, kStateSlots = 12 };
// Edge rows in global memory, (nblocks, W) each: by parity, the bottom
// row's x_v and g_v and the top row's x_v, x_h, g_v, g_h; then the top row
// of r and the global route's r on the row below the band.
enum EdgeSlot { kBotX, kBotG, kTopXv, kTopXh, kTopGv, kTopGh, kParitySlots };
constexpr int kRTop = 2 * kParitySlots, kRHalo = kRTop + 1, kEdgeSlots = kRHalo + 1;

struct Args {
  Points pts;         // each point's image b (H, W), cold x₀ (2, H, W), μ, τ₀
  float* x_out;       // (npath, 2, H, W)
  Records rec;
  int* k_out;         // (npath,)
  int* status_out;    // (npath,)
  float* state;       // global route: (kStateSlots, H·W); resident: unused
  float* edge;        // (kEdgeSlots, nblocks, W)
  const int* bands;   // (4, nblocks): first row, end row, block above, block below (−1: none)
  double* part;       // (3, kSlots, nblocks): work_doubles(nblocks)
  unsigned* bar;      // grid_barrier's counter, zero at launch
  Control ctl;
  int npath, H, W, N, band_rows, rdd, warm;
};

// the box prox clamp(z, −1, 1), NaN propagating as torch.clamp does: the
// NaN-propagating max and min of sm_80 and later, two instructions
__device__ __forceinline__ float box(float z) {
  float r;
  asm("max.NaN.f32 %0, %1, 0fBF800000;\n\tmin.NaN.f32 %0, %0, 0f3F800000;" : "=f"(r) : "f"(z));
  return r;
}

// x₁ = box(x − τg) at one pixel and channel
__device__ __forceinline__ float trial_at(float x, float g, float tau) {
  return box(step_hat(x, g, tau));
}

// μ·((up − here_v) + (left − here_h)): div at one pixel from the four
// channel values it reads (zero where the stencil leaves the image)
__device__ __forceinline__ float div_of(float up, float here_v, float left, float here_h, float mu) {
  return __fmul_rn(mu, __fadd_rn(__fsub_rn(up, here_v), __fsub_rn(left, here_h)));
}

// μ·(r_next − r_here), the grad stencil along one channel
__device__ __forceinline__ float grad_of(float next, float here, float mu) {
  return __fmul_rn(mu, __fsub_rn(next, here));
}

// A thread's pixels l = tid, tid + kThreads, … of a band of width W,
// with their rows i and columns j, stepped without a division a pixel.
struct Walk {
  int l, i, j;
  const int W, di, dj;
  __device__ __forceinline__ Walk(int row0, int W_)
      : l(threadIdx.x), i(row0 + threadIdx.x / W_), j(threadIdx.x % W_), W(W_),
        di(kThreads / W_), dj(kThreads % W_) {}
  __device__ __forceinline__ void next() {
    l += kThreads;
    i += di;
    j += dj;
    if (j >= W) {
      j -= W;
      ++i;
    }
  }
};

// Each phase's partials in block_sums' order (the floats, then the Acc
// values) and the slot each goes to (−1: none): adaptive ‖Δx‖², ‖g‖²,
// ‖x₁−x̂₁‖², ‖Δg‖², ⟨Δx,g⟩, 2f, ⟨Δx,Δg⟩; FISTA the same with the restart
// dot in place of the BB values, in float or (restart_dd) in Acc.
__device__ __forceinline__ int partial_slot(int k, bool accel, bool rdd) {
  switch (k) {
    case 0: return kNd2;
    case 1: return kNg2;
    case 2: return kNsm2;
    case 3: return accel ? (rdd ? -1 : kRdot) : kNdg2;
    case 4: return kBtDot;
    case 5: return kF;
    case 6: return accel ? (rdd ? kRdot : -1) : kBbDot;
    default: return -1;
  }
}

// Threads t = 0, 1, … < nt of a block (t < 0: none) copy the edge rows of
// parity par that a band reads — the block above's bottom row, the block
// below's top row — into cache (kParitySlots rows of W), eight loads in
// flight a thread.
__device__ __forceinline__ void fill_cache(float* cache, const float* edge, int par, int nb, int W,
                                           int above, int below, int t, int nt) {
  if (t < 0) return;
  const int total = kParitySlots * W;
  for (int e0 = t; e0 < total; e0 += 8 * nt) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * nt, s = e / W, k = s < kTopXv ? above : below;
      v[u] = e < total && k >= 0
                 ? __ldcg(edge + ((size_t)(par * kParitySlots + s) * nb + k) * W + (e - s * W))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (e0 + u * nt < total) cache[e0 + u * nt] = v[u];
  }
}

template <typename Acc, bool ACCEL, bool RES>
__global__ void __launch_bounds__(kThreads, 1) microsolve_tv_kernel(Args a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ Acc fwin[kWinMax];
  __shared__ float fsum[kWarps * 4];
  __shared__ Acc asum[kWarps * 3];
  __shared__ double tot[kReduced];
  __shared__ State st;
  __shared__ Acc f1s;        // FISTA: f(x₁) of the accepted trial
  __shared__ int carry_ok;   // the previous path point ended finite
  __shared__ float tprev;    // its warm τ carry

  const int tid = threadIdx.x;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int H = a.H, W = a.W, N = a.N;
  const int row0 = a.bands[blk], row1 = a.bands[nb + blk];
  const int above = a.bands[2 * nb + blk], below = a.bands[3 * nb + blk];
  const int q0 = row0 * W, npix = (row1 - row0) * W;
  // the band's state: slot s of pixel l is S(s, l), in shared memory or in
  // the band's rows of the work buffer; a field of two channels is the
  // slot of its channel 0 (channel 1 follows), so the current parity picks
  // slots by arithmetic
  using Idx = typename std::conditional<RES, int, size_t>::type;
  const Idx stride = RES ? Idx(a.band_rows * W) : Idx(N);
  float* const gstate = a.state + q0;
  auto S = [&](int s, int l) -> float& {
    return RES ? dyn[s * stride + l] : gstate[s * stride + l];
  };
  constexpr int kXacc = kG + 2;  // FISTA's x_acc
  // an edge row of block k (k ≥ 0 where it is read)
  auto edge = [&](int slot, int k) { return a.edge + ((size_t)slot * nb + (k < 0 ? 0 : k)) * W; };
  auto pedge = [&](int par, int slot, int k) { return edge(par * kParitySlots + slot, k); };
  float* const rtop = edge(kRTop, blk);
  float* const rhalo = RES ? dyn + kStateSlots * stride : edge(kRHalo, blk);
  // resident, adaptive: the neighbours' edge rows of the parity a trial
  // would make current (kParitySlots rows of W), copied into shared memory
  // while the decision is taken, and that parity (−1: none)
  float* const ecache = dyn + kStateSlots * stride + W;
  int cache_par = -1;
  double* P0 = a.part;
  unsigned gen = 0;
  auto barrier = [&]() { grid_barrier(a.bar, nb, gen); };
  // the edges of pixel (i, j) of a field made current with parity par
  auto publish = [&](int par, int i, int j, float xv, float xh, float gv, float gh) {
    if (i == row1 - 1 && below >= 0) {
      pedge(par, kBotX, blk)[j] = xv;
      pedge(par, kBotG, blk)[j] = gv;
    }
    if (!ACCEL && i == row0 && above >= 0) {
      pedge(par, kTopXv, blk)[j] = xv;
      pedge(par, kTopXh, blk)[j] = xh;
      pedge(par, kTopGv, blk)[j] = gv;
      pedge(par, kTopGh, blk)[j] = gh;
    }
  };
  int trial = 0;
  int carried = kX;  // the field the previous point ended in

  if (tid == 0) {
    carry_ok = 0;
    tprev = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < a.npath; ++p) {
    const float mu = a.pts.mu_at(p);
    const float* bp = a.pts.b_at(p);
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    const float* xs =
        (a.warm && p > 0 && carry_ok) ? a.x_out + (size_t)(p - 1) * 2 * N : a.pts.x0_at(p);
    const float tau_start =
        (a.warm && !ACCEL && p > 0 && tprev > 0.f) ? tprev : a.pts.tau0_at(p);
    cache_par = -1;

    // ---- point start: x₀, b, d₀ = μ·div x₀ and r₀ into the band (the top
    // row of r₀ published), f₀; then g₀ = μ·grad r₀ and the edges.  A warm
    // point takes its band from the previous point's state, still in the
    // band, and only the row above it from the previous point's output.
    {
      const bool from_band = a.warm && p > 0 && carry_ok;
      Acc fpart = Acc(0);
      for (Walk w(row0, W); w.l < npix; w.next()) {
        const int l = w.l, i = w.i, j = w.j, q = q0 + l;
        const float xv = from_band ? S(carried, l) : __ldcg(xs + q);
        const float xh = from_band ? S(carried + 1, l) : __ldcg(xs + N + q);
        const float up =
            i > 0 ? (from_band && i > row0 ? S(carried, l - W) : __ldcg(xs + q - W)) : 0.f;
        const float left =
            j > 0 ? (from_band ? S(carried + 1, l - 1) : __ldcg(xs + N + q - 1)) : 0.f;
        const float d = div_of(up, i < H - 1 ? xv : 0.f, left, j < W - 1 ? xh : 0.f, mu);
        const float bq = __ldg(bp + q);
        const float r = __fsub_rn(d, bq);
        S(kX, l) = xv;
        S(kX + 1, l) = xh;
        S(kR, l) = r;
        S(kB, l) = bq;
        if (ACCEL) {
          S(kDacc, l) = d;
          S(kXacc, l) = xv;
          S(kXacc + 1, l) = xh;
        }
        if (i == row0 && above >= 0) rtop[j] = r;
        fpart += Acc(r) * Acc(r);
      }
      fpart = fasta::block_sum(fpart, asum);
      if (tid == 0) P0[kF * nb + blk] = double(fpart);
      barrier();
      const float* rbelow = edge(kRTop, below);
      for (Walk w(row0, W); w.l < npix; w.next()) {
        const int l = w.l, i = w.i, j = w.j;
        const float rq = S(kR, l);
        const float gv =
            i < H - 1 ? grad_of(i + 1 < row1 ? S(kR, l + W) : __ldcg(rbelow + j), rq, mu) : 0.f;
        const float gh = j < W - 1 ? grad_of(S(kR, l + 1), rq, mu) : 0.f;
        S(kG, l) = gv;
        S(kG + 1, l) = gh;
        publish(0, i, j, S(kX, l), S(kX + 1, l), gv, gh);
      }
      if (tid < 32) {
        const Acc f = fasta::warp_sum_global<Acc>(P0 + kF * nb, nb);
        if (tid == 0) start_point(st, fwin, Acc(0.5f) * f, tau_start);
      }
      barrier();
    }

    for (;;) {
      ++trial;
      double* P = a.part + (size_t)(1 + (trial & 1)) * kSlots * nb;
      const float tau = st.tau;
      const int cur = st.cur;
      const int xc = kX + 2 * cur, gc = kG + 2 * cur, x1 = kX + 2 * (cur ^ 1);
      // the neighbours' edge rows: from shared memory when the copy made
      // during the last decision holds this parity, else from L2
      const bool cached = RES && !ACCEL && cache_par == cur;
      auto erow = [&](int slot, int k) { return cached ? ecache + slot * W : pedge(cur, slot, k); };
      auto ld_edge = [&](const float* q) { return cached ? *q : __ldcg(q); };
      const float* upx = erow(kBotX, above);
      const float* upg = erow(kBotG, above);
      // x₁ at (i−1, j): from the band, or from the row the block above
      // published
      auto x1_up = [&](int i, int l, int j) {
        if (i == 0) return 0.f;
        if (i > row0) return trial_at(S(xc, l - W), S(gc, l - W), tau);
        return trial_at(ld_edge(upx + j), ld_edge(upg + j), tau);
      };
      float fv[4] = {0.f, 0.f, 0.f, 0.f};  // ‖Δx‖², ‖g‖², ‖x₁−x̂₁‖², ‖Δg‖² or the restart dot
      Acc av[3] = {Acc(0), Acc(0), Acc(0)};  // ⟨Δx,g⟩, 2f, ⟨Δx,Δg⟩ or the FP64 restart dot

      if (!ACCEL) {
        // ---- the adaptive trial: x₁, d, r on the band and r on the row
        // below it (from the top row the block below published) ...
        const int g1 = kG + 2 * (cur ^ 1);
        const float* bx = erow(kTopXv, below);
        const float* bxh = erow(kTopXh, below);
        const float* bg = erow(kTopGv, below);
        const float* bgh = erow(kTopGh, below);
        const int nhalo = below >= 0 ? W : 0;
        for (Walk w(row0, W); w.l < npix + nhalo; w.next()) {
          const int e = w.l;
          if (e < npix) {
            const int l = e, i = w.i, j = w.j;
            const float xv = S(xc, l), xh = S(xc + 1, l), gv = S(gc, l), gh = S(gc + 1, l);
            const float zv = step_hat(xv, gv, tau), zh = step_hat(xh, gh, tau);
            const float x1v = box(zv), x1h = box(zh);
            S(x1, l) = x1v;
            S(x1 + 1, l) = x1h;
            const float dxv = __fsub_rn(x1v, xv), dxh = __fsub_rn(x1h, xh);
            const float smv = __fsub_rn(x1v, zv), smh = __fsub_rn(x1h, zh);
            fv[0] = fmaf(dxh, dxh, fmaf(dxv, dxv, fv[0]));
            fv[1] = fmaf(gh, gh, fmaf(gv, gv, fv[1]));
            fv[2] = fmaf(smh, smh, fmaf(smv, smv, fv[2]));
            av[0] += Acc(dxv) * Acc(gv);
            av[0] += Acc(dxh) * Acc(gh);
            const float left = j > 0 ? trial_at(S(xc + 1, l - 1), S(gc + 1, l - 1), tau) : 0.f;
            const float d =
                div_of(x1_up(i, l, j), i < H - 1 ? x1v : 0.f, left, j < W - 1 ? x1h : 0.f, mu);
            const float r = __fsub_rn(d, S(kB, l));
            S(kR, l) = r;
            av[1] += Acc(r) * Acc(r);
          } else {
            const int j = e - npix, i = row1, l = npix - W + j;
            const float x1v = trial_at(ld_edge(bx + j), ld_edge(bg + j), tau);
            const float x1h = trial_at(ld_edge(bxh + j), ld_edge(bgh + j), tau);
            const float left =
                j > 0 ? trial_at(ld_edge(bxh + j - 1), ld_edge(bgh + j - 1), tau) : 0.f;
            const float up = trial_at(S(xc, l), S(gc, l), tau);
            const float d = div_of(up, i < H - 1 ? x1v : 0.f, left, j < W - 1 ? x1h : 0.f, mu);
            rhalo[j] = __fsub_rn(d, __ldg(bp + (size_t)i * W + j));
          }
        }
        __syncthreads();
        // ... then g₁ = μ·grad r, the BB partials and the edges of x₁, g₁
        for (Walk w(row0, W); w.l < npix; w.next()) {
          const int l = w.l, i = w.i, j = w.j;
          const float rq = S(kR, l);
          const float gv1 =
              i < H - 1 ? grad_of(i + 1 < row1 ? S(kR, l + W) : rhalo[j], rq, mu) : 0.f;
          const float gh1 = j < W - 1 ? grad_of(S(kR, l + 1), rq, mu) : 0.f;
          S(g1, l) = gv1;
          S(g1 + 1, l) = gh1;
          const float xv = S(xc, l), xh = S(xc + 1, l);
          const float zv = step_hat(xv, S(gc, l), tau), zh = step_hat(xh, S(gc + 1, l), tau);
          const float x1v = S(x1, l), x1h = S(x1 + 1, l);
          const float dxv = __fsub_rn(x1v, xv), dxh = __fsub_rn(x1h, xh);
          // Δg = g₁ + (x̂₁ − y)/τ  (== g₁ − g, in the TPU kernel's rounding)
          const float dgv = __fadd_rn(gv1, __fdiv_rn(__fsub_rn(zv, xv), tau));
          const float dgh = __fadd_rn(gh1, __fdiv_rn(__fsub_rn(zh, xh), tau));
          av[2] += Acc(dxv) * Acc(dgv);
          av[2] += Acc(dxh) * Acc(dgh);
          fv[3] = fmaf(dgh, dgh, fmaf(dgv, dgv, fv[3]));
          publish(cur ^ 1, i, j, x1v, x1h, gv1, gh1);
        }
      } else {
        // ---- phase T (FISTA): x₁, the restart dot ⟨y − x₁, x₁ − x_acc⟩, d₁
        for (Walk w(row0, W); w.l < npix; w.next()) {
          const int l = w.l, i = w.i, j = w.j;
          const float xv = S(xc, l), xh = S(xc + 1, l), gv = S(gc, l), gh = S(gc + 1, l);
          const float zv = step_hat(xv, gv, tau), zh = step_hat(xh, gh, tau);
          const float x1v = box(zv), x1h = box(zh);
          S(x1, l) = x1v;
          S(x1 + 1, l) = x1h;
          const float dxv = __fsub_rn(x1v, xv), dxh = __fsub_rn(x1h, xh);
          const float smv = __fsub_rn(x1v, zv), smh = __fsub_rn(x1h, zh);
          fv[0] = fmaf(dxh, dxh, fmaf(dxv, dxv, fv[0]));
          fv[1] = fmaf(gh, gh, fmaf(gv, gv, fv[1]));
          fv[2] = fmaf(smh, smh, fmaf(smv, smv, fv[2]));
          av[0] += Acc(dxv) * Acc(gv);
          av[0] += Acc(dxh) * Acc(gh);
          const float rav = __fsub_rn(xv, x1v), rbv = __fsub_rn(x1v, S(kXacc, l));
          const float rah = __fsub_rn(xh, x1h), rbh = __fsub_rn(x1h, S(kXacc + 1, l));
          if (a.rdd) {
            av[2] += Acc(rav) * Acc(rbv);
            av[2] += Acc(rah) * Acc(rbh);
          } else {
            fv[3] = fmaf(rah, rbh, fmaf(rav, rbv, fv[3]));
          }
          const float left = j > 0 ? trial_at(S(xc + 1, l - 1), S(gc + 1, l - 1), tau) : 0.f;
          const float d =
              div_of(x1_up(i, l, j), i < H - 1 ? x1v : 0.f, left, j < W - 1 ? x1h : 0.f, mu);
          S(kD1, l) = d;
          const float r = __fsub_rn(d, S(kB, l));
          av[1] += Acc(r) * Acc(r);
        }
      }
      {
        const double v = block_sums(fv, av, fsum, asum);
        const int slot = tid < 7 ? partial_slot(tid, ACCEL, a.rdd) : -1;
        if (slot >= 0) P[slot * nb + blk] = v;
      }
      barrier();
      if (RES && !ACCEL) {
        // the warps the decision's sums leave free copy the edge rows the
        // trial published, which the next trial reads if it is accepted
        cache_par = cur ^ 1;
        fill_cache(ecache, a.edge, cache_par, nb, W, above, below, tid - 32 * kCommon,
                   kThreads - 32 * kCommon);
      }

      // ---- the decision: every block reduces the same partials in the
      // same order and takes the same decision (g, the box indicator, is
      // 0 at the prox point)
      reduce_partials_wide<Acc, ACCEL>(P, nb, false, a.rdd, tot);
      __syncthreads();
      if (tid == 0) {
        State s = st;
        decide<Acc, ACCEL>(s, tot, fwin, f1s, 0.5f, 0.f, a.ctl, a.rec, rec0, blk == 0);
        st = s;
      }
      __syncthreads();

      if (ACCEL && st.post) {
        const float beta = st.beta;
        // ---- phase A: d_n = d₁ + β(d₁ − d_acc), r_n = d_n − b (its top
        // row published), partial f
        {
          Acc fpart = Acc(0);
          for (int l = tid; l < npix; l += kThreads) {
            const float d1 = S(kD1, l), da = S(kDacc, l);
            const float dn = __fadd_rn(d1, __fmul_rn(beta, __fsub_rn(d1, da)));
            S(kDacc, l) = d1;
            const float r = __fsub_rn(dn, S(kB, l));
            S(kR, l) = r;
            if (l < W && above >= 0) rtop[l] = r;
            fpart += Acc(r) * Acc(r);
          }
          fpart = fasta::block_sum(fpart, asum);
          if (tid == 0) P[kFn * nb + blk] = double(fpart);
        }
        barrier();
        // ---- phase B: g_n = μ·grad r_n, y_n = x₁ + β(x₁ − x_acc), x_acc =
        // x₁; the bottom row of (y_v, g_v) published
        {
          const float* rbelow = edge(kRTop, below);
          for (Walk w(row0, W); w.l < npix; w.next()) {
            const int l = w.l, i = w.i, j = w.j;
            const float rq = S(kR, l);
            const float gv = i < H - 1
                                 ? grad_of(i + 1 < row1 ? S(kR, l + W) : __ldcg(rbelow + j), rq, mu)
                                 : 0.f;
            const float gh = j < W - 1 ? grad_of(S(kR, l + 1), rq, mu) : 0.f;
            S(gc, l) = gv;
            S(gc + 1, l) = gh;
            float y[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float xv1 = S(x1 + c, l), xa = S(kXacc + c, l);
              y[c] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
              S(xc + c, l) = y[c];
              S(kXacc + c, l) = xv1;
            }
            publish(cur, i, j, y[0], y[1], gv, gh);
          }
        }
        barrier();
        if (tid < 32) {
          const Acc fn = Acc(0.5f) * fasta::warp_sum_global<Acc>(P + kFn * nb, nb);
          if (tid == 0) {
            State s = st;
            finish_fista(s, fn, f1s, fwin, a.ctl, a.rec, rec0, blk == 0);
            st = s;
          }
        }
        __syncthreads();
      }
      if (st.done) break;
    }

    // ---- point end: the solution (FISTA: x₁ on a converged stop, else
    // the extrapolated y), its counts, and the warm carry
    const int xf = (ACCEL && st.status == 1) ? kXacc : kX + 2 * st.cur;
    carried = xf;
    float* xo = a.x_out + (size_t)p * 2 * N + q0;
    for (int l = tid; l < npix; l += kThreads) {
      xo[l] = S(xf, l);
      xo[N + l] = S(xf + 1, l);
    }
    if (blk == 0 && tid == 0) {
      a.k_out[p] = st.k;
      a.status_out[p] = st.status;
    }
    if (tid == 0) {
      const bool ok = st.status != 2;
      carry_ok = ok;
      tprev = (ok && st.k > 0 && st.tau_acc > 0.f) ? st.tau_acc : st.tau_start;
    }
    if (p + 1 < a.npath) barrier();  // the next point may start from xo
  }
}

template <bool RES>
const void* kernel_for(bool hp, bool accel) {
  return hp ? (accel ? (const void*)microsolve_tv_kernel<double, true, RES>
                     : (const void*)microsolve_tv_kernel<double, false, RES>)
            : (accel ? (const void*)microsolve_tv_kernel<float, true, RES>
                     : (const void*)microsolve_tv_kernel<float, false, RES>);
}

// dynamic shared memory of the resident route: the band's state slots, the
// r row below it and the copy of the neighbours' edge rows (the same
// formula as kernels/microsolver_tv.py's resident_bytes)
size_t resident_bytes(int band_rows, int W) {
  return ((size_t)kStateSlots * band_rows * W + (1 + kParitySlots) * W) * sizeof(float);
}

cudaError_t max_blocks(int* nblocks) {
  const void* fns[8];
  for (int i = 0; i < 4; ++i) {
    fns[i] = kernel_for<false>(i & 1, i & 2);
    fns[4 + i] = kernel_for<true>(i & 1, i & 2);
  }
  return cooperative_blocks(fns, 8, kThreads, nblocks);
}

}  // namespace

// The cooperative grid size on the current device, one block per SM (0 if
// the kernel cannot be resident at all), and the dynamic shared memory a
// block of the resident route may take: the device's per-block opt-in
// less the kernel's static shared memory.
extern "C" int fasta_microsolve_tv_grid(int* nblocks, int* smem_budget) {
  cudaError_t err = max_blocks(nblocks);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  size_t fixed = 0;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel_for<true>(i & 1, i & 2));
    fixed = attr.sharedSizeBytes > fixed ? attr.sharedSizeBytes : fixed;
  }
  if (err != cudaSuccess) return err;
  *smem_budget = optin > (int)fixed ? optin - (int)fixed : 0;
  return cudaSuccess;
}

// Run npath TV-dual solves on `stream`: point p takes the image
// b + p·b_stride, the cold start x0 + p·x0_stride, the weight
// mus[p·mu_stride] and τ₀ tau0s[p] (tau0 when tau0s is null); see the
// option bits in Flag.  Outputs have a leading axis of npath.  bands
// holds the band plan (4·nblocks ints on the device), band_rows its widest
// band; resident != 0 keeps the bands in shared memory, else in state
// (12·H·W floats).  edge holds 14·nblocks·W floats, work_d
// fasta_fbs_work_doubles(nblocks) doubles (microsolver.cu); bar is a zeroed
// counter for grid_barrier.cuh.  fvals, bts, objs and nres may be null.
extern "C" int fasta_microsolve_tv(const float* b, int b_stride, const float* x0, int x0_stride,
                                   const float* mus, int mu_stride, const float* tau0s, int npath,
                                   float tau0, int H, int W, int max_iters, int window, float tol,
                                   float shrink_factor, int max_backtracks, int stop_rule_code,
                                   int flags, float* x_out, float* taus, float* res, float* fvals,
                                   int* bts, float* objs, float* nres, int* k_out, int* status_out,
                                   const int* bands, int band_rows, int resident, float* state,
                                   float* edge, unsigned* bar, double* work_d, int nblocks,
                                   void* stream) {
  if (H < 1 || W < 1 || (long long)H * W > (1LL << 28) || npath < 1 || max_iters < 1 ||
      window < 1 || window > kWinMax || max_backtracks < 0 || stop_rule_code < kResidual ||
      stop_rule_code > kIterations || b_stride < 0 || x0_stride < 0 || mu_stride < 0 ||
      band_rows < 1 || band_rows > H || (!resident && !state) || !bar)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = max_blocks(&limit);
  if (err != cudaSuccess) return err;
  if (nblocks < 1 || nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  Args args{};
  args.pts = Points{b, x0, mus, tau0s, b_stride, x0_stride, mu_stride, tau0};
  args.x_out = x_out;
  args.rec = Records{taus, res, fvals, bts, objs, nres};
  args.k_out = k_out;
  args.status_out = status_out;
  args.state = state;
  args.edge = edge;
  args.bands = bands;
  args.part = work_d;
  args.bar = bar;
  args.npath = npath;
  args.H = H;
  args.W = W;
  args.N = H * W;
  args.band_rows = band_rows;
  args.ctl = Control{max_iters, window, max_backtracks, stop_rule_code,
                     (flags & kRestart) != 0, tol, shrink_factor};
  args.rdd = (flags & kHp) && (flags & kRestartDd);
  args.warm = (flags & kWarm) != 0;
  void* params[] = {&args};
  const bool hp = (flags & kHp) != 0, accel = (flags & kAccel) != 0;
  const void* fn = resident ? kernel_for<true>(hp, accel) : kernel_for<false>(hp, accel);
  const size_t smem = resident ? resident_bytes(band_rows, W) : 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}
