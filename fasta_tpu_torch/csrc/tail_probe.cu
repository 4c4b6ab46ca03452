// K-P3: the tail-ablation ladder of the dense whole-solve iteration.
//
// K in-kernel iterations of a cumulative ladder of kernels, each adding one
// piece of the adaptive FBS body (LASSO, μ = 0.1, τ₀ = 0.05, window 10,
// shrink 0.2, at most 20 backtracks) at the position the TPU probe adds
// it:
//   L0  x̂ = x − τg, d = A x, f = ½‖d − b‖², g₁ = Aᵀ(d − b)  (no prox)
//   L1  + the shrink and Δx
//   L2  + the backtracking loop and its reductions ‖Δx‖², ⟨Δx,g⟩ (with no
//         window the test never fails)
//   L3  + the nonmonotone window (its max and update)
//   L4  + the residual and stopping sums (‖Δx‖² again, ‖g‖², ‖x₁ − x̂‖²;
//         the test "< −1" never fires)
//   L5  + the BB scalars (⟨Δx,Δg⟩, ‖Δg‖², the Zhou–Gao–Dai select)
//   L6  + the τ / residual records (the first 128 iterations)
// Every iteration restarts from x = x₀ + 0·x₁ (+ 0·stop), so the run never
// converges and its work stays the same; g and τ carry over.  The X
// variants each change one thing of L6 and compute L6's math:
//   X1  the adjoint by tiles of columns of A, with no contiguous Aᵀ copy
//       (K-B1's wrapper builds that copy on every launch);
//   X2  ‖Δx‖² and ⟨Δx,g⟩ reduced once per trial and reused by the
//       backtrack, the stop test and BB (no second ‖Δx‖² partial);
//   X3  the decision chain in registers: every warp reduces the partials
//       and every thread decides, with no thread-0 decision and no
//       shared-memory broadcast;
//   X4  BB's and the stop test's four dots (‖g‖², ‖x₁−x̂‖², ⟨Δx,Δg⟩,
//       ‖Δg‖²) reduced as one stacked (nblocks, 4) pass;
//   X5  the first trial outside the backtracking loop, the loop behind a
//       rarely taken branch.
// On the TPU the X variants were cumulative; here each is L6 plus one
// change, so that a difference reads as that change alone and X2, X3, X4
// and X5 keep L6's summation order (bit-identical results).
//
// Replaces: benchmarks/micro_tail_probe.py, make(level, col=, thread=,
// vecscal=, fusedred=, condbt=) → run (pallas_call at :411; bodies kern
// :243 and kern_vecscal :104), which split the TPU whole-solve iteration
// between the matvec pair and the serial decision chain.
//
// Bound on this card: A read once per launch (8 MB at 1000×2000, then
// resident in L2) and 4mn + O(m + n) float32 operations per trial — a
// fraction of a microsecond.  What the ladder measures is everything
// else: three grid barriers per trial, the passes over A in L2, the block
// and grid reductions and the decision latency.
//
// Design: K-B1's own structure (csrc/microsolver.cu) with hp off — one
// cooperative launch, one block per SM, 512 threads; a trial is
//   P  the step over each block's columns (x̂, x₁, Δx, the column partials);
//   F  d = A x₁ over the rows, a warp per row, r = d − b and the f partial;
//   G  g₁ = Aᵀr, a warp per row of a contiguous Aᵀ (X1: column tiles of A
//      with a fixed pairwise tree over row lanes), with the BB partials;
// each phase ended by a grid barrier.  Then every block reduces the same
// float32 per-block partials in one fixed order (lane-strided, then the
// shuffle tree) and takes the same decisions (as fbs_control.cuh does):
// the uniform control flow the barriers need.  Partials are double-
// buffered by trial parity.  Elementwise formulas use the _rn intrinsics,
// so they round as the plain PyTorch version's separate operations.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "fbs_control.cuh"
#include "prox.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;
using fasta::nanmax;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 16;
constexpr int kRowLanes = kThreads / (kTileCols / 4);
constexpr int kWindow = 10;
constexpr int kMaxBt = 20;
constexpr int kRec = 128;
constexpr float kMu = 0.1f;
constexpr float kTau0 = 0.05f;
constexpr float kShrink = 0.2f;

// the variants, in the order of kernels.tail_probe.VARIANTS
enum Variant { kLadder, kCol, kThread, kVec, kFused, kCondbt, kVariants };
// per-block partial slots; the last four are stacked (nblocks, 4) under X4
enum Slot { kF, kNd2, kRdg, kNd2b, kGg, kSs, kDot, kNdg2, kSlots };
constexpr int kStacked = kGg;

struct Args {
  const float* A;   // (m, n)
  const float* At;  // (n, m) contiguous transpose, or null (X1)
  const float* b;
  const float* x0;
  int m, n, K;
  float* x_out;   // (n,)
  float* g_out;   // (n,)
  float* tau_out; // (1,)
  float* taus;    // (kRec,)
  float* res;     // (kRec,)
  int* trials;    // (1,)
  float* x1;      // (pn,) the trial's prox point
  float* g;       // (2, pn) the current and the trial's gradient
  float* r;       // (m,) d − b
  float* xcur;    // (pn,) the iteration's x
  float* part;    // (2, kSlots, nblocks)
  float* stack;   // (2, nblocks, 4)
  int pn;
};

// The decision state.  With X3 every thread holds it; otherwise thread 0
// of each block decides and publishes τ, the iteration, the buffer index,
// the stop flag and the backtrack verdict through shared memory.
struct State {
  float tau, maxres, stopf;
  int k, cnt, cur, viol;
  float fwin[kWindow];
};

struct Pub {
  float tau, stopf;
  int k, cur, viol;
};

// row · v over L entries by one warp (fixed order); the sum in lane 0.
__device__ __forceinline__ float row_dot(const float* __restrict__ row, const float* v, int L,
                                         int lane) {
  float s = 0.f;
  if ((L & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int q = lane; q < (L >> 2); q += 32) {
      const float4 a = __ldg(r4 + q), w = __ldcg(v4 + q);
      s = fmaf(a.x, w.x, s);
      s = fmaf(a.y, w.y, s);
      s = fmaf(a.z, w.z, s);
      s = fmaf(a.w, w.w, s);
    }
  } else {
    for (int j = lane; j < L; j += 32) s = fmaf(__ldg(row + j), __ldcg(v + j), s);
  }
  return fasta::warp_sum(s);
}

// Σ of a slot's nb partials: lane-strided in index order, then the shuffle
// tree.  ALL: a butterfly, the same value in every lane (it pairs lanes as
// warp_sum's tree does for lane 0, so the sums are bit-identical); else
// lane 0 only.
template <bool ALL>
__device__ __forceinline__ float slot_sum(const float* p, int nb) {
  const int lane = threadIdx.x & 31;
  float v = 0.f;
  for (int i = lane; i < nb; i += 32) v += __ldcg(p + i);
  if (ALL) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  }
  return fasta::warp_sum(v);
}

// the four stacked slots in one pass of 16-byte loads, in the same order
template <bool ALL>
__device__ __forceinline__ float4 stack_sum(const float* p, int nb) {
  const int lane = threadIdx.x & 31;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = lane; i < nb; i += 32) {
    const float4 w = __ldcg(reinterpret_cast<const float4*>(p) + i);
    v.x += w.x;
    v.y += w.y;
    v.z += w.z;
    v.w += w.w;
  }
  if (ALL) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, off);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, off);
    }
    return v;
  }
  return make_float4(fasta::warp_sum(v.x), fasta::warp_sum(v.y), fasta::warp_sum(v.z),
                     fasta::warp_sum(v.w));
}

__device__ __forceinline__ void start(State& s, float f0) {
  s.tau = kTau0;
  s.maxres = -CUDART_INF_F;
  s.stopf = 0.f;
  s.k = s.cnt = s.cur = s.viol = 0;
#pragma unroll
  for (int w = 0; w < kWindow; ++w) s.fwin[w] = w == 0 ? f0 : -CUDART_INF_F;
}

// the backtracking test after a trial; a violation shrinks τ
template <int L>
__device__ __forceinline__ void test_trial(State& s, float f1, float nd2, float rdg) {
  s.viol = 0;
  if (L < 2) return;
  float M = CUDART_INF_F;
  if (L >= 3) {
    M = s.fwin[0];
#pragma unroll
    for (int w = 1; w < kWindow; ++w) M = nanmax(M, s.fwin[w]);
  }
  const float suff = __fadd_rn(__fadd_rn(M, rdg), __fdiv_rn(nd2, __fmul_rn(2.f, s.tau)));
  s.viol = (__fsub_rn(f1, 1e-12f) > suff) && s.cnt < kMaxBt;
  if (s.viol) {
    s.tau = __fmul_rn(s.tau, kShrink);
    s.cnt += 1;
  }
}

// the end of an iteration after its accepted trial: the window, the
// residual and stop test, the BB stepsize, the records
template <int L>
__device__ __forceinline__ void accept(State& s, float f1, float nd2, float gg, float ss, float dot,
                                       float ndg2, float* taus, float* rres, bool write) {
  const float tau = s.tau;
  float res = f1, tau_n = tau;
  bool stop = false;
  if (L >= 3) {
    const int w = (s.k + 1) % kWindow;
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      if (i == w) s.fwin[i] = f1;
  }
  if (L >= 4) {
    res = __fdiv_rn(sqrtf(nd2), tau);
    s.maxres = nanmax(s.maxres, res);
    const float nrm = __fadd_rn(nanmax(sqrtf(gg), __fdiv_rn(sqrtf(ss), tau)), 1e-8f);
    const float nres = __fdiv_rn(res, nrm);
    stop = (__fdiv_rn(res, __fadd_rn(s.maxres, 1e-8f)) < -1.f) || (nres < -1.f);
  }
  if (L >= 5) {
    const float tau_s = dot != 0.f ? __fdiv_rn(nd2, dot) : CUDART_INF_F;
    const float tau_m = nanmax(ndg2 > 0.f ? __fdiv_rn(dot, ndg2) : 0.f, 0.f);
    tau_n = __fmul_rn(2.f, tau_m) > tau_s ? tau_m : __fsub_rn(tau_s, __fmul_rn(0.5f, tau_m));
    if (tau_n <= 0.f || isinf(tau_n) || isnan(tau_n)) tau_n = __fmul_rn(tau, 1.5f);
  }
  if (L >= 6 && write && s.k < kRec) {
    taus[s.k] = tau;
    rres[s.k] = res;
  }
  s.stopf = stop ? 1.f : 0.f;
  s.tau = tau_n;
  s.cur ^= 1;
  s.k += 1;
  s.cnt = 0;
}

template <int L, int X>
__global__ void __launch_bounds__(kThreads, 1) tail_kernel(Args a) {
  constexpr bool COL = X == kCol, THREAD = X == kThread, VEC = X == kVec;
  constexpr bool FUSED = X == kFused, CONDBT = X == kCondbt;
  cg::grid_group grid = cg::this_grid();
  __shared__ float scr[kWarps];
  __shared__ float tree[kRowLanes][kTileCols];
  __shared__ Pub pub;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gthreads = nb * kThreads;
  const int gwarp = blk * kWarps + warp, gwarps = nb * kWarps;
  const int m = a.m, n = a.n;
  float* G[2] = {a.g, a.g + a.pn};
  const bool decider = VEC || tid == 0;  // holds the authoritative state
  const bool writer = blk == 0 && tid == 0;
  State st;
  int ntrial = 0;

  // d = A x over this block's rows: r = d − b, the partial Σr²
  auto rows = [&](const float* x) {
    float fp = 0.f;
    for (int i = gwarp; i < m; i += gwarps) {
      const float d = row_dot(a.A + (size_t)i * n, x, n, lane);
      if (lane == 0) {
        const float r = __fsub_rn(d, __ldg(a.b + i));
        a.r[i] = r;
        fp = fmaf(r, r, fp);
      }
    }
    return fasta::block_sum(fp, scr);
  };
  // g₁ = Aᵀr into G1 over this block's columns; with BB, the partials
  // ⟨Δx,Δg⟩ and ‖Δg‖² of the trial at τ from gc
  auto adjoint = [&](float* G1, const float* gc, float tau, bool bb, float& dot, float& ndg2) {
    auto column = [&](int j, float gj) {
      G1[j] = gj;
      if (bb) {
        const float xv = __ldcg(a.xcur + j), gv = __ldcg(gc + j);
        const float xh = __fsub_rn(xv, __fmul_rn(tau, gv));
        const float dx = __fsub_rn(__ldcg(a.x1 + j), xv);
        const float dg = __fadd_rn(gj, __fdiv_rn(__fsub_rn(xh, xv), tau));
        dot = fmaf(dx, dg, dot);
        ndg2 = fmaf(dg, dg, ndg2);
      }
    };
    if (!COL) {
      for (int j = gwarp; j < n; j += gwarps) {
        const float gj = row_dot(a.At + (size_t)j * m, a.r, m, lane);
        if (lane == 0) column(j, gj);
      }
    } else {
      constexpr int GR = kTileCols / 4;
      const int rl = tid / GR, gl = tid % GR;
      const int ntiles = (n + kTileCols - 1) / kTileCols;
      for (int t = blk; t < ntiles; t += nb) {
        const int q = t * GR + gl;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (q < (n >> 2)) {
#pragma unroll 4
          for (int i = rl; i < m; i += kRowLanes) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(a.A + (size_t)i * n) + q);
            const float ri = __ldcg(a.r + i);
            acc[0] = fmaf(v.x, ri, acc[0]);
            acc[1] = fmaf(v.y, ri, acc[1]);
            acc[2] = fmaf(v.z, ri, acc[2]);
            acc[3] = fmaf(v.w, ri, acc[3]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) tree[rl][gl * 4 + c] = acc[c];
        __syncthreads();
        for (int s = kRowLanes / 2; s > 0; s >>= 1) {
          if (rl < s)
#pragma unroll
            for (int c = 0; c < 4; ++c) tree[rl][gl * 4 + c] += tree[rl + s][gl * 4 + c];
          __syncthreads();
        }
        const int j = t * kTileCols + tid;
        if (tid < kTileCols && j < n) column(j, tree[0][tid]);
        __syncthreads();  // tree is rewritten by the next tile
      }
    }
  };
  // a decision the deciders took, seen by every thread
  auto publish = [&]() {
    if (VEC) return;
    if (tid == 0) pub = Pub{st.tau, st.stopf, st.k, st.cur, st.viol};
    __syncthreads();
    st.tau = pub.tau;
    st.stopf = pub.stopf;
    st.k = pub.k;
    st.cur = pub.cur;
    st.viol = pub.viol;
    __syncthreads();  // pub is rewritten by the next decision
  };

  // ---- start: d₀ = A x₀, f₀, g₀ = Aᵀ(d₀ − b), xcur = x₀
  {
    const float fp = rows(a.x0);
    if (tid == 0) a.part[kF * nb + blk] = fp;
    for (int j = gtid; j < n; j += gthreads) a.xcur[j] = __ldg(a.x0 + j);
    grid.sync();
    float unused0 = 0.f, unused1 = 0.f;
    adjoint(G[0], G[1], 0.f, false, unused0, unused1);
    if (VEC || warp == 0) {
      const float f0 = __fmul_rn(0.5f, slot_sum<VEC>(a.part + kF * nb, nb));
      if (decider) start(st, f0);
    }
    if (!VEC) {
      if (tid != 0) start(st, 0.f);
    }
    grid.sync();
  }

  float f1 = 0.f, nd2 = 0.f;  // the last trial's, at the deciders
  // one line-search trial at st.tau; returns the backtrack verdict (the
  // same in every thread of every block)
  auto trial = [&](bool first) -> bool {
    ++ntrial;
    float* P = a.part + (size_t)(ntrial & 1) * kSlots * nb;
    float* S = a.stack + (size_t)(ntrial & 1) * nb * 4;
    const float tau = st.tau;
    const float* gc = G[st.cur];
    // ---- phase P: the step over this block's columns
    {
      float pnd2 = 0.f, prdg = 0.f, pnd2b = 0.f, pgg = 0.f, pss = 0.f;
      const float tmu = __fmul_rn(tau, kMu), zstop = __fmul_rn(0.f, st.stopf);
      for (int j = gtid; j < n; j += gthreads) {
        float xv;
        if (first && st.k > 0) {
          xv = __fadd_rn(__fadd_rn(__ldg(a.x0 + j), __fmul_rn(0.f, a.x1[j])), zstop);
          a.xcur[j] = xv;
        } else {
          xv = a.xcur[j];
        }
        const float gv = __ldcg(gc + j);
        const float xh = __fsub_rn(xv, __fmul_rn(tau, gv));
        const float x1 = L >= 1 ? fasta::shrink(xh, tmu) : xv;
        const float dx = __fsub_rn(x1, xv);
        a.x1[j] = x1;
        if (L >= 2) {
          pnd2 = fmaf(dx, dx, pnd2);
          prdg = fmaf(dx, gv, prdg);
        }
        if (L >= 4) {
          if (!THREAD) pnd2b = fmaf(dx, dx, pnd2b);
          const float sm = __fsub_rn(x1, xh);
          pgg = fmaf(gv, gv, pgg);
          pss = fmaf(sm, sm, pss);
        }
      }
      if (L >= 2) {
        pnd2 = fasta::block_sum(pnd2, scr);
        prdg = fasta::block_sum(prdg, scr);
      }
      if (L >= 4) {
        if (!THREAD) pnd2b = fasta::block_sum(pnd2b, scr);
        pgg = fasta::block_sum(pgg, scr);
        pss = fasta::block_sum(pss, scr);
      }
      if (tid == 0) {
        if (L >= 2) {
          P[kNd2 * nb + blk] = pnd2;
          P[kRdg * nb + blk] = prdg;
        }
        if (L >= 4) {
          if (!THREAD) P[kNd2b * nb + blk] = pnd2b;
          if (FUSED) {
            S[blk * 4 + kGg - kStacked] = pgg;
            S[blk * 4 + kSs - kStacked] = pss;
          } else {
            P[kGg * nb + blk] = pgg;
            P[kSs * nb + blk] = pss;
          }
        }
      }
    }
    grid.sync();
    // ---- phase F: d = A x₁, r, the f partial
    {
      const float fp = rows(a.x1);
      if (tid == 0) P[kF * nb + blk] = fp;
    }
    grid.sync();
    // ---- phase G: g₁ = Aᵀr, the BB partials
    {
      float pdot = 0.f, pndg2 = 0.f;
      adjoint(G[st.cur ^ 1], gc, tau, L >= 5, pdot, pndg2);
      if (L >= 5) {
        pdot = fasta::block_sum(pdot, scr);
        pndg2 = fasta::block_sum(pndg2, scr);
        if (tid == 0) {
          if (FUSED) {
            S[blk * 4 + kDot - kStacked] = pdot;
            S[blk * 4 + kNdg2 - kStacked] = pndg2;
          } else {
            P[kDot * nb + blk] = pdot;
            P[kNdg2 * nb + blk] = pndg2;
          }
        }
      }
    }
    grid.sync();
    // ---- the backtracking test, from the reduced partials
    if (VEC || warp == 0) {
      const float f = __fmul_rn(0.5f, slot_sum<VEC>(P + kF * nb, nb));
      const float n2 = L >= 2 ? slot_sum<VEC>(P + kNd2 * nb, nb) : 0.f;
      const float rd = L >= 2 ? slot_sum<VEC>(P + kRdg * nb, nb) : 0.f;
      if (decider) {
        f1 = f;
        nd2 = n2;
        test_trial<L>(st, f, n2, rd);
      }
    }
    publish();
    return st.viol != 0;
  };

  for (int k = 0; k < a.K; ++k) {
    if (L < 2) {
      trial(true);
    } else if (CONDBT) {
      if (trial(true))
        while (trial(false)) {
        }
    } else {
      bool first = true;
      while (trial(first)) first = false;
    }
    // ---- the accepted trial: stop sums, BB, window, records
    if (VEC || warp == 0) {
      const float* P = a.part + (size_t)(ntrial & 1) * kSlots * nb;
      const float* S = a.stack + (size_t)(ntrial & 1) * nb * 4;
      float n2 = nd2, gg = 0.f, ss = 0.f, dot = 0.f, ndg2 = 0.f;
      if (L >= 4 && !THREAD) n2 = slot_sum<VEC>(P + kNd2b * nb, nb);
      if (FUSED) {
        const float4 v = stack_sum<VEC>(S, nb);
        gg = v.x;
        ss = v.y;
        dot = v.z;
        ndg2 = v.w;
      } else {
        if (L >= 4) {
          gg = slot_sum<VEC>(P + kGg * nb, nb);
          ss = slot_sum<VEC>(P + kSs * nb, nb);
        }
        if (L >= 5) {
          dot = slot_sum<VEC>(P + kDot * nb, nb);
          ndg2 = slot_sum<VEC>(P + kNdg2 * nb, nb);
        }
      }
      if (decider) accept<L>(st, f1, n2, gg, ss, dot, ndg2, a.taus, a.res, writer);
    }
    publish();
  }

  // ---- x = (x₀ + 0·x₁ + 0·stop) + 0·g, as the TPU kernel writes it
  const float* gf = G[st.cur];
  const float zstop = __fmul_rn(0.f, st.stopf);
  for (int j = gtid; j < n; j += gthreads) {
    const float gv = __ldcg(gf + j);
    const float xf = __fadd_rn(__fadd_rn(__ldg(a.x0 + j), __fmul_rn(0.f, a.x1[j])), zstop);
    a.x_out[j] = __fadd_rn(xf, __fmul_rn(0.f, gv));
    a.g_out[j] = gv;
  }
  if (writer) {
    a.tau_out[0] = st.tau;
    a.trials[0] = ntrial;
  }
}

template <int X>
const void* level_fn(int level) {
  switch (level) {
    case 0: return (const void*)tail_kernel<0, X>;
    case 1: return (const void*)tail_kernel<1, X>;
    case 2: return (const void*)tail_kernel<2, X>;
    case 3: return (const void*)tail_kernel<3, X>;
    case 4: return (const void*)tail_kernel<4, X>;
    case 5: return (const void*)tail_kernel<5, X>;
    default: return (const void*)tail_kernel<6, X>;
  }
}

// the ladder's seven rungs and the five X variants of L6; null for any
// other pair
const void* pick(int level, int variant) {
  if (level < 0 || level > 6 || variant < 0 || variant >= kVariants) return nullptr;
  if (variant == kLadder) return level_fn<kLadder>(level);
  if (level != 6) return nullptr;
  switch (variant) {
    case kCol: return (const void*)tail_kernel<6, kCol>;
    case kThread: return (const void*)tail_kernel<6, kThread>;
    case kVec: return (const void*)tail_kernel<6, kVec>;
    case kFused: return (const void*)tail_kernel<6, kFused>;
    default: return (const void*)tail_kernel<6, kCondbt>;
  }
}

size_t pad4(int v) { return ((size_t)v + 3) / 4 * 4; }

}  // namespace

// The cooperative grid of the ladder on the current device: one block per
// SM (0 if a kernel cannot be resident).
extern "C" int fasta_tail_probe_grid(int* nblocks) {
  const void* fns[12];
  int c = 0;
  for (int l = 0; l <= 6; ++l) fns[c++] = pick(l, kLadder);
  for (int v = kCol; v < kVariants; ++v) fns[c++] = pick(6, v);
  return fasta::cooperative_blocks(fns, c, kThreads, nblocks);
}

// The floats of work_f and of work_p a launch over nblocks needs.
extern "C" int fasta_tail_probe_work(int m, int n, int nblocks, int* nf, int* np) {
  if (m < 1 || n < 1 || nblocks < 1) return cudaErrorInvalidValue;
  *nf = (int)(4 * pad4(n) + pad4(m));
  *np = 2 * kSlots * nblocks + 2 * 4 * nblocks;
  return cudaSuccess;
}

// Run K iterations of rung `level` (variant 0) or of X variant 1..5 over
// L6 on `stream`.  At must be A's contiguous transpose unless the variant
// is X1 (col), when it may be null.  n % 4 == 0; A, At, x0 and the work
// 16-byte aligned.  taus and res (128 floats) are written at L6 only.
extern "C" int fasta_tail_probe(int level, int variant, const float* A, const float* At,
                                const float* b, const float* x0, int m, int n, int K,
                                float* x_out, float* g_out, float* tau_out, float* taus,
                                float* res, int* trials, float* work_f, float* work_p,
                                int nblocks, void* stream) {
  const void* fn = pick(level, variant);
  if (fn == nullptr || m < 1 || n < 4 || n % 4 || K < 1 || nblocks < 1 ||
      (variant != kCol && At == nullptr))
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = static_cast<cudaError_t>(fasta_tail_probe_grid(&limit));
  if (err != cudaSuccess) return err;
  if (nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  const size_t pn = pad4(n);
  Args args{};
  args.A = A;
  args.At = At;
  args.b = b;
  args.x0 = x0;
  args.m = m;
  args.n = n;
  args.K = K;
  args.x_out = x_out;
  args.g_out = g_out;
  args.tau_out = tau_out;
  args.taus = taus;
  args.res = res;
  args.trials = trials;
  args.x1 = work_f;
  args.g = work_f + pn;
  args.xcur = work_f + 3 * pn;
  args.r = work_f + 4 * pn;
  args.part = work_p;
  args.stack = work_p + 2 * kSlots * nblocks;
  args.pn = (int)pn;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}
