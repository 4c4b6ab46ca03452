// K-B8: the whole planar PhaseMax FASTA solve in one launch,
//     min_x  ½ Σᵢ max(|(A x)ᵢ| − bᵢ, 0)²  −  ⟨c, x⟩,   prox(z, τ) = z + τ·c,
// A = Ar + i·Ai complex (m, n) in planar layout, x and c (n, 2), b (m,)
// magnitudes, float32, in adaptive (BB) or FISTA mode, for one instance
// (K-B8) or a batch of instances sharing A and c, each with its own b, x₀
// and τ₀ (K-B8b).
//
// Replaces: fasta_tpu/kernels/microsolver_planar.py,
// microsolve_planar_phasemax (pallas_call at :669), body _make_kernel —
// the TPU kernel that pins the transposed channel matrices in VMEM and
// runs the loop on one core; K-B8b replaces it under jax.vmap
// (fasta_tpu/micro.py:435).
//
// Bound on this card: operations and latency.  A trial does 16·m·n
// operations on the rows (1.0 µs at 67 TFLOP/s at 16384×256) and reads
// both channel matrices once (33.6 MB: 10.0 µs through device memory,
// less from the 50 MB L2, where they stay between trials); the phases
// depend on one another through grid-wide barriers and decisions.
//
// Two routes: microsolve_planar_kernel for n ≤ 512 (padded), below, and
// microsolve_planar_wide_kernel for every wider n the reference's gate
// admits (2·m·n·4 ≤ 48 MB, so up to millions of columns at small m), whose
// note follows its own code.
//
// Design of the route for n ≤ 512, after K-B1 and K-B6 (fbs_control.cuh
// holds the shared control):
//  * One persistent cooperative launch, one block per SM.  n is small
//    (n ≤ 512 once padded to a multiple of 4), so every block keeps the
//    whole n-sized state in shared memory — x (FISTA: y), g, the trial x₁,
//    c and FISTA's x_acc — and computes the prox step z + τc and every
//    n-sized sum itself, in the same order as every other block: no
//    barrier for the prox step, and every block reduces to bit-identical
//    scalars.
//  * Only the m-sized work is shared out: a warp owns rows (planar_rows.cuh:
//    lane l holds the float4 column slots l + 32s), forms the row's
//    (A x)ᵢ by a shuffle butterfly, applies the hinge and adds the row's
//    share of Aᴴℓ from the values it loaded: each channel matrix is read
//    once per pass.  The warps' shares meet in shared memory in warp
//    order; each block writes one (2n,) share, and after a barrier the
//    blocks reduce those shares column by column (16 chains per column,
//    fixed order) into g, which every block copies after a second barrier.
//  * Grid barriers per adaptive trial: 2 (publish the row partials; the
//    reduced g).  FISTA: 1 per trial (the trials need only f) plus 2 per
//    acceptance (the extrapolated d_n = d₁ + β(d₁ − d_acc) on the owned
//    rows with its adjoint, A being linear; the reduced g_n).
//  * With hp, f, the window, ⟨Δx,g⟩, ⟨Δx,Δg⟩ and (restart_dd) the restart
//    dot accumulate in FP64, as in K-B1.
//  * Storage: the public split (Ar, Ai) row-major layout, which K-P5
//    measured fastest on the H100 (PERF.md); ragged n is padded to a
//    multiple of 4 with zero columns by the wrapper (zero columns of A, x
//    and c stay zero through the solve).
//  * K-B8b runs the instances in turn inside the launch, each over the
//    whole grid exactly as K-B8 runs its one (Points in fbs_control.cuh:
//    per-instance b, x₀ and τ₀; A and c shared, so the channel matrices
//    stay in L2 from one instance to the next).  A grid barrier separates
//    instances, after which every block reloads its shared-memory state
//    and start_point resets the window, τ, the counts and the halt code,
//    so each instance is bit-identical to its own K-B8 launch.
//  * Elementwise formulas use the _rn intrinsics, so they round like the
//    plain PyTorch version's separate operations.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "fbs_control.cuh"
#include "losses.cuh"
#include "planar_rows.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;
using namespace fasta;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChains = kWarps;      // chains per column of the g reduction
constexpr bool kInterleaved = false;  // K-P5's decision: the split layout

struct Args {
  const float* A0;   // Ar (m, n4)
  const float* A1;   // Ai (m, n4)
  Points pts;        // each instance's b (m,), cold x₀ (n4, 2) and τ₀
  const float* c;    // (n4, 2)
  float* x_out;      // (npoints, n, 2)
  Records rec;
  float* its;        // (npoints, max_iters, n, 2) or null
  int* k_out;        // (npoints,)
  int* status_out;   // (npoints,)
  float* gpart;      // (nblocks, 2·n4) the blocks' shares of Aᴴℓ
  float* gvec;       // (2·n4,) the reduced g: [gr | gi]
  float* dbuf;       // (m, 2) FISTA: d₁ of the trial
  float* dacc;       // (m, 2) FISTA: A x_acc
  double* part;      // (3, kSlots, nblocks)
  Control ctl;
  int npoints, m, n, n4, rdd;
};

// What a rows pass does on each owned row.
enum Pass {
  kStart,     // d = A x, hinge, f, Aᴴℓ; FISTA: d_acc = d
  kAdaptive,  // d = A x₁, hinge, f, Aᴴℓ
  kFista,     // d = A x₁, hinge, f; d₁ stored
  kExtrap     // d_n = d₁ + β(d₁ − d_acc), d_acc = d₁, hinge, f, Aᴴℓ
};

// Sums over the block of N values at once; every thread gets them.
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

// One pass over the block's rows (see Pass), x = [xr | xi] in shared
// memory (unused by kExtrap).  Returns the block's Σr² in Acc (valid in
// thread 0); with the adjoint, writes the block's (2·n4,) share of Aᴴℓ to
// gpart through gw.
template <typename Acc, int CPT, int PASS>
__device__ __forceinline__ Acc rows_pass(const Args& a, const float* bp, const float* x,
                                         float beta, float* gw, Acc* acc_scratch) {
  constexpr bool kAdj = PASS != kFista;
  constexpr int TM = CPT <= 2 ? 2 : 1;  // rows in flight per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n4 = a.n4, nq = n4 / 4;
  const int gws = gridDim.x * kWarps;
  float4 xr[CPT], xi[CPT], gr[CPT], gi[CPT];
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int q = lane + 32 * s;
    const bool on = q < nq && PASS != kExtrap;
    xr[s] = on ? reinterpret_cast<const float4*>(x)[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    xi[s] = on ? reinterpret_cast<const float4*>(x + n4)[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    gr[s] = gi[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  Acc fsum = Acc(0);
  for (int i0 = blockIdx.x * kWarps + warp; i0 < a.m; i0 += TM * gws) {
    float4 va[TM][CPT], vc[TM][CPT];
    float dr[TM], di[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int i = i0 + t * gws;
      dr[t] = di[t] = 0.f;
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int q = lane + 32 * s;
        if (i < a.m && q < nq) {
          load_slot<kInterleaved>(a.A0, a.A1, n4, i, q, va[t][s], vc[t][s]);
        } else {
          va[t][s] = vc[t][s] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        if (PASS != kExtrap) slot_dot(va[t][s], vc[t][s], xr[s], xi[s], dr[t], di[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int i = i0 + t * gws;
      if (i >= a.m) break;  // the same for every lane of the warp
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
        pr = warp_allsum(dr[t]);
        pi = warp_allsum(di[t]);
      }
      float lr, li, r;
      phase_hinge(pr, pi, __ldg(bp + i), lr, li, r);
      if (lane == 0) {
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
      if (kAdj)
#pragma unroll
        for (int s = 0; s < CPT; ++s) slot_grad(va[t][s], vc[t][s], lr, li, gr[s], gi[s]);
    }
  }
  fsum = block_sum(fsum, acc_scratch);
  if (kAdj) {
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int q = lane + 32 * s;
      if (q < nq) {
        reinterpret_cast<float4*>(gw + warp * 2 * n4)[q] = gr[s];
        reinterpret_cast<float4*>(gw + warp * 2 * n4 + n4)[q] = gi[s];
      }
    }
    __syncthreads();
    float* out = a.gpart + (size_t)blockIdx.x * 2 * n4;
    for (int j = tid; j < 2 * n4; j += kThreads) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += gw[w * 2 * n4 + j];
      out[j] = t;
    }
  }
  return fsum;
}

// After a grid barrier: g = Σ over blocks of their shares, each column by
// kChains chains (a warp each, lanes on neighbouring columns) in a fixed
// order, into gvec.
__device__ __forceinline__ void reduce_shares(const Args& a, float (*red)[32]) {
  const int tid = threadIdx.x, lane = tid & 31, chain = tid >> 5;
  const int N2 = 2 * a.n4, nb = gridDim.x;
  for (int c0 = blockIdx.x * 32; c0 < N2; c0 += nb * 32) {  // uniform per block
    const int j = c0 + lane;
    float s = 0.f;
    if (j < N2)
#pragma unroll 4
      for (int p = chain; p < nb; p += kChains) s += __ldcg(a.gpart + (size_t)p * N2 + j);
    red[chain][lane] = s;
    __syncthreads();
    if (chain == 0 && j < N2) {
      float t = 0.f;
      for (int k = 0; k < kChains; ++k) t += red[k][lane];
      a.gvec[j] = t;
    }
    __syncthreads();
  }
}

template <typename Acc, bool ACCEL, int CPT>
__global__ void __launch_bounds__(kThreads, 1) microsolve_planar_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ Acc fwin[kWinMax];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ Acc acc2[2][kWarps];
  __shared__ float f32_5[5][kWarps];
  __shared__ double f64_scratch[kWarps];
  __shared__ float red[kChains][32];
  __shared__ double tot[kReduced];
  __shared__ float gobj;
  __shared__ State st;
  __shared__ Acc f1s;

  const int tid = threadIdx.x;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n4 = a.n4, N2 = 2 * n4, n = a.n;
  float* X[2] = {smem, smem + N2};          // [xr | xi] each; FISTA: y and x₁
  float* G[2] = {smem + 2 * N2, smem + 3 * N2};
  float* cs = smem + 4 * N2;
  float* xacc = smem + 5 * N2;
  float* gw = smem + 6 * N2;                // (kWarps, N2)
  double* P0 = a.part;
  int trial = 0;

  for (int j = tid; j < n4; j += kThreads) {
    cs[j] = a.c[2 * j];
    cs[n4 + j] = a.c[2 * j + 1];
  }

  for (int p = 0; p < a.npoints; ++p) {
    const float* bp = a.pts.b_at(p);
    const float* x0 = a.pts.x0_at(p);
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    for (int j = tid; j < n4; j += kThreads) {
      X[0][j] = x0[2 * j];
      X[0][n4 + j] = x0[2 * j + 1];
      if (ACCEL) {
        xacc[j] = X[0][j];
        xacc[n4 + j] = X[0][n4 + j];
      }
    }
    __syncthreads();

    // ---- start: d₀ = A x₀, f₀, g₀ = Aᴴℓ(d₀); FISTA: d_acc = d₀
    {
      const Acc f = rows_pass<Acc, CPT, kStart>(a, bp, X[0], 0.f, gw, acc_scratch);
      if (tid == 0) P0[kF * nb + blk] = double(f);
      grid.sync();
      reduce_shares(a, red);
      grid.sync();
      for (int j = tid; j < N2; j += kThreads) G[0][j] = __ldcg(a.gvec + j);
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
      const float* xc = X[cur];
      const float* gc = G[cur];
      float* x1 = X[cur ^ 1];

      // ---- the trial step x₁ = (x − τg) + τc over all of x, with its sums
      {
        // ‖Δx‖², ‖g‖², ‖x₁ − x̂‖², ⟨c, x₁⟩ and the float32 restart dot
        float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        Acc w[1] = {Acc(0)};  // ⟨Δx, g⟩
        double rdot64 = 0.0;
        for (int j = tid; j < N2; j += kThreads) {
          const float xv = xc[j], gv = gc[j];
          const float z = step_hat(xv, gv, tau);
          const float xn = __fadd_rn(z, __fmul_rn(tau, cs[j]));
          x1[j] = xn;
          const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, z);
          v[0] = fmaf(dx, dx, v[0]);
          v[1] = fmaf(gv, gv, v[1]);
          v[2] = fmaf(sm, sm, v[2]);
          v[3] = fmaf(cs[j], xn, v[3]);
          w[0] += Acc(dx) * Acc(gv);
          if (ACCEL) {
            // the restart dot ⟨y − x₁, x₁ − x_acc⟩
            const float ra = __fsub_rn(xv, xn), rb = __fsub_rn(xn, xacc[j]);
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
          tot[kNd2] = v[0];
          tot[kNg2] = v[1];
          tot[kNsm2] = v[2];
          tot[kBtDot] = double(w[0]);
          tot[kRdot] = a.rdd ? rdot64 : double(v[4]);
          gobj = -v[3];
        }
      }
      __syncthreads();

      // ---- the rows at x₁: f (and the adaptive gradient's shares)
      {
        const Acc f = ACCEL ? rows_pass<Acc, CPT, kFista>(a, bp, x1, 0.f, gw, acc_scratch)
                            : rows_pass<Acc, CPT, kAdaptive>(a, bp, x1, 0.f, gw, acc_scratch);
        if (tid == 0) P[kF * nb + blk] = double(f);
      }
      grid.sync();

      if (!ACCEL) {
        // ---- g₁ reduced, then the BB sums over all of x
        reduce_shares(a, red);
        grid.sync();
        float* g1 = G[cur ^ 1];
        float v[1] = {0.f};
        Acc w[1] = {Acc(0)};
        for (int j = tid; j < N2; j += kThreads) {
          const float g = __ldcg(a.gvec + j);
          g1[j] = g;
          const float xv = xc[j];
          const float z = step_hat(xv, gc[j], tau);
          const float dx = __fsub_rn(x1[j], xv);
          // Δg = g₁ + (x̂₁ − x)/τ  (== g₁ − g, in the TPU kernel's rounding)
          const float dg = __fadd_rn(g, __fdiv_rn(__fsub_rn(z, xv), tau));
          w[0] += Acc(dx) * Acc(dg);
          v[0] = fmaf(dg, dg, v[0]);
        }
        block_sums(v, f32_5);
        block_sums(w, acc2);
        if (tid == 0) {
          tot[kBbDot] = double(w[0]);
          tot[kNdg2] = v[0];
        }
      }

      // ---- the decision, the same in every block
      if (tid < 32) {
        const Acc f = warp_sum_global<Acc>(P + kF * nb, nb);
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
        const Acc fn = rows_pass<Acc, CPT, kExtrap>(a, bp, nullptr, beta, gw, acc_scratch);
        if (tid == 0) P[kFn * nb + blk] = double(fn);
        float* y = X[cur];
        for (int j = tid; j < N2; j += kThreads) {
          const float xv1 = x1[j], xa = xacc[j];
          y[j] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
          xacc[j] = xv1;
        }
        grid.sync();
        reduce_shares(a, red);
        grid.sync();
        for (int j = tid; j < N2; j += kThreads) G[cur][j] = __ldcg(a.gvec + j);
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
    if (p + 1 < a.npoints) grid.sync();
  }
}


// ---------------------------------------------------------------------------
// The route past n = 512 (the "wide" route).  The n-sized state no longer
// fits every block's shared memory (the gate admits n up to 48 MB / 8m),
// so it lives in device memory, where it stays in L2:
//  * Block b owns a contiguous range of column groups (4 columns each) of
//    x (FISTA: y), g, the trial x₁, c and x_acc, and does the prox step,
//    its sums and the BB sums on those columns only; every n-sized sum is
//    a block's fixed-order partial, reduced over blocks in a fixed order
//    (fbs_control.cuh reduce_partials), so every block takes bit-identical
//    decisions.
//  * Rows: a warp per row, as on the other route, its lanes striding
//    over the row's column groups (x read from device memory), the row dot
//    summed by a shuffle butterfly; lane 0 applies the hinge and stores
//    the row's weight ℓᵢ = (ℓr, ℓi) in device memory.
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
//  * K-B8b runs the instances in turn as the other route does; each is
//    bit-identical to its own K-B8 launch on this route.
// ---------------------------------------------------------------------------

struct WideArgs {
  const float* A0;   // Ar (m, n4)
  const float* A1;   // Ai (m, n4)
  Points pts;
  const float* c;    // (n4, 2)
  float* x_out;      // (npoints, n, 2)
  Records rec;
  float* its;        // (npoints, max_iters, n, 2) or null
  int* k_out;
  int* status_out;
  float* X[2];       // (2·n4,) each: [xr | xi]; FISTA: y and x₁
  float* G[2];       // (2·n4,) each: g at X[k]
  float* xacc;       // (2·n4,) FISTA: x_acc
  float* lbuf;       // (m, 2) the rows' weights ℓ
  float* dbuf;       // (m, 2) FISTA: d₁ of the trial
  float* dacc;       // (m, 2) FISTA: A x_acc
  double* part;      // (3, kSlots, nblocks)
  Control ctl;
  int npoints, m, n, n4, rdd;
};

// One pass over the block's rows (see Pass), a warp per row, x = [xr | xi]
// in device memory (unused by kExtrap).  Returns the block's Σr² (valid
// in every thread) and, except for kFista, leaves each row's weight in
// lbuf.
template <typename Acc, int PASS>
__device__ __forceinline__ Acc rows_wide(const WideArgs& a, const float* bp, const float* x,
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
__device__ __forceinline__ void columns_wide(const WideArgs& a, int g0, int g1, float* gout,
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
    float4 gr = make_float4(0.f, 0.f, 0.f, 0.f), gi = gr;
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
        for (int k = 0; k < 2; ++k) {
          const float4 u = colred[k][tid + st * tg];
          float4& v = colred[k][tid];
          v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
        }
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
__global__ void __launch_bounds__(kThreads, 1) microsolve_planar_wide_kernel(WideArgs a) {
  cg::grid_group grid = cg::this_grid();
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
  Acc bbdot;
  float ndg2;

  for (int p = 0; p < a.npoints; ++p) {
    const float* bp = a.pts.b_at(p);
    const float* x0 = a.pts.x0_at(p);
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    for (int e = tid; e < 2 * cnt; e += kThreads) {
      const int h = e >= cnt, j = c0 + e - h * cnt, idx = h * n4 + j;
      a.X[0][idx] = x0[2 * j + h];
      if (ACCEL) a.xacc[idx] = x0[2 * j + h];
    }
    grid.sync();

    // ---- start: d₀ = A x₀, f₀, g₀ = Aᴴℓ(d₀); FISTA: d_acc = d₀
    {
      const Acc f = rows_wide<Acc, kStart>(a, bp, a.X[0], 0.f, acc_scratch);
      if (tid == 0) P0[kF * nb + blk] = double(f);
      grid.sync();
      columns_wide<Acc, false>(a, g0, g1, a.G[0], nullptr, nullptr, nullptr, 0.f, colred, f32_5,
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
          const float xv = xc[idx], gv = gc[idx], cv = __ldg(a.c + 2 * j + h);
          const float z = step_hat(xv, gv, tau);
          const float xn = __fadd_rn(z, __fmul_rn(tau, cv));
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
      grid.sync();

      // ---- the rows at x₁: f (and the adaptive gradient's weights)
      {
        const Acc f = ACCEL ? rows_wide<Acc, kFista>(a, bp, x1, 0.f, acc_scratch)
                            : rows_wide<Acc, kAdaptive>(a, bp, x1, 0.f, acc_scratch);
        if (tid == 0) P[kF * nb + blk] = double(f);
      }
      grid.sync();

      if (!ACCEL) {
        // ---- g₁ on the own columns, then the BB sums there
        columns_wide<Acc, true>(a, g0, g1, a.G[cur ^ 1], xc, gc, x1, tau, colred, f32_5, acc2,
                                bbdot, ndg2);
        if (tid == 0) {
          P[kBbDot * nb + blk] = double(bbdot);
          P[kNdg2 * nb + blk] = ndg2;
        }
        grid.sync();
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
        const Acc fn = rows_wide<Acc, kExtrap>(a, bp, nullptr, beta, acc_scratch);
        if (tid == 0) P[kFn * nb + blk] = double(fn);
        float* y = a.X[cur];
        for (int e = tid; e < 2 * cnt; e += kThreads) {
          const int h = e >= cnt, idx = h * n4 + c0 + e - h * cnt;
          const float xv1 = x1[idx], xa = a.xacc[idx];
          y[idx] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
          a.xacc[idx] = xv1;
        }
        grid.sync();
        columns_wide<Acc, false>(a, g0, g1, a.G[cur], nullptr, nullptr, nullptr, 0.f, colred,
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
    if (p + 1 < a.npoints) grid.sync();
  }
}

using Kernel = void (*)(Args);
using WideKernel = void (*)(WideArgs);

Kernel pick(bool hp, bool accel, int cpt) {
  if (cpt == 2)
    return hp ? (accel ? microsolve_planar_kernel<double, true, 2>
                       : microsolve_planar_kernel<double, false, 2>)
              : (accel ? microsolve_planar_kernel<float, true, 2>
                       : microsolve_planar_kernel<float, false, 2>);
  if (cpt == 4)
    return hp ? (accel ? microsolve_planar_kernel<double, true, 4>
                       : microsolve_planar_kernel<double, false, 4>)
              : (accel ? microsolve_planar_kernel<float, true, 4>
                       : microsolve_planar_kernel<float, false, 4>);
  return nullptr;
}

WideKernel pick_wide(bool hp, bool accel) {
  return hp ? (accel ? microsolve_planar_wide_kernel<double, true>
                     : microsolve_planar_wide_kernel<double, false>)
            : (accel ? microsolve_planar_wide_kernel<float, true>
                     : microsolve_planar_wide_kernel<float, false>);
}

// column slots per lane of the route for n ≤ 512; 0: the wide route
int slots(int n4) { return n4 <= 256 ? 2 : n4 <= 512 ? 4 : 0; }

size_t smem_bytes(int n4) { return (size_t)(6 + kWarps) * 2 * n4 * sizeof(float); }

size_t pad4(int v) { return ((size_t)v + 3) / 4 * 4; }

}  // namespace

// The cooperative grid at padded width n4 (a multiple of 4) on the
// current device: one block per SM, after raising each instantiation's
// dynamic shared-memory cap on the route for n4 ≤ 512 (0 blocks if one
// cannot be resident).
extern "C" int fasta_microsolve_planar_grid(int n4, int* nblocks) {
  if (n4 < 4 || n4 % 4) return cudaErrorInvalidValue;
  const int cpt = slots(n4);
  if (cpt == 0) {
    const void* fns[4];
    for (int k = 0; k < 4; ++k) fns[k] = (const void*)pick_wide(k & 1, k & 2);
    return cooperative_blocks(fns, 4, kThreads, nblocks);
  }
  const int smem = (int)smem_bytes(n4);
  int dev = 0, sms = 0, per_sm = 1 << 30;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    const void* fn = (const void*)pick(k & 1, k & 2, cpt);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, kThreads, smem);
    per_sm = per < per_sm ? per : per_sm;
  }
  if (err != cudaSuccess) return err;
  *nblocks = per_sm < 1 ? 0 : sms;
  return cudaSuccess;
}

// The floats of work_f a launch needs.  n4 ≤ 512: the blocks' shares, g,
// d₁ and d_acc; wider: x, g (two each), x_acc, ℓ, d₁ and d_acc.
extern "C" int fasta_microsolve_planar_work(int m, int n4, int nblocks, int* nfloats) {
  if (m < 1 || n4 < 4 || nblocks < 1) return cudaErrorInvalidValue;
  if (slots(n4) == 0)
    *nfloats = (int)(5 * 2 * (size_t)n4 + 3 * pad4(2 * m));
  else
    *nfloats = (int)((size_t)nblocks * 2 * n4 + 2 * (size_t)n4 + 2 * pad4(2 * m));
  return cudaSuccess;
}

// Run npoints solves on `stream`, point p taking b + p·b_stride, the cold
// start x0 + p·x0_stride and τ₀ tau0s[p] (tau0 when tau0s is null); see
// the option bits in Flag (kWarm is not taken).  A0 and A1 are Ar and Ai
// (m, n4), c and each x0 (n4, 2), all with n4 − n zero columns; x_out is
// (npoints, n, 2), its (npoints, max_iters, n, 2) or null;
// work_f holds fasta_microsolve_planar_work floats, work_d
// fasta_fbs_work_doubles(nblocks) doubles.  fvals, bts, objs and nres may
// be null.  n4 ≤ 512 takes the shared-memory route, wider n4 the wide one.
extern "C" int fasta_microsolve_planar(const float* A0, const float* A1, const float* b,
                                       int b_stride, const float* c, const float* x0,
                                       int x0_stride, const float* tau0s, int npoints,
                                       float tau0, int m, int n,
                                       int n4, int max_iters, int window, float tol,
                                       float shrink_factor, int max_backtracks, int stop_rule_code,
                                       int flags, float* x_out, float* taus, float* res,
                                       float* fvals, int* bts, float* objs, float* nres,
                                       float* its, int* k_out, int* status_out, float* work_f,
                                       double* work_d, int nblocks, void* stream) {
  const int cpt = slots(n4);
  if (m < 1 || n < 1 || n4 < n || n4 % 4 || max_iters < 1 || window < 1 ||
      window > kWinMax || max_backtracks < 0 || stop_rule_code < kResidual ||
      stop_rule_code > kIterations || (flags & kWarm) || npoints < 1 || b_stride < 0 ||
      x0_stride < 0)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = fasta_microsolve_planar_grid(n4, &limit) == cudaSuccess
                        ? cudaSuccess
                        : cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return err;
  if (nblocks < 1 || nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  const bool accel = (flags & kAccel) != 0, hp = (flags & kHp) != 0;
  const Points pts{b, x0, nullptr, tau0s, b_stride, x0_stride, 0, tau0};
  const Records rec{taus, res, fvals, bts, objs, nres};
  const Control ctl{max_iters, window, max_backtracks, stop_rule_code,
                    (flags & kRestart) != 0, tol, shrink_factor};
  const int rdd = hp && (flags & kRestartDd);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpt == 0) {
    WideArgs args{};
    args.A0 = A0;
    args.A1 = A1;
    args.pts = pts;
    args.c = c;
    args.x_out = x_out;
    args.rec = rec;
    args.its = its;
    args.k_out = k_out;
    args.status_out = status_out;
    const size_t N2 = 2 * (size_t)n4;
    args.X[0] = work_f;
    args.X[1] = work_f + N2;
    args.G[0] = work_f + 2 * N2;
    args.G[1] = work_f + 3 * N2;
    args.xacc = work_f + 4 * N2;
    args.lbuf = work_f + 5 * N2;
    args.dbuf = args.lbuf + pad4(2 * m);
    args.dacc = accel ? args.dbuf + pad4(2 * m) : nullptr;
    args.part = work_d;
    args.ctl = ctl;
    args.npoints = npoints;
    args.m = m;
    args.n = n;
    args.n4 = n4;
    args.rdd = rdd;
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel((const void*)pick_wide(hp, accel), dim3(nblocks),
                                      dim3(kThreads), params, 0, s);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  Args args{};
  args.A0 = A0;
  args.A1 = A1;
  args.pts = pts;
  args.c = c;
  args.x_out = x_out;
  args.rec = rec;
  args.its = its;
  args.k_out = k_out;
  args.status_out = status_out;
  args.gpart = work_f;
  args.gvec = work_f + (size_t)nblocks * 2 * n4;
  args.dbuf = args.gvec + 2 * n4;
  args.dacc = accel ? args.dbuf + pad4(2 * m) : nullptr;
  args.part = work_d;
  args.ctl = ctl;
  args.npoints = npoints;
  args.m = m;
  args.n = n;
  args.n4 = n4;
  args.rdd = rdd;
  void* params[] = {&args};
  const Kernel fn = pick(hp, accel, cpt);
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(nblocks), dim3(kThreads), params,
                                    smem_bytes(n4), s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
