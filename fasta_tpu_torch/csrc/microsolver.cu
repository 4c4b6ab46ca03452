// K-B1 and K-B1p: whole dense FASTA solves in one launch,
//     min f(A x) + g(x),   A dense real float32,
// f ∈ {½‖·−b‖², Σlog(1+exp(·))−bᵀ·, ½Σmax(0,1−b⊙·)²} (losses.cuh) and
// g ∈ {μ‖·‖₁, indicator{x ≥ 0}, indicator{−1 ≤ x ≤ 1}, (μ/2)‖·‖²}, in
// adaptive (BB) or FISTA mode, for one weight μ (K-B1), a path of
// weights, warm or cold (K-B1p), or a batch of instances sharing A, each
// with its own b, x₀ and τ₀ (K-B1b).
//
// Replaces: fasta_tpu/kernels/microsolver.py, microsolve_lasso and
// microsolve_lasso_path (body _make_kernel) — the TPU kernels that pin A
// in VMEM and run the solver loop on one core, the path as a sequential
// grid with the warm x/τ carry in persistent scratch; K-B1b replaces
// microsolve_lasso under jax.vmap (fasta_tpu/micro.py:435), which Pallas
// lowers to a leading grid axis of instances.
//
// Bound on this card: latency.  One iteration moves A and Aᵀ once from L2
// (16 MB at 1000×2000, which fits the 50 MB L2) and is otherwise a chain
// of dependent phases; launching a kernel per phase from the host would
// cost more than the phases themselves.
//
// Design:
//  * One persistent cooperative launch, at most one block per SM.  The
//    phases of a line-search trial are separated by grid-wide barriers
//    (cooperative_groups::this_grid().sync()), in the order of the TPU
//    kernel's loop body (microsolver.py:474-678):
//      1. the prox step over each block's columns, with partial ‖Δx‖²,
//         ⟨Δx,g⟩, ‖g‖², ‖x₁−x̂₁‖², and when asked Σ|x₁| or Σx₁² (the
//         objective's g) and the FISTA restart dot ⟨y−x₁, x₁−x_acc⟩;
//      2. d = A x₁ over each block's rows (one warp per row), with the
//         loss's gradient weight ℓ′(d) and partial f;
//      3. adaptive: g₁ = Aᵀ ℓ′(d) over each block's columns (one warp per
//         row of a contiguous Aᵀ copy), with partial ⟨Δx,Δg⟩ and ‖Δg‖²;
//         FISTA needs no adjoint during the trials;
//      4. every block reduces all blocks' partials and takes the decisions.
//    After a FISTA acceptance two more phases follow: A. the extrapolated
//    d_n = d₁ + β(d₁ − d_acc) over the rows (A is linear: no matvec),
//    with ℓ′(d_n) and partial f(d_n); B. g_n = Aᵀ ℓ′(d_n), y_n and x_acc
//    over the columns; then the window takes f(d_n), or f(x₁) on a stop.
//  * Uniform control flow.  The backtracking loop, the stop test, the
//    halt code, the mode, the loss and the prox branch around grid
//    barriers, so every block must take the same branch.  Loss, prox and
//    mode are runtime codes fixed for the launch; the decisions come from
//    the same per-block partials, which each block reduces from global
//    memory in the same fixed order (fbs_control.cuh, shared with K-B6),
//    so every block derives bit-identical scalars.  No atomics; no
//    fast-math.  The FP64
//    accumulation type (hp off / on) and the mode are template
//    parameters, so the adaptive instantiations carry no FISTA code: four
//    instantiations.
//  * State (the nonmonotone window, τ, α, the max residual, k, the
//    status, the warm carry) is replicated in each block's shared memory;
//    block 0 alone writes the records, the iteration count and the status.
//  * Partials are double-buffered by trial parity, so a fast block's
//    next trial never overwrites partials a slow block is still reading;
//    a third buffer serves each path point's start.
//  * K-B1p runs the path points one after another inside the launch (the
//    TPU's sequential grid), a grid barrier between them.  Point i's
//    solution is its row of the output, from which point i+1 starts when
//    the path is warm; adaptive mode also carries the last genuinely
//    accepted τ.  A single solve is a path of one point.
//  * K-B1b is the same loop over cold points that each take their own b,
//    x₀ and τ₀ (Points in fbs_control.cuh; a path shares b and x₀, a
//    batch shares μ).  Every point runs over the whole grid exactly as a
//    single launch runs it, from state that start_point resets (window,
//    τ, counts, halt code) and partials that each trial overwrites, so an
//    instance is bit-identical to its own K-B1 launch, and A stays in L2
//    from one instance to the next.
//  * With hp, the decision scalars (f, the window, ⟨Δx,∇f⟩, ⟨Δx,Δg⟩, and
//    with restart_dd the restart dot) accumulate in FP64 (K-B2); positive
//    sums stay in float32.
//  * Elementwise formulas use the _rn intrinsics, which the compiler never
//    contracts into FMAs, so they round exactly like the plain PyTorch
//    version's separate operations.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "fbs_control.cuh"
#include "losses.cuh"
#include "prox.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;
using namespace fasta;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// proxes, in the order of kernels.microsolver.PROXES
enum Prox { kL1, kNonneg, kBox, kRidge };

struct Args {
  const float* A;    // (m, n)
  const float* At;   // (n, m), contiguous transpose of A
  Points pts;        // each point's b (m,), cold x₀ (n,), μ and τ₀
  float* x_out;      // (npath, n)
  Records rec;
  float* its;        // (npath, max_iters, n) or null
  int* k_out;        // (npath,)
  int* status_out;   // (npath,)
  float* xbuf;       // (2, pn): current and trial iterate (FISTA: y and x₁)
  float* gbuf;       // (2, pn): their gradients
  float* xacc;       // (n,) FISTA: the last prox point
  float* rbuf;       // (m,) the gradient weights ℓ′(d)
  float* dbuf;       // (m,) FISTA: A x₁ of the trial
  double* part;      // (3, kSlots, nblocks)
  float* dacc;       // (m,) FISTA: A x_acc
  Control ctl;
  int npath, m, n, pn, loss, prox;
  int rdd, warm;
};

// the prox of g at z with t = τμ (ridge: z/(1+τλ), μ carrying λ)
__device__ __forceinline__ float prox_eval(int prox, float z, float t) {
  switch (prox) {
    case kNonneg: return nanmax(z, 0.f);
    case kBox: return nanmin(nanmax(z, -1.f), 1.f);
    case kRidge: return __fdiv_rn(z, __fadd_rn(1.f, t));
    default: return shrink(z, t);
  }
}

// row · v over L entries by one warp (fixed order); result in lane 0.  v
// is written by other blocks, so it is read past L1.
__device__ __forceinline__ float row_dot(const float* __restrict__ row, const float* v,
                                         int L, int lane) {
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

template <typename Acc, bool ACCEL>
__global__ void __launch_bounds__(kThreads, 1) microsolve_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Acc fwin[kWinMax];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ float f32_scratch[kWarps];
  __shared__ double f64_scratch[kWarps];
  __shared__ double tot[kReduced];
  __shared__ State st;
  __shared__ Acc f1s;        // FISTA: f(x₁) of the accepted trial
  __shared__ int carry_ok;   // the previous path point ended finite
  __shared__ float tprev;    // its warm τ carry

  const int tid = threadIdx.x, lane = tid & 31;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gthreads = nb * kThreads;
  const int gwarp = blk * kWarps + (tid >> 5), gwarps = nb * kWarps;
  const int m = a.m, n = a.n;
  const float fscale = fasta::loss_scale(a.loss);
  const bool need_gx = a.rec.objs != nullptr && (a.prox == kL1 || a.prox == kRidge);
  float* X[2] = {a.xbuf, a.xbuf + a.pn};
  float* G[2] = {a.gbuf, a.gbuf + a.pn};
  double* P0 = a.part;  // each point's start
  int trial = 0;

  if (tid == 0) {
    carry_ok = 0;
    tprev = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < a.npath; ++p) {
    const float mu = a.pts.mu_at(p);
    const float* bp = a.pts.b_at(p);
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    // the start: point p−1's solution when the path is warm and it ended
    // finite, else the point's own cold start; adaptive mode also takes
    // the carried τ
    const float* xs =
        (a.warm && p > 0 && carry_ok) ? a.x_out + (size_t)(p - 1) * n : a.pts.x0_at(p);
    const float tau_start =
        (a.warm && !ACCEL && p > 0 && tprev > 0.f) ? tprev : a.pts.tau0_at(p);

    // ---- point start: d₀ = A x₀, f₀, g₀ = Aᵀ ℓ′(d₀)
    {
      Acc fpart = Acc(0);
      for (int i = gwarp; i < m; i += gwarps) {
        const float d = row_dot(a.A + (size_t)i * n, xs, n, lane);
        if (lane == 0) {
          float w, e;
          fasta::loss_eval(a.loss, d, __ldg(bp + i), w, e);
          a.rbuf[i] = w;
          if (ACCEL) a.dacc[i] = d;
          fpart += fasta::loss_term<Acc>(a.loss, e);
        }
      }
      for (int j = gtid; j < n; j += gthreads) {
        const float v = __ldcg(xs + j);
        X[0][j] = v;
        if (ACCEL) a.xacc[j] = v;
      }
      fpart = fasta::block_sum(fpart, acc_scratch);
      if (tid == 0) P0[kF * nb + blk] = double(fpart);
      grid.sync();
      for (int j = gwarp; j < n; j += gwarps) {
        const float g = row_dot(a.At + (size_t)j * m, a.rbuf, m, lane);
        if (lane == 0) G[0][j] = g;
      }
      if (tid < 32) {
        const Acc f = fasta::warp_sum_global<Acc>(P0 + kF * nb, nb);
        if (tid == 0) start_point(st, fwin, Acc(fscale) * f, tau_start);
      }
      grid.sync();
    }

    for (;;) {
      ++trial;
      double* P = a.part + (size_t)(1 + (trial & 1)) * kSlots * nb;
      const float tau = st.tau;
      const int cur = st.cur;
      const float* xc = X[cur];
      const float* gc = G[cur];
      float* x1 = X[cur ^ 1];

      // ---- phase 1: trial step over this block's columns
      {
        const float t = __fmul_rn(tau, mu);
        float nd2 = 0.f, ng2 = 0.f, nsm2 = 0.f, gx = 0.f, rdot = 0.f;
        Acc btd = Acc(0);
        double rdot64 = 0.0;
        for (int j = gtid; j < n; j += gthreads) {
          const float xv = __ldcg(xc + j), gv = __ldcg(gc + j);
          const float xh = step_hat(xv, gv, tau);
          const float xn = prox_eval(a.prox, xh, t);
          const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, xh);
          x1[j] = xn;
          nd2 = fmaf(dx, dx, nd2);
          ng2 = fmaf(gv, gv, ng2);
          nsm2 = fmaf(sm, sm, nsm2);
          btd += Acc(dx) * Acc(gv);
          if (need_gx) gx = a.prox == kL1 ? __fadd_rn(gx, fabsf(xn)) : fmaf(xn, xn, gx);
          if (ACCEL) {
            // the restart dot ⟨y − x₁, x₁ − x_acc⟩
            const float ra = __fsub_rn(xv, xn), rb = __fsub_rn(xn, __ldcg(a.xacc + j));
            if (a.rdd)
              rdot64 += double(ra) * double(rb);
            else
              rdot = fmaf(ra, rb, rdot);
          }
        }
        nd2 = fasta::block_sum(nd2, f32_scratch);
        ng2 = fasta::block_sum(ng2, f32_scratch);
        nsm2 = fasta::block_sum(nsm2, f32_scratch);
        btd = fasta::block_sum(btd, acc_scratch);
        if (need_gx) gx = fasta::block_sum(gx, f32_scratch);
        if (ACCEL) {
          if (a.rdd)
            rdot64 = fasta::block_sum(rdot64, f64_scratch);
          else
            rdot = fasta::block_sum(rdot, f32_scratch);
        }
        if (tid == 0) {
          P[kNd2 * nb + blk] = nd2;
          P[kNg2 * nb + blk] = ng2;
          P[kNsm2 * nb + blk] = nsm2;
          P[kBtDot * nb + blk] = double(btd);
          P[kGx * nb + blk] = gx;
          P[kRdot * nb + blk] = a.rdd ? rdot64 : double(rdot);
        }
      }
      grid.sync();

      // ---- phase 2: d = A x₁ over this block's rows, ℓ′(d), partial f
      {
        Acc fpart = Acc(0);
        for (int i = gwarp; i < m; i += gwarps) {
          const float d = row_dot(a.A + (size_t)i * n, x1, n, lane);
          if (lane == 0) {
            float w, e;
            fasta::loss_eval(a.loss, d, __ldg(bp + i), w, e);
            if (ACCEL)
              a.dbuf[i] = d;
            else
              a.rbuf[i] = w;
            fpart += fasta::loss_term<Acc>(a.loss, e);
          }
        }
        fpart = fasta::block_sum(fpart, acc_scratch);
        if (tid == 0) P[kF * nb + blk] = double(fpart);
      }
      grid.sync();

      // ---- phase 3 (adaptive): g₁ = Aᵀ ℓ′(d) over this block's columns,
      // BB partials
      if (!ACCEL) {
        float* g1 = G[cur ^ 1];
        Acc bbd = Acc(0);
        float ndg2 = 0.f;
        for (int j = gwarp; j < n; j += gwarps) {
          const float g = row_dot(a.At + (size_t)j * m, a.rbuf, m, lane);
          if (lane == 0) {
            g1[j] = g;
            const float xv = __ldcg(xc + j), gv = __ldcg(gc + j);
            const float xh = step_hat(xv, gv, tau);
            const float dx = __fsub_rn(__ldcg(x1 + j), xv);
            // Δg = g₁ + (x̂₁ − x)/τ  (== g₁ − g, in the TPU kernel's rounding)
            const float dg = __fadd_rn(g, __fdiv_rn(__fsub_rn(xh, xv), tau));
            bbd += Acc(dx) * Acc(dg);
            ndg2 = fmaf(dg, dg, ndg2);
          }
        }
        bbd = fasta::block_sum(bbd, acc_scratch);
        ndg2 = fasta::block_sum(ndg2, f32_scratch);
        if (tid == 0) {
          P[kBbDot * nb + blk] = double(bbd);
          P[kNdg2 * nb + blk] = ndg2;
        }
        grid.sync();
      }

      // ---- phase 4: every block reduces the same partials in the same
      // order and takes the same decision
      if (tid < 32) reduce_partials<Acc, ACCEL>(P, nb, need_gx, a.rdd, tot);
      __syncthreads();
      if (tid == 0) {
        const float gx = float(tot[kGx]);
        const float gobj = a.prox == kL1     ? __fmul_rn(mu, gx)
                           : a.prox == kRidge ? __fmul_rn(__fmul_rn(0.5f, mu), gx)
                                              : 0.f;
        State s = st;
        decide<Acc, ACCEL>(s, tot, fwin, f1s, fscale, gobj, a.ctl, a.rec, rec0, blk == 0);
        st = s;
      }
      __syncthreads();
      if (a.its && st.accepted) {
        // record the accepted prox point: this thread wrote these columns
        float* row = a.its + (rec0 + st.krec) * n;
        for (int j = gtid; j < n; j += gthreads) row[j] = x1[j];
      }

      if (ACCEL && st.post) {
        const float beta = st.beta;
        // ---- phase A: d_n = d₁ + β(d₁ − d_acc), ℓ′(d_n), partial f(d_n)
        {
          Acc fpart = Acc(0);
          for (int i = gtid; i < m; i += gthreads) {
            const float d1 = __ldcg(a.dbuf + i), da = __ldcg(a.dacc + i);
            const float dn = __fadd_rn(d1, __fmul_rn(beta, __fsub_rn(d1, da)));
            a.dacc[i] = d1;
            float w, e;
            fasta::loss_eval(a.loss, dn, __ldg(bp + i), w, e);
            a.rbuf[i] = w;
            fpart += fasta::loss_term<Acc>(a.loss, e);
          }
          fpart = fasta::block_sum(fpart, acc_scratch);
          if (tid == 0) P[kFn * nb + blk] = double(fpart);
        }
        grid.sync();
        // ---- phase B: g_n = Aᵀ ℓ′(d_n), y_n = x₁ + β(x₁ − x_acc), x_acc = x₁
        {
          float* y = X[cur];
          float* gy = G[cur];
          for (int j = gwarp; j < n; j += gwarps) {
            const float g = row_dot(a.At + (size_t)j * m, a.rbuf, m, lane);
            if (lane == 0) {
              const float xv1 = __ldcg(x1 + j), xa = __ldcg(a.xacc + j);
              gy[j] = g;
              y[j] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
              a.xacc[j] = xv1;
            }
          }
        }
        grid.sync();
        if (tid < 32) {
          const Acc fn = Acc(fscale) * fasta::warp_sum_global<Acc>(P + kFn * nb, nb);
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
    const float* xf = (ACCEL && st.status == 1) ? a.xacc : X[st.cur];
    float* xo = a.x_out + (size_t)p * n;
    for (int j = gtid; j < n; j += gthreads) xo[j] = __ldcg(xf + j);
    if (blk == 0 && tid == 0) {
      a.k_out[p] = st.k;
      a.status_out[p] = st.status;
    }
    if (tid == 0) {
      const bool ok = st.status != 2;
      carry_ok = ok;
      tprev = (ok && st.k > 0 && st.tau_acc > 0.f) ? st.tau_acc : st.tau_start;
    }
    if (p + 1 < a.npath) grid.sync();  // the next point may start from xo
  }
}

cudaError_t max_blocks(int* nblocks) {
  const void* fns[] = {(const void*)microsolve_kernel<float, false>,
                       (const void*)microsolve_kernel<double, false>,
                       (const void*)microsolve_kernel<float, true>,
                       (const void*)microsolve_kernel<double, true>};
  return cooperative_blocks(fns, 4, kThreads, nblocks);
}

size_t pad4(int v) { return ((size_t)v + 3) / 4 * 4; }

}  // namespace

// The cooperative grid size on the current device: one block per SM
// (0 if the kernel cannot be resident at all).
extern "C" int fasta_microsolve_grid(int* nblocks) { return max_blocks(nblocks); }

// The doubles of work_d that a launch of K-B1 or K-B6 over nblocks needs.
extern "C" int fasta_fbs_work_doubles(int nblocks, int* ndoubles) {
  if (nblocks < 1) return cudaErrorInvalidValue;
  *ndoubles = (int)work_doubles(nblocks);
  return cudaSuccess;
}

// Run npath solves on `stream`: point p takes b + p·b_stride, the cold
// start x0 + p·x0_stride, the weight mus[p·mu_stride] and τ₀ tau0s[p]
// (tau0 when tau0s is null); see the option bits in Flag (a warm path
// takes strides 0 for b and x0).  Outputs have a leading axis of npath.  work_f holds
// 5·pad4(n) + 3·pad4(m) floats, work_d fasta_fbs_work_doubles(nblocks)
// doubles.  fvals, bts, objs, nres and its may be null.
extern "C" int fasta_microsolve(const float* A, const float* At, const float* b, int b_stride,
                                const float* x0, int x0_stride, const float* mus, int mu_stride,
                                const float* tau0s, int npath, float tau0, int m,
                                int n, int max_iters, int window, float tol, float shrink_factor,
                                int max_backtracks, int stop_rule_code, int loss, int prox,
                                int flags, float* x_out, float* taus, float* res, float* fvals,
                                int* bts, float* objs, float* nres, float* its, int* k_out,
                                int* status_out, float* work_f, double* work_d, int nblocks,
                                void* stream) {
  if (m < 1 || n < 1 || npath < 1 || max_iters < 1 || window < 1 || window > kWinMax ||
      max_backtracks < 0 || stop_rule_code < kResidual || stop_rule_code > kIterations ||
      loss < fasta::kLstsq || loss > fasta::kSquaredHinge || prox < kL1 || prox > kRidge ||
      b_stride < 0 || x0_stride < 0 || mu_stride < 0)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = max_blocks(&limit);
  if (err != cudaSuccess) return err;
  if (nblocks < 1 || nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  const size_t pn = pad4(n), pm = pad4(m);
  Args args{};
  args.A = A;
  args.At = At;
  args.pts = Points{b, x0, mus, tau0s, b_stride, x0_stride, mu_stride, tau0};
  args.x_out = x_out;
  args.rec = Records{taus, res, fvals, bts, objs, nres};
  args.its = its;
  args.k_out = k_out;
  args.status_out = status_out;
  args.xbuf = work_f;
  args.gbuf = work_f + 2 * pn;
  args.xacc = work_f + 4 * pn;
  args.rbuf = work_f + 5 * pn;
  args.dbuf = args.rbuf + pm;
  args.dacc = args.dbuf + pm;
  args.part = work_d;
  args.npath = npath;
  args.m = m;
  args.n = n;
  args.pn = (int)pn;
  args.ctl = Control{max_iters, window, max_backtracks, stop_rule_code,
                     (flags & kRestart) != 0, tol, shrink_factor};
  args.loss = loss;
  args.prox = prox;
  args.rdd = (flags & kHp) && (flags & kRestartDd);
  args.warm = (flags & kWarm) != 0;
  void* params[] = {&args};
  const bool hp = (flags & kHp) != 0, accel = (flags & kAccel) != 0;
  const void* fn = hp ? (accel ? (const void*)microsolve_kernel<double, true>
                               : (const void*)microsolve_kernel<double, false>)
                      : (accel ? (const void*)microsolve_kernel<float, true>
                               : (const void*)microsolve_kernel<float, false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
