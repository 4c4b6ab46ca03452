// K-B6 and K-B6p: whole TV-dual FASTA solves in one launch,
//     min_p ½‖μ·div p − b‖²   s.t.  ‖p‖∞ ≤ 1,
// p a dual field (2, H, W) (channel 0 vertical, channel 1 horizontal), b
// an image (H, W), float32, in adaptive (BB) or FISTA mode, for one TV
// weight μ (K-B6) or a path of weights, warm or cold (K-B6p).  The
// stencils follow reference_oracle/generators.py: grad leaves the last
// row (channel 0) and column (channel 1) at zero, div is its adjoint.
//
// Replaces: fasta_tpu/kernels/microsolver_tv.py, microsolve_tv (pallas_call
// at :607) and microsolve_tv_path (:731), body _make_kernel — the TPU
// kernels that keep the state in VMEM and run the loop on one core, the
// path as a sequential grid with the warm carry in persistent scratch.
//
// Bound on this card: latency.  One adaptive iteration must read y, g and
// b and write x₁ and g₁, 36 B per pixel (9.4 MB at 512×512, 2.8 µs at
// 3.35 TB/s; the whole state stays in the 50 MB L2), but the phases
// depend on one another through the grid-wide decisions.
//
// Design, after K-B1 (microsolver.cu), whose rules it keeps:
//  * One persistent cooperative launch, at most one block per SM; each
//    thread owns the pixels q = gtid, gtid + gthreads, ... of the flat
//    image, both channels, in every phase (so any H × W works, and a
//    block with no pixel still joins every barrier).
//  * Phase T (trial): x₁ = clamp(y − τg, −1, 1) on the owned pixels, with
//    the partials ‖Δx‖², ⟨Δx,g⟩, ‖g‖², ‖x₁−x̂₁‖² (and FISTA's restart dot),
//    and d = μ·div x₁ with r = d − b and the partial of ‖r‖².  div at
//    (i, j) needs x₁ at (i−1, j) and (i, j−1), which other threads own:
//    the thread recomputes them from y and g (an elementwise map, so the
//    value is bit-identical), which saves the grid barrier K-B1 spends
//    between its prox and its matvec.
//  * Phase G (adaptive): g₁ = μ·grad r on the owned pixels, reading r at
//    (i+1, j) and (i, j+1) after a grid barrier, with the BB partials
//    ⟨Δx,Δg⟩ and ‖Δg‖².  FISTA needs no adjoint during the trials.
//  * Then every block reduces every block's partials in one fixed order
//    and takes the same decisions (fbs_control.cuh, shared with K-B1:
//    uniform control flow around every barrier; partials double-buffered
//    by trial parity).  Grid barriers per trial: 2 adaptive, 1 FISTA,
//    plus 2 after each FISTA acceptance (A: d_n = d₁ + β(d₁ − d_acc) and
//    r_n; B: g_n = μ·grad r_n, y_n and x_acc).
//  * With hp, f, the window, ⟨Δx,g⟩, ⟨Δx,Δg⟩ and (restart_dd) the restart
//    dot accumulate in FP64 (reduce.cuh), as in K-B1.
//  * K-B6p runs the points in turn inside the launch, a grid barrier
//    between them; point i's solution is its output row, from which point
//    i+1 starts when the path is warm.  Adaptive mode also carries the
//    last genuinely accepted τ; FISTA restarts from the caller's τ₀; a
//    nonfinite point sends the next one back to x₀ (the JAX code's carry).
//    A single solve is a path of one point, so cold points are
//    bit-identical to separate K-B6 launches.
//  * Elementwise formulas use the _rn intrinsics, so they round like the
//    plain PyTorch version's separate operations.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "fbs_control.cuh"
#include "losses.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;
using namespace fasta;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* b;    // (H, W)
  const float* x0;   // (2, H, W)
  const float* mus;  // (npath,) the TV weight of each path point
  float* x_out;      // (npath, 2, H, W)
  Records rec;
  int* k_out;        // (npath,)
  int* status_out;   // (npath,)
  float* xbuf;       // (2, 2N): current and trial field (FISTA: y and x₁)
  float* gbuf;       // (2, 2N): their gradients
  float* xacc;       // (2N,) FISTA: the last prox point
  float* rbuf;       // (N,) r = d − b of the trial (FISTA: at d_n)
  float* dbuf;       // (N,) FISTA: d₁ = μ·div x₁ of the trial
  float* dacc;       // (N,) FISTA: μ·div x_acc
  double* part;      // (3, kSlots, nblocks): work_doubles(nblocks)
  Control ctl;
  int npath, H, W, N, rdd, warm;
  float tau0;
};

// the box prox clamp(z, −1, 1), NaN propagating as torch.clamp does
__device__ __forceinline__ float box(float z) { return nanmin(nanmax(z, -1.f), 1.f); }

// μ·((up − here_v) + (left − here_h)): div at one pixel from the four
// channel values it reads (zero where the stencil leaves the image)
__device__ __forceinline__ float div_of(float up, float here_v, float left, float here_h, float mu) {
  return __fmul_rn(mu, __fadd_rn(__fsub_rn(up, here_v), __fsub_rn(left, here_h)));
}

// g = μ·grad r at pixel q = (i, j) from r (read past L1: other blocks
// wrote the neighbours)
__device__ __forceinline__ void grad_at(const float* r, int q, int i, int j, int H, int W,
                                        float mu, float& gv, float& gh) {
  const float rq = __ldcg(r + q);
  gv = i < H - 1 ? __fmul_rn(mu, __fsub_rn(__ldcg(r + q + W), rq)) : 0.f;
  gh = j < W - 1 ? __fmul_rn(mu, __fsub_rn(__ldcg(r + q + 1), rq)) : 0.f;
}

template <typename Acc, bool ACCEL>
__global__ void __launch_bounds__(kThreads, 1) microsolve_tv_kernel(Args a) {
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

  const int tid = threadIdx.x;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gthreads = nb * kThreads;
  const int H = a.H, W = a.W, N = a.N;
  float* X[2] = {a.xbuf, a.xbuf + 2 * (size_t)N};
  float* G[2] = {a.gbuf, a.gbuf + 2 * (size_t)N};
  double* P0 = a.part;
  int trial = 0;

  if (tid == 0) {
    carry_ok = 0;
    tprev = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < a.npath; ++p) {
    const float mu = __ldg(a.mus + p);
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    const float* xs =
        (a.warm && p > 0 && carry_ok) ? a.x_out + (size_t)(p - 1) * 2 * N : a.x0;
    const float tau_start = (a.warm && !ACCEL && p > 0 && tprev > 0.f) ? tprev : a.tau0;

    // ---- point start: d₀ = μ·div x₀, r₀, f₀; then g₀ = μ·grad r₀
    {
      Acc fpart = Acc(0);
      for (int q = gtid; q < N; q += gthreads) {
        const int i = q / W, j = q - (q / W) * W;
        const float xv = __ldcg(xs + q), xh = __ldcg(xs + N + q);
        const float up = i > 0 ? __ldcg(xs + q - W) : 0.f;
        const float left = j > 0 ? __ldcg(xs + N + q - 1) : 0.f;
        const float d = div_of(up, i < H - 1 ? xv : 0.f, left, j < W - 1 ? xh : 0.f, mu);
        const float r = __fsub_rn(d, __ldg(a.b + q));
        a.rbuf[q] = r;
        X[0][q] = xv;
        X[0][N + q] = xh;
        if (ACCEL) {
          a.dacc[q] = d;
          a.xacc[q] = xv;
          a.xacc[N + q] = xh;
        }
        fpart += Acc(r) * Acc(r);
      }
      fpart = fasta::block_sum(fpart, acc_scratch);
      if (tid == 0) P0[kF * nb + blk] = double(fpart);
      grid.sync();
      for (int q = gtid; q < N; q += gthreads) {
        const int i = q / W, j = q - (q / W) * W;
        float gv, gh;
        grad_at(a.rbuf, q, i, j, H, W, mu, gv, gh);
        G[0][q] = gv;
        G[0][N + q] = gh;
      }
      if (tid < 32) {
        const Acc f = fasta::warp_sum_global<Acc>(P0 + kF * nb, nb);
        if (tid == 0) start_point(st, fwin, Acc(0.5f) * f, tau_start);
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

      // ---- phase T: the trial step and d = μ·div x₁ on the owned pixels
      {
        float nd2 = 0.f, ng2 = 0.f, nsm2 = 0.f, rdot = 0.f;
        Acc btd = Acc(0), fpart = Acc(0);
        double rdot64 = 0.0;
        for (int q = gtid; q < N; q += gthreads) {
          const int i = q / W, j = q - (q / W) * W;
          const float xv = __ldcg(xc + q), xh = __ldcg(xc + N + q);
          const float gv = __ldcg(gc + q), gh = __ldcg(gc + N + q);
          const float zv = step_hat(xv, gv, tau), zh = step_hat(xh, gh, tau);
          const float x1v = box(zv), x1h = box(zh);
          x1[q] = x1v;
          x1[N + q] = x1h;
          const float dxv = __fsub_rn(x1v, xv), dxh = __fsub_rn(x1h, xh);
          const float smv = __fsub_rn(x1v, zv), smh = __fsub_rn(x1h, zh);
          nd2 = fmaf(dxh, dxh, fmaf(dxv, dxv, nd2));
          ng2 = fmaf(gh, gh, fmaf(gv, gv, ng2));
          nsm2 = fmaf(smh, smh, fmaf(smv, smv, nsm2));
          btd += Acc(dxv) * Acc(gv);
          btd += Acc(dxh) * Acc(gh);
          if (ACCEL) {
            // the restart dot ⟨y − x₁, x₁ − x_acc⟩
            const float rav = __fsub_rn(xv, x1v), rbv = __fsub_rn(x1v, __ldcg(a.xacc + q));
            const float rah = __fsub_rn(xh, x1h), rbh = __fsub_rn(x1h, __ldcg(a.xacc + N + q));
            if (a.rdd) {
              rdot64 += double(rav) * double(rbv);
              rdot64 += double(rah) * double(rbh);
            } else {
              rdot = fmaf(rah, rbh, fmaf(rav, rbv, rdot));
            }
          }
          // x₁ at (i−1, j) and (i, j−1), recomputed from y and g
          const float up =
              i > 0 ? box(step_hat(__ldcg(xc + q - W), __ldcg(gc + q - W), tau)) : 0.f;
          const float left =
              j > 0 ? box(step_hat(__ldcg(xc + N + q - 1), __ldcg(gc + N + q - 1), tau)) : 0.f;
          const float d = div_of(up, i < H - 1 ? x1v : 0.f, left, j < W - 1 ? x1h : 0.f, mu);
          const float r = __fsub_rn(d, __ldg(a.b + q));
          if (ACCEL)
            a.dbuf[q] = d;
          else
            a.rbuf[q] = r;
          fpart += Acc(r) * Acc(r);
        }
        nd2 = fasta::block_sum(nd2, f32_scratch);
        ng2 = fasta::block_sum(ng2, f32_scratch);
        nsm2 = fasta::block_sum(nsm2, f32_scratch);
        btd = fasta::block_sum(btd, acc_scratch);
        fpart = fasta::block_sum(fpart, acc_scratch);
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
          P[kF * nb + blk] = double(fpart);
          P[kRdot * nb + blk] = a.rdd ? rdot64 : double(rdot);
        }
      }
      grid.sync();

      // ---- phase G (adaptive): g₁ = μ·grad r on the owned pixels, BB
      // partials
      if (!ACCEL) {
        float* g1 = G[cur ^ 1];
        Acc bbd = Acc(0);
        float ndg2 = 0.f;
        for (int q = gtid; q < N; q += gthreads) {
          const int i = q / W, j = q - (q / W) * W;
          float gv1, gh1;
          grad_at(a.rbuf, q, i, j, H, W, mu, gv1, gh1);
          g1[q] = gv1;
          g1[N + q] = gh1;
          const float xv = __ldcg(xc + q), xh = __ldcg(xc + N + q);
          const float zv = step_hat(xv, __ldcg(gc + q), tau);
          const float zh = step_hat(xh, __ldcg(gc + N + q), tau);
          const float dxv = __fsub_rn(__ldcg(x1 + q), xv), dxh = __fsub_rn(__ldcg(x1 + N + q), xh);
          // Δg = g₁ + (x̂₁ − y)/τ  (== g₁ − g, in the TPU kernel's rounding)
          const float dgv = __fadd_rn(gv1, __fdiv_rn(__fsub_rn(zv, xv), tau));
          const float dgh = __fadd_rn(gh1, __fdiv_rn(__fsub_rn(zh, xh), tau));
          bbd += Acc(dxv) * Acc(dgv);
          bbd += Acc(dxh) * Acc(dgh);
          ndg2 = fmaf(dgh, dgh, fmaf(dgv, dgv, ndg2));
        }
        bbd = fasta::block_sum(bbd, acc_scratch);
        ndg2 = fasta::block_sum(ndg2, f32_scratch);
        if (tid == 0) {
          P[kBbDot * nb + blk] = double(bbd);
          P[kNdg2 * nb + blk] = ndg2;
        }
        grid.sync();
      }

      // ---- the decision: every block reduces the same partials in the
      // same order and takes the same decision (g, the box indicator, is
      // 0 at the prox point)
      if (tid < 32) reduce_partials<Acc, ACCEL>(P, nb, false, a.rdd, tot);
      __syncthreads();
      if (tid == 0) {
        State s = st;
        decide<Acc, ACCEL>(s, tot, fwin, f1s, 0.5f, 0.f, a.ctl, a.rec, rec0, blk == 0);
        st = s;
      }
      __syncthreads();

      if (ACCEL && st.post) {
        const float beta = st.beta;
        // ---- phase A: d_n = d₁ + β(d₁ − d_acc), r_n = d_n − b, partial f
        {
          Acc fpart = Acc(0);
          for (int q = gtid; q < N; q += gthreads) {
            const float d1 = __ldcg(a.dbuf + q), da = __ldcg(a.dacc + q);
            const float dn = __fadd_rn(d1, __fmul_rn(beta, __fsub_rn(d1, da)));
            a.dacc[q] = d1;
            const float r = __fsub_rn(dn, __ldg(a.b + q));
            a.rbuf[q] = r;
            fpart += Acc(r) * Acc(r);
          }
          fpart = fasta::block_sum(fpart, acc_scratch);
          if (tid == 0) P[kFn * nb + blk] = double(fpart);
        }
        grid.sync();
        // ---- phase B: g_n = μ·grad r_n, y_n = x₁ + β(x₁ − x_acc), x_acc = x₁
        {
          float* y = X[cur];
          float* gy = G[cur];
          for (int q = gtid; q < N; q += gthreads) {
            const int i = q / W, j = q - (q / W) * W;
            float gv, gh;
            grad_at(a.rbuf, q, i, j, H, W, mu, gv, gh);
            gy[q] = gv;
            gy[N + q] = gh;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const size_t o = (size_t)c * N + q;
              const float xv1 = __ldcg(x1 + o), xa = __ldcg(a.xacc + o);
              y[o] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
              a.xacc[o] = xv1;
            }
          }
        }
        grid.sync();
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
    const float* xf = (ACCEL && st.status == 1) ? a.xacc : X[st.cur];
    float* xo = a.x_out + (size_t)p * 2 * N;
    for (int q = gtid; q < 2 * N; q += gthreads) xo[q] = __ldcg(xf + q);
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
  const void* fns[] = {(const void*)microsolve_tv_kernel<float, false>,
                       (const void*)microsolve_tv_kernel<double, false>,
                       (const void*)microsolve_tv_kernel<float, true>,
                       (const void*)microsolve_tv_kernel<double, true>};
  return cooperative_blocks(fns, 4, kThreads, nblocks);
}

}  // namespace

// The cooperative grid size on the current device: one block per SM
// (0 if the kernel cannot be resident at all).
extern "C" int fasta_microsolve_tv_grid(int* nblocks) { return max_blocks(nblocks); }

// Run npath TV-dual solves (one per weight in mus) on `stream`; see the
// option bits in Flag.  Outputs have a leading axis of npath.  work_f
// holds 13·H·W floats, work_d fasta_fbs_work_doubles(nblocks) doubles
// (microsolver.cu).  fvals, bts, objs and nres may be null.
extern "C" int fasta_microsolve_tv(const float* b, const float* x0, const float* mus, int npath,
                                   float tau0, int H, int W, int max_iters, int window, float tol,
                                   float shrink_factor, int max_backtracks, int stop_rule_code,
                                   int flags, float* x_out, float* taus, float* res, float* fvals,
                                   int* bts, float* objs, float* nres, int* k_out, int* status_out,
                                   float* work_f, double* work_d, int nblocks, void* stream) {
  if (H < 1 || W < 1 || (long long)H * W > (1LL << 28) || npath < 1 || max_iters < 1 ||
      window < 1 || window > kWinMax || max_backtracks < 0 || stop_rule_code < kResidual ||
      stop_rule_code > kIterations)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = max_blocks(&limit);
  if (err != cudaSuccess) return err;
  if (nblocks < 1 || nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  const size_t N = (size_t)H * W;
  Args args{};
  args.b = b;
  args.x0 = x0;
  args.mus = mus;
  args.x_out = x_out;
  args.rec = Records{taus, res, fvals, bts, objs, nres};
  args.k_out = k_out;
  args.status_out = status_out;
  args.xbuf = work_f;
  args.gbuf = work_f + 4 * N;
  args.xacc = work_f + 8 * N;
  args.rbuf = work_f + 10 * N;
  args.dbuf = args.rbuf + N;
  args.dacc = args.dbuf + N;
  args.part = work_d;
  args.npath = npath;
  args.H = H;
  args.W = W;
  args.N = (int)N;
  args.ctl = Control{max_iters, window, max_backtracks, stop_rule_code,
                     (flags & kRestart) != 0, tol, shrink_factor};
  args.rdd = (flags & kHp) && (flags & kRestartDd);
  args.warm = (flags & kWarm) != 0;
  args.tau0 = tau0;
  void* params[] = {&args};
  const bool hp = (flags & kHp) != 0, accel = (flags & kAccel) != 0;
  const void* fn = hp ? (accel ? (const void*)microsolve_tv_kernel<double, true>
                               : (const void*)microsolve_tv_kernel<double, false>)
                      : (accel ? (const void*)microsolve_tv_kernel<float, true>
                               : (const void*)microsolve_tv_kernel<float, false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
