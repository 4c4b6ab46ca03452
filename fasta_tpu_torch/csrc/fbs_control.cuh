// The control of a whole FASTA solve in one cooperative launch, shared by
// K-B1 (microsolver.cu, dense operators) and K-B6 (microsolver_tv.cu, the
// TV stencils): the partial-sum slots, the fixed-order reduction that
// every block runs on them, and the decisions thread 0 of every block
// takes from the reduced scalars — nonmonotone backtracking over the
// window, the stop rules, the Zhou–Gao–Dai BB stepsize or the FISTA
// momentum with O'Donoghue–Candès restart, the records and the halt code
// (fasta_tpu/kernels/microsolver.py, microsolver_tv.py: backtrack,
// resid_stop and the two loop bodies).  The kernels differ only in how a
// trial's partials are computed.
//
// Every block reduces the same per-block partials in the same order, so
// every block derives bit-identical decisions: the uniform control flow
// the grid barriers need.  With hp (Acc = double) the cancellation-prone
// scalars — f, the window, ⟨Δx,∇f⟩, ⟨Δx,Δg⟩ — accumulate in FP64.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "losses.cuh"
#include "reduce.cuh"

namespace fasta {

constexpr int kWinMax = 128;
constexpr float kEps32 = 1.1920928955078125e-07f;

// partial slots, each (nblocks,) doubles: the kCommon slots every trial
// writes, the objective's g and the restart dot when asked for, and
// FISTA's f(d_n)
enum Slot { kNd2, kBtDot, kNg2, kNsm2, kF, kBbDot, kNdg2, kGx, kRdot, kFn, kSlots };
constexpr int kCommon = kGx;
constexpr int kReduced = kFn;  // the slots the decision reads
// the FP64 scratch of a launch over nblocks: the partials of a path
// point's start and of two trials (double-buffered by parity); every
// point overwrites them, so a batch reuses one scratch
constexpr size_t work_doubles(int nblocks) { return 3 * (size_t)kSlots * nblocks; }
// the cancellation-prone common slots, which sum in Acc; the others in float
__host__ __device__ constexpr bool acc_slot(int s) { return s == kBtDot || s == kF || s == kBbDot; }
// stop rules, in the order of options.STOP_RULES
enum Rule { kResidual, kNormalized, kRatio, kHybrid, kIterations };
// option bits of the entry points' flags
enum Flag { kHp = 1, kAccel = 2, kRestart = 4, kRestartDd = 8, kWarm = 16 };

// the options the decisions read
struct Control {
  int max_iters, window, max_backtracks, stop_rule, restart;
  float tol, shrink;
};

// Where each point of a launch (a path point or a batch instance) finds
// its data: point p's measurements at b + p·b_stride, its cold start at
// x0 + p·x0_stride, its weight at mus[p·mu_stride] and its τ₀ at
// tau0s[p], or tau0 when tau0s is null.  A stride of 0 shares one datum
// among the points: a weight path shares b and x₀, a batch μ.
struct Points {
  const float* b;
  const float* x0;
  const float* mus;
  const float* tau0s;
  long long b_stride, x0_stride;
  int mu_stride;
  float tau0;
  __device__ __forceinline__ const float* b_at(int p) const { return b + p * b_stride; }
  __device__ __forceinline__ const float* x0_at(int p) const { return x0 + p * x0_stride; }
  __device__ __forceinline__ float mu_at(int p) const { return __ldg(mus + p * mu_stride); }
  __device__ __forceinline__ float tau0_at(int p) const {
    return tau0s ? __ldg(tau0s + p) : tau0;
  }
};

// per-iteration records, (npath, max_iters) each; all but taus and res
// may be null
struct Records {
  float* taus;
  float* res;
  float* fvals;
  int* bts;
  float* objs;
  float* nres;
};

struct State {
  float tau, maxres, alpha, beta, res, tau_acc, tau_start;
  int k, cnt, cur, status, done;
  int accepted;  // the last trial was accepted, as iteration krec
  int post;      // FISTA: the post-acceptance phases follow
  int stop, krec;
};

// x̂ = x − τ g, rounded like the separate multiply and subtract
__device__ __forceinline__ float step_hat(float x, float g, float tau) {
  return __fsub_rn(x, __fmul_rn(tau, g));
}

__device__ __forceinline__ bool stop_rule(int rule, float res, float nres, float maxres,
                                          float tol) {
  switch (rule) {
    case kResidual: return res < tol;
    case kNormalized: return nres < tol;
    case kRatio: return __fdiv_rn(res, maxres + 1e-8f) < tol;
    case kIterations: return false;
    default: return (__fdiv_rn(res, maxres + 1e-8f) < tol) || (nres < tol);
  }
}

// The state at a path point's start, with the window holding f₀.
template <typename Acc>
__device__ __forceinline__ void start_point(State& st, Acc* fwin, Acc f0, float tau_start) {
  fwin[0] = f0;
  for (int w = 1; w < kWinMax; ++w) fwin[w] = Acc(-CUDART_INF);
  State s;
  s.tau = tau_start;
  s.maxres = -CUDART_INF_F;
  s.alpha = 1.f;
  s.beta = 0.f;
  s.res = 0.f;
  s.tau_acc = 0.f;
  s.tau_start = tau_start;
  s.k = s.cnt = s.cur = s.status = s.done = s.accepted = s.post = s.stop = s.krec = 0;
  st = s;
}

// Warp 0 of every block: the sums over blocks of a trial's partials P
// into tot, lane-strided then a shuffle tree.  The loads of the common
// slots start together; the objective's g and the restart dot follow only
// when they were written.
template <typename Acc, bool ACCEL>
__device__ __forceinline__ void reduce_partials(const double* P, int nb, bool need_gx, bool rdd,
                                                double* tot) {
  const int lane = threadIdx.x & 31;
  Acc sa[kCommon];
  float sf[kCommon];
#pragma unroll
  for (int s = 0; s < kCommon; ++s) {
    sa[s] = Acc(0);
    sf[s] = 0.f;
  }
  for (int i = lane; i < nb; i += 32) {
    double v[kCommon];
#pragma unroll
    for (int s = 0; s < kCommon; ++s) v[s] = __ldcg(P + s * nb + i);
#pragma unroll
    for (int s = 0; s < kCommon; ++s) {
      if (acc_slot(s))
        sa[s] += Acc(v[s]);
      else
        sf[s] += float(v[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < kCommon; ++s) {
    const double v = acc_slot(s) ? double(warp_sum(sa[s])) : double(warp_sum(sf[s]));
    if (lane == 0) tot[s] = v;
  }
  if (need_gx || ACCEL) {
    float gx = 0.f, rdot = 0.f;
    double rdot64 = 0.0;
    for (int i = lane; i < nb; i += 32) {
      gx += float(__ldcg(P + kGx * nb + i));
      const double r = __ldcg(P + kRdot * nb + i);
      rdot += float(r);
      rdot64 += r;
    }
    gx = warp_sum(gx);
    const double rd = rdd ? warp_sum(rdot64) : double(warp_sum(rdot));
    if (lane == 0) {
      tot[kGx] = gx;
      tot[kRdot] = rd;
    }
  }
}

// Warps 0…kCommon−1 of every block (and two more when the objective's g
// or the restart dot is wanted): the sums over blocks of a trial's
// partials P into tot, one slot a warp, lane-strided then a shuffle tree —
// reduce_partials' order, but every slot's loads start at once, eight a
// lane, so the sums wait on one trip to L2 rather than one for each 32
// blocks.  Every thread of the block may call it.
template <typename Acc, bool ACCEL>
__device__ __forceinline__ void reduce_partials_wide(const double* P, int nb, bool need_gx,
                                                     bool rdd, double* tot) {
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  if (s >= ((need_gx || ACCEL) ? kReduced : kCommon)) return;
  const bool wide = acc_slot(s) || (s == kRdot && rdd);
  Acc sa = Acc(0);
  float sf = 0.f;
  double sd = 0.0;
  for (int i0 = 0; i0 < nb; i0 += 256) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + lane + 32 * u;
      v[u] = i < nb ? __ldcg(P + s * nb + i) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      sa += Acc(v[u]);
      sf += float(v[u]);
      sd += v[u];
    }
  }
  // the restart dot in FP64 (restart_dd), the other Acc slots in Acc
  const double tsum = wide ? (s == kRdot ? warp_sum(sd) : double(warp_sum(sa)))
                           : double(warp_sum(sf));
  if (lane == 0) tot[s] = tsum;
}

// Thread 0 of every block: the decision after a trial from the reduced
// scalars tot (f = fscale·tot[kF]), gobj being g at the trial's prox
// point for the objective record.  Backtracks (τ shrinks) or accepts;
// an adaptive acceptance takes the BB stepsize and ends the iteration, a
// FISTA one sets the momentum and leaves the iteration to finish_fista.
// Block 0 alone (write) stores the records of point offset rec0.
template <typename Acc, bool ACCEL>
__device__ __forceinline__ void decide(State& s, const double* tot, Acc* fwin, Acc& f1s,
                                       float fscale, float gobj, const Control& c,
                                       const Records& rec, size_t rec0, bool write) {
  constexpr bool hp = sizeof(Acc) == sizeof(double);
  const float nd2 = float(tot[kNd2]);
  const Acc f1 = Acc(fscale) * Acc(tot[kF]);
  const Acc btd = Acc(tot[kBtDot]);
  Acc M = fwin[0];
  for (int w = 1; w < c.window; ++w) M = fwin[w] > M ? fwin[w] : M;
  const float q = __fdiv_rn(nd2, __fmul_rn(2.f, s.tau));
  bool viol;
  if (hp) {
    // the TPU kernel's hp slack: 1e-12 plus 64 ulp of the f scale
    const double slack = 1e-12 + (64.0 * double(kEps32)) * (fabs(double(M)) + fabs(double(f1)));
    viol = (double(f1) - (double(M) + (double(btd) + double(q)))) > slack;
  } else {
    const float suff = __fadd_rn(__fadd_rn(float(M), float(btd)), q);
    viol = __fsub_rn(float(f1), 1e-12f) > suff;
  }
  s.accepted = 0;
  if (viol && s.cnt < c.max_backtracks) {
    s.tau = __fmul_rn(s.tau, c.shrink);
    s.cnt += 1;
    return;
  }
  s.accepted = 1;
  const float res = __fdiv_rn(sqrtf(nd2), s.tau);
  s.maxres = nanmax(s.maxres, res);
  const float nrm = __fadd_rn(
      nanmax(sqrtf(float(tot[kNg2])), __fdiv_rn(sqrtf(float(tot[kNsm2])), s.tau)), 1e-8f);
  const float nres = __fdiv_rn(res, nrm);
  const bool stop = stop_rule(c.stop_rule, res, nres, s.maxres, c.tol);
  // the last genuinely accepted τ, for the warm carry
  if (s.cnt < c.max_backtracks) s.tau_acc = s.tau;
  const size_t r = rec0 + s.k;
  if (write) {
    rec.taus[r] = s.tau;
    rec.res[r] = res;
    if (rec.bts) rec.bts[r] = s.cnt;
    if (rec.nres) rec.nres[r] = nres;
    // the prox-point objective f(x₁) + g(x₁)
    if (rec.objs) rec.objs[r] = __fadd_rn(float(f1), gobj);
  }
  s.krec = s.k;
  if (!ACCEL) {
    // Zhou–Gao–Dai BB stepsize; the numerator rounds to float32
    const float dot = float(Acc(tot[kBbDot]));
    const float ndg2 = float(tot[kNdg2]);
    const float tau_s = dot != 0.f ? __fdiv_rn(nd2, dot) : CUDART_INF_F;
    const float tau_m = nanmax(ndg2 > 0.f ? __fdiv_rn(dot, ndg2) : 0.f, 0.f);
    float tau_n =
        __fmul_rn(2.f, tau_m) > tau_s ? tau_m : __fsub_rn(tau_s, __fmul_rn(0.5f, tau_m));
    if (tau_n <= 0.f || isinf(tau_n) || isnan(tau_n)) tau_n = __fmul_rn(s.tau, 1.5f);
    // halt code: nonfinite wins over converged
    const bool finite = isfinite(res) && isfinite(tau_n) && isfinite(double(f1));
    s.status = !finite ? 2 : (stop ? 1 : 0);
    if (write && rec.fvals) rec.fvals[r] = float(f1);
    fwin[(s.k + 1) % c.window] = f1;
    s.k += 1;
    s.cur ^= 1;
    s.tau = tau_n;
    s.cnt = 0;
    s.done = (s.k >= c.max_iters) || (s.status != 0);
  } else {
    // O'Donoghue–Candès restart and the FISTA momentum
    const float rdot = float(tot[kRdot]);
    const float a0 = (c.restart && rdot > 0.f) ? 1.f : s.alpha;
    const float a1 =
        __fdiv_rn(__fadd_rn(1.f, sqrtf(__fadd_rn(1.f, __fmul_rn(__fmul_rn(4.f, a0), a0)))), 2.f);
    s.beta = __fdiv_rn(__fsub_rn(a0, 1.f), a1);
    s.alpha = a1;
    s.res = res;
    s.stop = stop;
    s.post = 1;
    f1s = f1;
  }
}

// Thread 0 of every block: the end of a FISTA iteration, fn = f(d_n)
// at the extrapolated point.  The window sees f at the next search point,
// or f(x₁) on a stop.
template <typename Acc>
__device__ __forceinline__ void finish_fista(State& s, Acc fn, Acc f1s, Acc* fwin,
                                             const Control& c, const Records& rec, size_t rec0,
                                             bool write) {
  const Acc f_rec = s.stop ? f1s : fn;
  const bool finite = isfinite(s.res) && isfinite(s.tau) && isfinite(double(f_rec));
  s.status = !finite ? 2 : (s.stop ? 1 : 0);
  if (write && rec.fvals) rec.fvals[rec0 + s.k] = float(f_rec);
  fwin[(s.k + 1) % c.window] = f_rec;
  s.k += 1;
  s.cnt = 0;
  s.post = 0;
  s.done = (s.k >= c.max_iters) || (s.status != 0);
}

// The cooperative grid size of a kernel's instantiations fns[0..n) at
// `threads` per block on the current device: one block per SM, or 0 when
// one of them cannot be resident at all.
inline cudaError_t cooperative_blocks(const void* const* fns, int n, int threads, int* nblocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per_sm = 1 << 30;
  for (int i = 0; i < n; ++i) {
    int k = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, fns[i], threads, 0);
    per_sm = k < per_sm ? k : per_sm;
  }
  if (err != cudaSuccess) return err;
  *nblocks = per_sm < 1 ? 0 : sms;  // at most one block per SM
  return cudaSuccess;
}

}  // namespace fasta
