// K-B1: the whole adaptive FASTA solve of a LASSO problem in one launch,
//     min ½‖A x − b‖² + μ‖x‖₁,   A dense real float32.
//
// Replaces: fasta_tpu/kernels/microsolver.py, microsolve_lasso (body
// _make_kernel) for loss "lstsq" × prox "l1" in adaptive mode — the TPU
// kernel that pins A in VMEM and runs the solver loop on one core.
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
//    kernel's loop body (microsolver.py:607-678):
//      1. the shrink step over each block's columns, with partial ‖Δx‖²,
//         ⟨Δx,g⟩, ‖g‖² and ‖x₁−x̂₁‖²;
//      2. r = A x₁ − b over each block's rows (one warp per row), with
//         partial ‖r‖²;
//      3. g₁ = Aᵀ r over each block's columns (one warp per row of a
//         contiguous Aᵀ copy), with partial ⟨Δx,Δg⟩ and ‖Δg‖²;
//      4. every block reduces all blocks' partials and takes the decisions.
//  * Uniform control flow.  The backtracking loop, the stop test and the
//    halt code branch around grid barriers, so every block must take the
//    same branch.  Each block reduces the same per-block partials, read
//    from global memory in the same fixed order (reduce.cuh), and so
//    derives bit-identical scalars.  No atomics; no fast-math.
//  * State (the nonmonotone window, τ, the max residual, k, the status)
//    is replicated in each block's shared memory; block 0 alone writes
//    the records, the iteration count and the status.
//  * Partials are double-buffered by trial parity, so a fast block's
//    next trial never overwrites partials a slow block is still reading.
//  * With hp, the decision scalars (f, the window, ⟨Δx,∇f⟩, ⟨Δx,Δg⟩)
//    accumulate in FP64 (K-B2); positive sums stay in float32.
//  * Elementwise formulas use the _rn intrinsics, which the compiler never
//    contracts into FMAs, so they round exactly like the plain PyTorch
//    version's separate operations.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWinMax = 128;
constexpr float kEps32 = 1.1920928955078125e-07f;

// partial slots, each (nblocks,) doubles
enum Slot { kNd2, kBtDot, kNg2, kNsm2, kF, kBbDot, kNdg2, kSlots };
// the cancellation-prone slots, which sum in Acc; the others in float
__host__ __device__ constexpr bool acc_slot(int s) { return s == kBtDot || s == kF || s == kBbDot; }
// stop rules, in the order of options.STOP_RULES
enum Rule { kResidual, kNormalized, kRatio, kHybrid, kIterations };

struct Args {
  const float* A;   // (m, n)
  const float* At;  // (n, m), contiguous transpose of A
  const float* b;   // (m,)
  const float* x0;  // (n,)
  float* x_out;     // (n,)
  float* taus;      // (max_iters,)
  float* res;       // (max_iters,)
  float* fvals;     // (max_iters,) or null
  int* bts;         // (max_iters,) or null
  int* k_out;
  int* status_out;
  float* xbuf;      // (2, n): current and trial iterate
  float* gbuf;      // (2, n): their gradients
  float* rbuf;      // (m,): residual A x₁ − b of the trial
  double* part;     // (2, kSlots, nblocks)
  int m, n, max_iters, window, max_backtracks, stop_rule;
  float tau0, mu, tol, shrink;
};

struct State {
  float tau;
  float maxres;
  int k;
  int cnt;     // line-search trials of the current iteration
  int cur;     // which half of xbuf/gbuf holds the accepted iterate
  int status;  // 0 running, 1 converged, 2 nonfinite
  int done;
};

// jnp.maximum semantics: NaN in either operand gives NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
}

// x̂ = x − τ g, rounded like the separate multiply and subtract
__device__ __forceinline__ float step_hat(float x, float g, float tau) {
  return __fsub_rn(x, __fmul_rn(tau, g));
}

// soft threshold z·max(|z|−t, 0)/max(|z|, 1e-30)
__device__ __forceinline__ float shrink(float z, float t) {
  const float mag = fabsf(z);
  return __fmul_rn(z, __fdiv_rn(nanmax(__fsub_rn(mag, t), 0.f), nanmax(mag, 1e-30f)));
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

template <typename Acc>
__global__ void __launch_bounds__(kThreads, 1) microsolve_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Acc fwin[kWinMax];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ float f32_scratch[kWarps];
  __shared__ double tot[kSlots];
  __shared__ State st;

  const int tid = threadIdx.x, lane = tid & 31;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gthreads = nb * kThreads;
  const int gwarp = blk * kWarps + (tid >> 5), gwarps = nb * kWarps;
  const int m = a.m, n = a.n;
  float* X[2] = {a.xbuf, a.xbuf + n};
  float* G[2] = {a.gbuf, a.gbuf + n};

  // ---- initial point: r₀ = A x₀ − b, f₀ = ½‖r₀‖², g₀ = Aᵀ r₀
  {
    Acc fpart = Acc(0);
    for (int i = gwarp; i < m; i += gwarps) {
      const float d = row_dot(a.A + (size_t)i * n, a.x0, n, lane);
      if (lane == 0) {
        const float r = __fsub_rn(d, __ldg(a.b + i));
        a.rbuf[i] = r;
        fpart += Acc(r) * Acc(r);
      }
    }
    for (int j = gtid; j < n; j += gthreads) X[0][j] = __ldg(a.x0 + j);
    fpart = fasta::block_sum(fpart, acc_scratch);
    if (tid == 0) a.part[kF * nb + blk] = double(fpart);
    grid.sync();
    for (int j = gwarp; j < n; j += gwarps) {
      const float g = row_dot(a.At + (size_t)j * m, a.rbuf, m, lane);
      if (lane == 0) G[0][j] = g;
    }
    if (tid < 32) {
      const Acc f = fasta::warp_sum_global<Acc>(a.part + kF * nb, nb);
      if (tid == 0) {
        fwin[0] = Acc(0.5) * f;
        for (int w = 1; w < kWinMax; ++w) fwin[w] = Acc(-CUDART_INF);
        st = State{a.tau0, -CUDART_INF_F, 0, 0, 0, 0, 0};
      }
    }
    grid.sync();
  }

  for (int trial = 1;; ++trial) {
    double* P = a.part + (size_t)(trial & 1) * kSlots * nb;
    const float tau = st.tau;
    const int cur = st.cur;
    const float* xc = X[cur];
    const float* gc = G[cur];
    float* x1 = X[cur ^ 1];
    float* g1 = G[cur ^ 1];

    // ---- phase 1: trial step over this block's columns
    {
      const float t = __fmul_rn(tau, a.mu);
      float nd2 = 0.f, ng2 = 0.f, nsm2 = 0.f;
      Acc btd = Acc(0);
      for (int j = gtid; j < n; j += gthreads) {
        const float xv = __ldcg(xc + j), gv = __ldcg(gc + j);
        const float xh = step_hat(xv, gv, tau);
        const float xn = shrink(xh, t);
        const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, xh);
        x1[j] = xn;
        nd2 = fmaf(dx, dx, nd2);
        ng2 = fmaf(gv, gv, ng2);
        nsm2 = fmaf(sm, sm, nsm2);
        btd += Acc(dx) * Acc(gv);
      }
      nd2 = fasta::block_sum(nd2, f32_scratch);
      ng2 = fasta::block_sum(ng2, f32_scratch);
      nsm2 = fasta::block_sum(nsm2, f32_scratch);
      btd = fasta::block_sum(btd, acc_scratch);
      if (tid == 0) {
        P[kNd2 * nb + blk] = nd2;
        P[kNg2 * nb + blk] = ng2;
        P[kNsm2 * nb + blk] = nsm2;
        P[kBtDot * nb + blk] = double(btd);
      }
    }
    grid.sync();

    // ---- phase 2: r = A x₁ − b over this block's rows
    {
      Acc fpart = Acc(0);
      for (int i = gwarp; i < m; i += gwarps) {
        const float d = row_dot(a.A + (size_t)i * n, x1, n, lane);
        if (lane == 0) {
          const float r = __fsub_rn(d, __ldg(a.b + i));
          a.rbuf[i] = r;
          fpart += Acc(r) * Acc(r);
        }
      }
      fpart = fasta::block_sum(fpart, acc_scratch);
      if (tid == 0) P[kF * nb + blk] = double(fpart);
    }
    grid.sync();

    // ---- phase 3: g₁ = Aᵀ r over this block's columns, BB partials
    {
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
    }
    grid.sync();

    // ---- phase 4: every block reduces the same partials in the same order
    // (lane-strided, then a shuffle tree); the loads of all slots start
    // together
    if (tid < 32) {
      Acc sa[kSlots];
      float sf[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        sa[s] = Acc(0);
        sf[s] = 0.f;
      }
      for (int i = lane; i < nb; i += 32) {
        double v[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) v[s] = __ldcg(P + s * nb + i);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (acc_slot(s))
            sa[s] += Acc(v[s]);
          else
            sf[s] += float(v[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const double v = acc_slot(s) ? double(fasta::warp_sum(sa[s]))
                                     : double(fasta::warp_sum(sf[s]));
        if (tid == 0) tot[s] = v;
      }
    }
    __syncthreads();
    if (tid == 0) {
      State s = st;
      const float nd2 = float(tot[kNd2]);
      const Acc f1 = Acc(0.5) * Acc(tot[kF]);
      const Acc btd = Acc(tot[kBtDot]);
      Acc M = fwin[0];
      for (int w = 1; w < a.window; ++w) M = fwin[w] > M ? fwin[w] : M;
      const float q = __fdiv_rn(nd2, __fmul_rn(2.f, s.tau));
      bool viol;
      if (sizeof(Acc) == sizeof(double)) {
        // the TPU kernel's hp slack: 1e-12 plus 64 ulp of the f scale
        const double slack = 1e-12 + (64.0 * double(kEps32)) * (fabs(double(M)) + fabs(double(f1)));
        viol = (double(f1) - (double(M) + (double(btd) + double(q)))) > slack;
      } else {
        const float suff = __fadd_rn(__fadd_rn(float(M), float(btd)), q);
        viol = __fsub_rn(float(f1), 1e-12f) > suff;
      }
      if (viol && s.cnt < a.max_backtracks) {
        s.tau = __fmul_rn(s.tau, a.shrink);
        s.cnt += 1;
      } else {
        const float res = __fdiv_rn(sqrtf(nd2), s.tau);
        s.maxres = nanmax(s.maxres, res);
        const float nrm = __fadd_rn(nanmax(sqrtf(float(tot[kNg2])),
                                           __fdiv_rn(sqrtf(float(tot[kNsm2])), s.tau)),
                                    1e-8f);
        const float nres = __fdiv_rn(res, nrm);
        const bool stop = stop_rule(a.stop_rule, res, nres, s.maxres, a.tol);
        // Zhou–Gao–Dai BB stepsize; the numerator rounds to float32
        const float dot = float(Acc(tot[kBbDot]));
        const float ndg2 = float(tot[kNdg2]);
        const float tau_s = dot != 0.f ? __fdiv_rn(nd2, dot) : CUDART_INF_F;
        const float tau_m = nanmax(ndg2 > 0.f ? __fdiv_rn(dot, ndg2) : 0.f, 0.f);
        float tau_n = __fmul_rn(2.f, tau_m) > tau_s ? tau_m
                                                    : __fsub_rn(tau_s, __fmul_rn(0.5f, tau_m));
        if (tau_n <= 0.f || isinf(tau_n) || isnan(tau_n)) tau_n = __fmul_rn(s.tau, 1.5f);
        // halt code: nonfinite wins over converged
        const bool finite = isfinite(res) && isfinite(tau_n) && isfinite(double(f1));
        s.status = !finite ? 2 : (stop ? 1 : 0);
        if (blk == 0) {
          a.taus[s.k] = s.tau;
          a.res[s.k] = res;
          if (a.fvals) a.fvals[s.k] = float(f1);
          if (a.bts) a.bts[s.k] = s.cnt;
        }
        fwin[(s.k + 1) % a.window] = f1;
        s.k += 1;
        s.cur ^= 1;
        s.tau = tau_n;
        s.cnt = 0;
        s.done = (s.k >= a.max_iters) || (s.status != 0);
      }
      st = s;
    }
    __syncthreads();
    if (st.done) break;
  }

  const float* xf = X[st.cur];
  for (int j = gtid; j < n; j += gthreads) a.x_out[j] = __ldcg(xf + j);
  if (blk == 0 && tid == 0) {
    *a.k_out = st.k;
    *a.status_out = st.status;
  }
}

cudaError_t max_blocks(int* nblocks) {
  int dev = 0, sms = 0, per_sm_f = 0, per_sm_d = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_f, microsolve_kernel<float>,
                                                        kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_d, microsolve_kernel<double>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const int per_sm = per_sm_f < per_sm_d ? per_sm_f : per_sm_d;
  *nblocks = per_sm < 1 ? 0 : sms;  // at most one block per SM
  return cudaSuccess;
}

}  // namespace

// The cooperative grid size on the current device: one block per SM
// (0 if the kernel cannot be resident at all).
extern "C" int fasta_microsolve_grid(int* nblocks) { return max_blocks(nblocks); }

// Run the whole solve on `stream`.  work_f holds 4n + m floats, work_d
// 2·7·nblocks doubles.  fvals and bts may be null.
extern "C" int fasta_microsolve_lasso(const float* A, const float* At, const float* b,
                                      const float* x0, float tau0, float mu, int m, int n,
                                      int max_iters, int window, float tol, float shrink_factor,
                                      int max_backtracks, int hp, int stop_rule_code,
                                      float* x_out, float* taus, float* res, float* fvals,
                                      int* bts, int* k_out, int* status_out, float* work_f,
                                      double* work_d, int nblocks, void* stream) {
  if (m < 1 || n < 1 || max_iters < 1 || window < 1 || window > kWinMax || max_backtracks < 0 ||
      stop_rule_code < kResidual || stop_rule_code > kIterations)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = max_blocks(&limit);
  if (err != cudaSuccess) return err;
  if (nblocks < 1 || nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  Args args{A, At, b, x0, x_out, taus, res, fvals, bts, k_out, status_out,
            work_f, work_f + 2 * (size_t)n, work_f + 4 * (size_t)n, work_d,
            m, n, max_iters, window, max_backtracks, stop_rule_code,
            tau0, mu, tol, shrink_factor};
  void* params[] = {&args};
  const void* fn = hp ? (const void*)microsolve_kernel<double> : (const void*)microsolve_kernel<float>;
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
