// K-P3: the tail-ablation ladder of the dense whole-solve iteration, on
// K-B1's design.
//
// K in-kernel iterations of a cumulative ladder of kernels, each adding one
// piece of the adaptive FBS body (LASSO, μ = 0.1, τ₀ = 0.05, window 10,
// shrink 0.2, at most 20 backtracks) at the position the TPU probe adds
// it:
//   L0  x̂ = x − τg, d = A x, f = ½‖d − b‖², g₁ = Aᵀ(d − b)  (no prox)
//   L1  + the shrink and Δx
//   L2  + the backtracking loop and its sums ‖Δx‖², ⟨Δx,g⟩ (with no
//         window the test never fails)
//   L3  + the nonmonotone window (its max and update)
//   L4  + the residual and stopping sums (‖Δx‖² again, ‖g‖², ‖x₁ − x̂‖²;
//         the test "< −1" never fires)
//   L5  + the BB scalars (⟨Δx,Δg⟩, ‖Δg‖², the Zhou–Gao–Dai select)
//   L6  + the τ / residual records (the first 128 iterations)
// L6 is K-B1's adaptive trial with hp off (csrc/microsolver.cu,
// dense_rows_kernel) on the probe's problem; each lower rung is that trial
// with the later pieces left out.  Every iteration restarts from
// x = x₀ + 0·x₁ (+ 0·stop), so the run never converges and its work stays
// the same; g and τ carry over.  The X variants each change one thing of
// L6 and compute L6's math (on the TPU they were cumulative; here each is
// L6 plus one change, so that a difference reads as that change alone):
//   X1  the adjoint by chunks of 32 columns of A read from L2 (the pass
//       publishes r = d − b; a block's 16 warps split a chunk's rows and
//       meet in shared memory in warp order), where L6 takes it from the
//       rows on the chip: X1 − L6 prices what keeping A on the chip saves;
//   X2  ‖Δx‖² summed once and reused by the backtracking test, the stop
//       test and BB (L6 sums it twice, as the ladder adds it);
//   X3  every thread decides from registers: each warp sums the chunks'
//       BB sums by a butterfly and every thread holds the state and takes
//       the whole decision, where L6 takes the half that needs no f (the
//       window's maximum, the test's quadratic term, the residual and the
//       stop test) in one thread between the first barrier's halves and
//       the rest in thread 0 after the second, published through shared
//       memory (K-B1's decide_prepare / decide_finish);
//   X4  the stop and BB dots as one stacked pass: the step's five sums in
//       one block reduction and the chunks' BB sums stored (chunks, 2) and
//       loaded in one pass (K-B1's own form), where L6 takes the
//       backtracking and the stop sums in two block reductions and the BB
//       sums from two arrays;
//   X5  the first trial outside the backtracking loop, the loop behind a
//       rarely taken branch.
// X2, X3, X4 and X5 keep L6's summation order: bit-identical results.
//
// Replaces: benchmarks/micro_tail_probe.py, make(level, col=, thread=,
// vecscal=, fusedred=, condbt=) → run (pallas_call at :411; bodies kern
// :243 and kern_vecscal :104), which split the TPU whole-solve iteration
// between the matvec pair and the serial decision chain.
//
// Bound on this card: A read once a launch (8 MB at 1000×2000) and 4mn +
// O(m + n) float32 operations a trial — a fraction of a microsecond.  What
// the ladder measures is everything else: the pass over the rows on the
// chip, two grid barriers a trial, the block and grid reductions and the
// decision's latency.
//
// Design: K-B1's dense_rows_kernel (dense_rows.cuh) — one persistent
// cooperative launch, one block of 512 threads per SM.  The wrapper's plan
// (dense_plan at the probe's budget, kernels/tail_probe.py) gives each
// block a band of rows: its first step of rows in registers (n ≤ 2048),
// the next in shared memory, the rest read from L2 once a pass; where a
// row lies never changes the order of a sum.  Every block holds the
// n-sized state in shared memory — the iteration's x, the trial's x₁, g
// and the trial's g₁ — and takes the step and its n-sized sums itself in
// one fixed order.  A trial:
//   1. x₁ = shrink(x − τg, τμ) at the thread's slots (row lane 0 forms it,
//      the other row lanes read it back);
//   2. one pass over the band: r = A x₁ − b row by row, f's share, and the
//      rows' share of Aᵀr from the values the threads hold (X1: r
//      published instead);
//   3. grid_arrive; the step's sums over the block and the decision's
//      first half; grid_wait;
//   4. g₁ = Σ of the blocks' shares by chunks of 32 columns (chain_sum),
//      with each chunk's BB sums; the last block sums f meanwhile;
//   5. a grid barrier; every block copies g₁ and decides.
// Grid barriers: 2 a trial, 2 at the start.  Their counter and exit ticket
// (grid_barrier.cuh) lie in the wrapper's stream scratch with the
// partials and g; the kernel writes every output, the records past the
// last iteration zeroed, so a call is one device operation.  No atomics
// on values: two runs give the same bits.  Elementwise formulas use the
// _rn intrinsics, so they round as the plain PyTorch version's separate
// operations.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense_rows.cuh"
#include "fbs_control.cuh"
#include "grid_barrier.cuh"

using namespace fasta;

namespace {

constexpr int kWindow = 10;
constexpr int kMaxBt = 20;
constexpr int kRec = 128;
constexpr float kMu = 0.1f;
constexpr float kTau0 = 0.05f;
constexpr float kShrink = 0.2f;

// the variants, in the order of kernels.tail_probe.VARIANTS
enum Variant { kLadder, kCol, kThread, kVec, kFused, kCondbt, kVariants };

struct Args {
  const float* A;    // (m, n) row-major, n % 4 == 0
  const float* b;    // (m,)
  const float* x0;   // (n,)
  int m, n, K;
  float* x_out;      // (n,)
  float* g_out;      // (n,)
  float* tau_out;    // (1,)
  float* taus;       // (kRec,)
  float* res;        // (kRec,)
  int* trials;       // (1,)
  const int* tiles;  // (4, nblocks): first row, end row, rows in registers, in shared memory
  unsigned* bar;     // grid_barrier's counter and grid_exit's ticket, zero at launch
  double* fpart;     // (2, nblocks) the blocks' f partials by trial parity
  float* ftot;       // the reduced f
  float* bbp;        // the chunks' BB sums: (2, kChunks), X4 (kChunks, 2)
  float* gvec;       // (n,) the reduced g
  float* gpart;      // (nblocks, n) the blocks' shares of Aᵀr
  float* rbuf;       // (m,) X1: r = d − b
};

// The decision state: thread 0's in shared memory, or (X3) every thread's
// in registers.
struct TailState {
  float tau, maxres, stopf;
  int k, cnt, cur, viol;
  float fwin[kWindow];
};

// The half of a trial's decision that needs no f.
struct Half {
  float suff, res, maxres;
  int stop;
};

// the step's sums, as tot holds them
enum Sum { kSumNd2, kSumRdg, kSumNd2s, kSumGg, kSumSs, kSums };

__device__ __forceinline__ void start(TailState& s, float f0) {
  s.tau = kTau0;
  s.maxres = -CUDART_INF_F;
  s.stopf = 0.f;
  s.k = s.cnt = s.cur = s.viol = 0;
#pragma unroll
  for (int w = 0; w < kWindow; ++w) s.fwin[w] = w == 0 ? f0 : -CUDART_INF_F;
}

// from the step's sums: the backtracking test's bound M + ⟨Δx,g⟩ +
// ‖Δx‖²/(2τ) (M the window's maximum, ∞ below L3) and, from L4, the
// residual and the stop test
template <int L, bool ONCE>
__device__ __forceinline__ Half prepare(const TailState& s, const float* tot) {
  Half h{CUDART_INF_F, 0.f, s.maxres, 0};
  if (L < 2) return h;
  float M = CUDART_INF_F;
  if (L >= 3) {
    M = s.fwin[0];
#pragma unroll
    for (int w = 1; w < kWindow; ++w) M = nanmax(M, s.fwin[w]);
  }
  const float q = __fdiv_rn(tot[kSumNd2], __fmul_rn(2.f, s.tau));
  h.suff = __fadd_rn(__fadd_rn(M, tot[kSumRdg]), q);
  if (L >= 4) {
    const float nd2 = tot[ONCE ? kSumNd2 : kSumNd2s];
    h.res = __fdiv_rn(sqrtf(nd2), s.tau);
    h.maxres = nanmax(s.maxres, h.res);
    const float nrm =
        __fadd_rn(nanmax(sqrtf(tot[kSumGg]), __fdiv_rn(sqrtf(tot[kSumSs]), s.tau)), 1e-8f);
    const float nres = __fdiv_rn(h.res, nrm);
    h.stop = (__fdiv_rn(h.res, __fadd_rn(h.maxres, 1e-8f)) < -1.f) || (nres < -1.f);
  }
  return h;
}

// The rest, with f₁ and the BB sums: a violation shrinks τ for another
// trial; an acceptance updates the window, the stop flag, τ (BB) and the
// records, and ends the iteration.
template <int L>
__device__ __forceinline__ void finish(TailState& s, const Half& h, float f1, float nd2, float dot,
                                       float ndg2, float* taus, float* rres, bool write) {
  s.viol = 0;
  if (L >= 2 && __fsub_rn(f1, 1e-12f) > h.suff && s.cnt < kMaxBt) {
    s.tau = __fmul_rn(s.tau, kShrink);
    s.cnt += 1;
    s.viol = 1;
    return;
  }
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
    res = h.res;
    s.maxres = h.maxres;
    stop = h.stop;
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

// Σ over the warp, the same value in every lane: a butterfly, which pairs
// lane 0's terms as warp_sum's tree does, so its sums are warp_sum's bits.
__device__ __forceinline__ float warp_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int L, int VAR, int S>
__global__ void __launch_bounds__(kThreads, 1) tail_kernel(Args a) {
  constexpr bool COL = VAR == kCol, ONCE = VAR == kThread, REGS = VAR == kVec;
  constexpr bool STACK = VAR == kFused, CONDBT = VAR == kCondbt;
  constexpr int TB = 8 / S;
  extern __shared__ __align__(16) float smem[];
  __shared__ float acc_scratch[kWarps];
  __shared__ float fs[kWarps * 4];  // the step's block reductions
  __shared__ float ts[kWarps];
  __shared__ float fs2[kWarps * 2];  // L6's second (the stop sums)
  __shared__ float ts2[kWarps];
  __shared__ float red[kChains][32];
  __shared__ float rowred[8][kWarps];
  __shared__ float lrow[kStepMax];
  __shared__ float bsh[kBandMax];
  __shared__ float tot[kSums];
  __shared__ TailState sst;
  __shared__ Half shalf;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n = a.n, m = a.m;
  const Lane ln = lane_of(n);
  const int nq = ln.nq;
  // x at X, the trial x₁ at X1, g and the trial's g₁ at G(cur) and
  // G(cur ^ 1), the R − 1 other row lanes' shares, then the band's rows
  float* X = smem;
  float* X1 = smem + n;
  auto G = [&](int k) { return smem + (2 + k) * n; };
  float* aux = smem + 4 * n;
  const float4* sA = reinterpret_cast<const float4*>(aux + (size_t)(ln.R - 1) * n);
  const Tile tile = tile_of(a.tiles, nb, blk);
  const int steps = (tile.rows + ln.R * TB - 1) / (ln.R * TB);
  float* share = a.gpart + (size_t)blk * n;
  unsigned gen = 0;
  int ntrial = 0;
  TailState rst;  // X3
  Half rhalf;     // X3
  auto st = [&]() -> TailState& {
    if constexpr (REGS) return rst;
    else return sst;
  };
  auto barrier = [&]() { grid_barrier(a.bar, nb, gen); };

  // the band on the chip for the whole launch; b's band beside it
  float4 ra[S == 1 ? 8 : 1][S];
  load_reg_rows<float, S>(a.A, n, tile, ln, ra);
  stage_slots<float>(a.A, n, nq, tile.r0 + tile.nreg, tile.nsm,
                     reinterpret_cast<float4*>(aux + (size_t)(ln.R - 1) * n));
  const float* bb = stage_b(a.b, tile, bsh);

  // One pass at the thread's slots xs of x₁: r = d − b, the block's Σr²
  // (thread 0) and its share of Aᵀr (X1: r to rbuf instead).
  auto pass = [&](const float (&xs)[S][4]) -> float {
    float fsum = 0.f;
    band_pass<float, S, !COL>(a.A, n, tile, ln, steps, sA, xs, ra, aux, rowred, lrow, share,
                              [&](int l, float dv) {
                                 const float r = __fsub_rn(dv, bb[l]);
                                 fsum = fmaf(r, r, fsum);
                                 if (COL) a.rbuf[tile.r0 + l] = r;
                                 return r;
                               });
    return block_total(fsum, acc_scratch);
  };
  // After the first barrier: g₁ into gvec — the blocks' shares by chunks
  // (X1: the chunks' columns of A from L2, times r) — with each chunk's
  // BB sums from x, its g, x₁ and τ when bb_on; f into ftot by the last
  // block's last warp meanwhile.
  auto reduce = [&](const double* fp, bool bb_on, const float* gc, float tau) {
    if (blk == nb - 1 && warp == kWarps - 1) {
      const float f = warp_sum_blocks<float>(fp, nb);
      if (lane == 0) *a.ftot = f;
    }
    auto each = [&](int c, int j, float g) {
      if (j < n) a.gvec[j] = g;
      if (L >= 5 && bb_on) {
        float w = 0.f, v = 0.f;
        if (j < n) {
          const float xv = X[j];
          const float z = step_hat(xv, gc[j], tau);
          const float dx = __fsub_rn(X1[j], xv);
          // Δg = g₁ + (x̂₁ − x)/τ; a zero numerator's quotient is itself
          const float num = __fsub_rn(z, xv);
          const float dg = __fadd_rn(g, (num == 0.f && tau > 0.f) ? num : __fdiv_rn(num, tau));
          w = dx * dg;
          v = dg * dg;
        }
        w = warp_sum(w);
        v = warp_sum(v);
        if (lane == 0) {
          if (STACK) {
            a.bbp[2 * c] = w;
            a.bbp[2 * c + 1] = v;
          } else {
            a.bbp[c] = w;
            a.bbp[kChunks + c] = v;
          }
        }
      }
    };
    if (!COL) {
      reduce_chunks(a.gpart, n, red, each);
      return;
    }
    const int chunks = (n + 31) / 32;
    for (int c = blk; c < chunks; c += nb) {  // uniform per block
      const int j = c * 32 + lane;
      float s = 0.f;
      if (j < n)
        for (int i0 = warp; i0 < m; i0 += 8 * kWarps) {
          float u[8], r[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int i = i0 + k * kWarps;
            u[k] = i < m ? __ldg(a.A + (size_t)i * n + j) : 0.f;
            r[k] = i < m ? __ldcg(a.rbuf + i) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) s = fmaf(u[k], r[k], s);
        }
      red[warp][lane] = s;
      __syncthreads();
      if (warp == 0) {
        float g = 0.f;
        for (int k = 0; k < kWarps; ++k) g += red[k][lane];
        each(c, j, g);
      }
      __syncthreads();
    }
  };

  // ---- start: g₀ = Aᵀ(A x₀ − b), f₀
  for (int j = tid; j < n; j += kThreads) X[j] = __ldg(a.x0 + j);
  __syncthreads();
  {
    float xs[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = ln.gl + ln.tg * s;
      const float4 v = ln.active && q < nq ? reinterpret_cast<const float4*>(X)[q] : zero4();
      xs[s][0] = v.x;
      xs[s][1] = v.y;
      xs[s][2] = v.z;
      xs[s][3] = v.w;
    }
    const float f = pass(xs);
    if (tid == 0) a.fpart[blk] = double(f);
    barrier();
    reduce(a.fpart, false, nullptr, 0.f);
    barrier();
    const float f0 = (REGS || tid == 0) ? __ldcg(a.ftot) : 0.f;
    copy_g(a.gvec, G(0), nq);
    if (REGS || tid == 0) start(st(), __fmul_rn(0.5f, f0));
    __syncthreads();
  }

  // One line-search trial at the state's τ; returns the backtracking
  // verdict, the same in every thread of every block.
  auto trial = [&](bool first) -> bool {
    ++ntrial;
    double* P = a.fpart + (size_t)(ntrial & 1) * nb;
    const float tau = st().tau;
    const int cur = st().cur;
    const float* gc = G(cur);
    // ---- the step at the thread's slots: row lane 0 forms x₁ (the
    // iteration's first trial restarts x = x₀ + 0·x₁ + 0·stop there)
    float xs[S][4], xv[S][4], gv[S][4];
    {
      const float tm = __fmul_rn(tau, kMu), zstop = __fmul_rn(0.f, st().stopf);
      const bool restart = first && st().k > 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = ln.gl + ln.tg * s;
#pragma unroll
        for (int c = 0; c < 4; ++c) xs[s][c] = xv[s][c] = gv[s][c] = 0.f;
        if (ln.rl == 0 && q < nq) {
          float4 x4 = reinterpret_cast<const float4*>(X)[q];
          if (restart) {
            const float4 o = __ldg(reinterpret_cast<const float4*>(a.x0) + q);
            const float4 p = reinterpret_cast<const float4*>(X1)[q];
            x4 = make_float4(__fadd_rn(__fadd_rn(o.x, __fmul_rn(0.f, p.x)), zstop),
                             __fadd_rn(__fadd_rn(o.y, __fmul_rn(0.f, p.y)), zstop),
                             __fadd_rn(__fadd_rn(o.z, __fmul_rn(0.f, p.z)), zstop),
                             __fadd_rn(__fadd_rn(o.w, __fmul_rn(0.f, p.w)), zstop));
            reinterpret_cast<float4*>(X)[q] = x4;
          }
          const float4 g4 = reinterpret_cast<const float4*>(gc)[q];
          const float xa[4] = {x4.x, x4.y, x4.z, x4.w}, ga[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float xh = step_hat(xa[c], ga[c], tau);
            xs[s][c] = L >= 1 ? shrink_sparse(xh, tm) : xa[c];
            xv[s][c] = xa[c];
            gv[s][c] = ga[c];
          }
          reinterpret_cast<float4*>(X1)[q] = make_float4(xs[s][0], xs[s][1], xs[s][2], xs[s][3]);
        }
      }
      if (ln.R > 1) {
        __syncthreads();
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int q = ln.gl + ln.tg * s;
          if (ln.rl > 0 && ln.active && q < nq) {
            const float4 v = reinterpret_cast<const float4*>(X1)[q];
            xs[s][0] = v.x;
            xs[s][1] = v.y;
            xs[s][2] = v.z;
            xs[s][3] = v.w;
          }
        }
      }
    }
    // ---- the pass at x₁
    {
      const float f = pass(xs);
      if (tid == 0) P[blk] = double(f);
    }
    grid_arrive(a.bar, gen);
    // ---- while the others arrive: the step's sums over the block (row
    // lane 0 a slot) and the decision's first half
    if (L >= 2) {
      float p[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = ln.gl + ln.tg * s;
        if (ln.rl == 0 && q < nq)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float dx = __fsub_rn(xs[s][c], xv[s][c]);
            p[kSumNd2] = fmaf(dx, dx, p[kSumNd2]);
            p[kSumRdg] = fmaf(dx, gv[s][c], p[kSumRdg]);
            if (L >= 4) {
              if (!ONCE) p[kSumNd2s] = fmaf(dx, dx, p[kSumNd2s]);
              const float sm = __fsub_rn(xs[s][c], step_hat(xv[s][c], gv[s][c], tau));
              p[kSumGg] = fmaf(gv[s][c], gv[s][c], p[kSumGg]);
              p[kSumSs] = fmaf(sm, sm, p[kSumSs]);
            }
          }
      }
      // each value's warps' sums meet in one warp in warp order, however
      // many values a reduction takes: the same bits either way
      if (STACK) {
        float f4[4] = {p[kSumNd2], p[kSumRdg], p[kSumNd2s], p[kSumGg]};
        float t1[1] = {p[kSumSs]};
        const double r = block_sums_warp<4, 1, float>(f4, t1, fs, ts);
        if (lane == 0 && warp < kSums) tot[warp] = float(r);
      } else {
        float f1[1] = {p[kSumNd2]};
        float t1[1] = {p[kSumRdg]};
        const double r = block_sums_warp<1, 1, float>(f1, t1, fs, ts);
        if (lane == 0 && warp < 2) tot[warp] = float(r);
        if (L >= 4) {
          float t2[1] = {p[kSumSs]};
          if (ONCE) {
            float f2[1] = {p[kSumGg]};
            const double r2 = block_sums_warp<1, 1, float>(f2, t2, fs2, ts2);
            if (lane == 0 && warp < 2) tot[kSumGg + warp] = float(r2);
          } else {
            float f2[2] = {p[kSumNd2s], p[kSumGg]};
            const double r2 = block_sums_warp<2, 1, float>(f2, t2, fs2, ts2);
            if (lane == 0 && warp < 3) tot[kSumNd2s + warp] = float(r2);
          }
        }
      }
      __syncthreads();
      if (REGS)
        rhalf = prepare<L, ONCE>(rst, tot);
      else if (warp == 1 && lane == 0)
        shalf = prepare<L, ONCE>(sst, tot);
    }
    grid_wait(a.bar, nb, gen);
    reduce(P, true, gc, tau);
    barrier();
    // ---- the decision, the same in every block: f and the chunks' BB
    // sums loaded first (warp 0; X3 every warp), so that they travel with
    // g₁'s copy
    const int chunks = (n + 31) / 32;
    float bw[kChunks / 32], bv[kChunks / 32];
    const bool loads = REGS || warp == 0;
#pragma unroll
    for (int k = 0; k < kChunks / 32; ++k) {
      const int c = lane + 32 * k;
      const bool on = L >= 5 && loads && c < chunks;
      if (STACK) {
        const float2 u = on ? __ldcg(reinterpret_cast<const float2*>(a.bbp) + c)
                            : make_float2(0.f, 0.f);
        bw[k] = u.x;
        bv[k] = u.y;
      } else {
        bw[k] = on ? __ldcg(a.bbp + c) : 0.f;
        bv[k] = on ? __ldcg(a.bbp + kChunks + c) : 0.f;
      }
    }
    const float f = (REGS || tid == 0) ? __ldcg(a.ftot) : 0.f;
    copy_g(a.gvec, G(cur ^ 1), nq);
    if (loads) {
      float dot = 0.f, ndg2 = 0.f;
      if (L >= 5) {
#pragma unroll
        for (int k = 0; k < kChunks / 32; ++k) {
          dot += bw[k];
          ndg2 += bv[k];
        }
        dot = REGS ? warp_all(dot) : warp_sum(dot);
        ndg2 = REGS ? warp_all(ndg2) : warp_sum(ndg2);
      }
      const float nd2 = tot[ONCE ? kSumNd2 : kSumNd2s];
      const bool writer = blk == 0 && tid == 0;
      if (REGS) {
        finish<L>(rst, rhalf, __fmul_rn(0.5f, f), nd2, dot, ndg2, a.taus, a.res, writer);
      } else if (tid == 0) {
        TailState s = sst;
        finish<L>(s, shalf, __fmul_rn(0.5f, f), nd2, dot, ndg2, a.taus, a.res, writer);
        sst = s;
      }
    }
    __syncthreads();
    return st().viol != 0;
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
  }

  // ---- x = (x₀ + 0·x₁ + 0·stop) + 0·g, as the TPU kernel writes it; the
  // records past the last iteration zeroed
  if (blk == 0) {
    const TailState& s = st();
    const float* gf = G(s.cur);
    const float zstop = __fmul_rn(0.f, s.stopf);
    for (int j = tid; j < n; j += kThreads) {
      const float g = gf[j];
      const float xf = __fadd_rn(__fadd_rn(__ldg(a.x0 + j), __fmul_rn(0.f, X1[j])), zstop);
      a.x_out[j] = __fadd_rn(xf, __fmul_rn(0.f, g));
      a.g_out[j] = g;
    }
    if (tid == 0) {
      a.tau_out[0] = s.tau;
      a.trials[0] = ntrial;
    }
    for (int r = (L >= 6 ? min(a.K, kRec) : 0) + tid; r < kRec; r += kThreads) {
      a.taus[r] = 0.f;
      a.res[r] = 0.f;
    }
  }
  grid_exit(a.bar, nb);
}

template <int VAR, int S>
const void* level_fn(int level) {
  switch (level) {
    case 0: return (const void*)tail_kernel<0, VAR, S>;
    case 1: return (const void*)tail_kernel<1, VAR, S>;
    case 2: return (const void*)tail_kernel<2, VAR, S>;
    case 3: return (const void*)tail_kernel<3, VAR, S>;
    case 4: return (const void*)tail_kernel<4, VAR, S>;
    case 5: return (const void*)tail_kernel<5, VAR, S>;
    default: return (const void*)tail_kernel<6, VAR, S>;
  }
}

template <int S>
const void* pick_s(int level, int variant) {
  if (variant == kLadder) return level_fn<kLadder, S>(level);
  if (level != 6) return nullptr;
  switch (variant) {
    case kCol: return (const void*)tail_kernel<6, kCol, S>;
    case kThread: return (const void*)tail_kernel<6, kThread, S>;
    case kVec: return (const void*)tail_kernel<6, kVec, S>;
    case kFused: return (const void*)tail_kernel<6, kFused, S>;
    default: return (const void*)tail_kernel<6, kCondbt, S>;
  }
}

// the ladder's seven rungs and the five X variants of L6 at width n (a
// multiple of 4 up to kStateMax); null for anything else
const void* pick(int level, int variant, int n) {
  if (level < 0 || level > 6 || variant < 0 || variant >= kVariants || n < 4 || n % 4 ||
      n > kStateMax)
    return nullptr;
  const int S = slots_of(n);
  return S == 1 ? pick_s<1>(level, variant)
                : S == 2 ? pick_s<2>(level, variant) : pick_s<4>(level, variant);
}

// the shared memory of a block's state besides its rows of A, in bytes:
// x, x₁, g twice and the R − 1 other row lanes' shares
size_t state_bytes(int n) { return (size_t)(3 + lanes_of(n).R) * n * sizeof(float); }

size_t pad4(int v) { return ((size_t)v + 3) / 4 * 4; }

// The scratch of a launch, in doubles from its base: the barrier's words
// alone in the first 128 bytes, then the f partials (2, nblocks) as
// doubles, f, the chunks' BB sums, g (n), the blocks' shares (nblocks, n)
// and X1's r (m), each 16-byte aligned.
struct Layout {
  size_t fpart, ftot, bbp, gvec, gpart, rbuf, total;
};

Layout layout(int m, int n, int nblocks) {
  Layout l;
  l.fpart = 16;
  l.ftot = l.fpart + 2 * (size_t)nblocks;
  l.bbp = l.ftot + 2;
  l.gvec = l.bbp + kChunks;
  l.gpart = l.gvec + (size_t)n / 2;
  l.rbuf = l.gpart + (size_t)nblocks * n / 2;
  l.total = l.rbuf + pad4(m) / 2;
  return l;
}

}  // namespace

// The cooperative grid at width n (a multiple of 4 up to 8192) on the
// current device — one block per SM, 0 blocks if one cannot be resident —
// and the shared memory a block has for rows of A: the device's per-block
// opt-in (optin) less the kernels' static shared memory (fixed, the most
// of the twelve instantiations that may run at n) and the block's state
// (kernels/tail_probe.py, tail_budget, is the same arithmetic).  Raises
// each instantiation's dynamic shared-memory cap to what it may take.
extern "C" int fasta_tail_probe_grid(int n, int* nblocks, int* budget, int* optin_out,
                                     int* fixed_out) {
  if (pick(0, kLadder, n) == nullptr) return cudaErrorInvalidValue;
  const void* fns[7 + kVariants - 1];
  int c = 0;
  for (int l = 0; l <= 6; ++l) fns[c++] = pick(l, kLadder, n);
  for (int v = kCol; v < kVariants; ++v) fns[c++] = pick(6, v, n);
  return rows_grid(fns, c, state_bytes(n), nblocks, budget, optin_out, fixed_out);
}

// The doubles of the stream scratch a launch over nblocks needs.
extern "C" int fasta_tail_probe_work(int m, int n, int nblocks, int* ndoubles) {
  if (m < 1 || n < 4 || n % 4 || nblocks < 1) return cudaErrorInvalidValue;
  const size_t total = layout(m, n, nblocks).total;
  if (total > (size_t)0x7fffffff) return cudaErrorInvalidValue;
  *ndoubles = (int)total;
  return cudaSuccess;
}

// Run K iterations of rung `level` (variant 0) or of X variant 1..5 over
// L6 on `stream`.  n % 4 == 0 up to 8192; A, x0 and work 16-byte aligned;
// tiles the plan's (4, nblocks) table on the device and smem_rows the
// most rows a block keeps in shared memory; work the stream scratch
// (fasta_tail_probe_work doubles), its first two words zero, which the
// launch leaves zero.  Every output is written: taus and res (128 floats)
// are zero past the recorded iterations (all zero below L6).  The grid
// and shared memory must be what fasta_tail_probe_grid set up, or the
// launch is refused.
extern "C" int fasta_tail_probe(int level, int variant, const float* A, const float* b,
                                const float* x0, int m, int n, int K, float* x_out, float* g_out,
                                float* tau_out, float* taus, float* res, int* trials,
                                const int* tiles, int smem_rows, void* work, int nblocks,
                                void* stream) {
  const void* fn = pick(level, variant, n);
  if (fn == nullptr || m < 1 || K < 1 || nblocks < 1 || tiles == nullptr || work == nullptr ||
      smem_rows < 0)
    return cudaErrorInvalidValue;
  const Layout l = layout(m, n, nblocks);
  double* w = static_cast<double*>(work);
  Args args{};
  args.A = A;
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
  args.tiles = tiles;
  args.bar = static_cast<unsigned*>(work);
  args.fpart = w + l.fpart;
  args.ftot = reinterpret_cast<float*>(w + l.ftot);
  args.bbp = reinterpret_cast<float*>(w + l.bbp);
  args.gvec = reinterpret_cast<float*>(w + l.gvec);
  args.gpart = reinterpret_cast<float*>(w + l.gpart);
  args.rbuf = reinterpret_cast<float*>(w + l.rbuf);
  const size_t smem = state_bytes(n) + (size_t)smem_rows * n * sizeof(float);
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params,
                                                      smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}
