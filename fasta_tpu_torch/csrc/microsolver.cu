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
// Bound on this card: latency.  A trial is 4·m·n operations on A (the
// forward and the adjoint product) and otherwise a chain of dependent
// phases — the grid barriers, the reductions over blocks and the
// decision — whose floor a tiny shape measures (tools/dense_split.py;
// the times are in PERF.md).  As the TPU kernel pins A in VMEM, the row
// kernel below keeps A on the chip for the whole launch, and the adjoint
// comes from the same rows: there is no transposed copy.
//
// The dense plan (kernels/microsolver.py, dense_plan) reaches the kernel
// as a (4, nblocks) int32 table: block k owns the band of rows [r0, r1)
// and keeps its first nreg rows in registers and the next nsm in shared
// memory for the whole launch; the rest of its band (the streamed
// remainder) it reads from L2 once a pass, each thread with its own
// 16-byte loads as it comes to a row.  Two kernels:
//  * dense_rows_kernel, n ≤ 8192 (padded to a multiple of 4, kStateMax):
//    rows on the chip, every block holding the whole n-sized state;
//  * dense_columns_kernel past it (the column fallback): nothing of A on
//    the chip, the state in device memory, A read from L2 twice a trial.
// Each kernel's note follows below.  Common to both:
//  * One persistent cooperative launch, one block of 512 threads per SM.
//  * The grid barrier is grid_barrier.cuh's, its counter and exit ticket
//    in the wrapper's stream scratch, left at zero by the last block out
//    (grid_exit): no memset a call.  The records past a point's last
//    iteration are zeroed by the kernel, so a call is one device
//    operation.
//  * Uniform control flow: the backtracking loop, the stop test, the halt
//    code, the mode, the loss and the prox branch around grid barriers,
//    so every block takes the same branch.  Loss, prox and mode are fixed
//    for the launch; every block derives bit-identical decisions from the
//    same sums, each taken in one fixed order (fbs_control.cuh).  No
//    atomics on values, no fast math: two runs give the same bits.  The
//    FP64 accumulation type (hp off / on) and the mode are template
//    parameters.
//  * K-B1p runs the path points one after another inside the launch (the
//    TPU's sequential grid); point i+1 starts from point i's solution
//    when the path is warm, adaptive mode also from its last genuinely
//    accepted τ.  A single solve is a path of one point.  K-B1b is the
//    same loop over cold points that each take their own b, x₀ and τ₀
//    (Points in fbs_control.cuh); start_point resets the window, τ, the
//    counts and the halt code, so each instance is bit-identical to its
//    own K-B1 launch, and A is staged on the chip once a launch.
//  * With hp, f, the window, ⟨Δx,∇f⟩, ⟨Δx,Δg⟩ and (restart_dd) the
//    restart dot accumulate in FP64 (K-B2); positive sums in float32.
//  * Elementwise formulas use the _rn intrinsics, which the compiler never
//    contracts into FMAs, so they round exactly like the plain PyTorch
//    version's separate operations.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense_rows.cuh"
#include "fbs_control.cuh"
#include "grid_barrier.cuh"
#include "losses.cuh"
#include "reduce.cuh"

using namespace fasta;

namespace {

// proxes, in the order of kernels.microsolver.PROXES
enum Prox { kL1, kNonneg, kBox, kRidge };
// the kernels, as the wrapper's plan names them
enum Route { kRouteRows, kRouteColumns };

struct Args {
  const float* A;      // (m, n) row-major, 16-byte aligned
  Points pts;          // each point's b (m,), cold x₀ (n,) and τ₀
  const float* mus;    // (npoints,) the path's weights, or null: mu0 for every point
  float mu0;
  float* x_out;        // (npoints, n)
  Records rec;
  float* its;          // (npoints, max_iters, n) or null
  int* k_out;          // (npoints,)
  int* status_out;     // (npoints,)
  const int* tiles;    // (4, nblocks) rows: first row, end row, rows in registers, in shared memory
  unsigned* bar;       // grid_barrier's counter and grid_exit's ticket, zero at launch
  float* gpart;        // (nblocks, n4) rows: the blocks' shares of Aᵀℓ′
  float* gvec;         // (n4,) rows: the reduced g
  double* ftot;        // rows: the reduced f of the last pass, beside g
  double* bbp;         // (kChunks, 2) rows: each column chunk's ⟨Δx,Δg⟩, ‖Δg‖²
  float* xbuf;         // (2, n4) columns: current and trial iterate (FISTA: y and x₁)
  float* gbuf;         // (2, n4) columns: their gradients
  float* xacc;         // (n4,) columns, FISTA: the last prox point
  float* rbuf;         // (m,) columns: the gradient weights ℓ′(d)
  float* dbuf;         // (m,) FISTA: A x₁ of the trial
  float* dacc;         // (m,) FISTA: A x_acc
  double* part;        // (3, kSlots, nblocks)
  Control ctl;
  int npoints, m, n, n4, loss, prox, rdd, warm;
  int adj_w;           // columns: warps that split the rows of a column chunk
};

__device__ __forceinline__ float point_mu(const Args& a, int p) {
  return a.mus ? __ldg(a.mus + p) : a.mu0;
}

// the prox of g at z with t = τμ (ridge: z/(1+τλ), μ carrying λ)
__device__ __forceinline__ float prox_eval(int prox, float z, float t) {
  switch (prox) {
    case kNonneg: return nanmax(z, 0.f);
    case kBox: return nanmin(nanmax(z, -1.f), 1.f);
    case kRidge: return __fdiv_rn(z, __fadd_rn(1.f, t));
    default: return shrink_sparse(z, t);
  }
}

// x₁ = prox(x − τg) at a slot's four entries, the prox's branch taken once
__device__ __forceinline__ float4 prox4(int prox, float4 x, float4 g, float tau, float t) {
  const float4 h = make_float4(step_hat(x.x, g.x, tau), step_hat(x.y, g.y, tau),
                               step_hat(x.z, g.z, tau), step_hat(x.w, g.w, tau));
  switch (prox) {
    case kNonneg:
      return make_float4(nanmax(h.x, 0.f), nanmax(h.y, 0.f), nanmax(h.z, 0.f), nanmax(h.w, 0.f));
    case kBox:
      return make_float4(nanmin(nanmax(h.x, -1.f), 1.f), nanmin(nanmax(h.y, -1.f), 1.f),
                         nanmin(nanmax(h.z, -1.f), 1.f), nanmin(nanmax(h.w, -1.f), 1.f));
    case kRidge: {
      const float d = __fadd_rn(1.f, t);
      return make_float4(__fdiv_rn(h.x, d), __fdiv_rn(h.y, d), __fdiv_rn(h.z, d),
                         __fdiv_rn(h.w, d));
    }
    default:
      return make_float4(shrink_sparse(h.x, t), shrink_sparse(h.y, t), shrink_sparse(h.z, t),
                         shrink_sparse(h.w, t));
  }
}

// One entry's terms of the step's sums (rows kernel): v = ‖Δx‖², ‖g‖²,
// ‖x₁ − x̂‖², g's sum (Σ|x₁| for the l1 norm, else Σx₁²) and the float32
// restart dot; w = ⟨Δx, g⟩ and the FP64 restart dot (restart_dd, which
// comes with hp: Acc is double), x₁ being xn, FISTA's x_acc xa.
template <typename Acc, bool ACCEL>
__device__ __forceinline__ void step_sums(float xv, float gv, float xn, float xa, float tau,
                                          int prox, int rdd, float (&v)[5], Acc (&w)[2]) {
  const float xh = step_hat(xv, gv, tau);
  const float dx = __fsub_rn(xn, xv), sm = __fsub_rn(xn, xh);
  v[0] = fmaf(dx, dx, v[0]);
  v[1] = fmaf(gv, gv, v[1]);
  v[2] = fmaf(sm, sm, v[2]);
  v[3] = prox == kL1 ? __fadd_rn(v[3], fabsf(xn)) : fmaf(xn, xn, v[3]);
  w[0] += Acc(dx) * Acc(gv);
  if (ACCEL) {
    // the restart dot ⟨y − x₁, x₁ − x_acc⟩
    const float ra = __fsub_rn(xv, xn), rb = __fsub_rn(xn, xa);
    if (rdd)
      w[1] += Acc(ra) * Acc(rb);
    else
      v[4] = fmaf(ra, rb, v[4]);
  }
}

// g's objective term at the prox point from its sum gx (Σ|x₁| for the
// l1 norm, Σx₁² for the ridge)
__device__ __forceinline__ float g_objective(int prox, float mu, float gx) {
  return prox == kL1 ? __fmul_rn(mu, gx)
                     : prox == kRidge ? __fmul_rn(__fmul_rn(0.5f, mu), gx) : 0.f;
}

// ---------------------------------------------------------------------------
// dense_rows_kernel: n ≤ 8192 (padded to a multiple of 4).
//  * Every block keeps the whole n-sized state in shared memory — x
//    (FISTA: y), g, the trial x₁ and FISTA's x_acc — and takes the prox
//    step and every n-sized sum itself, in the same order as every other
//    block: no barrier for the prox step.
//  * A row is spread over tg threads (whole warps: the row's float4 slots
//    rounded up to a warp, at most 512), R = 512 / tg row lanes side by
//    side each taking the band's rows rl, rl + R, … in order, a thread
//    owning the slots q = gl + tg·s (s < S ≤ 4) of every row it meets.
//    Row lane 0 forms x₁ at its slots from x and g in shared memory
//    (the other row lanes read it back) and every thread keeps it in
//    registers for the pass.  A step takes TB = 8 / S rows a row lane:
//    each thread loads their slots once (from registers, shared memory or
//    L2) and forms its share of each row dot; one transposed shuffle sum
//    (transpose_sum) takes the step's TB dots over the warp, the warps'
//    sums meet in shared memory, one thread a row adds them in warp order
//    and applies the loss, and after a second block barrier the threads
//    add the rows' share of Aᵀℓ′ from the values they hold, in registers:
//    one read of A a pass.  The row lanes' shares meet in shared memory
//    in lane order and the block writes one (n4,) share.  The pass is
//    bound by the instructions its 16 warps issue, not by A's bytes:
//    code that a row lane or a step does not need is branched around,
//    never only predicated off.
//  * The band stays on the chip: at S = 1 (n4 ≤ 2048) a thread keeps the
//    rows of its first step in registers (R·8 rows a block); the next
//    rows, as many as the plan's budget holds, sit in shared memory; the
//    rest each thread reads from L2 with its own 16-byte loads.  Where a
//    row lies never changes the order of a sum: the band does, so a plan
//    forced to stream gives the card's own plan's bits.
//  * After the first barrier each block reduces its chunks of 32 columns
//    over the blocks' shares (16 chains a column, all loads of a chain in
//    flight, a fixed order) into g and takes the chunks' BB sums there;
//    the last block sums the f partials meanwhile, so the second barrier
//    publishes g, f and the BB sums at once: every block copies g while
//    warp 0 loads the chunks' sums a lane a chunk and decides.
//  * The step's sums need no other block: they run between the halves of
//    the first barrier (grid_arrive, grid_wait), and warp 1 takes from
//    them the half of the decision that needs no f (decide_prepare,
//    fbs_control.cuh); thread 0 finishes it after the last barrier.
//  * Grid barriers per adaptive trial: 2 (publish the rows' partials;
//    the reduced g).  FISTA: 1 per trial (the trials need only f) plus 2
//    per acceptance (d_n = d₁ + β(d₁ − d_acc) on the owned rows, A being
//    linear, with its adjoint; the reduced g_n).  A path point's start
//    takes 2.
// ---------------------------------------------------------------------------

// What a pass over the band does on each row.
enum Pass {
  kStart,     // d = A x, ℓ′, f, Aᵀℓ′; FISTA: d_acc = d
  kAdaptive,  // d = A x₁, ℓ′, f, Aᵀℓ′
  kFista,     // d = A x₁, ℓ′, f; d₁ stored
  kExtrap     // d_n = d₁ + β(d₁ − d_acc), d_acc = d₁, ℓ′, f, Aᵀℓ′
};

// One pass over the block's band (see Pass) in `steps` steps at the
// thread's slots xs of x (kStart) or x₁ (unused by kExtrap):
// dense_rows.cuh's band_pass with the loss at each row, bb the band's b,
// sA the band's rows in shared memory, ra the thread's register rows
// (S = 1).  Returns the block's f sum in Acc (valid in thread 0); with
// the adjoint, writes the block's (n4,) share of Aᵀℓ′ to gpart, the row
// lanes' shares meeting in aux.
template <typename Acc, int S, int PASS>
__device__ __forceinline__ Acc rows_pass(const Args& a, const Tile& t, const Lane& L, int steps,
                                         const float4* sA, const float* bb,
                                         const float4 (&xs)[S], float beta,
                                         const float4 (&ra)[S == 1 ? 8 : 1][S], float* aux,
                                         Acc* acc_scratch, float (*rowred)[kWarps], float* lrow) {
  float xv[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    xv[s][0] = xs[s].x;
    xv[s][1] = xs[s].y;
    xv[s][2] = xs[s].z;
    xv[s][3] = xs[s].w;
  }
  Acc fsum = Acc(0);
  band_pass<float, S, PASS != kFista, PASS != kExtrap>(
      a.A, a.n, t, L, steps, sA, xv, ra, aux, rowred, lrow, a.gpart + (size_t)blockIdx.x * a.n4,
      [&](int l, float dv) {
        const int i = t.r0 + l;
        if (PASS == kExtrap) {
          const float d1 = a.dbuf[i], da = a.dacc[i];
          dv = __fadd_rn(d1, __fmul_rn(beta, __fsub_rn(d1, da)));
          a.dacc[i] = d1;
        }
        float w, e;
        loss_eval(a.loss, dv, bb[l], w, e);
        fsum += loss_term<Acc>(a.loss, e);
        if (PASS == kFista) a.dbuf[i] = dv;
        if (PASS == kStart && a.dacc != nullptr) a.dacc[i] = dv;
        return w;
      });
  return block_total(fsum, acc_scratch);
}

// After a grid barrier: g = Σ over blocks of their shares, each column by
// kChains chains (a warp each, lanes on neighbouring columns) in a fixed
// order, into gvec, a block taking chunks of 32 columns; meanwhile the
// last block's last warp sums the blocks' f partials fp into ftot, so that
// the next barrier publishes f with g.  With BB (the adaptive trial) the
// warp that finishes a chunk also takes the chunk's ⟨Δx,Δg⟩ and ‖Δg‖² from
// x (xc), its gradient gc and the trial x₁ (the block's shared memory) at
// stepsize tau, and publishes them in bbp.
template <typename Acc, bool BB>
__device__ __forceinline__ void reduce_shares(const Args& a, const double* fp, float (*red)[32],
                                              const float* xc, const float* gc, const float* x1,
                                              float tau) {
  const int tid = threadIdx.x, lane = tid & 31, chain = tid >> 5;
  const int n4 = a.n4, nb = gridDim.x;
  if ((int)blockIdx.x == nb - 1 && chain == kWarps - 1) {
    const Acc f = warp_sum_blocks<Acc>(fp, nb);
    if (lane == 0) *a.ftot = double(f);
  }
  for (int c0 = blockIdx.x * 32; c0 < n4; c0 += nb * 32) {  // uniform per block
    const int j = c0 + lane;
    red[chain][lane] = j < n4 ? chain_sum(a.gpart, n4, nb, chain, j) : 0.f;
    __syncthreads();
    if (chain == 0) {
      float g = 0.f;
      for (int k = 0; k < kChains; ++k) g += red[k][lane];
      if (j < n4) a.gvec[j] = g;
      if (BB) {
        Acc w = Acc(0);
        float v = 0.f;
        if (j < n4) {
          const float xv = xc[j];
          const float z = step_hat(xv, gc[j], tau);
          const float dx = __fsub_rn(x1[j], xv);
          // Δg = g₁ + (x̂₁ − x)/τ  (== g₁ − g, in the TPU kernel's rounding;
          // a zero numerator's quotient is itself, without the division's
          // slow path)
          const float num = __fsub_rn(z, xv);
          const float dg = __fadd_rn(g, (num == 0.f && tau > 0.f) ? num : __fdiv_rn(num, tau));
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

template <typename Acc, bool ACCEL, int S>
__global__ void __launch_bounds__(kThreads, 1) dense_rows_kernel(Args a) {
  constexpr int TB = 8 / S;
  extern __shared__ __align__(16) float smem[];
  __shared__ Acc fwin[kWinMax];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ float fs[kWarps * 5];
  __shared__ Acc ts[kWarps * 2];
  __shared__ float red[kChains][32];
  __shared__ float rowred[8][kWarps];
  __shared__ float lrow[kStepMax];
  __shared__ float bsh[kBandMax];
  __shared__ double tot[kReduced];
  __shared__ float gobj;
  __shared__ State st;
  __shared__ Prepared<Acc> prep;  // the decision's half that needs no f
  __shared__ Acc f1s;        // FISTA: f(x₁) of the accepted trial
  __shared__ int carry_ok;   // the previous point ended finite
  __shared__ float tprev;    // its warm τ carry

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n4 = a.n4, nq = n4 / 4, n = a.n;
  const Lane L = lane_of(n4);
  const float fscale = loss_scale(a.loss);
  // x (FISTA: y) and the trial x₁ at X(cur) and X(cur ^ 1), their
  // gradients at G(·), FISTA's x_acc, the row lanes' shares (R − 1, n4),
  // then the band's rows
  auto X = [&](int k) { return smem + k * n4; };
  auto G = [&](int k) { return smem + (2 + k) * n4; };
  float* xacc = smem + 4 * n4;
  float* aux = smem + 5 * n4;
  float4* sA = reinterpret_cast<float4*>(aux + (size_t)(L.R - 1) * n4);
  const Tile tile = tile_of(a.tiles, nb, blk);
  const int steps = (tile.rows + L.R * TB - 1) / (L.R * TB);
  double* P0 = a.part;  // each point's start
  int trial = 0;
  unsigned gen = 0;
  auto barrier = [&]() { grid_barrier(a.bar, nb, gen); };

  // the band on the chip for the whole launch: at S = 1 each thread's
  // first step of rows in registers, the next rows in shared memory
  float4 ra[S == 1 ? 8 : 1][S];
  load_reg_rows<float, S>(a.A, n, tile, L, ra);
  stage_slots<float>(a.A, n, nq, tile.r0 + tile.nreg, tile.nsm, sA);
  if (tid == 0) {
    carry_ok = 0;
    tprev = 0.f;
  }

  for (int p = 0; p < a.npoints; ++p) {
    const float mu = point_mu(a, p);
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    __syncthreads();  // the last point's readers of bsh, st and the state are done
    const float* bb = stage_b(a.pts.b_at(p), tile, bsh);
    // the start: point p−1's solution when the path is warm and it ended
    // finite (every block holds it), else the point's own cold start;
    // adaptive mode also takes the carried τ
    const bool carry = a.warm && p > 0 && carry_ok;
    const float* xw = !carry ? nullptr : (ACCEL && st.status == 1) ? xacc : X(st.cur);
    const float* x0 = a.pts.x0_at(p);
    const float tau_start =
        (a.warm && !ACCEL && p > 0 && tprev > 0.f) ? tprev : a.pts.tau0_at(p);
    for (int j = tid; j < n4; j += kThreads) {
      const float v = carry ? xw[j] : (j < n ? __ldg(x0 + j) : 0.f);
      X(0)[j] = v;
      if (ACCEL) xacc[j] = v;
    }
    __syncthreads();

    // ---- start: d₀ = A x₀, f₀, g₀ = Aᵀℓ′(d₀); FISTA: d_acc = d₀
    {
      float4 xs[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = L.gl + L.tg * s;
        xs[s] = L.active && q < nq ? reinterpret_cast<const float4*>(X(0))[q] : zero4();
      }
      const Acc f = rows_pass<Acc, S, kStart>(a, tile, L, steps, sA, bb, xs, 0.f, ra, aux,
                                              acc_scratch, rowred, lrow);
      if (tid == 0) P0[kF * nb + blk] = double(f);
      barrier();
      reduce_shares<Acc, false>(a, P0 + kF * nb, red, nullptr, nullptr, nullptr, 0.f);
      barrier();
      const double f0 = tid == 0 ? __ldcg(a.ftot) : 0.0;
      copy_g(a.gvec, G(0), nq);
      if (tid == 0) start_point(st, fwin, Acc(fscale) * Acc(f0), tau_start);
      __syncthreads();
    }

    for (;;) {
      ++trial;
      double* P = a.part + (size_t)(1 + (trial & 1)) * kSlots * nb;
      const float tau = st.tau;
      const int cur = st.cur;
      const float* xc = X(cur);
      const float* gc = G(cur);
      float* x1 = X(cur ^ 1);

      // ---- the trial step at this thread's slots: x₁ in registers, formed
      // once a slot by row lane 0, which stores it, and shared with the
      // other row lanes through shared memory
      float4 xs[S];
      {
        const float tm = __fmul_rn(tau, mu);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int q = L.gl + L.tg * s;
          xs[s] = zero4();
          if (L.rl == 0 && q < nq) {
            xs[s] = prox4(a.prox, reinterpret_cast<const float4*>(xc)[q],
                          reinterpret_cast<const float4*>(gc)[q], tau, tm);
            reinterpret_cast<float4*>(x1)[q] = xs[s];
          }
        }
        if (L.R > 1) {
          __syncthreads();
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int q = L.gl + L.tg * s;
            if (L.rl > 0 && L.active && q < nq) xs[s] = reinterpret_cast<const float4*>(x1)[q];
          }
        }
      }

      // ---- the rows at x₁: f (and the adaptive gradient's shares)
      {
        const Acc f = ACCEL ? rows_pass<Acc, S, kFista>(a, tile, L, steps, sA, bb, xs, 0.f, ra,
                                                         aux, acc_scratch, rowred, lrow)
                            : rows_pass<Acc, S, kAdaptive>(a, tile, L, steps, sA, bb, xs, 0.f,
                                                           ra, aux, acc_scratch, rowred, lrow);
        if (tid == 0) P[kF * nb + blk] = double(f);
      }
      grid_arrive(a.bar, gen);
      // ---- while the others arrive: the step's sums over the block —
      // ‖Δx‖², ‖g‖², ‖x₁ − x̂‖², g's sum and the float32 restart dot;
      // ⟨Δx, g⟩ and the FP64 restart dot, row lane 0 a slot — and from them
      // the half of the decision that needs no f (warp 1)
      {
        float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        Acc w[2] = {Acc(0), Acc(0)};
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int q = L.gl + L.tg * s;
          if (L.rl == 0 && q < nq) {
            const float4 x4 = reinterpret_cast<const float4*>(xc)[q];
            const float4 g4 = reinterpret_cast<const float4*>(gc)[q];
            const float4 a4 = ACCEL ? reinterpret_cast<const float4*>(xacc)[q] : zero4();
            step_sums<Acc, ACCEL>(x4.x, g4.x, xs[s].x, a4.x, tau, a.prox, a.rdd, v, w);
            step_sums<Acc, ACCEL>(x4.y, g4.y, xs[s].y, a4.y, tau, a.prox, a.rdd, v, w);
            step_sums<Acc, ACCEL>(x4.z, g4.z, xs[s].z, a4.z, tau, a.prox, a.rdd, v, w);
            step_sums<Acc, ACCEL>(x4.w, g4.w, xs[s].w, a4.w, tau, a.prox, a.rdd, v, w);
          }
        }
        const double r = block_sums_warp<5, 2, Acc>(v, w, fs, ts);
        if (lane == 0) {
          if (warp == 0) tot[kNd2] = r;
          if (warp == 1) tot[kNg2] = r;
          if (warp == 2) tot[kNsm2] = r;
          if (warp == 3) gobj = g_objective(a.prox, mu, float(r));
          if (warp == 4 && !a.rdd) tot[kRdot] = r;
          if (warp == 5) tot[kBtDot] = r;
          if (warp == 6 && a.rdd) tot[kRdot] = r;
        }
        __syncthreads();
        if (warp == 1) decide_prepare<Acc, ACCEL>(st, tot, fwin, a.ctl, prep);
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
        const int chunks = (n4 + 31) / 32;
        double bw[kChunks / 32], bv[kChunks / 32];
#pragma unroll
        for (int k = 0; k < kChunks / 32; ++k) {
          const int c = tid + 32 * k;
          const bool on = tid < 32 && c < chunks;
          bw[k] = on ? __ldcg(a.bbp + 2 * c) : 0.0;
          bv[k] = on ? __ldcg(a.bbp + 2 * c + 1) : 0.0;
        }
        const double f = tid == 0 ? __ldcg(a.ftot) : 0.0;
        copy_g(a.gvec, G(cur ^ 1), nq);
        if (tid < 32) {
          Acc bw_s = Acc(0);
          float bv_s = 0.f;
#pragma unroll
          for (int k = 0; k < kChunks / 32; ++k) {
            bw_s += Acc(bw[k]);
            bv_s += float(bv[k]);
          }
          bw_s = warp_sum(bw_s);
          bv_s = warp_sum(bv_s);
          if (tid == 0) {
            tot[kF] = f;
            tot[kBbDot] = double(bw_s);
            tot[kNdg2] = bv_s;
            State s = st;
            decide_finish<Acc, ACCEL>(s, tot, prep, fwin, f1s, fscale, gobj, a.ctl, a.rec, rec0,
                                      blk == 0);
            st = s;
          }
        }
      } else if (tid < 32) {
        // ---- the decision, the same in every block
        const Acc f = warp_sum_blocks<Acc>(P + kF * nb, nb);
        if (tid == 0) {
          tot[kF] = double(f);
          State s = st;
          decide_finish<Acc, ACCEL>(s, tot, prep, fwin, f1s, fscale, gobj, a.ctl, a.rec, rec0,
                                    blk == 0);
          st = s;
        }
      }
      __syncthreads();
      if (a.its && st.accepted && (int)(st.krec % nb) == blk) {
        float* row = a.its + (rec0 + st.krec) * n;
        for (int j = tid; j < n; j += kThreads) row[j] = x1[j];
      }

      if (ACCEL && st.post) {
        const float beta = st.beta;
        // ---- the rows at d_n = d₁ + β(d₁ − d_acc): f(d_n) and g_n's
        // shares; y_n = x₁ + β(x₁ − x_acc), x_acc = x₁ over all of x
        const Acc fn = rows_pass<Acc, S, kExtrap>(a, tile, L, steps, sA, bb, xs, beta, ra, aux,
                                                  acc_scratch, rowred, lrow);
        if (tid == 0) P[kFn * nb + blk] = double(fn);
        float* y = X(cur);
        for (int j = tid; j < n4; j += kThreads) {
          const float xv1 = x1[j], xa = xacc[j];
          y[j] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
          xacc[j] = xv1;
        }
        barrier();
        reduce_shares<Acc, false>(a, P + kFn * nb, red, nullptr, nullptr, nullptr, 0.f);
        barrier();
        const double fpub = tid == 0 ? __ldcg(a.ftot) : 0.0;
        copy_g(a.gvec, G(cur), nq);
        if (tid == 0) {
          State s = st;
          finish_fista(s, Acc(fscale) * Acc(fpub), f1s, fwin, a.ctl, a.rec, rec0, blk == 0);
          st = s;
        }
        __syncthreads();
      }
      if (st.done) break;
    }

    // ---- point end: the solution (FISTA: x₁ on a converged stop, else
    // the extrapolated y), the counts, the records past the last
    // iteration zeroed, and the warm carry
    const int K = a.ctl.max_iters, k = st.k;
    if (blk == 0) {
      const float* xf = (ACCEL && st.status == 1) ? xacc : X(st.cur);
      float* xo = a.x_out + (size_t)p * n;
      for (int j = tid; j < n; j += kThreads) xo[j] = xf[j];
      if (tid == 0) {
        a.k_out[p] = k;
        a.status_out[p] = st.status;
      }
      for (int r = k + tid; r < K; r += kThreads) {
        a.rec.taus[rec0 + r] = 0.f;
        a.rec.res[rec0 + r] = 0.f;
        if (a.rec.fvals) a.rec.fvals[rec0 + r] = 0.f;
        if (a.rec.bts) a.rec.bts[rec0 + r] = 0;
        if (a.rec.objs) a.rec.objs[rec0 + r] = 0.f;
        if (a.rec.nres) a.rec.nres[rec0 + r] = 0.f;
      }
    }
    if (a.its)
      for (int r = k + (((blk - k) % nb) + nb) % nb; r < K; r += nb) {
        float* row = a.its + (rec0 + r) * n;
        for (int j = tid; j < n; j += kThreads) row[j] = 0.f;
      }
    if (tid == 0) {
      const bool ok = st.status != 2;
      carry_ok = ok;
      tprev = (ok && st.k > 0 && st.tau_acc > 0.f) ? st.tau_acc : st.tau_start;
    }
  }
  grid_exit(a.bar, nb);
}

// ---------------------------------------------------------------------------
// dense_columns_kernel: the column fallback past n = 8192, the state in
// device memory and nothing of A on the chip (A read from L2 twice a
// trial).  The phases of a trial:
//   1. the prox step over each thread's columns of the grid, with the
//      step's partial sums;
//   2. d = A x₁ over each block's rows (a warp a row), with ℓ′(d) and
//      partial f;
//   3. adaptive: g₁ = Aᵀℓ′ by column chunks of 32 (a lane a column, the
//      rows split over adj_w warps of a block, their sums met in shared
//      memory in warp order), with partial ⟨Δx,Δg⟩ and ‖Δg‖²;
//   4. every block reduces all blocks' partials and decides.
// Grid barriers per adaptive trial: 3; FISTA: 2 per trial plus 2 per
// acceptance (d_n over the rows; g_n = Aᵀℓ′(d_n), y_n and x_acc over the
// column chunks).  Partials are double-buffered by trial parity.
// ---------------------------------------------------------------------------

// row · v over L entries by one warp (fixed order); result in lane 0.  v
// is written by other blocks, so it is read past L1.
__device__ __forceinline__ float row_dot(const float* __restrict__ row, const float* v,
                                         int L, int lane) {
  float s = 0.f;
  if ((L & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int q = lane; q < (L >> 2); q += 32) s = dot4(__ldg(r4 + q), __ldcg(v4 + q), s);
  } else {
    for (int j = lane; j < L; j += 32) s = fmaf(__ldg(row + j), __ldcg(v + j), s);
  }
  return warp_sum(s);
}

// g = Aᵀ r (r written by other blocks) by column chunks of 32: a block's
// kWarps / W groups of W warps each take chunks blk·G + group, … ; warp
// wi of a group adds rows wi, wi + W, … of its chunk in order (eight
// loads in flight), and the group's sums meet in shared memory in warp
// order.  each(j, g) runs once a column, in the group's first warp.
template <typename F>
__device__ __forceinline__ void adjoint_chunks(const Args& a, const float* r, float (*red)[32],
                                               F&& each) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = a.adj_w, G = kWarps / W, grp = warp / W, wi = warp - grp * W;
  const int m = a.m, n = a.n, nb = gridDim.x;
  const int chunks = (n + 31) / 32;
  for (int c0 = blockIdx.x * G; c0 < chunks; c0 += nb * G) {  // uniform per block
    const int c = c0 + grp, j = c * 32 + lane;
    const bool on = c < chunks && j < n;
    float s = 0.f;
    if (on) {
      for (int i0 = wi; i0 < m; i0 += 8 * W) {
        float u[8], q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = i0 + k * W;
          u[k] = i < m ? __ldg(a.A + (size_t)i * n + j) : 0.f;
          q[k] = i < m ? __ldcg(r + i) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) s = fmaf(u[k], q[k], s);
      }
    }
    red[warp][lane] = s;
    __syncthreads();
    if (wi == 0 && on) {
      float g = 0.f;
      for (int k = 0; k < W; ++k) g += red[grp * W + k][lane];
      each(j, g);
    }
    __syncthreads();
  }
}

template <typename Acc, bool ACCEL>
__global__ void __launch_bounds__(kThreads, 1) dense_columns_kernel(Args a) {
  __shared__ Acc fwin[kWinMax];
  __shared__ Acc acc_scratch[kWarps];
  __shared__ float f32_scratch[kWarps];
  __shared__ double f64_scratch[kWarps];
  __shared__ float red[kWarps][32];
  __shared__ double tot[kReduced];
  __shared__ State st;
  __shared__ Acc f1s;
  __shared__ int carry_ok;
  __shared__ float tprev;

  const int tid = threadIdx.x, lane = tid & 31;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gthreads = nb * kThreads;
  const int gwarp = blk * kWarps + (tid >> 5), gwarps = nb * kWarps;
  const int m = a.m, n = a.n;
  const float fscale = loss_scale(a.loss);
  const bool need_gx = a.rec.objs != nullptr && (a.prox == kL1 || a.prox == kRidge);
  float* X[2] = {a.xbuf, a.xbuf + a.n4};
  float* G[2] = {a.gbuf, a.gbuf + a.n4};
  double* P0 = a.part;
  int trial = 0;
  unsigned gen = 0;
  auto barrier = [&]() { grid_barrier(a.bar, nb, gen); };

  if (tid == 0) {
    carry_ok = 0;
    tprev = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < a.npoints; ++p) {
    const float mu = point_mu(a, p);
    const float* bp = a.pts.b_at(p);
    const size_t rec0 = (size_t)p * a.ctl.max_iters;
    const float* xs =
        (a.warm && p > 0 && carry_ok) ? a.x_out + (size_t)(p - 1) * n : a.pts.x0_at(p);
    const float tau_start =
        (a.warm && !ACCEL && p > 0 && tprev > 0.f) ? tprev : a.pts.tau0_at(p);

    // ---- point start: d₀ = A x₀, f₀, g₀ = Aᵀℓ′(d₀)
    {
      Acc fpart = Acc(0);
      for (int i = gwarp; i < m; i += gwarps) {
        const float d = row_dot(a.A + (size_t)i * n, xs, n, lane);
        if (lane == 0) {
          float w, e;
          loss_eval(a.loss, d, __ldg(bp + i), w, e);
          a.rbuf[i] = w;
          if (ACCEL) a.dacc[i] = d;
          fpart += loss_term<Acc>(a.loss, e);
        }
      }
      for (int j = gtid; j < n; j += gthreads) {
        const float v = __ldcg(xs + j);
        X[0][j] = v;
        if (ACCEL) a.xacc[j] = v;
      }
      fpart = block_sum(fpart, acc_scratch);
      if (tid == 0) P0[kF * nb + blk] = double(fpart);
      barrier();
      adjoint_chunks(a, a.rbuf, red, [&](int j, float g) { G[0][j] = g; });
      if (tid < 32) {
        const Acc f = warp_sum_global<Acc>(P0 + kF * nb, nb);
        if (tid == 0) start_point(st, fwin, Acc(fscale) * f, tau_start);
      }
      barrier();
    }

    for (;;) {
      ++trial;
      double* P = a.part + (size_t)(1 + (trial & 1)) * kSlots * nb;
      const float tau = st.tau;
      const int cur = st.cur;
      const float* xc = X[cur];
      const float* gc = G[cur];
      float* x1 = X[cur ^ 1];

      // ---- phase 1: the trial step over this thread's columns
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
        nd2 = block_sum(nd2, f32_scratch);
        ng2 = block_sum(ng2, f32_scratch);
        nsm2 = block_sum(nsm2, f32_scratch);
        btd = block_sum(btd, acc_scratch);
        if (need_gx) gx = block_sum(gx, f32_scratch);
        if (ACCEL) {
          if (a.rdd)
            rdot64 = block_sum(rdot64, f64_scratch);
          else
            rdot = block_sum(rdot, f32_scratch);
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
      barrier();

      // ---- phase 2: d = A x₁ over this block's rows, ℓ′(d), partial f
      {
        Acc fpart = Acc(0);
        for (int i = gwarp; i < m; i += gwarps) {
          const float d = row_dot(a.A + (size_t)i * n, x1, n, lane);
          if (lane == 0) {
            float w, e;
            loss_eval(a.loss, d, __ldg(bp + i), w, e);
            if (ACCEL)
              a.dbuf[i] = d;
            else
              a.rbuf[i] = w;
            fpart += loss_term<Acc>(a.loss, e);
          }
        }
        fpart = block_sum(fpart, acc_scratch);
        if (tid == 0) P[kF * nb + blk] = double(fpart);
      }
      barrier();

      // ---- phase 3 (adaptive): g₁ = Aᵀℓ′(d) by column chunks, BB partials
      if (!ACCEL) {
        float* g1 = G[cur ^ 1];
        Acc bbd = Acc(0);
        float ndg2 = 0.f;
        adjoint_chunks(a, a.rbuf, red, [&](int j, float g) {
          g1[j] = g;
          const float xv = __ldcg(xc + j), gv = __ldcg(gc + j);
          const float xh = step_hat(xv, gv, tau);
          const float dx = __fsub_rn(__ldcg(x1 + j), xv);
          // Δg = g₁ + (x̂₁ − x)/τ  (== g₁ − g, in the TPU kernel's rounding)
          const float dg = __fadd_rn(g, __fdiv_rn(__fsub_rn(xh, xv), tau));
          bbd += Acc(dx) * Acc(dg);
          ndg2 = fmaf(dg, dg, ndg2);
        });
        bbd = block_sum(bbd, acc_scratch);
        ndg2 = block_sum(ndg2, f32_scratch);
        if (tid == 0) {
          P[kBbDot * nb + blk] = double(bbd);
          P[kNdg2 * nb + blk] = ndg2;
        }
        barrier();
      }

      // ---- phase 4: every block reduces the same partials in the same
      // order and takes the same decision
      if (tid < 32) reduce_partials<Acc, ACCEL>(P, nb, need_gx, a.rdd, tot);
      __syncthreads();
      if (tid == 0) {
        const float gobj = g_objective(a.prox, mu, float(tot[kGx]));
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
            loss_eval(a.loss, dn, __ldg(bp + i), w, e);
            a.rbuf[i] = w;
            fpart += loss_term<Acc>(a.loss, e);
          }
          fpart = block_sum(fpart, acc_scratch);
          if (tid == 0) P[kFn * nb + blk] = double(fpart);
        }
        barrier();
        // ---- phase B: g_n = Aᵀℓ′(d_n), y_n = x₁ + β(x₁ − x_acc), x_acc = x₁
        {
          float* y = X[cur];
          float* gy = G[cur];
          adjoint_chunks(a, a.rbuf, red, [&](int j, float g) {
            const float xv1 = __ldcg(x1 + j), xa = __ldcg(a.xacc + j);
            gy[j] = g;
            y[j] = __fadd_rn(xv1, __fmul_rn(beta, __fsub_rn(xv1, xa)));
            a.xacc[j] = xv1;
          });
        }
        barrier();
        if (tid < 32) {
          const Acc fn = Acc(fscale) * warp_sum_global<Acc>(P + kFn * nb, nb);
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

    // ---- point end: the solution, its counts, the records past the last
    // iteration zeroed, and the warm carry
    const int K = a.ctl.max_iters, k = st.k;
    const float* xf = (ACCEL && st.status == 1) ? a.xacc : X[st.cur];
    float* xo = a.x_out + (size_t)p * n;
    for (int j = gtid; j < n; j += gthreads) xo[j] = __ldcg(xf + j);
    if (blk == 0) {
      if (tid == 0) {
        a.k_out[p] = k;
        a.status_out[p] = st.status;
      }
      for (int r = k + tid; r < K; r += kThreads) {
        a.rec.taus[rec0 + r] = 0.f;
        a.rec.res[rec0 + r] = 0.f;
        if (a.rec.fvals) a.rec.fvals[rec0 + r] = 0.f;
        if (a.rec.bts) a.rec.bts[rec0 + r] = 0;
        if (a.rec.objs) a.rec.objs[rec0 + r] = 0.f;
        if (a.rec.nres) a.rec.nres[rec0 + r] = 0.f;
      }
    }
    if (a.its)
      for (int r = k; r < K; ++r) {
        float* row = a.its + (rec0 + r) * n;
        for (int j = gtid; j < n; j += gthreads) row[j] = 0.f;
      }
    if (tid == 0) {
      const bool ok = st.status != 2;
      carry_ok = ok;
      tprev = (ok && st.k > 0 && st.tau_acc > 0.f) ? st.tau_acc : st.tau_start;
    }
    if (p + 1 < a.npoints) barrier();  // the next point may start from xo
  }
  grid_exit(a.bar, nb);
}

using Kernel = void (*)(Args);

template <typename Acc, bool ACCEL>
Kernel pick_t(int route, int n4) {
  if (route == kRouteColumns) return dense_columns_kernel<Acc, ACCEL>;
  const int S = slots_of(n4);
  return S == 1 ? dense_rows_kernel<Acc, ACCEL, 1>
                : S == 2 ? dense_rows_kernel<Acc, ACCEL, 2> : dense_rows_kernel<Acc, ACCEL, 4>;
}

Kernel pick(int route, int n4, bool hp, bool accel) {
  return hp ? (accel ? pick_t<double, true>(route, n4) : pick_t<double, false>(route, n4))
            : (accel ? pick_t<float, true>(route, n4) : pick_t<float, false>(route, n4));
}

// the kernel the wrapper's plan takes at padded width n4
int route_of(int n4) { return n4 <= kStateMax ? kRouteRows : kRouteColumns; }

// dynamic shared memory of a row block besides its rows of A, in bytes:
// the n-sized state (x, g, each twice, and x_acc) and the R − 1 row
// lanes' shares
size_t state_bytes(int n4) {
  return (size_t)(5 + lanes_of(n4).R - 1) * n4 * sizeof(float);
}

size_t pad4(int v) { return ((size_t)v + 3) / 4 * 4; }

// the warps of a block that split a column chunk's rows on the column
// fallback: as many as the grid has to spare for each chunk, a power of
// two up to kWarps
int adjoint_warps(int n, int nblocks) {
  const long long chunks = (n + 31) / 32, spare = (long long)nblocks * kWarps / chunks;
  int w = 1;
  while (2 * w <= kWarps && 2 * w <= spare) w *= 2;
  return w;
}

}  // namespace

// The cooperative grid at padded width n4 (a multiple of 4) on the
// current device — one block per SM, 0 blocks if one cannot be resident —
// and the shared memory a block of the row kernel has for rows of A: the
// device's per-block opt-in (optin) less the kernels' static shared memory
// (fixed, the most of the four instantiations that may run at n4) and the
// block's state (0 on the column fallback; kernels/microsolver.py,
// dense_budget, is the same arithmetic).  Raises every instantiation's
// dynamic shared-memory cap to what it may take.
extern "C" int fasta_microsolve_grid(int n4, int* nblocks, int* budget, int* optin_out,
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
  const long long left = (long long)dyn - (long long)state_bytes(n4);
  *nblocks = per_sm < 1 ? 0 : sms;
  *budget = route == kRouteColumns || left < 0 ? 0 : (int)left;
  *optin_out = optin;
  *fixed_out = (int)fixed;
  return cudaSuccess;
}

// The floats of work_f a launch needs on a route.  Rows: the blocks'
// shares, g, f and the chunks' BB sums, d₁ and d_acc; columns: x, g (two
// each), x_acc, ℓ′, d₁ and d_acc.
extern "C" int fasta_microsolve_work(int m, int n4, int nblocks, int route, int* nfloats) {
  if (m < 1 || n4 < 4 || n4 % 4 || nblocks < 1 || route != route_of(n4))
    return cudaErrorInvalidValue;
  const size_t pm = pad4(m);
  const size_t nf = route == kRouteRows ? (size_t)nblocks * n4 + n4 + 4 + 4 * kChunks + 2 * pm
                                        : 5 * (size_t)n4 + 3 * pm;
  if (nf > (size_t)0x7fffffff) return cudaErrorInvalidValue;
  *nfloats = (int)nf;
  return cudaSuccess;
}

// The doubles of work_d that a launch of K-B1, K-B6 or K-B8 over nblocks
// needs.
extern "C" int fasta_fbs_work_doubles(int nblocks, int* ndoubles) {
  if (nblocks < 1) return cudaErrorInvalidValue;
  *ndoubles = (int)work_doubles(nblocks);
  return cudaSuccess;
}

// Run npoints solves on `stream`: point p takes b + p·b_stride, the cold
// start x0 + p·x0_stride, the weight mus[p] (mu when mus is null) and τ₀
// tau0s[p] (tau0 when tau0s is null); see the option bits in Flag (a warm
// path takes strides 0 for b and x0).  A is (m, n), 16-byte aligned, n4
// its width padded to a multiple of 4; outputs have a leading axis of
// npoints; the records past each point's last iteration come back zero.
// route is the plan's kernel, the one for n4 (0: n4 ≤ 8192, rows; 1: the
// column fallback past it), tiles its (4, nblocks) table on the device
// (first row, end row, rows in registers, rows in shared memory; null on
// route 1) and smem_rows the most rows a block keeps in shared memory;
// bar two zeroed unsigned words that the launch leaves zeroed; work_f
// holds fasta_microsolve_work floats, work_d fasta_fbs_work_doubles
// doubles.  fvals, bts, objs, nres and its may be null.
extern "C" int fasta_microsolve(const float* A, const float* b, int b_stride, const float* x0,
                                int x0_stride, const float* mus, float mu, const float* tau0s,
                                int npoints, float tau0, int m, int n, int n4, int max_iters,
                                int window, float tol, float shrink_factor, int max_backtracks,
                                int stop_rule_code, int loss, int prox, int flags, float* x_out,
                                float* taus, float* res, float* fvals, int* bts, float* objs,
                                float* nres, float* its, int* k_out, int* status_out,
                                const int* tiles, int route, int smem_rows, unsigned* bar,
                                float* work_f, double* work_d, int nblocks, void* stream) {
  if (m < 1 || n < 1 || n4 < n || n4 % 4 || n4 - n > 3 || npoints < 1 || max_iters < 1 ||
      window < 1 || window > kWinMax || max_backtracks < 0 || stop_rule_code < kResidual ||
      stop_rule_code > kIterations || loss < kLstsq || loss > kSquaredHinge || prox < kL1 ||
      prox > kRidge || b_stride < 0 || x0_stride < 0 || route != route_of(n4) ||
      (route == kRouteRows && !tiles) || smem_rows < 0 || !bar)
    return cudaErrorInvalidValue;
  int limit = 0, budget = 0, optin = 0, fixed = 0;
  if (fasta_microsolve_grid(n4, &limit, &budget, &optin, &fixed) != cudaSuccess)
    return cudaErrorInvalidConfiguration;
  if (nblocks < 1 || nblocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  const bool hp = (flags & kHp) != 0, accel = (flags & kAccel) != 0;
  Args args{};
  args.A = A;
  args.pts = Points{b, x0, nullptr, tau0s, b_stride, x0_stride, 0, tau0};
  args.mus = mus;
  args.mu0 = mu;
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
  args.loss = loss;
  args.prox = prox;
  args.rdd = hp && (flags & kRestartDd);
  args.warm = (flags & kWarm) != 0;
  args.adj_w = adjoint_warps(n, nblocks);
  const size_t pm = pad4(m);
  float* w = work_f;
  if (route == kRouteRows) {
    args.gpart = w;
    args.gvec = w + (size_t)nblocks * n4;
    args.ftot = reinterpret_cast<double*>(args.gvec + n4);
    args.bbp = args.ftot + 2;
    w = args.gvec + n4 + 4 + 4 * kChunks;
  } else {
    args.xbuf = w;
    args.gbuf = w + 2 * (size_t)n4;
    args.xacc = w + 4 * (size_t)n4;
    args.rbuf = w + 5 * (size_t)n4;
    w = args.rbuf + pm;
  }
  args.dbuf = w;
  args.dacc = accel ? w + pm : nullptr;
  size_t smem = 0;
  if (route == kRouteRows) {
    smem = state_bytes(n4) + (size_t)smem_rows * n4 * sizeof(float);
    if ((size_t)budget + state_bytes(n4) < smem) return cudaErrorInvalidValue;
  }
  void* params[] = {&args};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)pick(route, n4, hp, accel), dim3(nblocks),
                                  dim3(kThreads), params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
