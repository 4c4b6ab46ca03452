// K-P1 and K-P2: the GEMV formulation probe over a matrix resident in L2.
//
// K-P1 runs K data-chained operations over one float32 matrix A (m, n) in
// one launch, with a grid barrier after each; the chaining rules are the
// TPU probe's, so every operation depends on the one before:
//     fwd_*      d = A x,           x ← x + d₀·1e-9
//     fwd_strip* s = Σᵢ (A x)ᵢ,     x ← x + s·1e-9
//     adj_*      g = Aᵀ(x₀·1),      x ← x + g·1e-9     (x₀: x's first entry)
// It returns x and the last operation's result (d, s or g).  The gradmap
// form (r = A x − b, f = ½‖r‖², g = Aᵀr) has its own kernel on K-B1's rows
// on the chip, gradmap_probe.cu.  K-P2 is the gradmap pass once, as its
// own form of the kernel here: f and g of one pass over A.
//
// Replaces: benchmarks/matvec_kernels.py, run_variant (pallas_call at :158,
// body _body_factory at :41) and check_gradmap_correct (pallas_call at
// :199) — the TPU probes that chose the whole-solve kernel's GEMV
// formulation (MXU against VPU, row strips) and checked the one-pass
// gradient map.
//
// Bound on this card: one read of A per operation, 8.19 MB at 1000×2048
// over 3.35 TB/s = 2.45 µs, but A (8 MB) stays in the 50 MB L2, so an
// operation can beat that bound; what is left is the L2's rate, the
// latency of the dependent chain and the grid barrier after each
// operation.
//
// Design: one persistent cooperative launch, one block per SM, 512
// threads.  Each TPU formulation maps to this card's counterpart.  The
// forward forms (redesigned for the H100: every warp of every block takes
// a share of A, and every load of A is coalesced) keep x in every block's
// shared memory and update it there from d₀ (or s), read after the
// barrier: one barrier an operation.  Block k takes rows (strips, tiles)
// ⌊k·count/nb⌋ to ⌊(k+1)·count/nb⌋, so the split is a function of the
// shape and the grid alone, and the partial sums meet in a fixed order:
//  * fwd_vpu (K-B1's phase F): each of the block's rows is split over
//    S = 16 / rows warps (at least one) in contiguous column ranges; a
//    lane takes 16-byte loads of A 32 apart, eight in flight, and the
//    warps' sums of a row meet in shared memory in warp order.  A lane's
//    first eight loads of the next operation (fwd_strip: its column of
//    the first strip's 8 rows) are issued between the block's arrival at
//    the barrier that ends this one and its wait, so they travel while the
//    block waits (A does not depend on x) and the arrival's release does
//    not wait for them.  Every load of A is volatile, so each operation
//    reads A once.
//  * fwd_mxu / adj_mxu: tensor cores at float32 accuracy, the counterpart
//    of Precision.HIGHEST: mma.sync.m16n8k8 TF32 through inline PTX with
//    the 3×TF32 split (lo·hi + hi·lo + hi·hi, cvt.rna.tf32.f32).  Forward:
//    A is the B operand, a tile of 8 rows of A as its 8 columns, and x is
//    row 0 of the 16-row A operand (the wasted dimension), so the 125
//    tiles of 1000 rows fill the grid; the 16 warps split the reduction
//    in chunks of 32 columns.  A lane loads its row's 8 consecutive
//    columns of a chunk with two 16-byte loads and feeds them to four
//    k-steps, k permuted the same way in A and x (the sum over k does not
//    depend on its order).  Adjoint: a block takes a tile of 16 columns
//    and its warps split the rows in steps of 8, with scalar fragment
//    loads (32-bit types have no ldmatrix transpose).  Warp sums meet in
//    shared memory in warp order.
//  * fwd_strip: strips of 8 rows; the 16 warps of a block split a strip's
//    columns, a lane keeps a register accumulator per row over 16-byte
//    loads; only Σd is kept.  fwd_strip_auto: the same strips and column
//    split, each lane a plain loop over its columns and the strip's rows
//    left to the compiler (no hand-written vector loads or shuffles in
//    its row sums).  Lane sums meet in the block sum; block partials are
//    summed by every block in block order.
//  * check (K-P2): a warp per row computes rᵢ = aᵢᵀx − bᵢ and at once
//    adds rᵢ·aᵢ into its warp's share of g in shared memory (the row is
//    read from L2 once; its second touch hits L1); the warps' shares make
//    a per-block partial of g.  The rows are dealt out block by block
//    (row i to block i mod nb), and the end is spread over the grid:
//    after the barrier block k adds the block partials of columns
//    ⌊k·n/nb⌋ to ⌊(k+1)·n/nb⌋, several chains a column, eight partials in
//    flight a chain, the chains then in order; block 0 adds the f
//    partials.  One barrier, no x to publish.  The barrier stays: it lets
//    every block take a share of the partials, where a last-block ticket
//    would leave them all to one SM.
//  * adj_vpu: tiles of 16 columns; threads are (row lane, column group)
//    pairs, the row lanes' sums added by a fixed pairwise tree (as K-P4's
//    adjoint).  The adjoint variants keep x in device memory, double-
//    buffered by operation parity, each column updated by its owner.
//  * The barrier-alone form runs K grid barriers and nothing else: the
//    floor under every chained operation, with grid_barrier.cuh's barrier
//    or, when the wrapper passes no counter, cooperative_groups'
//    grid.sync (1.06 against 1.19 µs on an H100).  Every form ends its
//    operations with grid_barrier.cuh's.
//  * The barrier's counter and exit ticket live in the stream's scratch
//    (kernels/_build.py, stream_scratch), zero at launch; every launch
//    sets them back to zero at its end (grid_exit).  The dynamic shared
//    memory cap is raised once, to the most a block can take, so no later
//    grid query lowers it under another launch.
//  * No float atomics: the same result on every run.  Values other
//    blocks wrote are read past L1 (__ldcg).  Elementwise updates use the
//    _rn intrinsics, so they round as the plain PyTorch version does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "grid_barrier.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 16;
constexpr int kRowLanes = kThreads / (kTileCols / 4);

// in the order of kernels.matvec_probe._FORMS, then the barrier alone and
// the check
enum Variant {
  kFwdVpu, kFwdMxu, kFwdStrip, kFwdStripAuto, kAdjVpu, kAdjMxu, kBarrier, kCheck, kCount
};

struct Args {
  const float* A;  // (m, n), rows 16-byte aligned
  const float* x0;
  const float* b;
  int m, n, K;
  float* x_out;   // (n,)
  float* dbuf;    // (2, m): the forward's d by operation parity
  float* xbuf;    // (2, n): adjoints: x by operation parity
  float* gout;    // (n,): the last operation's g
  float* gpart;   // (nblocks, n): the check's per-block partial g
  double* fpart;  // (2, nblocks): strip sums by parity, or the check's f partials
  float* scal;    // (1,): the last strip sum or f
  unsigned* bar;  // grid_barrier's counter and exit ticket, zero at launch; null: grid.sync
};

// rows (strips, tiles) ⌊k·count/nb⌋ to ⌊(k+1)·count/nb⌋ of block k
__device__ __forceinline__ int share(int k, int count, int nb) {
  return (int)((long long)k * count / nb);
}

__device__ __forceinline__ unsigned to_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// v = hi + lo, each a TF32 value
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b at float32 accuracy: the small cross terms first
__device__ __forceinline__ void mma3(float* c, const float* av, const float* bv) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split(bv[i], bh[i], bl[i]);
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// 16 bytes of A through the read-only path, issued where it is written:
// volatile, so the compiler neither hoists the load of a later operation
// out of the chain nor merges it with an earlier one's — each operation
// reads its share of A once
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float dot4(float4 v, float4 w, float s) {
  s = fmaf(v.x, w.x, s);
  s = fmaf(v.y, w.y, s);
  s = fmaf(v.z, w.z, s);
  return fmaf(v.w, w.w, s);
}

__device__ __forceinline__ float ld_a(const Args& a, int r, int c) {
  return (r < a.m && c < a.n) ? __ldg(a.A + (size_t)r * a.n + c) : 0.f;
}

// sum over the warp, the same value in every lane (a butterfly pairs the
// lanes as warp_sum's tree does for lane 0)
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Σ over the blocks' partials P (nb,) by warp 0, lane-strided then a
// shuffle tree (warp_sum_global's order), eight loads in flight a lane;
// the value in every thread after the call
__device__ __forceinline__ float grid_total(const double* P, int nb, float* slot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v = 0.f;
    for (int i0 = 0; i0 < nb; i0 += 256) {
      double w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + lane + 32 * u;
        w[u] = i < nb ? __ldcg(P + i) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) v += float(w[u]);
    }
    v = fasta::warp_sum(v);
    if (lane == 0) *slot = v;
  }
  __syncthreads();
  return *slot;
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1) matvec_probe_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[kWarps][kTileCols];             // mxu: the warps' tile sums
  __shared__ float tree[kRowLanes][kTileCols];         // adj_vpu: the row lanes' sums
  __shared__ float fscr[kWarps];
  __shared__ float bcast;
  constexpr bool STAGED = V < kAdjVpu;  // x staged in shared memory
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gwarps = nb * kWarps;
  const int m = a.m, n = a.n, n4 = n >> 2;
  const int g8 = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  float* xs = dyn;                          // (n,)
  float* gw = dyn + n;                      // check: (kWarps, n)
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  unsigned gen = 0;
  // the grid barrier; with grid_barrier.cuh's, `during` runs between the
  // arrival and the wait
  auto sync_with = [&](auto during) {
    if (a.bar) {
      fasta::grid_arrive(a.bar, gen);
      during();
      fasta::grid_wait(a.bar, nb, gen);
    } else {
      during();
      grid.sync();
    }
  };
  auto sync = [&]() { sync_with([] {}); };

  if (V == kBarrier) {
    for (int k = 0; k < a.K; ++k) sync();
    if (a.bar) fasta::grid_exit(a.bar, nb);
    return;
  }
  if (STAGED) {
    for (int j = tid; j < n; j += kThreads) xs[j] = __ldg(a.x0 + j);
    __syncthreads();
  }
  // fwd_vpu: the block's rows, each split over S warps in contiguous
  // column ranges (S = 1: the warps take whole rows in turn); fwd_strip:
  // the block's strips of 8 rows, the warps splitting each strip's columns
  const int r0 = share(blk, m, nb), rows = share(blk + 1, m, nb) - r0;
  const int S = rows > 0 && rows < kWarps ? kWarps / rows : 1;
  const int nstrips = (m + 7) / 8, s0 = share(blk, nstrips, nb), s1 = share(blk + 1, nstrips, nb);
  const int sq0 = share(warp, n4, kWarps), sq1 = share(warp + 1, n4, kWarps);
  // The first 8 loads of a lane in fwd_vpu (its warp's first row range,
  // 32 apart) and fwd_strip (its first column of the block's first strip,
  // 8 rows), issued during the barrier that ends the previous operation.
  float4 pre[8];
  auto prefetch = [&]() {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    if (V == kFwdVpu) {
      const bool has = warp < rows * S;
      const int i = r0 + warp / S, c = warp % S;
      const int q = share(c, n4, S) + lane, q1 = share(c + 1, n4, S);
      const float4* r4 = reinterpret_cast<const float4*>(a.A + (size_t)i * n);
#pragma unroll
      for (int u = 0; u < 8; ++u) pre[u] = has && q + 32 * u < q1 ? ld_stream(r4 + q + 32 * u) : zero;
    } else if (V == kFwdStrip) {
      const int q = sq0 + lane;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        pre[r] = s0 < s1 && q < sq1 && s0 * 8 + r < m
                     ? ld_stream(reinterpret_cast<const float4*>(a.A + (size_t)(s0 * 8 + r) * n) + q)
                     : zero;
    }
  };
  prefetch();
  for (int k = 0; k < a.K; ++k) {
    const int par = k & 1;
    const bool last = k + 1 == a.K;
    const float* xk = k == 0 ? a.x0 : a.xbuf + (size_t)par * n;  // check, adjoints
    float* xn = a.xbuf + (size_t)(par ^ 1) * n;

    if (V == kFwdVpu || V == kFwdMxu) {
      float* d = a.dbuf + (size_t)par * m;
      if (V == kFwdVpu) {
        for (int t = warp; t < rows * S; t += kWarps) {
          const int i = r0 + t / S, c = t % S;
          const int q1 = share(c + 1, n4, S);
          const float4* r4 = reinterpret_cast<const float4*>(a.A + (size_t)i * n);
          float s = 0.f;
          int q = share(c, n4, S) + lane;
          if (t == warp) {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (q + 32 * u < q1) s = dot4(pre[u], xs4[q + 32 * u], s);
            q += 8 * 32;
          }
#pragma unroll 8
          for (; q < q1; q += 32) s = dot4(ld_stream(r4 + q), xs4[q], s);
          s = fasta::warp_sum(s);
          if (lane == 0) {
            if (S == 1)
              d[i] = s;
            else
              fscr[t] = s;
          }
        }
        if (S > 1) {
          __syncthreads();
          if (tid < rows) {
            float s = 0.f;
            for (int c = 0; c < S; ++c) s += fscr[tid * S + c];
            d[r0 + tid] = s;
          }
        }
      } else {
        // tiles of 8 rows of A as the B operand, x as row 0 of the A
        // operand; the warps split the columns in chunks of 32
        const int ntiles = (m + 7) / 8, nchunks = (n + 31) / 32;
        const int c0 = share(warp, nchunks, kWarps), c1 = share(warp + 1, nchunks, kWarps);
        for (int t = share(blk, ntiles, nb); t < share(blk + 1, ntiles, nb); ++t) {
          const int row = t * 8 + g8;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          for (int ch = c0; ch < c1; ++ch) {
            // this lane's 8 consecutive columns of the chunk: A's row and,
            // in lanes 0-3 (row 0 of the A operand), x
            const int col = ch * 32 + 8 * tq;
            float4 av[2], xv[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool in = col + 4 * h < n;
              av[h] = in && row < m
                          ? __ldg(reinterpret_cast<const float4*>(a.A + (size_t)row * n + col) + h)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
              xv[h] = in && g8 == 0 ? xs4[(col >> 2) + h] : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            const float ae[8] = {av[0].x, av[0].y, av[0].z, av[0].w,
                                 av[1].x, av[1].y, av[1].z, av[1].w};
            const float xe[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                                 xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
            for (int st = 0; st < 4; ++st) {
              // k = tq ↦ column col + 2st, k = tq + 4 ↦ col + 2st + 1
              const float xa[4] = {xe[2 * st], 0.f, xe[2 * st + 1], 0.f};
              const float ab[2] = {ae[2 * st], ae[2 * st + 1]};
              mma3(c, xa, ab);
            }
          }
          if (g8 == 0) {
            red[warp][2 * tq] = c[0];
            red[warp][2 * tq + 1] = c[1];
          }
          __syncthreads();
          if (tid < 8 && t * 8 + tid < m) {
            float s = 0.f;
            for (int w = 0; w < kWarps; ++w) s += red[w][tid];
            d[t * 8 + tid] = s;
          }
          __syncthreads();
        }
      }
      sync_with([&] {
        if (k + 1 < a.K) prefetch();
      });
      const float step = __fmul_rn(__ldcg(d), 1e-9f);
      for (int j = tid; j < n; j += kThreads) xs[j] = __fadd_rn(xs[j], step);
      __syncthreads();
    } else if (V == kFwdStrip || V == kFwdStripAuto) {
      float part = 0.f;
      for (int t = s0; t < s1; ++t) {
        const int i0 = t * 8;
        if (V == kFwdStrip) {
          float acc[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r] = 0.f;
          for (int q = sq0 + lane; q < sq1; q += 32) {
            const float4 w = xs4[q];
            const bool first = t == s0 && q == sq0 + lane;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (i0 + r < m) {
                const float4 v =
                    first ? pre[r]
                          : ld_stream(reinterpret_cast<const float4*>(a.A + (size_t)(i0 + r) * n) + q);
                acc[r] = dot4(v, w, acc[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) part += acc[r];
        } else {
          // a plain loop over this lane's columns, 32 apart; the strip's
          // row sums as the compiler makes them
          float d8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int j = 4 * sq0 + lane; j < 4 * sq1; j += 32)
            for (int r = 0; r < 8; ++r)
              if (i0 + r < m) d8[r] = fmaf(a.A[(size_t)(i0 + r) * n + j], xs[j], d8[r]);
          for (int r = 0; r < 8; ++r) part += d8[r];
        }
      }
      part = fasta::block_sum(part, fscr);
      if (tid == 0) a.fpart[par * nb + blk] = part;
      sync_with([&] {
        if (k + 1 < a.K) prefetch();
      });
      const float s = grid_total(a.fpart + par * nb, nb, &bcast);
      const float step = __fmul_rn(s, 1e-9f);
      for (int j = tid; j < n; j += kThreads) xs[j] = __fadd_rn(xs[j], step);
      if (last && gtid == 0) a.scal[0] = s;
      __syncthreads();
    } else if (V == kCheck) {
      // ---- phase A: r = A x − b, each warp's share of g = Σ rᵢ aᵢ, f
      for (int j = tid; j < n; j += kThreads) xs[j] = __ldcg(xk + j);
      for (int e = tid; e < kWarps * n; e += kThreads) gw[e] = 0.f;
      __syncthreads();
      float4* gw4 = reinterpret_cast<float4*>(gw + (size_t)warp * n);
      float fp = 0.f;
      // the rows dealt out block by block, so that every SM takes a share
      // when there are fewer rows than warps
      for (int i = warp * nb + blk; i < m; i += gwarps) {
        const float4* r4 = reinterpret_cast<const float4*>(a.A + (size_t)i * n);
        float s = 0.f;
#pragma unroll 4
        for (int q = lane; q < n4; q += 32) {
          const float4 v = __ldg(r4 + q), w = xs4[q];
          s = fmaf(v.x, w.x, s);
          s = fmaf(v.y, w.y, s);
          s = fmaf(v.z, w.z, s);
          s = fmaf(v.w, w.w, s);
        }
        const float r = __fsub_rn(warp_allsum(s), __ldg(a.b + i));
        if (lane == 0) fp = fmaf(r, r, fp);
#pragma unroll 4
        for (int q = lane; q < n4; q += 32) {
          const float4 v = __ldg(r4 + q);
          float4 acc = gw4[q];
          acc.x = fmaf(r, v.x, acc.x);
          acc.y = fmaf(r, v.y, acc.y);
          acc.z = fmaf(r, v.z, acc.z);
          acc.w = fmaf(r, v.w, acc.w);
          gw4[q] = acc;
        }
      }
      __syncthreads();
      for (int j = tid; j < n; j += kThreads) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += gw[(size_t)w * n + j];
        a.gpart[(size_t)blk * n + j] = s;
      }
      fp = fasta::block_sum(fp, fscr);
      if (tid == 0) a.fpart[blk] = fp;
      sync();
      // ---- the check's end: block blk adds columns [c0, c1) of the
      // block partials, Y chains a column (thread (y, x) adds partials
      // y, y + Y, …, eight in flight), the chains in y order in `tree`
      const int c0 = share(blk, n, nb), c1 = share(blk + 1, n, nb);
      float* red2 = &tree[0][0];
      int P = 1;
      while (P < c1 - c0 && P < kThreads) P <<= 1;
      const int Y = kThreads / P, y = tid / P, x = tid - y * P;
      for (int base = c0; base < c1; base += P) {
        const int j = base + x;
        float s = 0.f;
        if (j < c1)
          for (int p0 = y; p0 < nb; p0 += 8 * Y) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              v[u] = p0 + u * Y < nb ? __ldcg(a.gpart + (size_t)(p0 + u * Y) * n + j) : 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (p0 + u * Y < nb) s += v[u];
          }
        red2[tid] = s;
        __syncthreads();
        if (y == 0 && j < c1) {
          float t = 0.f;
          for (int c = 0; c < Y; ++c) t += red2[c * P + x];
          a.gout[j] = t;
        }
        __syncthreads();
      }
      if (blk == 0) {
        const float f = __fmul_rn(0.5f, grid_total(a.fpart, nb, &bcast));
        if (tid == 0) a.scal[0] = f;
      }
    } else {
      // ---- adjoints: g = Aᵀ(x₀·1) by tiles of 16 columns
      const float xr = __ldcg(xk);
      const int ntiles = (n + kTileCols - 1) / kTileCols;
      for (int t = blk; t < ntiles; t += nb) {
        float gj = 0.f;
        if (V == kAdjVpu) {
          constexpr int G = kTileCols / 4;
          const int rl = tid / G, gl = tid % G, q = t * G + gl;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          if (q < n4) {
#pragma unroll 4
            for (int i = rl; i < m; i += kRowLanes) {
              const float4 v = __ldg(reinterpret_cast<const float4*>(a.A + (size_t)i * n) + q);
              acc[0] = fmaf(v.x, xr, acc[0]);
              acc[1] = fmaf(v.y, xr, acc[1]);
              acc[2] = fmaf(v.z, xr, acc[2]);
              acc[3] = fmaf(v.w, xr, acc[3]);
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) tree[rl][gl * 4 + c] = acc[c];
          __syncthreads();
          for (int st = kRowLanes / 2; st > 0; st >>= 1) {
            if (rl < st)
#pragma unroll
              for (int c = 0; c < 4; ++c) tree[rl][gl * 4 + c] += tree[rl + st][gl * 4 + c];
            __syncthreads();
          }
          if (tid < kTileCols) gj = tree[0][tid];
        } else {
          const int j0 = t * 16 + g8, j1 = j0 + 8, nks = (m + 7) / 8;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          for (int ks = warp; ks < nks; ks += kWarps) {
            const int i0 = ks * 8 + tq, i1 = i0 + 4;
            const float av[4] = {ld_a(a, i0, j0), ld_a(a, i0, j1), ld_a(a, i1, j0),
                                 ld_a(a, i1, j1)};
            const float bv[2] = {(g8 == 0 && i0 < m) ? xr : 0.f, (g8 == 0 && i1 < m) ? xr : 0.f};
            mma3(c, av, bv);
          }
          if (tq == 0) {
            red[warp][g8] = c[0];
            red[warp][g8 + 8] = c[2];
          }
          __syncthreads();
          if (tid < kTileCols)
            for (int w = 0; w < kWarps; ++w) gj += red[w][tid];
        }
        const int j = t * kTileCols + tid;
        if (tid < kTileCols && j < n) {
          const float x1 = __fadd_rn(__ldcg(xk + j), __fmul_rn(gj, 1e-9f));
          xn[j] = x1;
          if (last) {
            a.gout[j] = gj;
            a.x_out[j] = x1;
          }
        }
        __syncthreads();  // red and tree are rewritten by the next tile
      }
      sync();
    }
  }
  if (STAGED && blk == 0)
    for (int j = tid; j < n; j += kThreads) a.x_out[j] = xs[j];
  if (a.bar) fasta::grid_exit(a.bar, nb);
}

const void* pick(int v) {
  switch (v) {
    case kFwdVpu: return (const void*)matvec_probe_kernel<kFwdVpu>;
    case kFwdMxu: return (const void*)matvec_probe_kernel<kFwdMxu>;
    case kFwdStrip: return (const void*)matvec_probe_kernel<kFwdStrip>;
    case kFwdStripAuto: return (const void*)matvec_probe_kernel<kFwdStripAuto>;
    case kAdjVpu: return (const void*)matvec_probe_kernel<kAdjVpu>;
    case kAdjMxu: return (const void*)matvec_probe_kernel<kAdjMxu>;
    case kCheck: return (const void*)matvec_probe_kernel<kCheck>;
    default: return (const void*)matvec_probe_kernel<kBarrier>;
  }
}

// dynamic shared memory: x for the staged variants, and the check's warp
// shares of g
size_t smem_bytes(int v, int n) {
  if (v == kCheck) return (size_t)(kWarps + 1) * n * sizeof(float);
  return v < kAdjVpu ? (size_t)n * sizeof(float) : 0;  // adjoints, the barrier: none
}

}  // namespace

// The cooperative grid of `variant` for n columns on the current device,
// after raising its dynamic shared-memory cap to the most a block can take
// (a cap for this n could be lower than another launch needs): one block
// per SM (0 if a block cannot be resident: the check takes n up to about
// 3400 columns, the forward variants about 58000).
extern "C" int fasta_matvec_probe_grid(int variant, int n, int* nblocks) {
  if (variant < 0 || variant >= kCount || n < 4 || n % 4) return cudaErrorInvalidValue;
  const void* fn = pick(variant);
  const size_t smem = smem_bytes(variant, n);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  if (smem + attr.sharedSizeBytes > (size_t)optin) {
    *nblocks = 0;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  *nblocks = per_sm < 1 ? 0 : sms;
  return cudaSuccess;
}

// Run K operations of `variant` on `stream` (the check: K = 1), after a
// grid query for its n.  dbuf holds 2m floats, xbuf 2n, gout n, gpart
// nblocks·n (the check only, else may be null), fpart 2·nblocks
// doubles, scal 1 float; the check writes only gout and scal (x_out,
// dbuf, xbuf may be null).  n % 4 == 0 and A, x0 16-byte aligned.  bar
// holds grid_barrier.cuh's counter and exit ticket, both zero (and left
// so), or is null for grid.sync.  The barrier alone (variant kBarrier)
// reads no operand: they may be null.
extern "C" int fasta_matvec_probe(int variant, const float* A, const float* x0, const float* b,
                                  int m, int n, int K, float* x_out, float* dbuf, float* xbuf,
                                  float* gout, float* gpart, double* fpart, float* scal,
                                  unsigned* bar, int nblocks, void* stream) {
  if (variant < 0 || variant >= kCount || m < 1 || n < 4 || n % 4 || K < 1 || nblocks < 1)
    return cudaErrorInvalidValue;
  if (variant == kCheck && K != 1) return cudaErrorInvalidValue;
  Args args{A, x0, b, m, n, K, x_out, dbuf, xbuf, gout, gpart, fpart, scal, bar};
  void* params[] = {&args};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(pick(variant), dim3(nblocks), dim3(kThreads), params,
                                  smem_bytes(variant, n), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}
