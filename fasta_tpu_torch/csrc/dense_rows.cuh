// The row machinery of the dense kernels that keep a matrix's rows on the
// chip for a whole launch: K-B1 (microsolver.cu, the dense whole solve)
// and the probes that take its design, K-P3 (tail_probe.cu, the
// tail-ablation ladder), K-P4 (bf16_probe.cu, the bfloat16-storage
// probe) and K-P1's gradmap_fused form (gradmap_probe.cu).  A block of
// kThreads threads owns a band of rows (Tile, from the wrapper's plan),
// spreads a row over tg threads of whole warps (Lanes), keeps its first
// step of rows in registers and the next in shared memory, and sums a
// step's row dots by one transposed shuffle sum; the blocks' shares of
// Aᵀw meet over the grid by chain sums in a fixed order.  Every sum runs
// in one fixed order, so two runs, and a plan that streams rows where
// another keeps them, give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "losses.cuh"
#include "reduce.cuh"

namespace fasta {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChains = kWarps;              // chains per column of a reduction over blocks
constexpr int kStateMax = 8192;              // the widest n4 of dense_rows_kernel
constexpr int kChunks = kStateMax / 32;      // column chunks of g (their BB sums)
constexpr int kBandMax = 1024;               // the most rows of b a block stages
constexpr int kStepMax = 8 * kWarps;         // rows a step takes at most (R·TB, S = 1)

// shrink(z, t) of prox.cuh with the quotient of a zero numerator taken as
// +0 without dividing: the same bits (0 / d = +0 for every d ≥ 1e-30),
// but an IEEE division of zero leaves the fast path for a slow
// subroutine, and most entries of a sparse solution shrink to zero
__device__ __forceinline__ float shrink_sparse(float z, float t) {
  const float mag = fabsf(z);
  const float num = nanmax(__fsub_rn(mag, t), 0.f);
  return __fmul_rn(z, num == 0.f ? 0.f : __fdiv_rn(num, nanmax(mag, 1e-30f)));
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// The float4 slot q (columns 4q … 4q+3) of row i of A (n columns), zero
// past column n: one 16-byte load where rows are 16-byte aligned.
__device__ __forceinline__ float4 load_a(const float* __restrict__ A, int n, int i, int q) {
  const float* row = A + (size_t)i * n;
  if ((n & 3) == 0) return __ldg(reinterpret_cast<const float4*>(row) + q);
  const int j = 4 * q;
  return make_float4(j < n ? __ldg(row + j) : 0.f, j + 1 < n ? __ldg(row + j + 1) : 0.f,
                     j + 2 < n ? __ldg(row + j + 2) : 0.f, j + 3 < n ? __ldg(row + j + 3) : 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 x, float s) {
  s = fmaf(a.x, x.x, s);
  s = fmaf(a.y, x.y, s);
  s = fmaf(a.z, x.z, s);
  return fmaf(a.w, x.w, s);
}

__device__ __forceinline__ void axpy4(float w, float4 a, float4& g) {
  g.x = fmaf(w, a.x, g.x);
  g.y = fmaf(w, a.y, g.y);
  g.z = fmaf(w, a.z, g.z);
  g.w = fmaf(w, a.w, g.w);
}

__device__ __forceinline__ float4 add4(float4 u, float4 v) {
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

// Sum of `count` doubles in global memory (per-block partials written
// before a grid barrier) in T by one warp: lane l adds entries l, l + 32,
// … in order, eight loads a lane in flight; the result is valid in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum_blocks(const double* p, int count) {
  const int lane = threadIdx.x & 31;
  T v = T(0);
  for (int i0 = 0; i0 < count; i0 += 32 * 8) {
    double u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + lane + 32 * k;
      u[k] = i < count ? __ldcg(p + i) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v += static_cast<T>(u[k]);
  }
  return warp_sum(v);
}

// The block's sum of v, valid in thread 0: the warps' shuffle trees, one
// barrier, then warp 0's tree over the warps' sums.
template <typename T>
__device__ __forceinline__ T block_total(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp == 0 ? warp_sum(lane < kWarps ? scratch[lane] : T(0)) : T(0);
}

// Sums over the block of NF floats and NA values of type T at once: the
// warps' shuffle trees, one barrier, then warp k < NF + NA adds the warps'
// sums of the k-th value (the floats first) by a shuffle tree.  Lane 0 of
// warp k returns that total as a double; every other thread 0.  No thread
// may write fs or ts again before the block has passed another barrier.
template <int NF, int NA, typename T>
__device__ __forceinline__ double block_sums_warp(float (&f)[NF], T (&t)[NA], float* fs, T* ts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(f[k]);
#pragma unroll
  for (int k = 0; k < NA; ++k) t[k] = warp_sum(t[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) fs[warp * NF + k] = f[k];
#pragma unroll
    for (int k = 0; k < NA; ++k) ts[warp * NA + k] = t[k];
  }
  __syncthreads();
  double r = 0.0;
  if (warp < NF)
    r = warp_sum(lane < kWarps ? fs[lane * NF + warp] : 0.f);
  else if (warp < NF + NA)
    r = double(warp_sum(lane < kWarps ? ts[lane * NA + warp - NF] : T(0)));
  return lane == 0 ? r : 0.0;
}

// Column and row lanes at width n4: tg threads on a row's float4 slots
// (whole warps), R row lanes, S slots a thread (the instantiation takes
// 1, 2 or 4).
struct Lanes {
  int tg, R, S;
};

__host__ __device__ constexpr Lanes lanes_of(int n4) {
  const int nq = n4 / 4;
  const int w = (nq + 31) / 32 * 32;
  const int tg = w < kThreads ? w : kThreads;
  return Lanes{tg, kThreads / tg, (nq + tg - 1) / tg};
}

__host__ __device__ constexpr int slots_of(int n4) {
  return lanes_of(n4).S <= 1 ? 1 : lanes_of(n4).S <= 2 ? 2 : 4;
}

static_assert(slots_of(kStateMax) == 4, "a thread takes at most four slots of a row");

// A block's rows: its band [r0, r0 + rows) of A, the first nreg kept in
// registers, the next nsm in shared memory, the rest read from L2.
struct Tile {
  int r0, rows, nreg, nsm;
};

__device__ __forceinline__ Tile tile_of(const int* tiles, int nb, int blk) {
  Tile t;
  t.r0 = __ldg(tiles + blk);
  t.rows = __ldg(tiles + nb + blk) - t.r0;
  t.nreg = __ldg(tiles + 2 * nb + blk);
  t.nsm = __ldg(tiles + 3 * nb + blk);
  return t;
}

// The block's band of b (rows r0 … r0 + rows), staged in bsh when it
// holds at most kBandMax rows (no barrier: the caller's follows), else
// read where it lies; either way indexed by the band's row.
__device__ __forceinline__ const float* stage_b(const float* bp, const Tile& t, float* bsh) {
  if (t.rows > kBandMax) return bp + t.r0;
  for (int l = threadIdx.x; l < t.rows; l += kThreads) bsh[l] = __ldg(bp + t.r0 + l);
  return bsh;
}

// The sums over the warp of V = 2^k values at once (V ≤ 16), as K-B8's
// rows take them: halving steps hand half of a lane's values to the lane
// `o` away (o = 16, 8, …) and keep the other half, until each lane holds
// one value — value L >> (5 − k) in lane L — which the lanes that share
// it complete by a butterfly.  2V − 2 + 5 − k shuffles where V separate
// trees take 5V; a fixed order, the same in every run.
template <int V>
__device__ __forceinline__ float transpose_sum(float (&v)[V]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = V, o = 16; c > 1; c >>= 1, o >>= 1) {
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < c / 2; ++i) {
      const float send = hi ? v[i] : v[c / 2 + i];
      const float keep = hi ? v[c / 2 + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = 16 / V; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// This thread's place in a block of the row kernel, fixed for the launch:
// nq float4 slots a row, R row lanes of tg threads, its row lane rl and
// column lane gl (active: rl < R), the warps a row takes (wpr), and as
// the finishing thread of a step's row, that row's place: the fu-th row
// of row lane fr.
struct Lane {
  int nq, tg, R, rl, gl, wpr, fu, fr;
  bool active;
};

__device__ __forceinline__ Lane lane_of(int n4) {
  const Lanes ln = lanes_of(n4);
  Lane L;
  L.nq = n4 / 4;
  L.tg = ln.tg;
  L.R = ln.R;
  L.rl = threadIdx.x / ln.tg;
  L.gl = threadIdx.x - L.rl * ln.tg;
  L.wpr = ln.tg / 32;
  L.fu = threadIdx.x / ln.R;
  L.fr = threadIdx.x - L.fu * ln.R;
  L.active = L.rl < ln.R;
  return L;
}

// x at this thread's slots of a row of n columns, nq slots of V values
// (zero past column n and on an idle row lane): x0 on a launch's first
// pass (`first`), else x, which other blocks wrote (read past L1).  With
// WHOLE, n is a whole number of slots (n = V·nq): no slot is ragged.
template <int V, int S, bool WHOLE = false>
__device__ __forceinline__ void load_x_slots(const float* x0, const float* x, bool first, int n,
                                             int nq, const Lane& ln, float (&xs)[S][V]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = ln.gl + ln.tg * s, j0 = q * V;
    const bool on = ln.active && q < nq;
    if (on && (WHOLE || j0 + V <= n)) {
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        const float4 v = first ? __ldg(reinterpret_cast<const float4*>(x0 + j0) + h)
                               : __ldcg(reinterpret_cast<const float4*>(x + j0) + h);
        xs[s][4 * h] = v.x;
        xs[s][4 * h + 1] = v.y;
        xs[s][4 * h + 2] = v.z;
        xs[s][4 * h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int j = j0 + c;
        xs[s][c] = WHOLE || !(on && j < n) ? 0.f : first ? __ldg(x0 + j) : __ldcg(x + j);
      }
    }
  }
}

// Σ over blocks of their shares at column j of gpart (row stride n4),
// chain c adding blocks c, c + kChains, … in order with up to 16 loads in
// flight at once.
__device__ __forceinline__ float chain_sum(const float* gpart, int n4, int nb, int chain, int j) {
  float s = 0.f;
  for (int p0 = chain; p0 < nb; p0 += 16 * kChains) {
    float u[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int p = p0 + kChains * k;
      u[k] = p < nb ? __ldcg(gpart + (size_t)p * n4 + j) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) s += u[k];
  }
  return s;
}

// After a grid barrier: the reduced g (nq float4s in device memory) into
// the block's shared memory, every thread's loads in flight at once.
__device__ __forceinline__ void copy_g(const float* gvec, float* dst, int nq) {
  constexpr int kMax = kStateMax / 4 / kThreads;
  const float4* src = reinterpret_cast<const float4*>(gvec);
  float4 v[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int q = threadIdx.x + kThreads * k;
    v[k] = q < nq ? __ldcg(src + q) : zero4();
  }
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int q = threadIdx.x + kThreads * k;
    if (q < nq) reinterpret_cast<float4*>(dst)[q] = v[k];
  }
}

// ---------------------------------------------------------------------------
// The pass over a block's band (band_pass), shared by K-B1's passes
// (rows_pass in microsolver.cu), K-P3 and K-P4, over rows stored as E —
// float32, or bfloat16 upcast in registers — with each row's weight given
// by the caller.  A slot is 16 bytes of a row, kVec = 4 float32 or 8
// bfloat16 values, kept raw wherever the row lies (registers, shared
// memory or L2); lanes_of, lane_of and the plan take the width 4·nq of a
// row of nq slots, which lays out the same threads and shared-memory
// bytes a row.
// ---------------------------------------------------------------------------

template <typename E>
struct Stored;

template <>
struct Stored<float> {
  static constexpr int kVec = 4;
  using Raw = float4;
  // slot q of row i of A (n columns), zero past column n
  static __device__ __forceinline__ Raw load(const float* __restrict__ A, int n, int i, int q) {
    return load_a(A, n, i, q);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[kVec]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

template <>
struct Stored<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Raw = uint4;  // value 2k in the low half of word k
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* __restrict__ A, int n, int i,
                                             int q) {
    const unsigned short* row = reinterpret_cast<const unsigned short*>(A) + (size_t)i * n;
    if ((n & 7) == 0) return __ldg(reinterpret_cast<const uint4*>(row) + q);
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 8 * q + 2 * k;
      const unsigned lo = j < n ? __ldg(row + j) : 0u, hi = j + 1 < n ? __ldg(row + j + 1) : 0u;
      w[k] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[kVec]) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_lo(u[k]);
      v[2 * k + 1] = bf16_hi(u[k]);
    }
  }
};

// Copies `count` rows of A (n columns, nq slots a row) from row i0 into
// dst, raw, and waits for the block.
template <typename E>
__device__ void stage_slots(const E* __restrict__ A, int n, int nq, int i0, int count,
                            typename Stored<E>::Raw* dst) {
  for (int e = threadIdx.x; e < count * nq; e += kThreads) {
    const int l = e / nq, q = e - l * nq;
    dst[e] = Stored<E>::load(A, n, i0 + l, q);
  }
  __syncthreads();
}

// This thread's register rows (S = 1): the first step's rows of the band,
// zero past it.
template <typename E, int S>
__device__ __forceinline__ void load_reg_rows(const E* __restrict__ A, int n, const Tile& t,
                                              const Lane& L,
                                              typename Stored<E>::Raw (&ra)[S == 1 ? 8 : 1][S]) {
#pragma unroll
  for (int u = 0; u < (S == 1 ? 8 : 1); ++u) {
    const int l = u * L.R + L.rl;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = L.gl + L.tg * s;
      ra[u][s] = (S == 1 && L.active && l < t.nreg && q < L.nq) ? Stored<E>::load(A, n, t.r0 + l, q)
                                                              : typename Stored<E>::Raw{};
    }
  }
}

// One pass over the block's band in `steps` steps at the thread's slots
// xs of x.  A step takes TB = 8 / S rows a row lane: each thread loads
// their slots once (from registers, shared memory or L2) and, with DOT,
// forms its share of each row dot; one transposed shuffle sum takes the
// step's TB dots over the warp, the warps' sums meet in rowred, and the
// step's finishing threads (one a row, l the row's place in the band) add
// them in warp order and take the row's weight w = row(l, d) (without
// DOT, row(l, 0), the caller forming the row's value itself).  With ADJ
// every thread then adds the rows' w·a at its slots from the values it
// holds, and the block's share of Aᵀw goes to `share` (nq·kVec floats),
// the row lanes meeting in aux in lane order.  sA holds the band's rows
// kept in shared memory, ra the thread's register rows.
template <typename E, int S, bool ADJ, bool DOT = true, typename RowFn>
__device__ __forceinline__ void band_pass(const E* __restrict__ A, int n, const Tile& t,
                                          const Lane& L, int steps,
                                          const typename Stored<E>::Raw* sA,
                                          const float (&xs)[S][Stored<E>::kVec],
                                          const typename Stored<E>::Raw (&ra)[S == 1 ? 8 : 1][S],
                                          float* aux, float (*rowred)[kWarps], float* lrow,
                                          float* share, RowFn&& row) {
  using T = Stored<E>;
  using Raw = typename T::Raw;
  constexpr int V = T::kVec, TB = 8 / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = L.nq;
  float gs[S][V];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < V; ++c) gs[s][c] = 0.f;
  const int per = L.R * TB;  // rows a step
  for (int b = 0; b < steps; ++b) {  // uniform per block
    Raw v[TB][S];
    if (S == 1 && b == 0 && t.nreg == min(t.rows, per)) {
#pragma unroll
      for (int u = 0; u < TB; ++u) v[u][0] = ra[S == 1 ? u : 0][0];
    } else {
#pragma unroll
      for (int u = 0; u < TB; ++u) {
        const int l = (b * TB + u) * L.R + L.rl;
        const bool on = L.active && l < t.rows;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int q = L.gl + L.tg * s;
          if (on && q < nq) {
            if (S == 1 && l < t.nreg)
              v[u][s] = ra[S == 1 ? u : 0][s];
            else if (l < t.nreg + t.nsm)
              v[u][s] = sA[(size_t)(l - t.nreg) * nq + q];
            else
              v[u][s] = T::load(A, n, t.r0 + l, q);
          } else {
            v[u][s] = Raw{};
          }
        }
      }
    }
    if (DOT) {
      // the warp's share of each row dot, the TB of them summed over the
      // warp at once: row u lands in lanes u·32/TB …
      float d[TB];
#pragma unroll
      for (int u = 0; u < TB; ++u) {
        d[u] = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float a[V];
          T::unpack(v[u][s], a);
#pragma unroll
          for (int c = 0; c < V; ++c) d[u] = fmaf(a[c], xs[s][c], d[u]);
        }
      }
      const float mine = transpose_sum<TB>(d);
      if ((lane & (32 / TB - 1)) == 0) rowred[lane / (32 / TB)][warp] = mine;
    }
    __syncthreads();  // the warps' row sums are in
    // thread k < R·TB takes row k of the step (the fu-th row of row lane
    // fr): its total in warp order and its weight; the weights reach the
    // row lanes through shared memory
    if (tid < per) {
      const int l = b * per + tid;
      float w = 0.f;
      if (l < t.rows) {
        float dv = 0.f;
        if (DOT) {
          const float* rr = rowred[L.fu] + L.fr * L.wpr;
          float dk[kWarps];
#pragma unroll
          for (int k = 0; k < kWarps; ++k) dk[k] = k < L.wpr ? rr[k] : 0.f;
#pragma unroll
          for (int k = 0; k < kWarps; ++k)
            if (k < L.wpr) dv += dk[k];
        }
        w = row(l, dv);
      }
      lrow[tid] = w;
    }
    __syncthreads();  // the step's weights are in
    if (ADJ && L.active)
#pragma unroll
      for (int u = 0; u < TB; ++u) {
        const float w = lrow[u * L.R + L.rl];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float a[V];
          T::unpack(v[u][s], a);
#pragma unroll
          for (int c = 0; c < V; ++c) gs[s][c] = fmaf(w, a[c], gs[s][c]);
        }
      }
  }
  if (!ADJ) return;
  constexpr int H = V / 4;  // float4s a slot of g
  float4* out = reinterpret_cast<float4*>(share);
  if (S == 1 && L.R > 1) {  // R > 1 only at one slot a thread
    // the row lanes' shares: lanes 1…R−1 park theirs in aux, lane 0 adds
    // them in lane order (four loads in flight) and writes the block's
    float4* aux4 = reinterpret_cast<float4*>(aux);
    const int q = L.gl;
    if (L.active && L.rl > 0 && q < nq)
#pragma unroll
      for (int h = 0; h < H; ++h)
        aux4[((size_t)(L.rl - 1) * nq + q) * H + h] =
            make_float4(gs[0][4 * h], gs[0][4 * h + 1], gs[0][4 * h + 2], gs[0][4 * h + 3]);
    __syncthreads();
    if (L.rl == 0 && q < nq) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float4 g = make_float4(gs[0][4 * h], gs[0][4 * h + 1], gs[0][4 * h + 2], gs[0][4 * h + 3]);
#pragma unroll
        for (int k0 = 1; k0 < kWarps; k0 += 4) {
          float4 o[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            o[k] = k0 + k < L.R ? aux4[((size_t)(k0 + k - 1) * nq + q) * H + h] : zero4();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k0 + k < L.R) g = add4(g, o[k]);
        }
        out[q * H + h] = g;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = L.gl + L.tg * s;
      if (L.active && q < nq)
#pragma unroll
        for (int h = 0; h < H; ++h)
          out[q * H + h] = make_float4(gs[s][4 * h], gs[s][4 * h + 1], gs[s][4 * h + 2],
                                       gs[s][4 * h + 3]);
    }
  }
}

// After a grid barrier: g = Σ over the blocks of their shares (gpart, row
// stride w floats), by chunks of 32 columns, each column by kChains
// chains in a fixed order and then the chains in order, a block taking
// chunks blk, blk + nblocks, …; each(c, j, g) runs in warp 0 of the
// block, lane l on column j = 32c + l (past the last column, j ≥ w and
// g = 0), and may shuffle over the warp.
template <typename F>
__device__ __forceinline__ void reduce_chunks(const float* gpart, int w, float (*red)[32],
                                              F&& each) {
  const int tid = threadIdx.x, lane = tid & 31, chain = tid >> 5;
  const int nb = gridDim.x;
  for (int c0 = blockIdx.x * 32; c0 < w; c0 += nb * 32) {  // uniform per block
    const int j = c0 + lane;
    red[chain][lane] = j < w ? chain_sum(gpart, w, nb, chain, j) : 0.f;
    __syncthreads();
    if (chain == 0) {
      float g = 0.f;
      for (int k = 0; k < kChains; ++k) g += red[k][lane];
      each(c0 / 32, j, g);
    }
    __syncthreads();
  }
}

// The cooperative grid of a kernel that keeps rows on the chip, on the
// current device, for the `count` instantiations `fns` that may run at
// one width: one block per SM (0 blocks if one of them cannot be
// resident), and the shared memory a block has for rows of A — the
// device's per-block opt-in (optin) less the instantiations' largest
// static shared memory (fixed) and the block's state (`state` bytes).
// Raises each instantiation's dynamic shared-memory cap to the most a
// block may take, so that no later query lowers it.  The wrappers'
// budget functions (kernels/*.py) are the same arithmetic.
inline cudaError_t rows_grid(const void* const* fns, int count, size_t state, int* nblocks,
                             int* budget, int* optin_out, int* fixed_out) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  size_t fixed = 0;
  for (int k = 0; k < count && err == cudaSuccess; ++k) {
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, fns[k]);
    fixed = attr.sharedSizeBytes > fixed ? attr.sharedSizeBytes : fixed;
  }
  const int cap = optin > (int)fixed ? optin - (int)fixed : 0;
  int per_sm = 1 << 30;
  for (int k = 0; k < count && err == cudaSuccess; ++k) {
    err = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    int per = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fns[k], kThreads, cap);
    per_sm = per < per_sm ? per : per_sm;
  }
  if (err != cudaSuccess) return err;
  const long long left = (long long)cap - (long long)state;
  *nblocks = per_sm < 1 ? 0 : sms;
  *budget = left < 0 ? 0 : (int)left;
  *optin_out = optin;
  *fixed_out = (int)fixed;
  return cudaSuccess;
}

}  // namespace fasta
