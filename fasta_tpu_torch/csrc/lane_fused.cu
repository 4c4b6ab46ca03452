// The adaptive loop's elementwise chain over the lanes, in three kernels
// over R rows (one row a lane; R = 1 is a single solve):
//  * residual: r = d − b and each row's ½‖r‖², over (R, m) float32 with b
//    shared (m,) or one row a lane (R, m); the sum in float64 (hp) or
//    float32;
//  * sums: from x, g, x₁, ∇f₁ (R, n) and each row's τ, the BB step's
//        x̂₁ = x − τg,   Δx = x₁ − x,   Δg = ∇f₁ + (x̂₁ − x)/τ
//    in registers, and each row's ‖g‖², ⟨Δx, Δg⟩ (float64 with hp, else
//    float32) and ‖Δg‖² (float32); nothing of size (R, n) is written;
//  * update: x and ∇f take x₁ and ∇f₁ in the rows whose `live` flag is
//    set, the best iterate takes x₁ in the rows whose `better` flag is
//    set, all three written in place; a row whose flag is clear is
//    neither read nor written.  (In adaptive mode the solution is x₁ at
//    every point: the loop returns x as the solution.)
//
// Replaces: no TPU kernel.  In the JAX reference XLA fuses the loop
// body's elementwise work (fasta_tpu/solver.py, the adaptive branch);
// the port ran it as one ATen operation an expression, each writing its
// intermediate to device memory (kernels/lane_fused.py).
//
// Bound on this card: bytes.  Residual reads d and b and writes r,
// 12·R·m bytes with b a row a lane; sums reads four arrays, 16·R·n; the
// update reads two and writes two or three in the live rows, at most
// 20·R·n.  A handful of operations an entry, far below the float32 rate.
//
// Design: one launch a call, nothing else on the stream: no memset, no
// scratch, no atomics.  A warp a row, eight rows a block, so a row's sums
// need no barrier: each lane adds its entries in a fixed order, then one
// shuffle tree (reduce.cuh), and lane 0 writes the row's sums.  The
// wrapper takes this route where the rows are short or many enough to
// fill the card (lane_plan); elsewhere the loop keeps the composition.
// Rows whose length is a multiple of 4 (or a single row) are read and
// written as float4, kUnroll of them in flight a lane; other rows take
// scalars.  Each product of two float32 values is exact in float64, so a
// float64 sum differs from the composition's only in its order.  The
// elementwise formulas use the _rn intrinsics, which the compiler never
// contracts into FMAs, so each entry rounds as the composition's separate
// PyTorch operations round it.
#include <cuda_runtime.h>

#include <initializer_list>

#include "reduce.cuh"

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // vectors (or scalars) in flight a lane

// A row's sum of squares or products: float64 of exact products with hp,
// else float32 of rounded ones, each as the composition forms its terms.
template <bool HP>
struct Acc;
template <>
struct Acc<true> {
  double v = 0.0;
  __device__ __forceinline__ void add(float a, float b) { v += double(a) * double(b); }
};
template <>
struct Acc<false> {
  float v = 0.f;
  __device__ __forceinline__ void add(float a, float b) { v = __fadd_rn(v, __fmul_rn(a, b)); }
};

__device__ __forceinline__ float get(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set(float4& v, int c, float s) {
  if (c == 0)
    v.x = s;
  else if (c == 1)
    v.y = s;
  else if (c == 2)
    v.z = s;
  else
    v.w = s;
}

// The row of this warp, or -1 past the last row (the whole warp then
// returns, so every shuffle sees 32 lanes).
__device__ __forceinline__ long long warp_row(int R) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  return row < R ? row : -1;
}

// ---- residual ----------------------------------------------------------

template <bool HP>
struct Residual {
  Acc<HP> acc;
  __device__ __forceinline__ float operator()(float d, float b) {
    const float r = __fsub_rn(d, b);
    acc.add(r, r);
    return r;
  }
};

template <bool VEC, bool HP>
__global__ void __launch_bounds__(kThreads)
    lane_residual_kernel(const float* __restrict__ d, const float* __restrict__ b, int b_per_row,
                         int R, int m, float* __restrict__ r, void* __restrict__ value) {
  const long long row = warp_row(R);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const size_t off = (size_t)row * m;
  const float* dr = d + off;
  const float* br = b + (b_per_row ? off : 0);
  float* rr = r + off;
  Residual<HP> f;
  int j0 = lane;
  if (VEC) {
    const int nq = m >> 2;
    const float4* d4 = reinterpret_cast<const float4*>(dr);
    const float4* b4 = reinterpret_cast<const float4*>(br);
    float4* r4 = reinterpret_cast<float4*>(rr);
    for (int base = lane; base < nq; base += kUnroll * 32) {
      float4 a[kUnroll], c[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = base + 32 * k;
        if (q < nq) {
          a[k] = __ldg(d4 + q);
          c[k] = __ldg(b4 + q);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = base + 32 * k;
        if (q < nq) {
          float4 o;
#pragma unroll
          for (int e = 0; e < 4; ++e) set(o, e, f(get(a[k], e), get(c[k], e)));
          r4[q] = o;
        }
      }
    }
    j0 = (nq << 2) + lane;
  }
  for (int j = j0; j < m; j += 32) rr[j] = f(__ldg(dr + j), __ldg(br + j));
  const auto s = fasta::warp_sum(f.acc.v);
  if (lane == 0) {
    if (HP)
      static_cast<double*>(value)[row] = 0.5 * double(s);
    else
      static_cast<float*>(value)[row] = __fmul_rn(0.5f, float(s));
  }
}

// ---- sums --------------------------------------------------------------

template <bool HP>
struct Sums {
  float tau;
  Acc<false> ng2, ndg2;
  Acc<HP> dot;
  __device__ __forceinline__ void operator()(float x, float g, float x1, float gf1) {
    const float xh = __fsub_rn(x, __fmul_rn(tau, g));
    const float dx = __fsub_rn(x1, x);
    const float dg = __fadd_rn(gf1, __fdiv_rn(__fsub_rn(xh, x), tau));
    ng2.add(g, g);
    dot.add(dx, dg);
    ndg2.add(dg, dg);
  }
};

template <bool VEC, bool HP>
__global__ void __launch_bounds__(kThreads)
    lane_sums_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ x1, const float* __restrict__ gf1,
                     const float* __restrict__ tau, int R, int n, float* __restrict__ fsums,
                     void* __restrict__ dot) {
  const long long row = warp_row(R);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const size_t off = (size_t)row * n;
  const float *xr = x + off, *gr = g + off, *x1r = x1 + off, *fr = gf1 + off;
  Sums<HP> s;
  s.tau = __ldg(tau + row);
  int j0 = lane;
  if (VEC) {
    const int nq = n >> 2;
    const float4 *x4 = reinterpret_cast<const float4*>(xr),
                 *g4 = reinterpret_cast<const float4*>(gr),
                 *y4 = reinterpret_cast<const float4*>(x1r),
                 *f4 = reinterpret_cast<const float4*>(fr);
    for (int base = lane; base < nq; base += kUnroll * 32) {
      float4 a[kUnroll], b[kUnroll], c[kUnroll], e[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = base + 32 * k;
        if (q < nq) {
          a[k] = __ldg(x4 + q);
          b[k] = __ldg(g4 + q);
          c[k] = __ldg(y4 + q);
          e[k] = __ldg(f4 + q);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (base + 32 * k < nq) {
#pragma unroll
          for (int v = 0; v < 4; ++v) s(get(a[k], v), get(b[k], v), get(c[k], v), get(e[k], v));
        }
      }
    }
    j0 = (nq << 2) + lane;
  }
  for (int j = j0; j < n; j += 32) s(__ldg(xr + j), __ldg(gr + j), __ldg(x1r + j), __ldg(fr + j));
  const float ng2 = fasta::warp_sum(s.ng2.v), ndg2 = fasta::warp_sum(s.ndg2.v);
  const auto dt = fasta::warp_sum(s.dot.v);
  if (lane == 0) {
    fsums[row] = ng2;
    fsums[(size_t)R + row] = ndg2;
    if (HP)
      static_cast<double*>(dot)[row] = double(dt);
    else
      static_cast<float*>(dot)[row] = float(dt);
  }
}

// ---- update ------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    lane_update_kernel(const float* __restrict__ x1, const float* __restrict__ gf1,
                       const unsigned char* __restrict__ live,
                       const unsigned char* __restrict__ better, int R, int n,
                       float* __restrict__ x, float* __restrict__ gradf,
                       float* __restrict__ best_x) {
  const long long row = warp_row(R);
  if (row < 0 || !live[row]) return;
  const bool bet = better[row] != 0;
  const int lane = threadIdx.x & 31;
  const size_t off = (size_t)row * n;
  int j0 = lane;
  if (VEC) {
    const int nq = n >> 2;
    const float4 *y4 = reinterpret_cast<const float4*>(x1 + off),
                 *f4 = reinterpret_cast<const float4*>(gf1 + off);
    float4 *x4 = reinterpret_cast<float4*>(x + off), *g4 = reinterpret_cast<float4*>(gradf + off),
           *b4 = reinterpret_cast<float4*>(best_x + off);
    for (int base = lane; base < nq; base += kUnroll * 32) {
      float4 a[kUnroll], c[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = base + 32 * k;
        if (q < nq) {
          a[k] = __ldcs(y4 + q);
          c[k] = __ldcs(f4 + q);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int q = base + 32 * k;
        if (q < nq) {
          x4[q] = a[k];
          g4[q] = c[k];
          if (bet) b4[q] = a[k];
        }
      }
    }
    j0 = (nq << 2) + lane;
  }
  for (int j = j0; j < n; j += 32) {
    const float a = __ldcs(x1 + off + j), c = __ldcs(gf1 + off + j);
    x[off + j] = a;
    gradf[off + j] = c;
    if (bet) best_x[off + j] = a;
  }
}

bool aligned(std::initializer_list<const void*> ps) {
  size_t bits = 0;
  for (const void* p : ps) bits |= reinterpret_cast<size_t>(p);
  return (bits & 15) == 0;
}

unsigned int blocks(int R) { return (unsigned int)(((long long)R + kWarps - 1) / kWarps); }

}  // namespace

// r (R, m) and value (R,) = ½‖d − b‖² a row, float64 when hp else
// float32, for d (R, m) and b (m,) (b_per_row 0) or (R, m), on `stream`.
extern "C" int fasta_lane_residual(const float* d, const float* b, int b_per_row, int R, int m,
                                   int hp, float* r, void* value, void* stream) {
  if (R < 1 || m < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned({d, b, r}) && (R == 1 || (m & 3) == 0);
  const unsigned int grid = blocks(R);
  if (vec && hp)
    lane_residual_kernel<true, true><<<grid, kThreads, 0, s>>>(d, b, b_per_row, R, m, r, value);
  else if (vec)
    lane_residual_kernel<true, false><<<grid, kThreads, 0, s>>>(d, b, b_per_row, R, m, r, value);
  else if (hp)
    lane_residual_kernel<false, true><<<grid, kThreads, 0, s>>>(d, b, b_per_row, R, m, r, value);
  else
    lane_residual_kernel<false, false><<<grid, kThreads, 0, s>>>(d, b, b_per_row, R, m, r, value);
  return cudaGetLastError();
}

// fsums (2, R) = (‖g‖², ‖Δg‖²) and dot (R,) = ⟨Δx, Δg⟩ (float64 when hp,
// else float32) a row, for x, g, x1, gf1 (R, n) and tau (R,), on `stream`.
extern "C" int fasta_lane_sums(const float* x, const float* g, const float* x1, const float* gf1,
                               const float* tau, int R, int n, int hp, float* fsums, void* dot,
                               void* stream) {
  if (R < 1 || n < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned({x, g, x1, gf1}) && (R == 1 || (n & 3) == 0);
  const unsigned int grid = blocks(R);
  if (vec && hp)
    lane_sums_kernel<true, true><<<grid, kThreads, 0, s>>>(x, g, x1, gf1, tau, R, n, fsums, dot);
  else if (vec)
    lane_sums_kernel<true, false><<<grid, kThreads, 0, s>>>(x, g, x1, gf1, tau, R, n, fsums, dot);
  else if (hp)
    lane_sums_kernel<false, true><<<grid, kThreads, 0, s>>>(x, g, x1, gf1, tau, R, n, fsums, dot);
  else
    lane_sums_kernel<false, false><<<grid, kThreads, 0, s>>>(x, g, x1, gf1, tau, R, n, fsums,
                                                            dot);
  return cudaGetLastError();
}

// In the rows whose live flag is set: x and gradf take x1 and gf1, and
// best_x takes x1 where the better flag is set too; x1, gf1 and the three
// outputs (R, n), the flags (R,) bytes, on `stream`.
extern "C" int fasta_lane_update(const float* x1, const float* gf1, const void* live,
                                 const void* better, int R, int n, float* x, float* gradf,
                                 float* best_x, void* stream) {
  if (R < 1 || n < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lv = static_cast<const unsigned char*>(live);
  const auto* bt = static_cast<const unsigned char*>(better);
  const bool vec = aligned({x1, gf1, x, gradf, best_x}) && (R == 1 || (n & 3) == 0);
  if (vec)
    lane_update_kernel<true><<<blocks(R), kThreads, 0, s>>>(x1, gf1, lv, bt, R, n, x, gradf,
                                                            best_x);
  else
    lane_update_kernel<false><<<blocks(R), kThreads, 0, s>>>(x1, gf1, lv, bt, R, n, x, gradf,
                                                             best_x);
  return cudaGetLastError();
}
