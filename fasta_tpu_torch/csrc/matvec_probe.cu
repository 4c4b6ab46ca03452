// K-P1 and K-P2: the GEMV formulation probe over a matrix resident in L2.
//
// K-P1 runs K data-chained operations over one float32 matrix A (m, n) in
// one launch, with a grid barrier after each; the chaining rules are the
// TPU probe's, so every operation depends on the one before:
//     fwd_*      d = A x,           x ← x + d₀·1e-9
//     fwd_strip* s = Σᵢ (A x)ᵢ,     x ← x + s·1e-9
//     gradmap    r = A x − b, f = ½‖r‖², g = Aᵀr,  x ← (x + g·1e-12) + f·1e-12
//     adj_*      g = Aᵀ(x₀·1),      x ← x + g·1e-9     (x₀: x's first entry)
// It returns x and the last operation's result (d, s, (f, g) or g).  K-P2
// is the gradmap operation once (K = 1): f and g of one pass over A.
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
// threads.  Each TPU formulation maps to this card's counterpart:
//  * fwd_vpu: a warp per row, 16-byte loads of A, x staged in every
//    block's shared memory (K-B1's phase 2).  The forward variants keep x
//    in every block's shared memory and update it there from d₀ (or s),
//    read after the barrier: one barrier an operation.
//  * fwd_mxu / adj_mxu: tensor cores at float32 accuracy, the counterpart
//    of Precision.HIGHEST: mma.sync.m16n8k8 TF32 through inline PTX with
//    the 3×TF32 split (lo·hi + hi·lo + hi·hi, cvt.rna.tf32.f32); the vector
//    is column 0 of the 8-wide operand, the other seven are zero.  A block
//    takes a tile of 16 rows (forward) or 16 columns (adjoint) and its
//    warps split the reduction dimension in steps of 8; their sums meet
//    in shared memory in warp order.  32-bit types have no ldmatrix
//    transpose, so fragments are loaded as scalars.
//  * fwd_strip: a warp per strip of 8 rows, a register accumulator per row,
//    only Σd kept; fwd_strip_auto: a thread per row and a plain loop left
//    to the compiler.  Strip sums meet as block partials, summed by every
//    block in block order.
//  * gradmap (K-P2's pass): a warp per row computes rᵢ = aᵢᵀx − bᵢ and at
//    once adds rᵢ·aᵢ into its warp's share of g in shared memory (the row
//    is read from L2 once; its second touch hits L1); the warps' shares
//    make a per-block partial of g, and after a grid barrier each column's
//    owner sums the block partials in block order — no atomics.  A second
//    barrier publishes the new x.
//  * adj_vpu: tiles of 16 columns; threads are (row lane, column group)
//    pairs, the row lanes' sums added by a fixed pairwise tree (as K-P4's
//    adjoint).  The adjoint variants keep x in device memory, double-
//    buffered by operation parity, each column updated by its owner.
//  * No atomics anywhere: the same result on every run.  Values other
//    blocks wrote are read past L1 (__ldcg).  Elementwise updates use the
//    _rn intrinsics, so they round as the plain PyTorch version does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 16;
constexpr int kRowLanes = kThreads / (kTileCols / 4);

// in the order of kernels.matvec_probe.VARIANTS
enum Variant { kFwdVpu, kFwdMxu, kFwdStrip, kFwdStripAuto, kGradmap, kAdjVpu, kAdjMxu, kCount };

struct Args {
  const float* A;  // (m, n), rows 16-byte aligned
  const float* x0;
  const float* b;
  int m, n, K;
  float* x_out;   // (n,)
  float* dbuf;    // (2, m): the forward's d by operation parity
  float* xbuf;    // (2, n): gradmap and adjoint: x by operation parity
  float* gout;    // (n,): the last operation's g
  float* gpart;   // (nblocks, n): gradmap's per-block partial g
  double* fpart;  // (2, nblocks): strip sums or f partials by parity
  float* scal;    // (1,): the last strip sum or f
};

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

// Σ over the blocks' partials P (nb,) in block order, by warp 0; the value
// in every thread after the call
__device__ __forceinline__ float grid_total(const double* P, int nb, float* slot) {
  if (threadIdx.x < 32) {
    const float v = fasta::warp_sum_global<float>(P, nb);
    if (threadIdx.x == 0) *slot = v;
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
  constexpr bool STAGED = V <= kGradmap;  // x staged in shared memory
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gthreads = nb * kThreads;
  const int gwarp = blk * kWarps + warp, gwarps = nb * kWarps;
  const int m = a.m, n = a.n, n4 = n >> 2;
  const int g8 = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  float* xs = dyn;                          // (n,)
  float* gw = dyn + n;                      // gradmap: (kWarps, n)
  const float4* xs4 = reinterpret_cast<const float4*>(xs);

  if (STAGED && V != kGradmap) {
    for (int j = tid; j < n; j += kThreads) xs[j] = __ldg(a.x0 + j);
    __syncthreads();
  }
  for (int k = 0; k < a.K; ++k) {
    const int par = k & 1;
    const bool last = k + 1 == a.K;
    const float* xk = k == 0 ? a.x0 : a.xbuf + (size_t)par * n;  // gradmap, adjoints
    float* xn = a.xbuf + (size_t)(par ^ 1) * n;

    if (V == kFwdVpu || V == kFwdMxu) {
      float* d = a.dbuf + (size_t)par * m;
      if (V == kFwdVpu) {
        for (int i = gwarp; i < m; i += gwarps) {
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
          s = fasta::warp_sum(s);
          if (lane == 0) d[i] = s;
        }
      } else {
        const int ntiles = (m + 15) / 16, nks = (n + 7) / 8;
        for (int t = blk; t < ntiles; t += nb) {
          const int r0 = t * 16 + g8, r1 = r0 + 8;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          for (int ks = warp; ks < nks; ks += kWarps) {
            const int k0 = ks * 8 + tq, k1 = k0 + 4;
            const float av[4] = {ld_a(a, r0, k0), ld_a(a, r1, k0), ld_a(a, r0, k1),
                                 ld_a(a, r1, k1)};
            const float bv[2] = {(g8 == 0 && k0 < n) ? xs[k0] : 0.f,
                                 (g8 == 0 && k1 < n) ? xs[k1] : 0.f};
            mma3(c, av, bv);
          }
          if (tq == 0) {
            red[warp][g8] = c[0];
            red[warp][g8 + 8] = c[2];
          }
          __syncthreads();
          if (tid < 16) {
            float s = 0.f;
            for (int w = 0; w < kWarps; ++w) s += red[w][tid];
            if (t * 16 + tid < m) d[t * 16 + tid] = s;
          }
          __syncthreads();
        }
      }
      grid.sync();
      const float step = __fmul_rn(__ldcg(d), 1e-9f);
      for (int j = tid; j < n; j += kThreads) xs[j] = __fadd_rn(xs[j], step);
      __syncthreads();
    } else if (V == kFwdStrip || V == kFwdStripAuto) {
      float part = 0.f;
      if (V == kFwdStrip) {
        for (int i0 = gwarp * 8; i0 < m; i0 += gwarps * 8) {
          float acc[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r] = 0.f;
          for (int q = lane; q < n4; q += 32) {
            const float4 w = xs4[q];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (i0 + r < m) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(a.A + (size_t)(i0 + r) * n) + q);
                acc[r] = fmaf(v.x, w.x, acc[r]);
                acc[r] = fmaf(v.y, w.y, acc[r]);
                acc[r] = fmaf(v.z, w.z, acc[r]);
                acc[r] = fmaf(v.w, w.w, acc[r]);
              }
            }
          }
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) s += acc[r];
          s = fasta::warp_sum(s);
          if (lane == 0) part += s;
        }
      } else {
        for (int i = gtid; i < m; i += gthreads) {
          const float* row = a.A + (size_t)i * n;
          float s = 0.f;
          for (int j = 0; j < n; ++j) s = fmaf(__ldg(row + j), xs[j], s);
          part += s;
        }
      }
      part = fasta::block_sum(part, fscr);
      if (tid == 0) a.fpart[par * nb + blk] = part;
      grid.sync();
      const float s = grid_total(a.fpart + par * nb, nb, &bcast);
      const float step = __fmul_rn(s, 1e-9f);
      for (int j = tid; j < n; j += kThreads) xs[j] = __fadd_rn(xs[j], step);
      if (last && gtid == 0) a.scal[0] = s;
      __syncthreads();
    } else if (V == kGradmap) {
      // ---- phase A: r = A x − b, each warp's share of g = Σ rᵢ aᵢ, f
      for (int j = tid; j < n; j += kThreads) xs[j] = __ldcg(xk + j);
      for (int e = tid; e < kWarps * n; e += kThreads) gw[e] = 0.f;
      __syncthreads();
      float4* gw4 = reinterpret_cast<float4*>(gw + (size_t)warp * n);
      float fp = 0.f;
      for (int i = gwarp; i < m; i += gwarps) {
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
      grid.sync();
      // ---- phase B: g by columns from the block partials, f, the new x
      const float f = __fmul_rn(0.5f, grid_total(a.fpart, nb, &bcast));
      const float fstep = __fmul_rn(f, 1e-12f);
      for (int j = gtid; j < n; j += gthreads) {
        float g = 0.f;
        for (int p = 0; p < nb; ++p) g += __ldcg(a.gpart + (size_t)p * n + j);
        const float x1 = __fadd_rn(__fadd_rn(__ldcg(xk + j), __fmul_rn(g, 1e-12f)), fstep);
        xn[j] = x1;
        if (last) {
          a.gout[j] = g;
          a.x_out[j] = x1;
        }
      }
      if (last && gtid == 0) a.scal[0] = f;
      grid.sync();
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
      grid.sync();
    }
  }
  if (STAGED && V != kGradmap && blk == 0)
    for (int j = tid; j < n; j += kThreads) a.x_out[j] = xs[j];
}

const void* pick(int v) {
  switch (v) {
    case kFwdVpu: return (const void*)matvec_probe_kernel<kFwdVpu>;
    case kFwdMxu: return (const void*)matvec_probe_kernel<kFwdMxu>;
    case kFwdStrip: return (const void*)matvec_probe_kernel<kFwdStrip>;
    case kFwdStripAuto: return (const void*)matvec_probe_kernel<kFwdStripAuto>;
    case kGradmap: return (const void*)matvec_probe_kernel<kGradmap>;
    case kAdjVpu: return (const void*)matvec_probe_kernel<kAdjVpu>;
    default: return (const void*)matvec_probe_kernel<kAdjMxu>;
  }
}

// dynamic shared memory: x for the staged variants, and gradmap's warp
// shares of g
size_t smem_bytes(int v, int n) {
  if (v == kGradmap) return (size_t)(kWarps + 1) * n * sizeof(float);
  return v < kGradmap ? (size_t)n * sizeof(float) : 0;
}

}  // namespace

// The cooperative grid of `variant` for n columns on the current device,
// after raising its dynamic shared-memory cap: one block per SM (0 if a
// block cannot be resident: gradmap takes n up to about 3400 columns, the
// forward variants about 58000).
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
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  *nblocks = per_sm < 1 ? 0 : sms;
  return cudaSuccess;
}

// Run K operations of `variant` on `stream`.  dbuf holds 2m floats, xbuf
// 2n, gout n, gpart nblocks·n (gradmap only, else may be null), fpart
// 2·nblocks doubles, scal 1 float.  n % 4 == 0 and A, x0 16-byte aligned.
extern "C" int fasta_matvec_probe(int variant, const float* A, const float* x0, const float* b,
                                  int m, int n, int K, float* x_out, float* dbuf, float* xbuf,
                                  float* gout, float* gpart, double* fpart, float* scal,
                                  int nblocks, void* stream) {
  if (variant < 0 || variant >= kCount || m < 1 || n < 4 || n % 4 || K < 1 || nblocks < 1)
    return cudaErrorInvalidValue;
  Args args{A, x0, b, m, n, K, x_out, dbuf, xbuf, gout, gpart, fpart, scal};
  void* params[] = {&args};
  const void* fn = pick(variant);
  const size_t smem = smem_bytes(variant, n);
  // the cap is the kernel's, not the launch's: a grid query for another n
  // may have lowered it since
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}
