// K-P5: the planar matvec layout probe — K data-chained planar
// forward-plus-adjoint pairs, g = Aᴴ(A x), x ← x + 0·g, in one cooperative
// launch, for each storage layout of the two channel matrices.
//
// Replaces: benchmarks/planar_matvec_probe.py, make(variant) → run
// (pallas_call at :314) — the TPU probe that chose K-B8's transposed
// storage there, an answer to the TPU's lane/sublane relayouts, which
// this card does not have.
//
// Bound on this card: bytes per pair.  One read of both channel matrices,
// 2·m·n·4 bytes (33.6 MB at 16384×256, inside the 50 MB L2), against
// 16·m·n operations (1.0 µs at 67 TFLOP/s); the two-pass form reads them
// twice.
//
// Variants (kernels.planar_probe.VARIANTS), each with the pair structure
// of a K-B8 trial — the rows of a block, a barrier, a distributed
// reduction of the per-block gradient shares, a barrier:
//  0 split:        Ar, Ai (m, n) row-major, warp per row (planar_rows.cuh),
//                  one read;
//  1 interleaved:  (m, n, 2) (re, im) pairs, warp per row, one read;
//  2 transposed:   Arᵀ, Aiᵀ (n, m), the TPU kernel's storage: a block
//                  stages a tile of 32 rows (coalesced along m) in shared
//                  memory, then a warp per row reads it there, one read;
//  3 split, two passes: the forward over the rows, a grid barrier, then
//                  the adjoint reading the rows again.
// The final pair's g is returned; the wrapper holds it against K plain
// PlanarDenseOp pairs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "planar_rows.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;
using namespace fasta;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;
constexpr int kTilePitch = kTileRows + 1;  // conflict-free column reads

enum Variant { kSplit = 0, kInterleaved = 1, kTransposed = 2, kSplitTwoPass = 3 };

struct Args {
  const float* A0;  // split: Ar; interleaved: the pairs; transposed: Arᵀ
  const float* A1;  // split: Ai; transposed: Aiᵀ
  const float* x0;  // (n, 2)
  float* out;       // (n, 2): g of the last pair
  float* gpart;     // (nblocks, 2n)
  float* gbuf;      // (2n,) the reduced g of a pair: [gr | gi]
  float* dbuf;      // (m, 2) two-pass: the forward's rows
  int m, n, K;
};

// Dynamic shared memory: x as [xr | xi] (2n), the warps' gradient shares
// (kWarps, 2n), and for the transposed variant the staged tile, two
// channels of (n, kTilePitch).
template <int VARIANT, int CPT>
__global__ void __launch_bounds__(kThreads, 1) planar_probe_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, m = a.m;
  float* xs = smem;              // [xr | xi]
  float* gw = smem + 2 * n;      // (kWarps, 2n)
  float* tile = gw + kWarps * 2 * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int gtid = blk * kThreads + tid, gthreads = nb * kThreads;

  for (int j = tid; j < n; j += kThreads) {
    xs[j] = a.x0[2 * j];
    xs[n + j] = a.x0[2 * j + 1];
  }
  __syncthreads();

  for (int k = 0; k < a.K; ++k) {
    if (VARIANT == kTransposed) {
      // scalar columns j = lane + 32·t, t < 4·CPT
      constexpr int TC = 4 * CPT;
      float xr[TC], xi[TC], gr[TC], gi[TC];
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        xr[t] = xs[lane + 32 * t];
        xi[t] = xs[n + lane + 32 * t];
        gr[t] = gi[t] = 0.f;
      }
      float* tr = tile;
      float* ti = tile + n * kTilePitch;
      const int ntiles = (m + kTileRows - 1) / kTileRows;
      for (int tt = blk; tt < ntiles; tt += nb) {
        const int i0 = tt * kTileRows;
        for (int e = tid; e < n * kTileRows; e += kThreads) {
          const int j = e / kTileRows, r = e % kTileRows, i = i0 + r;
          tr[j * kTilePitch + r] = i < m ? __ldg(a.A0 + (size_t)j * m + i) : 0.f;
          ti[j * kTilePitch + r] = i < m ? __ldg(a.A1 + (size_t)j * m + i) : 0.f;
        }
        __syncthreads();
        for (int r = warp; r < kTileRows && i0 + r < m; r += kWarps) {
          float sr = 0.f, si = 0.f;
#pragma unroll
          for (int t = 0; t < TC; ++t) {
            const float av = tr[(lane + 32 * t) * kTilePitch + r];
            const float cv = ti[(lane + 32 * t) * kTilePitch + r];
            sr = fmaf(av, xr[t], fmaf(-cv, xi[t], sr));
            si = fmaf(av, xi[t], fmaf(cv, xr[t], si));
          }
          sr = warp_allsum(sr);
          si = warp_allsum(si);
#pragma unroll
          for (int t = 0; t < TC; ++t) {
            const float av = tr[(lane + 32 * t) * kTilePitch + r];
            const float cv = ti[(lane + 32 * t) * kTilePitch + r];
            gr[t] = fmaf(av, sr, fmaf(cv, si, gr[t]));
            gi[t] = fmaf(av, si, fmaf(-cv, sr, gi[t]));
          }
        }
        __syncthreads();  // the next tile overwrites this one
      }
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        gw[warp * 2 * n + lane + 32 * t] = gr[t];
        gw[warp * 2 * n + n + lane + 32 * t] = gi[t];
      }
    } else {
      float4 xr[CPT], xi[CPT], gr[CPT], gi[CPT];
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int q = lane + 32 * s;
        xr[s] = reinterpret_cast<const float4*>(xs)[q];
        xi[s] = reinterpret_cast<const float4*>(xs + n)[q];
        gr[s] = gi[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const int gw0 = blk * kWarps + warp, gws = nb * kWarps;
      constexpr bool kIl = VARIANT == kInterleaved;
      for (int i = gw0; i < m; i += gws) {
        float4 va[CPT], vc[CPT];
        float sr = 0.f, si = 0.f;
#pragma unroll
        for (int s = 0; s < CPT; ++s) {
          load_slot<kIl>(a.A0, a.A1, n, i, lane + 32 * s, va[s], vc[s]);
          slot_dot(va[s], vc[s], xr[s], xi[s], sr, si);
        }
        sr = warp_allsum(sr);
        si = warp_allsum(si);
        if (VARIANT == kSplitTwoPass) {
          if (lane == 0) {
            a.dbuf[2 * i] = sr;
            a.dbuf[2 * i + 1] = si;
          }
        } else {
#pragma unroll
          for (int s = 0; s < CPT; ++s) slot_grad(va[s], vc[s], sr, si, gr[s], gi[s]);
        }
      }
      if (VARIANT == kSplitTwoPass) {
        grid.sync();
        for (int i = gw0; i < m; i += gws) {
          const float dr = __ldcg(a.dbuf + 2 * i), di = __ldcg(a.dbuf + 2 * i + 1);
#pragma unroll
          for (int s = 0; s < CPT; ++s) {
            float4 va, vc;
            load_slot<false>(a.A0, a.A1, n, i, lane + 32 * s, va, vc);
            slot_grad(va, vc, dr, di, gr[s], gi[s]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int q = lane + 32 * s;
        reinterpret_cast<float4*>(gw + warp * 2 * n)[q] = gr[s];
        reinterpret_cast<float4*>(gw + warp * 2 * n + n)[q] = gi[s];
      }
    }
    __syncthreads();
    // the block's share: the warps' shares summed in warp order
    for (int j = tid; j < 2 * n; j += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += gw[w * 2 * n + j];
      a.gpart[(size_t)blk * 2 * n + j] = s;
    }
    grid.sync();
    // distributed reduction over the blocks, in block order
    for (int j = gtid; j < 2 * n; j += gthreads) {
      float s = 0.f;
      for (int p = 0; p < nb; ++p) s += __ldcg(a.gpart + (size_t)p * 2 * n + j);
      a.gbuf[j] = s;
    }
    grid.sync();
    // the chain: the next pair's x waits for this pair's g
    for (int j = tid; j < 2 * n; j += kThreads) xs[j] = xs[j] + 0.f * __ldcg(a.gbuf + j);
    __syncthreads();
  }
  if (blk == 0)
    for (int j = tid; j < n; j += kThreads) {
      a.out[2 * j] = __ldcg(a.gbuf + j);
      a.out[2 * j + 1] = __ldcg(a.gbuf + n + j);
    }
}

using ProbeKernel = void (*)(Args);

ProbeKernel pick(int variant, int cpt) {
#define FASTA_PROBE_CASES(V)                                \
  if (variant == V) {                                       \
    if (cpt == 1) return planar_probe_kernel<V, 1>;         \
    if (cpt == 2) return planar_probe_kernel<V, 2>;         \
    if (cpt == 4) return planar_probe_kernel<V, 4>;         \
  }
  FASTA_PROBE_CASES(kSplit)
  FASTA_PROBE_CASES(kInterleaved)
  FASTA_PROBE_CASES(kTransposed)
  FASTA_PROBE_CASES(kSplitTwoPass)
#undef FASTA_PROBE_CASES
  return nullptr;
}

size_t smem_bytes(int variant, int n) {
  size_t floats = 2 * (size_t)n + (size_t)kWarps * 2 * n;
  if (variant == kTransposed) floats += 2 * (size_t)n * kTilePitch;
  return floats * sizeof(float);
}

}  // namespace

// The cooperative grid for a variant at width n (128, 256 or 512) on the
// current device: one block per SM, after raising the
// kernel's dynamic shared-memory cap.
extern "C" int fasta_planar_probe_grid(int variant, int n, int* nblocks) {
  if (n < 128 || n > 512 || n % 128) return cudaErrorInvalidValue;
  const ProbeKernel fn = pick(variant, n / 128);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(variant, n);
  cudaError_t err =
      cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  *nblocks = per_sm < 1 ? 0 : sms;
  return cudaSuccess;
}

// K chained pairs of the variant on `stream`.  gpart holds nblocks·2n
// floats, gbuf 2n, dbuf 2m (two-pass only; may be null otherwise).
extern "C" int fasta_planar_probe(int variant, const float* A0, const float* A1, const float* x0,
                                  int m, int n, int K, float* out, float* gpart, float* gbuf,
                                  float* dbuf, int nblocks, void* stream) {
  if (m < 1 || K < 1 || nblocks < 1 || (variant == kSplitTwoPass && dbuf == nullptr))
    return cudaErrorInvalidValue;
  if (n < 128 || n > 512 || n % 128) return cudaErrorInvalidValue;
  const ProbeKernel fn = pick(variant, n / 128);
  if (fn == nullptr) return cudaErrorInvalidValue;
  Args args{A0, A1, x0, out, gpart, gbuf, dbuf, m, n, K};
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)fn, dim3(nblocks), dim3(kThreads),
                                                params, smem_bytes(variant, n),
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
