// K-P1's gradmap_fused form: K data-chained gradient maps over one float32
// matrix in one launch,
//     r = A x − b,  f = ½‖r‖²,  g = Aᵀr,  x ← (x + g·1e-12) + f·1e-12   (K times)
// with A (m, n), b (m,) and x₀ (n,) float32, n % 4 == 0; returns the last
// operation's x, g and f.  The other forms of the probe are in
// matvec_probe.cu.
//
// Replaces: benchmarks/matvec_kernels.py, run_variant (pallas_call at
// :158) with the gradmap_fused body (_body_factory, :93-118, chained at
// :137-141) — the TPU probe that pins A in VMEM for the whole launch and
// asks what one operation costs with A already on the chip.
//
// Bound on this card, two reckonings: the work is A read once a launch
// and 4mn float32 operations an operation, so at 1000×2048 and K = 2000
// an operation is bound by its operations (8.2 M: 0.12 µs), A's 8.19 MB
// spread over the launch; the former reckoning, one read of A an
// operation, is 2.45 µs.  What an operation costs on top is the design's:
// the pass over the rows on the chip, the grid sum of f, the reduction of
// g over the blocks and two grid barriers.
//
// Design: K-B1's rows on the chip, as K-P4 (bf16_probe.cu) takes them —
// one persistent cooperative launch, one block of 512 threads per SM, the
// wrapper's plan (dense_plan at this kernel's budget, gradmap_probe_plan
// in kernels/matvec_probe.py) giving each block a band of rows, staged
// once a launch: the first step's rows in registers (n ≤ 2048), the next
// in shared memory, the rest read from L2 once a pass; the band's b is
// staged once a launch too.  An operation:
//   1. each thread loads x at its slots (x₀ for the first operation, then
//      the last operation's x, which other blocks wrote: read past L1),
//      and warp 0 of a block that owns columns x at its first chunk's;
//   2. one pass over the band (band_pass with the adjoint): d_i = a_i·x,
//      the row's weight r_i = d_i − b_i, r_i² into the block's f sum, and
//      the block's share of Aᵀr from the values the threads hold — one
//      read of the band; the block's f sum to its slot of fpart;
//   3. grid barrier 1;
//   4. g = Σ of the blocks' shares by chunks of 32 columns (reduce_chunks,
//      a fixed order); the last warp of every block that owns columns
//      first sums the blocks' f partials in one fixed order
//      (warp_sum_blocks), so every block holds the same f before its
//      first chunk's update; at each column j < n the owner writes
//      x_j = (x_j + g_j·1e-12) + f·1e-12 (_rn rounding, as the plain
//      version rounds); the last operation also writes g and f;
//   5. grid barrier 2.
// Why two barriers and one x: between barrier 1 and barrier 2 no block
// reads x but each column's owner, which reads x_j and then writes it, so
// one buffer is enough; f is whole before any x_j moves (barrier 1); the
// second barrier stays because the next pass needs the whole new x.  The
// blocks' shares (gpart), the f partials and the barrier's counter and
// exit ticket live in the wrapper's stream scratch; nothing but x, g and
// f is written, so a call is one device operation.  Every sum runs in a
// fixed order and no atomics touch values: two runs, and a plan that
// streams rows where another keeps them, give the same bits.
//
// From dense_rows.cuh, as K-P4 takes them: Lane / lane_of, Tile /
// tile_of, load_reg_rows, stage_slots, load_x_slots, band_pass,
// reduce_chunks and the grid query rows_grid; besides, stage_b,
// block_total and warp_sum_blocks for b and f.  The barrier is
// grid_barrier.cuh's.
#include <cuda_runtime.h>

#include "dense_rows.cuh"
#include "grid_barrier.cuh"

using namespace fasta;

namespace {

struct Args {
  const float* A;    // (m, n) row-major, 16-byte aligned, n % 4 == 0
  const float* x0;   // (n,) 16-byte aligned
  const float* b;    // (m,)
  int n, K;
  float* x;          // (n,) 16-byte aligned: the running x, at the end the last operation's
  float* g;          // (n,) the last operation's g
  float* f;          // () the last operation's f
  const int* tiles;  // (4, nblocks): first row, end row, rows in registers, in shared memory
  unsigned* bar;     // grid_barrier's counter and grid_exit's ticket, zero at launch
  double* fpart;     // (nblocks,) the blocks' sums of r²
  float* gpart;      // (nblocks, n) the blocks' shares of Aᵀr, 16-byte aligned
};

template <int S>
__global__ void __launch_bounds__(kThreads, 1) gradmap_probe_kernel(Args a) {
  constexpr int TB = 8 / S;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kChains][32];
  __shared__ float rowred[8][kWarps];
  __shared__ float lrow[kStepMax];
  __shared__ float bsh[kBandMax];
  __shared__ float fscr[kWarps];
  __shared__ float fsh;

  const int nb = gridDim.x, blk = blockIdx.x;
  const int n = a.n, nq = n / 4;
  const Lane ln = lane_of(n);
  // the R − 1 other row lanes' shares, then the band's rows
  float* aux = smem;
  float4* sA = reinterpret_cast<float4*>(smem + (size_t)(ln.R - 1) * n);
  const Tile tile = tile_of(a.tiles, nb, blk);
  const int steps = (tile.rows + ln.R * TB - 1) / (ln.R * TB);
  float* share = a.gpart + (size_t)blk * n;
  // f is needed where a block owns columns (reduce_chunks' first chunk)
  const bool owns = blk * 32 < n;
  unsigned gen = 0;

  const float* bb = stage_b(a.b, tile, bsh);
  float4 ra[S == 1 ? 8 : 1][S];
  load_reg_rows<float, S>(a.A, n, tile, ln, ra);
  stage_slots<float>(a.A, n, nq, tile.r0 + tile.nreg, tile.nsm, sA);  // and bsh

  for (int k = 0; k < a.K; ++k) {
    const bool last = k + 1 == a.K;
    const float* xk = k == 0 ? a.x0 : a.x;
    float xs[S][4];
    load_x_slots<4, S, true>(a.x0, a.x, k == 0, n, nq, ln, xs);
    // the owner's x at its first chunk's columns, loaded beside the pass's
    // so that the update after the chain sums waits on no load
    const int jo = blk * 32 + (threadIdx.x & 31);
    float xo = 0.f;
    if (owns && threadIdx.x < 32 && jo < n) xo = k == 0 ? __ldg(xk + jo) : __ldcg(xk + jo);
    float fsum = 0.f;
    band_pass<float, S, true>(a.A, n, tile, ln, steps, sA, xs, ra, aux, rowred, lrow, share,
                              [&](int l, float d) {
                                const float r = __fsub_rn(d, bb[l]);
                                fsum = fmaf(r, r, fsum);
                                return r;
                              });
    const float fb = block_total(fsum, fscr);
    if (threadIdx.x == 0) a.fpart[blk] = fb;
    grid_barrier(a.bar, nb, gen);
    // the last warp sums the f partials while the others start their
    // chains; reduce_chunks' first block barrier publishes fsh to warp 0
    if (owns && (threadIdx.x >> 5) == kWarps - 1) {
      const float t = warp_sum_blocks<float>(a.fpart, nb);
      if ((threadIdx.x & 31) == 0) fsh = __fmul_rn(0.5f, t);
    }
    reduce_chunks(a.gpart, n, red, [&](int c, int j, float g) {
      const float f = fsh;
      if (j < n) {
        const float xj = c == blk ? xo : k == 0 ? __ldg(xk + j) : __ldcg(xk + j);
        a.x[j] = __fadd_rn(__fadd_rn(xj, __fmul_rn(g, 1e-12f)), __fmul_rn(f, 1e-12f));
        if (last) a.g[j] = g;
      }
      if (last && j == 0) *a.f = f;
    });
    grid_barrier(a.bar, nb, gen);
  }
  grid_exit(a.bar, nb);
}

const void* pick(int n) {
  const int S = slots_of(n);
  return S == 1 ? (const void*)gradmap_probe_kernel<1>
                : S == 2 ? (const void*)gradmap_probe_kernel<2>
                         : (const void*)gradmap_probe_kernel<4>;
}

bool takes(int n) { return n >= 4 && n % 4 == 0 && n <= kStateMax; }

// the shared memory of a block besides its rows of A, in bytes: the R − 1
// other row lanes' shares of g
size_t state_bytes(int n) { return (size_t)(lanes_of(n).R - 1) * n * sizeof(float); }

// doubles of the stream scratch before the blocks' shares: the barrier's
// words alone in the first 128 bytes, then the f partials, padded so that
// the shares start 16-byte aligned
int head_doubles(int nblocks) { return 16 + (nblocks + 1) / 2 * 2; }

}  // namespace

// The cooperative grid for n columns (n % 4 == 0, up to 8192) on the
// current device — one block per SM, 0 if a block cannot be resident —
// and the shared memory a block has for rows of A: the device's per-block
// opt-in less the kernel's static shared memory (fixed) and the block's
// state (kernels/matvec_probe.py, gradmap_probe_budget, is the same
// arithmetic).  Raises the kernel's dynamic shared-memory cap to the most
// a block may take, so that no later query lowers it.
extern "C" int fasta_gradmap_probe_grid(int n, int* nblocks, int* budget, int* optin_out,
                                        int* fixed_out) {
  if (!takes(n)) return cudaErrorInvalidValue;
  const void* fn = pick(n);
  return rows_grid(&fn, 1, state_bytes(n), nblocks, budget, optin_out, fixed_out);
}

// The doubles of the stream scratch a launch over nblocks needs: the
// barrier's words, the f partials, then the blocks' shares of g.
extern "C" int fasta_gradmap_probe_work(int n, int nblocks, int* ndoubles) {
  if (!takes(n) || nblocks < 1) return cudaErrorInvalidValue;
  *ndoubles = head_doubles(nblocks) + nblocks * n / 2;
  return cudaSuccess;
}

// Run K operations on `stream`: A (m, n), b (m,), x0 (n,) float32, A and
// x0 16-byte aligned; x and g (n,) and f (1,) the outputs, x 16-byte
// aligned; tiles the plan's (4, nblocks) table on the device and
// smem_rows the most rows a block keeps in shared memory; work the stream
// scratch (fasta_gradmap_probe_work doubles), its first two words zero,
// which the launch leaves zero.  The grid and shared memory must be what
// fasta_gradmap_probe_grid set up, or the launch is refused.
extern "C" int fasta_gradmap_probe(const float* A, const float* x0, const float* b, int m, int n,
                                   int K, float* x, float* g, float* f, const int* tiles,
                                   int smem_rows, void* work, int nblocks, void* stream) {
  if (!takes(n) || m < 1 || K < 1 || nblocks < 1 || tiles == nullptr || work == nullptr ||
      smem_rows < 0)
    return cudaErrorInvalidValue;
  double* scratch = static_cast<double*>(work);
  Args args{};
  args.A = A;
  args.x0 = x0;
  args.b = b;
  args.n = n;
  args.K = K;
  args.x = x;
  args.g = g;
  args.f = f;
  args.tiles = tiles;
  args.bar = reinterpret_cast<unsigned*>(scratch);
  args.fpart = scratch + 16;
  args.gpart = reinterpret_cast<float*>(scratch + head_doubles(nblocks));
  const size_t smem = state_bytes(n) + (size_t)smem_rows * n * sizeof(float);
  void* params[] = {&args};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(pick(n), dim3(nblocks), dim3(kThreads), params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}
