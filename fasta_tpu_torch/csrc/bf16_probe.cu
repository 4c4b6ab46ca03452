// K-P4: K data-chained forward and adjoint passes over one matrix in one
// launch,
//     d = A x,   g = Aᵀ d,   x = x₀ + 0·g        (K times)
// with A (m, n) stored as float32 or bfloat16 (upcast to float32 in
// registers) and x₀ (n,) float32; returns the last pair's x and g.
//
// Replaces: benchmarks/bf16_matvec_probe.py, make(dtype) → run (pallas_call
// at :53) — the TPU probe that asks whether storing the resident matrix
// of the whole-solve kernel in bfloat16 pays.  The update x = x₀ + 0·g
// keeps every pair dependent on the one before without changing x.
//
// Bound on this card: the work is A read once a launch (m·n·2 or 4 bytes),
// x₀ read and x, g written once, and 4mn float32 operations a pair, so at
// the probe's 1000×2000 a pair is bound by its operations (8 M: 0.12 µs),
// the bytes a launch spread over its pairs.  What a pair costs on top is
// the design's: the pass over the rows on the chip, two grid barriers and
// the reduction of g over the blocks.
//
// Design: K-B1's rows on the chip (dense_rows.cuh) — one persistent
// cooperative launch, one block of 512 threads per SM, the wrapper's plan
// (dense_plan at the probe's budget, kernels/bf16_probe.py) giving each
// block a band of rows, staged once a launch: the first step's rows in
// registers (rows of up to 512 slots of 16 bytes: n ≤ 2048 in float32,
// 4096 in bfloat16), the next in shared memory, the rest read from L2 once
// a pass.  bfloat16 rows stay bfloat16 there (8 values a 16-byte slot, so
// twice the rows of float32 fit) and are upcast in registers; a ragged row
// is padded with zeros as it is loaded.  A pair:
//   1. each thread loads x at its slots (x₀ for the first pair);
//   2. one pass over the band: d_i = a_i·x row by row, and the row's share
//      of Aᵀd from the values the threads hold — one read of the band;
//   3. a grid barrier;
//   4. g = Σ of the blocks' shares by chunks of 32 columns (chain_sum, a
//      fixed order), and x = x₀ + 0·g at the chunk's columns;
//   5. a grid barrier.
// Grid barriers: 2 a pair, grid_barrier.cuh's, the counter and exit ticket
// in the wrapper's stream scratch with the blocks' shares; nothing but x
// and g is written, so a call is one device operation.  No atomics on
// values: the same result on every run, whatever the plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_rows.cuh"
#include "grid_barrier.cuh"

using namespace fasta;

namespace {

struct Args {
  const void* A;     // (m, n) float32 or bfloat16, row-major
  const float* x0;   // (n,) 16-byte aligned
  int m, n, nq, K;   // nq slots of 16 bytes a row
  float* x;          // (n,) 16-byte aligned
  float* g;          // (n,)
  const int* tiles;  // (4, nblocks): first row, end row, rows in registers, in shared memory
  unsigned* bar;     // grid_barrier's counter and grid_exit's ticket, zero at launch
  float* gpart;      // (nblocks, nq·kVec) the blocks' shares of Aᵀd
};

template <typename E, int S>
__global__ void __launch_bounds__(kThreads, 1) bf16_probe_kernel(Args a) {
  using T = Stored<E>;
  using Raw = typename T::Raw;
  constexpr int V = T::kVec, TB = 8 / S;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kChains][32];
  __shared__ float rowred[8][kWarps];
  __shared__ float lrow[kStepMax];

  const int nb = gridDim.x, blk = blockIdx.x;
  const int n = a.n, nq = a.nq, w = nq * V;
  const E* A = static_cast<const E*>(a.A);
  const Lane ln = lane_of(4 * nq);
  // the R − 1 other row lanes' shares, then the band's rows
  float* aux = smem;
  Raw* sA = reinterpret_cast<Raw*>(smem + (size_t)(ln.R - 1) * w);
  const Tile tile = tile_of(a.tiles, nb, blk);
  const int steps = (tile.rows + ln.R * TB - 1) / (ln.R * TB);
  float* share = a.gpart + (size_t)blk * w;
  unsigned gen = 0;

  Raw ra[S == 1 ? 8 : 1][S];
  load_reg_rows<E, S>(A, n, tile, ln, ra);
  stage_slots<E>(A, n, nq, tile.r0 + tile.nreg, tile.nsm, sA);

  for (int k = 0; k < a.K; ++k) {
    // x at the thread's slots: x₀ for the first pair, then the last
    // pair's x, which other blocks wrote
    float xs[S][V];
    load_x_slots<V, S>(a.x0, a.x, k == 0, n, nq, ln, xs);
    band_pass<E, S, true>(A, n, tile, ln, steps, sA, xs, ra, aux, rowred, lrow, share,
                          [](int, float d) { return d; });
    grid_barrier(a.bar, nb, gen);
    reduce_chunks(a.gpart, w, red, [&](int, int j, float g) {
      if (j < n) {
        a.g[j] = g;
        a.x[j] = __fadd_rn(__ldg(a.x0 + j), __fmul_rn(0.f, g));
      }
    });
    grid_barrier(a.bar, nb, gen);
  }
  grid_exit(a.bar, nb);
}

// the instantiation for A's storage and nq slots a row
const void* pick(int bf16, int nq) {
  const int S = slots_of(4 * nq);
  if (bf16)  // at most 1024 slots a row: S ≤ 2
    return S == 1 ? (const void*)bf16_probe_kernel<__nv_bfloat16, 1>
                  : (const void*)bf16_probe_kernel<__nv_bfloat16, 2>;
  return S == 1 ? (const void*)bf16_probe_kernel<float, 1>
                : S == 2 ? (const void*)bf16_probe_kernel<float, 2>
                         : (const void*)bf16_probe_kernel<float, 4>;
}

int vec_of(int bf16) { return bf16 ? 8 : 4; }

// nq slots a row of n columns; 0 past the widest state (8192 columns)
int slots_for(int bf16, int n) {
  const int nq = (n + vec_of(bf16) - 1) / vec_of(bf16);
  return n < 1 || nq * vec_of(bf16) > kStateMax ? 0 : nq;
}

// the shared memory of a block besides its rows of A, in bytes: the R − 1
// other row lanes' shares of g
size_t state_bytes(int bf16, int nq) {
  return (size_t)(lanes_of(4 * nq).R - 1) * nq * vec_of(bf16) * sizeof(float);
}

}  // namespace

// The cooperative grid for A float32 (bf16 = 0) or bfloat16 (bf16 = 1)
// with n columns (up to 8192) on the current device — one block per SM, 0
// if a block cannot be resident — and the shared memory a block has for
// rows of A: the device's per-block opt-in less the kernel's static
// shared memory (fixed) and the block's state (kernels/bf16_probe.py,
// bf16_probe_budget, is the same arithmetic).  Raises the kernel's
// dynamic shared-memory cap to what it may take.
extern "C" int fasta_bf16_probe_grid(int bf16, int n, int* nblocks, int* budget, int* optin_out,
                                     int* fixed_out) {
  const int nq = slots_for(bf16, n);
  if (nq < 1) return cudaErrorInvalidValue;
  const void* fn = pick(bf16, nq);
  return rows_grid(&fn, 1, state_bytes(bf16, nq), nblocks, budget, optin_out, fixed_out);
}

// The doubles of the stream scratch a launch over nblocks needs: the
// barrier's words alone in the first 128 bytes, then the blocks' shares.
extern "C" int fasta_bf16_probe_work(int bf16, int n, int nblocks, int* ndoubles) {
  const int nq = slots_for(bf16, n);
  if (nq < 1 || nblocks < 1) return cudaErrorInvalidValue;
  *ndoubles = 16 + nblocks * nq * vec_of(bf16) / 2;
  return cudaSuccess;
}

// Run K pairs on `stream`: A (m, n) float32 or bfloat16 (bf16 = 1), x0, x
// and g (n,) float32, x0 and x 16-byte aligned (A too where its rows are
// whole 16-byte slots); tiles the plan's (4, nblocks) table on the device
// and smem_rows the most rows a block keeps in shared memory; work the
// stream scratch (fasta_bf16_probe_work doubles), its first two words
// zero, which the launch leaves zero.  The grid and shared memory must be
// what fasta_bf16_probe_grid set up, or the launch is refused.
extern "C" int fasta_bf16_probe(const void* A, const float* x0, int m, int n, int bf16, int K,
                                float* x, float* g, const int* tiles, int smem_rows, void* work,
                                int nblocks, void* stream) {
  const int nq = slots_for(bf16, n);
  if (nq < 1 || m < 1 || K < 1 || nblocks < 1 || tiles == nullptr || work == nullptr ||
      smem_rows < 0)
    return cudaErrorInvalidValue;
  Args args{};
  args.A = A;
  args.x0 = x0;
  args.m = m;
  args.n = n;
  args.nq = nq;
  args.K = K;
  args.x = x;
  args.g = g;
  args.tiles = tiles;
  args.bar = static_cast<unsigned*>(work);
  args.gpart = reinterpret_cast<float*>(static_cast<double*>(work) + 16);
  const size_t smem = state_bytes(bf16, nq) + (size_t)smem_rows * nq * 16;
  void* params[] = {&args};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(pick(bf16, nq), dim3(nblocks), dim3(kThreads), params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next call
    return err;
  }
  return cudaGetLastError();
}
