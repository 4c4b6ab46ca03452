// The row work of a planar-complex matrix held in device memory, shared by
// K-P5 (planar_probe.cu, which times the layouts) and K-B8
// (microsolver_planar.cu, which runs the chosen one), with the PhaseMax
// hinge that K-B7 (planar_fused.cu) and K-B8 apply to a row.  A warp owns
// a row, lane l owns the float4 column slots q = l + 32·s, s < CPT
// (columns 4q … 4q+3), and the row's values it loads serve both the row
// dot and the adjoint's gradient share, so each matrix entry is read once
// per pass.
//
// Layouts with this ownership:
//  * split: Ar and Ai (m, n) row-major, the public PlanarDenseOp layout —
//    two 16-byte loads per slot;
//  * interleaved: one (m, n, 2) array of (re, im) pairs — two 16-byte
//    loads per slot, both channels in each.
// (The transposed (n, m) layout of the TPU kernel has no such ownership;
// K-P5 times it with a tile staged through shared memory.)
#pragma once

#include <cuda_runtime.h>

#include "losses.cuh"

namespace fasta {

// The PhaseMax hinge at a row value (dr, di) with magnitude bi: the
// gradient weight (lr, li) = r/max(|d|, 1e-30)·d and r = max(|d| − bi, 0),
// whose square is the row's f term; rounded like the plain version's
// separate steps.
__device__ __forceinline__ void phase_hinge(float dr, float di, float bi, float& lr, float& li,
                                            float& r) {
  const float mag = sqrtf(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)));
  r = nanmax(__fsub_rn(mag, bi), 0.f);
  const float s = __fdiv_rn(r, nanmax(mag, 1e-30f));
  lr = __fmul_rn(s, dr);
  li = __fmul_rn(s, di);
}

// xor butterfly over a warp: every lane ends with the same sum
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the slot q of row i (n columns) as the real and imaginary channels
template <bool INTERLEAVED>
__device__ __forceinline__ void load_slot(const float* __restrict__ A0,
                                          const float* __restrict__ A1, int n, int i, int q,
                                          float4& a, float4& c) {
  if (INTERLEAVED) {
    const float4* row = reinterpret_cast<const float4*>(A0 + (size_t)i * 2 * n);
    const float4 p0 = __ldg(row + 2 * q), p1 = __ldg(row + 2 * q + 1);
    a = make_float4(p0.x, p0.z, p1.x, p1.z);
    c = make_float4(p0.y, p0.w, p1.y, p1.w);
  } else {
    a = __ldg(reinterpret_cast<const float4*>(A0 + (size_t)i * n) + q);
    c = __ldg(reinterpret_cast<const float4*>(A1 + (size_t)i * n) + q);
  }
}

// (sr, si) += the slot's share of the row dot with x = (xr, xi)
__device__ __forceinline__ void slot_dot(float4 a, float4 c, float4 xr, float4 xi, float& sr,
                                         float& si) {
  sr = fmaf(a.x, xr.x, fmaf(-c.x, xi.x, sr));
  si = fmaf(a.x, xi.x, fmaf(c.x, xr.x, si));
  sr = fmaf(a.y, xr.y, fmaf(-c.y, xi.y, sr));
  si = fmaf(a.y, xi.y, fmaf(c.y, xr.y, si));
  sr = fmaf(a.z, xr.z, fmaf(-c.z, xi.z, sr));
  si = fmaf(a.z, xi.z, fmaf(c.z, xr.z, si));
  sr = fmaf(a.w, xr.w, fmaf(-c.w, xi.w, sr));
  si = fmaf(a.w, xi.w, fmaf(c.w, xr.w, si));
}

// (gr, gi) += the slot's share of the adjoint for the row's weight (lr, li):
// gr += ar·lr + ai·li,  gi += ar·li − ai·lr
__device__ __forceinline__ void slot_grad(float4 a, float4 c, float lr, float li, float4& gr,
                                          float4& gi) {
  gr.x = fmaf(a.x, lr, fmaf(c.x, li, gr.x));
  gi.x = fmaf(a.x, li, fmaf(-c.x, lr, gi.x));
  gr.y = fmaf(a.y, lr, fmaf(c.y, li, gr.y));
  gi.y = fmaf(a.y, li, fmaf(-c.y, lr, gi.y));
  gr.z = fmaf(a.z, lr, fmaf(c.z, li, gr.z));
  gi.z = fmaf(a.z, li, fmaf(-c.z, lr, gi.z));
  gr.w = fmaf(a.w, lr, fmaf(c.w, li, gr.w));
  gi.w = fmaf(a.w, li, fmaf(-c.w, lr, gi.w));
}

}  // namespace fasta
