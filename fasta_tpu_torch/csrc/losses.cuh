// The elementwise smooth losses of the dense problems, shared by K-B1
// (microsolver.cu) and K-B3/K-B3p (lstsq_fused.cu).
//
// Replaces: the loss branches of fasta_tpu/kernels/microsolver.py
// (fof/lgrad, :300-335) and the (ℓ, ℓ′) functions that
// fasta_tpu/kernels/lstsq_fused.py's fused_pointwise_gradmap takes
// (terms.py _logistic_elem, _hinge_elem).  A CUDA kernel cannot take a
// Python closure, so the loss is a runtime code, the same in every thread
// of a launch.
//
// For a row value d and its datum y (measurement or label), loss_eval
// gives the gradient weight w = ℓ′(d) and the term e that the f sum
// takes: the residual r (summed as r², scaled by ½ at the end) for least
// squares and the squared hinge, ℓ itself (summed as is) for the
// logistic loss.  Formulas round like the plain PyTorch versions'
// separate operations: _rn intrinsics (never contracted into FMAs) and
// the accurate expf / log1pf (no fast math).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace fasta {

// loss codes, in the order of the Python wrappers' LOSSES
enum Loss { kLstsq = 0, kLogistic = 1, kSquaredHinge = 2 };

// jnp.maximum / torch.maximum semantics: NaN in either operand gives NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float nanmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ void loss_eval(int loss, float d, float y, float& w, float& e) {
  if (loss == kLogistic) {
    // ℓ = max(d,0) + log1p(exp(−|d|)) − y·d,  ℓ′ = 1/(1+exp(−d)) − y
    e = __fsub_rn(__fadd_rn(nanmax(d, 0.f), log1pf(expf(-fabsf(d)))), __fmul_rn(y, d));
    w = __fsub_rn(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-d))), y);
  } else if (loss == kSquaredHinge) {
    // r = max(0, 1 − y·d),  ℓ = ½r²,  ℓ′ = −y·r
    e = nanmax(__fsub_rn(1.f, __fmul_rn(y, d)), 0.f);
    w = __fmul_rn(-y, e);
  } else {
    // r = d − y,  ℓ = ½r²,  ℓ′ = r
    e = __fsub_rn(d, y);
    w = e;
  }
}

// The f sum's term for e, in the accumulation type T.
template <typename T>
__device__ __forceinline__ T loss_term(int loss, float e) {
  return loss == kLogistic ? T(e) : T(e) * T(e);
}

// acc + the f sum's term for e in float32, the squares as one FMA.
__device__ __forceinline__ float loss_accum(int loss, float e, float acc) {
  return loss == kLogistic ? __fadd_rn(acc, e) : fmaf(e, e, acc);
}

// The factor applied to the finished f sum: ½ for the squared losses.
__host__ __device__ __forceinline__ float loss_scale(int loss) {
  return loss == kLogistic ? 1.f : 0.5f;
}

}  // namespace fasta
