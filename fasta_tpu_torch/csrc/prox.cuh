// The soft threshold shared by K-B1 (microsolver.cu) and K-B4
// (prox_fused.cu): the prox of t·‖·‖₁ in the reference's form
// z·max(|z|−t, 0)/max(|z|, 1e-30), rounded like the plain PyTorch
// version's separate operations (_rn intrinsics), NaN propagating as
// torch.clamp_min and jnp.maximum do.
#pragma once

#include <cuda_runtime.h>

#include "losses.cuh"

namespace fasta {

__device__ __forceinline__ float shrink(float z, float t) {
  const float mag = fabsf(z);
  return __fmul_rn(z, __fdiv_rn(nanmax(__fsub_rn(mag, t), 0.f), nanmax(mag, 1e-30f)));
}

}  // namespace fasta
