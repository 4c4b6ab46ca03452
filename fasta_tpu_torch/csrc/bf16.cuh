// bfloat16 values as float32, exactly: a bfloat16 value is the top half of
// the float32 with the same bits, so the upcast is a shift.  Shared by the
// kernels that read a matrix stored in bfloat16 — K-B3/K-B3p
// (lstsq_fused.cu), K-B7 (planar_fused.cu) and K-P4 (bf16_probe.cu) —
// whose 16-byte loads hold 8 values, value 2k in the low half of word k.
#pragma once

#include <cuda_runtime.h>

namespace fasta {

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float bf16_up(unsigned short h) {
  return __uint_as_float(unsigned(h) << 16);
}

}  // namespace fasta
