"""Decision-scalar precision.

The JAX package carries its float32 decision scalars in double-word
float32 arithmetic (``fasta_tpu/precision.py``) because its chip has no
float64.  The H100 has native FP64, so the port accumulates the same
cancellation-prone scalars in float64 instead: the f-values and the
nonmonotone window, the backtracking dot ⟨Δx,∇f⟩ and the BB numerator
⟨Δx,Δg⟩ (the set listed at ``fasta_tpu/solver.py:230-237``).  Positive
sums (‖Δx‖², ‖Δg‖², the normalizer norms) carry no cancellation and stay
in working precision.  A product of two float32 values is exact in
float64, so a float64 sum of them meets the double-word error bound.
"""

from __future__ import annotations

import torch

__all__ = ["use_high_precision", "redot", "norm2", "dot64", "real_dtype"]


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of ``dtype`` (float32 for complex64, ...)."""
    return torch.empty((), dtype=dtype).real.dtype


def use_high_precision(precision: str, dtype: torch.dtype) -> bool:
    """Whether the decision scalars accumulate in float64: "high"
    always, "auto" exactly when the real working dtype is float32."""
    return precision == "high" or (precision == "auto"
                                   and real_dtype(dtype) == torch.float32)


def redot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re⟨a, b⟩ over arbitrary-shape (possibly complex) tensors, in the
    working precision."""
    return torch.sum(torch.real(torch.conj(a) * b))


def norm2(a: torch.Tensor) -> torch.Tensor:
    """‖a‖² in the working precision."""
    return redot(a, a)


def dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re⟨a, b⟩ accumulated in float64 (complex128 for complex data)."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    return redot(a.to(wide), b.to(wide))
