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

__all__ = ["use_high_precision", "redot", "norm2", "real_dtype",
           "lane_sum", "lane_redot", "lane_norm2", "lane_dot64", "lane"]


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


# Over a leading lane axis (the batch dimension of ``make_batch_solver``;
# one solve is one lane): one value per lane, each summed as the
# functions above sum one tensor.


def lane_sum(a: torch.Tensor) -> torch.Tensor:
    """The sum of each lane of ``a``, shape (B,)."""
    return torch.sum(a.reshape(a.shape[0], -1), dim=1)


def lane_redot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re⟨aᵢ, bᵢ⟩ per lane in the working precision."""
    return lane_sum(torch.real(torch.conj(a) * b))


def lane_norm2(a: torch.Tensor) -> torch.Tensor:
    """‖aᵢ‖² per lane in the working precision."""
    return lane_redot(a, a)


def lane_dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re⟨aᵢ, bᵢ⟩ per lane accumulated in float64."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    return lane_redot(a.to(wide), b.to(wide))


def lane(v, like: torch.Tensor):
    """A per-lane value (B,) shaped to broadcast against ``like`` (B, ...);
    a number or a 0-d tensor as it is."""
    if not torch.is_tensor(v) or v.ndim == 0:
        return v
    return v.reshape((v.shape[0],) + (1,) * (like.ndim - 1))
