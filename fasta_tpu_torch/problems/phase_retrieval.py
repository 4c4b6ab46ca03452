"""E5 — Phase retrieval (PhaseMax-style): recover x from b = |Ax| (port of
``problems/phase_retrieval.py``).

BASELINE config 5: complex Gaussian A with 16 384 measurement rows and a
signal of 256 entries.  The PhaseMax relaxation is solved as FBS on the
penalized form

    min  ½ Σ max(|(Ax)_i| − b_i, 0)²  −  δ·Re⟨x̂₀, x⟩

with the smooth circular hinge as f and a linear shift as the prox of g.
``planar=True`` stores A as two real channel matrices
(``PlanarDenseOp``) and x as (n, 2), which the whole-solve kernel K-B8
and the fused gradient map K-B7 take; ``planar=False`` keeps complex
tensors, which the PyTorch loop drives unchanged.  The instance comes
from the shared float64 generator.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_phase_retrieval

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("phase_retrieval")
def build(m: int = 16384, n: int = 256, delta: float = 0.1, seed: int = 5,
          dtype: torch.dtype = torch.complex64, planar: bool = False, *,
          device=None) -> Problem:
    """The instance of ``make_phase_retrieval(m, n, delta, seed)`` on
    ``device`` (the card when None).  ``dtype`` is the complex type, or
    with ``planar=True`` the real type of the channels (float32 for
    complex64 or float32)."""
    inst = make_phase_retrieval(m=m, n=n, delta=delta, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype,
        planar=planar)
