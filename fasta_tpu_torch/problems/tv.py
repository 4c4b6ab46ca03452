"""E4 — Total-variation denoising:  min ½‖x−b‖² + μ·TV(x), on the dual
(port of ``problems/tv.py``).

The FASTA variable is the dual field p ∈ ℝ^{2×H×W}; A = μ·div (the
(2,H,W) → (H,W) adjoint of the forward-difference gradient), f(Ap) =
½‖Ap−b‖², g the indicator of the ∞-ball, and the denoised image is
recovered as x* = b − μ·div(p*).  No matrix is formed: the operator is
the stencil pair of ``operators.py``.  The instance comes from the shared
float64 generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_tv

from ..convert import problem_from_instance
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("tv")
def build(h: int = 512, w: int = 512, mu: float = 0.1, sigma: float = 0.1,
          seed: int = 4, dtype: torch.dtype = torch.float32, *,
          device) -> Problem:
    """The TV instance of ``make_tv(h, w, mu, sigma, seed)`` as ``dtype``
    tensors on ``device`` (required), with ``recover`` mapping a dual
    field to the denoised image."""
    inst = make_tv(h=h, w=w, mu=mu, sigma=sigma, seed=seed)
    return problem_from_instance(inst, device=device, dtype=dtype)
