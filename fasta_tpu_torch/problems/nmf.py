"""E11 — Non-negative matrix factorization:
min ½‖Y − W Hᵀ‖²_F  s.t. W ≥ 0, H ≥ 0 (port of ``problems/nmf.py``).

Solved jointly over the stacked factor X = [W; H] under the identity
operator: f smooth (nonconvex), g the nonnegative cone's indicator.
``recover`` maps X to the reconstruction W Hᵀ, which the recovery error
holds against the clean planted product.  The instance comes from the
shared float64 generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_nmf

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("nmf")
def build(d1: int = 80, d2: int = 60, rank: int = 5, sigma: float = 0.01,
          seed: int = 13, dtype: torch.dtype = torch.float32, *,
          device=None) -> Problem:
    """The instance of ``make_nmf(d1, d2, rank, sigma, seed)`` as
    ``dtype`` tensors on ``device`` (the card when None)."""
    inst = make_nmf(d1=d1, d2=d2, r=rank, sigma=sigma, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)


if __name__ == "__main__":
    from ..harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-7,
                                                   max_iters=2000)))
