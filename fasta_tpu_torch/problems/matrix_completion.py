"""E8 — 1-bit (logistic) matrix completion:
min Σ_Ω log(1+exp(X)) − Y⊙X + μ‖X‖_* (port of
``problems/matrix_completion.py``).

Recovers a low-rank logit matrix from observed binary outcomes; A is the
identity and the nuclear-norm prox is singular-value thresholding
(``torch.linalg.svd``).  The instance comes from the shared float64
generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_matrix_completion

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("matrix_completion")
def build(d1: int = 200, d2: int = 200, rank: int = 5,
          obs_frac: float = 0.3, mu: float = 2.0, seed: int = 8,
          dtype: torch.dtype = torch.float32, *, device=None) -> Problem:
    """The instance of ``make_matrix_completion(d1, d2, rank, obs_frac,
    mu, seed)`` as ``dtype`` tensors on ``device`` (the card when None)."""
    inst = make_matrix_completion(d1=d1, d2=d2, rank=rank,
                                  obs_frac=obs_frac, mu=mu, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)


if __name__ == "__main__":
    from ..harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-5,
                                                   max_iters=500)))
