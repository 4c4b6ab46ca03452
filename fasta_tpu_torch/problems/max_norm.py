"""E9 — Max-norm regularization:  min ½‖X−B‖²_F  s.t.
max_i ‖X_i,:‖ ≤ c (port of ``problems/max_norm.py``).

The max-norm factorization constraint (bounded row norms of the stacked
factor); the prox projects each row onto the L2 ball.  The instance
comes from the shared float64 generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_max_norm

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("max_norm")
def build(d1: int = 300, d2: int = 60, radius: float = 1.0, seed: int = 9,
          dtype: torch.dtype = torch.float32, *, device=None) -> Problem:
    """The instance of ``make_max_norm(d1, d2, radius, seed)`` as
    ``dtype`` tensors on ``device`` (the card when None)."""
    inst = make_max_norm(d1=d1, d2=d2, radius=radius, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)


if __name__ == "__main__":
    from ..harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-6,
                                                   max_iters=500)))
