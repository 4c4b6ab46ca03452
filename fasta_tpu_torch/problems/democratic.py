"""E6 — Democratic representations:  min ½‖Ax−b‖² + μ‖x‖∞ (port of
``problems/democratic.py``).

Spreads the signal's energy evenly over a redundant frame; the L∞ prox is
the Moreau decomposition through the sort-based L1-ball projection.  On
float32 data the loop's gradient map is kernel K-B3.  The instance comes
from the shared float64 generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_democratic

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("democratic")
def build(m: int = 256, n: int = 1024, mu: float = 3.0, seed: int = 6,
          dtype: torch.dtype = torch.float32, *, device=None) -> Problem:
    """The instance of ``make_democratic(m, n, mu, seed)`` as ``dtype``
    tensors on ``device`` (the card when None)."""
    inst = make_democratic(m=m, n=n, mu=mu, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)


if __name__ == "__main__":
    from ..harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-6,
                                                   max_iters=2000)))
