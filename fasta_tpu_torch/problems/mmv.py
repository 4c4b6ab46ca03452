"""E7 — Multiple-measurement vector:  min ½‖AX−B‖²_F + μ‖X‖_{2,1}
(port of ``problems/mmv.py``).

Joint row-sparse recovery of several signals sharing a support; the L2,1
prox shrinks whole rows.  The variable X (n, l) is a matrix; the loop's
reductions flatten it.  The instance comes from the shared float64
generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_mmv

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("mmv")
def build(m: int = 400, n: int = 800, l: int = 10, k: int = 40,
          mu: float = 0.2, seed: int = 7, dtype: torch.dtype = torch.float32,
          *, device=None) -> Problem:
    """The instance of ``make_mmv(m, n, l, k, mu, seed)`` as ``dtype``
    tensors on ``device`` (the card when None)."""
    inst = make_mmv(m=m, n=n, l=l, k=k, mu=mu, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)


if __name__ == "__main__":
    from ..harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-6,
                                                   max_iters=2000)))
