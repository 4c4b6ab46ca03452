"""E10 — Sparse-operator LASSO:  min ½‖Ax−b‖² + μ‖x‖₁ with a sparse A
(port of ``problems/sparse_lasso.py``).

A is the generator's scipy CSR matrix as a ``SparseOp`` (torch sparse
CSR, its adjoint stored once); on float32 data the loop's trial step is
kernel K-B4.  The instance comes from the shared float64 generator, cast
to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_sparse_lasso

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("sparse_lasso")
def build(m: int = 1500, n: int = 3000, density: float = 0.02,
          k: int = 80, mu: float = 0.1, seed: int = 12,
          dtype: torch.dtype = torch.float32, *, device=None) -> Problem:
    """The instance of ``make_sparse_lasso(m, n, density, k, mu, seed)``
    as ``dtype`` tensors on ``device`` (the card when None)."""
    inst = make_sparse_lasso(m=m, n=n, density=density, k=k, mu=mu,
                             seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)


if __name__ == "__main__":
    from ..harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-6,
                                                   max_iters=2000)))
