"""E1 — LASSO / BPDN:  min ½‖Ax−b‖² + μ‖x‖₁ (port of
``problems/lasso.py``).

Dense Gaussian A, sparse planted signal.  The instance comes from the
shared float64 generator, cast to ``dtype`` on ``device``, so the oracle,
``fasta_tpu`` and this package solve the same numbers.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_lasso

from ..convert import problem_from_instance
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("lasso")
def build(m: int = 1000, n: int = 2000, k: int = 100, mu: float = 0.1,
          seed: int = 1, dtype: torch.dtype = torch.float32, *,
          device) -> Problem:
    """The LASSO instance of ``make_lasso(m, n, k, mu, seed)`` as
    ``dtype`` tensors on ``device`` (required: the port never picks a
    device itself)."""
    inst = make_lasso(m=m, n=n, k=k, mu=mu, seed=seed)
    return problem_from_instance(inst, device=device, dtype=dtype)
