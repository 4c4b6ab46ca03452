"""E3 — Sparse logistic regression:  min Σ log(1+exp(Ax)) − bᵀAx + μ‖x‖₁
(port of ``problems/logistic.py``).

A non-quadratic smooth term: the problem that exercises the nonmonotone
backtracking line search.  The instance comes from the shared float64
generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_logistic

from ..convert import problem_from_instance
from ..operators import default_device
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("logistic")
def build(m: int = 1000, n: int = 500, k: int = 20, mu: float = 0.02,
          seed: int = 3, dtype: torch.dtype = torch.float32, *,
          device=None) -> Problem:
    """The instance of ``make_logistic(m, n, k, mu, seed)`` as ``dtype``
    tensors on ``device`` (the card when None)."""
    inst = make_logistic(m=m, n=n, k=k, mu=mu, seed=seed)
    return problem_from_instance(
        inst, device=default_device(device, "problems.build"), dtype=dtype)
