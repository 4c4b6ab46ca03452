"""E10 — Linear SVM (squared hinge):
min ½ Σ max(0, 1 − y·(Ax))² + λ/2‖x‖² (port of ``problems/svm.py``).

A non-quadratic, piecewise-smooth f with the ridge prox.  The instance
comes from the shared float64 generator, cast to ``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_svm

from ..convert import problem_from_instance
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("svm")
def build(m: int = 800, n: int = 100, lam: float = 0.01, seed: int = 11,
          dtype: torch.dtype = torch.float32, *, device) -> Problem:
    """The instance of ``make_svm(m, n, lam, seed)`` as ``dtype`` tensors
    on ``device`` (required)."""
    inst = make_svm(m=m, n=n, lam=lam, seed=seed)
    return problem_from_instance(inst, device=device, dtype=dtype)
