"""E2 — Non-negative least squares:  min ½‖Ax−b‖²  s.t. x ≥ 0 (port of
``problems/nnls.py``).

g is the indicator of the nonnegative cone; its prox is the orthant
projection.  The instance comes from the shared float64 generator, cast to
``dtype`` on ``device``.
"""

from __future__ import annotations

import torch

from reference_oracle.generators import make_nnls

from ..convert import problem_from_instance
from ..problem import Problem
from . import register

__all__ = ["build"]


@register("nnls")
def build(m: int = 1000, n: int = 500, seed: int = 2,
          dtype: torch.dtype = torch.float32, *, device) -> Problem:
    """The NNLS instance of ``make_nnls(m, n, seed)`` as ``dtype``
    tensors on ``device`` (required)."""
    inst = make_nnls(m=m, n=n, seed=seed)
    return problem_from_instance(inst, device=device, dtype=dtype)
