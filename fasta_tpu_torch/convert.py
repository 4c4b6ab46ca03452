"""Carry problems and results across between ``fasta_tpu`` and the port.

The JAX package's problem data is its ``Problem.instance`` dict of raw
NumPy arrays (or ``np.asarray`` of its leaves); these helpers build a
port :class:`~fasta_tpu_torch.problem.Problem` holding the same numbers,
so both packages solve bit-identical inputs, and turn a port result back
into NumPy.  No JAX import: everything crosses as NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .operators import DenseOp
from .problem import Problem
from .terms import L1Norm, LeastSquares

__all__ = ["problem_from_instance", "problem_from_arrays",
           "result_to_numpy"]


def problem_from_arrays(A, b, mu: float, x0, tau0: Optional[float] = None,
                        *, device, dtype: torch.dtype,
                        name: Optional[str] = None) -> Problem:
    """A LASSO ``Problem`` (DenseOp · LeastSquares · L1Norm) over
    ``dtype`` copies of ``A``, ``b`` and ``x0`` on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    A_t = t(A)
    m, n = A_t.shape
    return Problem(
        name=name or f"lasso[{m}x{n}]",
        op=DenseOp(A_t),
        fterm=LeastSquares(t(b)),
        gterm=L1Norm(float(mu)),
        x0=t(x0),
        tau0=tau0,
    )


def problem_from_instance(inst: dict, *, device,
                          dtype: torch.dtype) -> Problem:
    """A port ``Problem`` from a generator instance dict (the JAX
    ``Problem.instance``).  Slice 1 carries the LASSO instance."""
    if inst.get("name") != "lasso":
        raise NotImplementedError(
            f"instance {inst.get('name')!r} is not ported yet (ROADMAP "
            f"Queue A item 7); the port carries 'lasso'")
    prob = problem_from_arrays(inst["A"], inst["b"], inst["mu"], inst["x0"],
                               device=device, dtype=dtype)
    prob.x_true = inst.get("x_true")
    prob.instance = inst
    return prob


def result_to_numpy(result) -> dict:
    """A result (``FastaResult``, ``DeviceResult``, ``MicroResult`` or a
    kernel's ``MicrosolveOutput``) as a dict of NumPy arrays and Python
    scalars, field by field."""
    if dataclasses.is_dataclass(result):
        fields = {f.name: getattr(result, f.name)
                  for f in dataclasses.fields(result)}
    else:
        fields = result._asdict()

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return v

    return {k: host(v) for k, v in fields.items()}
