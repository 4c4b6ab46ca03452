"""Public dispatch onto the whole-solve kernel (port of
``fasta_tpu/micro.py:41-325``, dense branch, lstsq × l1).

:func:`microsolve` inspects a :class:`~fasta_tpu_torch.problem.Problem`'s
operator and term types and routes it to kernel K-B1, raising with a
reason when the structure is outside the kernel's scope.  Calling it is
the opt-in: it never falls back to the general loop.

Two faults of the reference are not inherited: ``best_index`` ignores
NaN residuals and is None after a nonfinite abort, and ``status`` is a
string, never a truthy int.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .kernels.microsolver import (_DENSE_VMEM_BYTES, STATUS_NAMES,
                                  microsolve_lasso, supports_microsolver)
from .operators import DenseOp
from .problem import Problem
from .terms import L1Norm, LeastSquares

__all__ = ["MicroResult", "microsolve", "microsolve_supported"]


@dataclass
class MicroResult:
    """Result of a whole-solve kernel run.

    ``solution`` stays a device tensor; the scalar fields and the (k,)
    diagnostic series are on the host.  ``status`` says why the solve
    stopped: "converged", "max_iters" or "nonfinite" (the in-kernel guard
    aborts the iteration f, τ or the residual goes NaN/inf).
    ``best_index`` is the index of the smallest recorded residual,
    ignoring NaN, and None when the solve aborted as nonfinite or ran no
    iteration.  The objective, iterate and normalized-residual series of
    the reference's contract are not recorded by this slice's kernel and
    stay None."""

    solution: torch.Tensor
    iteration_count: int
    converged: bool
    residuals: np.ndarray
    taus: np.ndarray
    solve_time: float
    fvals: Optional[np.ndarray] = None
    status: str = "max_iters"
    backtracks: Optional[np.ndarray] = None
    total_backtracks: Optional[int] = None
    best_index: Optional[int] = None
    objectives: Optional[np.ndarray] = None
    iterates: Optional[np.ndarray] = None
    norm_residuals: Optional[np.ndarray] = None


def _dispatch(problem: Problem):
    """Return (kind, detail) for a supported problem, else (None, why)."""
    op, f, g = problem.op, problem.fterm, problem.gterm
    if isinstance(op, DenseOp) and isinstance(f, LeastSquares):
        if f.b.ndim != 1:
            return None, (f"dense kernel needs a vector of measurements, "
                          f"got ndim={f.b.ndim}")
        m, n = op.A.shape
        if not supports_microsolver(m, n):
            return None, (
                f"dense kernel needs A within the reference's residency "
                f"gate: {m}x{n} f32 is {m * n * 4 / (1 << 20):.0f} MB > "
                f"{_DENSE_VMEM_BYTES >> 20} MB — use Problem.solve")
        if isinstance(g, L1Norm):
            if np.ndim(g.mu) != 0:
                return None, "dense kernel needs a scalar mu per solve"
            return "dense", ("lstsq", "l1", float(g.mu))
        return None, (f"the port's dense kernel supports the L1Norm prox "
                      f"term, got {type(g).__name__} (the other proxes are "
                      f"ROADMAP Queue B item B1)")
    return None, (f"no whole-solve kernel for operator {type(op).__name__} "
                  f"+ smooth {type(f).__name__} (the port supports DenseOp "
                  f"with the least-squares loss)")


def microsolve_supported(problem: Problem) -> tuple:
    """(supported: bool, reason: str) — structure check only."""
    kind, detail = _dispatch(problem)
    if kind is None:
        return False, detail
    return True, kind


def microsolve(problem: Problem, tau0: Optional[float] = None,
               max_iters: int = 1000, tol: float = 1e-3, window: int = 10,
               shrink_factor: float = 0.2, max_backtracks: int = 20,
               hp: Optional[bool] = None, engine: Optional[str] = None,
               accelerate: bool = False,
               stop_rule: str = "hybrid_residual",
               record_fvals: bool = False, record_bts: bool = True,
               record_objs: bool = False, record_iterates: bool = False,
               record_nres: bool = False,
               interpret: Optional[bool] = None,
               generator: Optional[torch.Generator] = None) -> MicroResult:
    """Solve ``problem`` inside one launch of kernel K-B1 (adaptive mode).

    Options mean what they mean on ``fasta_tpu.micro.microsolve``.
    ``hp`` (default off) accumulates the decision scalars in float64.
    ``engine`` and ``interpret`` select TPU code paths and raise
    ``ValueError`` when passed; ``accelerate`` and the objective, iterate
    and normalized-residual recordings raise ``NotImplementedError``
    (ROADMAP Queue B item B1).  Without ``tau0`` (here or on the
    problem) the stepsize is estimated from points drawn from
    ``generator`` (default: seed 0 on the problem's device).

    The problem's data must lie on one device: a CUDA problem runs the
    kernel, a CPU problem its plain version.  Raises ``ValueError`` when
    the structure has no kernel."""
    kind, detail = _dispatch(problem)
    if kind is None:
        raise ValueError(f"microsolve: {detail}")
    if engine is not None:
        raise ValueError("microsolve: engine selects the TPU kernels' "
                         "matvec unit; the CUDA kernel has none")
    if interpret is not None:
        raise ValueError("microsolve: interpret selects the Pallas "
                         "interpreter; a CUDA kernel has no interpret mode")
    if accelerate:
        raise NotImplementedError("microsolve: FISTA mode is not ported "
                                  "yet (ROADMAP Queue B item B1)")
    _loss, _prox, mu = detail
    A = problem.op.A
    b = problem.fterm.b
    x0 = torch.as_tensor(problem.x0).to(A.device, torch.float32)

    if tau0 is None:
        tau0 = problem.tau0
    if tau0 is None:
        from .solver import estimate_stepsize
        if generator is None:
            generator = torch.Generator(device=A.device).manual_seed(0)
        tau0_t, _ = estimate_stepsize(problem.op, problem.fterm,
                                      x0.to(A.dtype), generator)
        tau0 = float(tau0_t)

    t0 = time.perf_counter()
    out = microsolve_lasso(
        A.to(torch.float32), b.to(torch.float32), x0, tau0, mu,
        max_iters=max_iters, window=window, tol=tol,
        shrink_factor=shrink_factor, max_backtracks=max_backtracks,
        hp=bool(hp), stop_rule=stop_rule, record_fvals=record_fvals,
        record_bts=record_bts, record_objs=record_objs,
        record_its=record_iterates, record_nres=record_nres)
    k = int(out.iteration_count)
    status = STATUS_NAMES[int(out.halt)]
    solve_time = time.perf_counter() - t0

    def host(a):
        return None if a is None else a.detach().cpu().numpy()[:k]

    res_h = host(out.residuals)
    bts_h = host(out.backtracks)
    if bts_h is not None:
        bts_h = bts_h.astype(np.int64)
    best = None
    if status != "nonfinite" and k > 0 and not np.isnan(res_h).all():
        best = int(np.nanargmin(res_h))
    return MicroResult(
        solution=out.x,
        iteration_count=k,
        converged=status == "converged",
        residuals=res_h,
        taus=host(out.taus),
        solve_time=solve_time,
        fvals=host(out.fvals),
        status=status,
        backtracks=bts_h,
        total_backtracks=None if bts_h is None else int(bts_h.sum()),
        best_index=best,
    )
