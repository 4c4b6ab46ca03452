"""Public dispatch onto the whole-solve kernels (port of
``fasta_tpu/micro.py:41-350, 442-621``, dense and TV branches).

:func:`microsolve` inspects a :class:`~fasta_tpu_torch.problem.Problem`'s
operator and term types and routes a dense problem — least-squares,
logistic or squared-hinge loss × L1, nonnegativity, [−1,1] box or ridge
prox — to kernel K-B1 and a TV-dual problem — ``ScaledOp(μ, TVDiv2D())``
× ``LeastSquares`` × ``BoxIndicator(-1, 1)`` — to kernel K-B6, raising
with a reason when the structure is outside the kernels' scope.
:func:`microsolve_sweep` solves a path of weights in one launch of kernel
K-B1p or K-B6p, cold or warm.  Calling either is the opt-in: it never
falls back to the general loop.

Two faults of the reference are not inherited: ``best_index`` ignores
NaN and is None after a nonfinite abort, and ``status`` is a string,
never a truthy int.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .kernels.microsolver import (_DENSE_VMEM_BYTES, STATUS_NAMES,
                                  microsolve_lasso, microsolve_lasso_path,
                                  supports_microsolver)
from .kernels.microsolver_tv import microsolve_tv, microsolve_tv_path
from .operators import DenseOp, ScaledOp, TVDiv2D
from .problem import Problem
from .terms import (BoxIndicator, L1Norm, L2Norm2, LeastSquares, Logistic,
                    NonnegIndicator, SquaredHinge)

__all__ = ["MicroResult", "MicroBatchResult", "microsolve",
           "microsolve_supported", "microsolve_sweep"]

_LOSSES = {LeastSquares: "lstsq", Logistic: "logistic",
           SquaredHinge: "squared_hinge"}


@dataclass
class MicroResult:
    """Result of a whole-solve kernel run.

    ``solution`` stays a device tensor; the scalar fields and the (k,)
    diagnostic series are on the host.  ``status`` says why the solve
    stopped: "converged", "max_iters" or "nonfinite" (the in-kernel guard
    aborts the iteration f, τ or the residual goes NaN/inf).
    ``best_index`` is the index of the best iterate — the smallest
    recorded objective when ``record_objs``, else the smallest residual
    (the loop's rule), ignoring NaN — and None when the solve aborted as
    nonfinite or ran no iteration.  ``fvals``, ``objectives``,
    ``iterates`` ((k, n)) and ``norm_residuals`` are None unless
    recorded."""

    solution: torch.Tensor               # (n,); TV: the dual field (2, H, W)
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


@dataclass
class MicroBatchResult:
    """Result of a path run: the leading axis of every field is the path
    point.  ``solutions`` stays on the device; the per-point series are
    host arrays trimmed to each point's iteration count (lists of (kᵢ,)
    arrays).  ``best_indices`` follows ``MicroResult.best_index``, with
    −1 where that is None."""

    solutions: torch.Tensor              # (B, n); TV: (B, 2, H, W)
    iteration_counts: np.ndarray         # (B,) int
    converged: np.ndarray                # (B,) bool
    residuals: list
    taus: list
    solve_time: float
    fvals: Optional[list] = None
    statuses: Optional[np.ndarray] = None
    norm_residuals: Optional[list] = None
    backtracks: Optional[list] = None
    total_backtracks: Optional[np.ndarray] = None
    best_indices: Optional[np.ndarray] = None
    objectives: Optional[list] = None


def _dispatch(problem: Problem):
    """Return (kind, detail) for a supported problem, else (None, why)."""
    op, f, g = problem.op, problem.fterm, problem.gterm
    if (isinstance(op, ScaledOp) and isinstance(op.op, TVDiv2D)
            and isinstance(f, LeastSquares) and isinstance(g, BoxIndicator)):
        if f.b.ndim != 2:
            return None, f"TV kernel needs a 2-D image, got b.ndim={f.b.ndim}"
        if not (g.lo == -1.0 and g.hi == 1.0):
            return None, "TV kernel implements the [-1,1] dual ball only"
        return "tv", float(op.c)
    if isinstance(op, DenseOp) and type(f) in _LOSSES:
        loss = _LOSSES[type(f)]
        data = f.y if isinstance(f, SquaredHinge) else f.b
        if data.ndim != 1:
            return None, (f"dense kernel needs a vector of measurements/"
                          f"labels, got ndim={data.ndim}")
        m, n = op.A.shape
        if not supports_microsolver(m, n):
            return None, (
                f"dense kernel needs A within the reference's residency "
                f"gate: {m}x{n} f32 is {m * n * 4 / (1 << 20):.0f} MB > "
                f"{_DENSE_VMEM_BYTES >> 20} MB — use Problem.solve")
        if isinstance(g, L1Norm):
            if np.ndim(g.mu) != 0:
                return None, ("dense kernel needs a scalar mu per solve; "
                              "for a mu sweep use microsolve_sweep")
            return "dense", (loss, "l1", float(g.mu))
        if isinstance(g, NonnegIndicator):
            return "dense", (loss, "nonneg", 0.0)
        if isinstance(g, BoxIndicator) and g.lo == -1.0 and g.hi == 1.0:
            return "dense", (loss, "box", 0.0)
        if isinstance(g, L2Norm2):
            if np.ndim(g.lam) != 0:
                return None, ("dense kernel needs a scalar ridge lambda "
                              "per solve; for a lambda sweep use "
                              "microsolve_sweep")
            return "dense", (loss, "ridge", float(g.lam))
        return None, (f"dense kernel supports L1Norm/NonnegIndicator/"
                      f"BoxIndicator(-1,1)/L2Norm2 prox terms, got "
                      f"{type(g).__name__}")
    return None, (f"no whole-solve kernel for operator {type(op).__name__} "
                  f"+ smooth {type(f).__name__}: the port supports DenseOp "
                  f"with the least-squares, logistic or squared-hinge loss "
                  f"and the TV dual (ScaledOp(mu, TVDiv2D()) with "
                  f"LeastSquares and BoxIndicator(-1, 1)); the planar "
                  f"PhaseMax kernel (ROADMAP Queue A item 10) is not ported "
                  f"yet")


def microsolve_supported(problem: Problem) -> tuple:
    """(supported: bool, reason: str) — structure check only."""
    kind, detail = _dispatch(problem)
    if kind is None:
        return False, detail
    return True, kind


def _start(problem, what, tau0, engine, interpret, generator,
           record_iterates=False):
    """(kind, detail, data, x0, tau0) of a supported problem — ``data``
    the float32 measurements, labels or image — after the checks every
    entry point makes."""
    kind, detail = _dispatch(problem)
    if kind is None:
        raise ValueError(f"{what}: {detail}")
    if record_iterates and kind == "tv":
        raise ValueError(
            f"{what}: record_iterates is implemented for the dense kernel "
            f"(the TV kernel's per-iteration state is a 2-D dual field — a "
            f"512x512 trajectory is ~4 GB; use "
            f"Problem.solve(record_iterates=True))")
    if engine is not None:
        raise ValueError(f"{what}: engine selects the TPU kernels' matvec "
                         f"unit; the CUDA kernels have none")
    if interpret is not None:
        raise ValueError(f"{what}: interpret selects the Pallas "
                         f"interpreter; a CUDA kernel has no interpret mode")
    f = problem.fterm
    data = f.y if isinstance(f, SquaredHinge) else f.b
    x0 = torch.as_tensor(problem.x0).to(data.device, torch.float32)
    if tau0 is None:
        tau0 = problem.tau0
    if tau0 is None:
        from .solver import estimate_stepsize
        if generator is None:
            generator = torch.Generator(device=data.device).manual_seed(0)
        tau0_t, _ = estimate_stepsize(problem.op, f, x0.to(data.dtype),
                                      generator)
        tau0 = float(tau0_t)
    return kind, detail, data.to(torch.float32), x0, tau0


def _best(status, series):
    """The best iterate's index: NaN-aware argmin, None after a
    nonfinite abort or with no iteration."""
    if status == "nonfinite" or series.size == 0 or np.isnan(series).all():
        return None
    return int(np.nanargmin(series))


def microsolve(problem: Problem, tau0: Optional[float] = None,
               max_iters: int = 1000, tol: float = 1e-3, window: int = 10,
               shrink_factor: float = 0.2, max_backtracks: int = 20,
               hp: Optional[bool] = None, engine: Optional[str] = None,
               accelerate: bool = False, restart: bool = True,
               restart_dd: bool = False,
               stop_rule: str = "hybrid_residual",
               record_fvals: bool = False, record_bts: bool = True,
               record_objs: bool = False, record_iterates: bool = False,
               record_nres: bool = False,
               interpret: Optional[bool] = None,
               generator: Optional[torch.Generator] = None) -> MicroResult:
    """Solve ``problem`` inside one launch of kernel K-B1 (dense) or K-B6
    (the TV dual).

    Options mean what they mean on ``fasta_tpu.micro.microsolve``:
    adaptive (BB) mode by default, FISTA with O'Donoghue–Candès
    ``restart`` with ``accelerate=True`` (``restart_dd`` takes the
    restart dot in float64 under hp); ``hp`` accumulates the decision
    scalars in float64 and defaults off for the dense kernel, on for the
    TV kernel; the ``record_*`` flags add the f-value, backtrack,
    prox-point objective, iterate (dense only: TV raises) and
    normalized-residual series.  ``engine`` and ``interpret`` select TPU
    code paths and raise ``ValueError`` when passed.  Without ``tau0``
    (here or on the problem) the stepsize is estimated from points drawn
    from ``generator`` (default: seed 0 on the problem's device).

    The problem's data must lie on one device: a CUDA problem runs the
    kernel, a CPU problem its plain version.  Raises ``ValueError`` when
    the structure has no kernel."""
    kind, detail, data, x0, tau0 = _start(
        problem, "microsolve", tau0, engine, interpret, generator,
        record_iterates)
    kw = dict(max_iters=max_iters, window=window, tol=tol,
              shrink_factor=shrink_factor, max_backtracks=max_backtracks,
              stop_rule=stop_rule, accelerate=accelerate, restart=restart,
              restart_dd=restart_dd, record_fvals=record_fvals,
              record_bts=record_bts, record_objs=record_objs,
              record_nres=record_nres)
    t0 = time.perf_counter()
    if kind == "tv":
        out = microsolve_tv(data, x0, tau0, detail,
                            hp=True if hp is None else bool(hp), **kw)
    else:
        loss, prox, mu = detail
        out = microsolve_lasso(
            problem.op.A.to(torch.float32), data, x0, tau0, mu, hp=bool(hp),
            loss=loss, prox=prox, record_its=record_iterates, **kw)
    k = int(out.iteration_count)
    status = STATUS_NAMES[int(out.halt)]
    solve_time = time.perf_counter() - t0

    def host(a):
        return None if a is None else a.detach().cpu().numpy()[:k]

    res_h, objs_h = host(out.residuals), host(out.objectives)
    bts_h = host(out.backtracks)
    if bts_h is not None:
        bts_h = bts_h.astype(np.int64)
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
        best_index=_best(status, objs_h if objs_h is not None else res_h),
        objectives=objs_h,
        iterates=host(out.iterates),
        norm_residuals=host(out.norm_residuals),
    )


def microsolve_sweep(problem: Problem, mus, tau0: Optional[float] = None,
                     max_iters: int = 1000, tol: float = 1e-3,
                     window: int = 10, shrink_factor: float = 0.2,
                     max_backtracks: int = 20, hp: Optional[bool] = None,
                     engine: Optional[str] = None,
                     accelerate: bool = False, restart: bool = True,
                     restart_dd: bool = False,
                     stop_rule: str = "hybrid_residual",
                     record_fvals: bool = False, record_bts: bool = True,
                     record_objs: bool = False, record_nres: bool = False,
                     warm_start: bool = False,
                     interpret: Optional[bool] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> MicroBatchResult:
    """Solve the regularization path — one full solve per weight in
    ``mus`` (μ of the L1 term, λ of the ridge; TV: the TV weight) — in one
    launch of kernel K-B1p (K-B6p for TV).

    By default each point runs cold from ``problem.x0``: bit-identical to
    per-μ :func:`microsolve` calls on the same device (use it when the
    points are independent, as in cross-validation).  ``warm_start=True``
    runs ``solve_path``'s continuation recipe in the kernel: point i
    starts from point i−1's solution and (adaptive mode) last accepted
    stepsize — order ``mus`` strongest first and prefer
    ``stop_rule="residual"``.  Options mean what they mean on
    :func:`microsolve` (``hp`` defaults on for TV).

    The dense nonnegativity and box proxes have no weight, so sweeping
    them raises ``ValueError``, as does every structure without a
    kernel."""
    kind, detail, data, x0, tau0 = _start(
        problem, "microsolve_sweep", tau0, engine, interpret, generator)
    if kind == "dense" and detail[1] in ("nonneg", "box"):
        prox = detail[1]
        # the projections discard the weight, so every swept mu would
        # return the same solve
        raise ValueError(
            f"microsolve_sweep: the {prox!r} prox is a projection with no "
            f"penalty weight — every swept mu would return the same solve; "
            f"sweep applies to 'l1' (mu) and 'ridge' (lambda) dense "
            f"problems and the TV weight")
    mus = torch.as_tensor(mus, dtype=torch.float32)
    if mus.ndim != 1:
        raise ValueError(f"mus must be a 1-D vector of penalty weights, "
                         f"got ndim={mus.ndim}")
    B = mus.shape[0]
    kw = dict(warm=warm_start, max_iters=max_iters, window=window, tol=tol,
              shrink_factor=shrink_factor, max_backtracks=max_backtracks,
              stop_rule=stop_rule, accelerate=accelerate, restart=restart,
              restart_dd=restart_dd, record_fvals=record_fvals,
              record_bts=record_bts, record_objs=record_objs,
              record_nres=record_nres)
    t0 = time.perf_counter()
    if kind == "tv":
        out = microsolve_tv_path(data, x0, tau0, mus,
                                 hp=True if hp is None else bool(hp), **kw)
    else:
        loss, prox, _mu = detail
        out = microsolve_lasso_path(
            problem.op.A.to(torch.float32), data, x0, tau0, mus, hp=bool(hp),
            loss=loss, prox=prox, **kw)
    ks = out.iteration_count.cpu().numpy().astype(np.int64)
    statuses = np.array([STATUS_NAMES[int(h)] for h in out.halt.cpu()])
    solve_time = time.perf_counter() - t0

    def ragged(a, dtype=None):
        if a is None:
            return None
        a = a.detach().cpu().numpy()
        if dtype is not None:
            a = a.astype(dtype)
        return [a[i, :ks[i]] for i in range(B)]

    res_l, objs_l = ragged(out.residuals), ragged(out.objectives)
    bts_l = ragged(out.backtracks, np.int64)
    best_l = objs_l if objs_l is not None else res_l
    best = [_best(statuses[i], best_l[i]) for i in range(B)]
    return MicroBatchResult(
        solutions=out.x,
        iteration_counts=ks,
        converged=statuses == "converged",
        residuals=res_l,
        taus=ragged(out.taus),
        solve_time=solve_time,
        fvals=ragged(out.fvals),
        statuses=statuses,
        norm_residuals=ragged(out.norm_residuals),
        backtracks=bts_l,
        total_backtracks=(None if bts_l is None
                          else np.array([int(b.sum()) for b in bts_l])),
        best_indices=np.array([-1 if i is None else i for i in best]),
        objectives=objs_l,
    )
