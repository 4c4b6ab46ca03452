"""Public dispatch onto the whole-solve kernels (port of
``fasta_tpu/micro.py:41-621, 669-698``, dense, TV and planar branches).

:func:`microsolve` inspects a :class:`~fasta_tpu_torch.problem.Problem`'s
operator and term types and routes a dense problem — least-squares,
logistic or squared-hinge loss × L1, nonnegativity, [−1,1] box or ridge
prox — to kernel K-B1, a TV-dual problem — ``ScaledOp(μ, TVDiv2D())``
× ``LeastSquares`` × ``BoxIndicator(-1, 1)`` — to kernel K-B6 and planar
PhaseMax — ``PlanarDenseOp`` × ``PlanarPhaseHinge`` ×
``PlanarLinearAnchor`` — to kernel K-B8, raising with a reason when the
structure is outside the kernels' scope.  :func:`microsolve_sweep` solves
a path of weights in one launch of kernel K-B1p or K-B6p, cold or warm,
and :func:`microsolve_batch` a batch of instances sharing the operator in
one launch of kernel K-B1b, K-B6b or K-B8b.  Calling any of them is the
opt-in: it never falls back to the general loop.

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
                                  microsolve_lasso, microsolve_lasso_batch,
                                  microsolve_lasso_path,
                                  supports_microsolver)
from .kernels.microsolver_planar import (microsolve_planar_phasemax,
                                        microsolve_planar_phasemax_batch,
                                        row_chunk,
                                        supports_planar_microsolver)
from .kernels.microsolver_tv import (microsolve_tv, microsolve_tv_batch,
                                     microsolve_tv_path)
from .operators import DenseOp, PlanarDenseOp, ScaledOp, TVDiv2D
from .problem import Problem
from .profiling import span
from .terms import (BoxIndicator, L1Norm, L2Norm2, LeastSquares, Logistic,
                    NonnegIndicator, PlanarLinearAnchor, PlanarPhaseHinge,
                    SquaredHinge)

__all__ = ["MicroResult", "MicroBatchResult", "microsolve",
           "microsolve_supported", "microsolve_sweep", "microsolve_batch"]

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
    ``iterates`` ((k, n); planar (k, n, 2)) and ``norm_residuals`` are
    None unless recorded."""

    solution: torch.Tensor   # (n,); TV: dual field (2, H, W); planar (n, 2)
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
    """Result of a batched run — the points of a weight path
    (:func:`microsolve_sweep`) or the instances of a batch
    (:func:`microsolve_batch`): the leading axis of every field is the
    point or instance.  ``solutions`` stays on the device; the
    per-point series are host arrays trimmed to each point's iteration
    count (lists of (kᵢ,) arrays).  ``statuses`` holds each point's
    ``MicroResult.status`` and ``best_indices`` its
    ``MicroResult.best_index``, with −1 where that is None."""

    solutions: torch.Tensor    # (B, n); TV: (B, 2, H, W); planar (B, n, 2)
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
    if (isinstance(op, PlanarDenseOp) and isinstance(f, PlanarPhaseHinge)
            and isinstance(g, PlanarLinearAnchor)):
        m, n = op.Ar.shape
        if not supports_planar_microsolver(m, n):
            # the reference's gates and reasons (micro.py:121-135)
            if row_chunk(m) is None:
                return None, (f"planar PhaseMax kernel needs m divisible "
                              f"by a 128-multiple row chunk, got m={m} — "
                              f"pad the measurement rows to a multiple "
                              f"of 128")
            return None, (f"planar PhaseMax kernel needs both channel "
                          f"matrices within the reference's residency "
                          f"gate (2*{m}*{n}*4 bytes > 48 MB)")
        return "planar", None
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
                  f"with the least-squares, logistic or squared-hinge loss, "
                  f"the TV dual (ScaledOp(mu, TVDiv2D()) with LeastSquares "
                  f"and BoxIndicator(-1, 1)) and planar PhaseMax "
                  f"(PlanarDenseOp with PlanarPhaseHinge and "
                  f"PlanarLinearAnchor)")


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
            f"{what}: record_iterates is implemented for the dense and "
            f"planar kernels (the TV kernel's per-iteration state is a 2-D "
            f"dual field — a 512x512 trajectory is ~4 GB; use "
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
    """Solve ``problem`` inside one launch of kernel K-B1 (dense), K-B6
    (the TV dual) or K-B8 (planar PhaseMax).

    Options mean what they mean on ``fasta_tpu.micro.microsolve``:
    adaptive (BB) mode by default, FISTA with O'Donoghue–Candès
    ``restart`` with ``accelerate=True`` (``restart_dd`` takes the
    restart dot in float64 under hp); ``hp`` accumulates the decision
    scalars in float64 and defaults off for the dense and planar
    kernels, on for the TV kernel; the ``record_*`` flags add the
    f-value, backtrack, prox-point objective, iterate (dense: (k, n);
    planar: (k, n, 2); TV raises) and normalized-residual series.
    ``engine`` and ``interpret`` select TPU code paths and raise
    ``ValueError`` when passed.  Without ``tau0``
    (here or on the problem) the stepsize is estimated from points drawn
    from ``generator`` (default: seed 0 on the problem's device).

    The problem's data must lie on one device: a CUDA problem runs the
    kernel, a CPU problem its plain version.  Raises ``ValueError`` when
    the structure has no kernel."""
    with span("fasta.micro.start"):
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
    with span("fasta.micro.launch"):
        if kind == "tv":
            out = microsolve_tv(data, x0, tau0, detail,
                                hp=True if hp is None else bool(hp), **kw)
        elif kind == "planar":
            op = problem.op
            out = microsolve_planar_phasemax(
                op.Ar.to(torch.float32), op.Ai.to(torch.float32), data,
                problem.gterm.c.to(torch.float32), x0, tau0, hp=bool(hp),
                record_its=record_iterates, **kw)
        else:
            loss, prox, mu = detail
            out = microsolve_lasso(
                problem.op.A.to(torch.float32), data, x0, tau0, mu,
                hp=bool(hp), loss=loss, prox=prox,
                record_its=record_iterates, **kw)
    with span("fasta.micro.result"):
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

    The dense nonnegativity and box proxes and planar PhaseMax have no
    weight, so sweeping them raises ``ValueError``, as does every
    structure without a kernel."""
    kind, detail, data, x0, tau0 = _start(
        problem, "microsolve_sweep", tau0, engine, interpret, generator)
    if kind == "planar":
        raise ValueError("microsolve_sweep: the planar PhaseMax kernel has "
                         "no penalty weight to sweep")
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
    return _pack_batch(out, B, t0)


def _instance_anchors(kind, problem, prox, B, dev):
    """The (B,) + c.shape float32 anchors of a planar batch; raises for a
    kernel that takes no per-instance prox data."""
    if kind != "planar":
        kernel = "K-B6b" if kind == "tv" else "K-B1b"
        raise ValueError(
            f"microsolve_batch: {kernel} shares the prox term "
            f"{type(problem.gterm).__name__} across the batch and takes no "
            f"per-instance prox data")
    c = problem.gterm.c
    prox = torch.as_tensor(prox).to(dev, torch.float32)
    if tuple(prox.shape) != (B,) + tuple(c.shape):
        raise ValueError(f"microsolve_batch: prox shape {tuple(prox.shape)} "
                         f"!= {(B,) + tuple(c.shape)}")
    return prox


def _pack_batch(out, B: int, t0: float) -> MicroBatchResult:
    """A batched kernel output (leading axis of B points) as a
    :class:`MicroBatchResult`, its series trimmed to each point's count;
    ``t0`` is the perf_counter reading before the launch.  The copies to
    the host and the series are the span ``fasta.micro.result``."""
    with span("fasta.micro.result"):
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


def microsolve_batch(problem: Problem, bs, x0s=None, tau0=None, prox=None,
                     max_iters: int = 1000, tol: float = 1e-3,
                     window: int = 10, shrink_factor: float = 0.2,
                     max_backtracks: int = 20, hp: Optional[bool] = None,
                     engine: Optional[str] = None,
                     accelerate: bool = False, restart: bool = True,
                     restart_dd: bool = False,
                     stop_rule: str = "hybrid_residual",
                     record_fvals: bool = False, record_bts: bool = True,
                     record_objs: bool = False, record_nres: bool = False,
                     interpret: Optional[bool] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> MicroBatchResult:
    """Solve a batch of instances sharing ``problem``'s operator in one
    launch of kernel K-B1b (dense), K-B6b (the TV dual, one image per
    instance) or K-B8b (planar PhaseMax); port of
    ``fasta_tpu/micro.py:353-475``.

    ``bs`` stacks the instances' measurements, labels or images on a new
    leading axis (``(B,) +`` the smooth term's data shape); ``x0s``
    stacks their starts (default: every instance starts from
    ``problem.x0``); ``prox`` stacks the prox term's data, one an
    instance: planar PhaseMax's anchors c (B, n, 2), which K-B8b reads
    per instance (default: the problem's one c for all; K-B1b and K-B6b
    take none and raise ``ValueError``).  ``tau0`` is one stepsize for
    all, or a (B,) vector of one per instance (default: the problem's,
    else estimated as :func:`microsolve` does).  Each instance runs the
    whole solve with its own stopping decision and is bit-identical to a
    separate :func:`microsolve` call on the same device (with its own
    anchor, start and stepsize).  Options mean what they
    mean on :func:`microsolve`.  Raises ``ValueError`` for a structure
    without a kernel and for ``bs``, ``x0s``, ``prox`` or ``tau0`` of the
    wrong shape."""
    with span("fasta.micro.start"):
        kind, detail, data, x0, tau0 = _start(
            problem, "microsolve_batch", tau0, engine, interpret, generator)
        dev = data.device
        bs = torch.as_tensor(bs).to(dev, torch.float32)
        if bs.ndim != data.ndim + 1:
            raise ValueError(f"microsolve_batch: bs must stack {data.ndim}-d "
                             f"instance data on a leading batch axis, got "
                             f"ndim={bs.ndim}")
        B = bs.shape[0]
        if x0s is None:
            x0s = x0                  # shared: the kernels read it once
        else:
            x0s = torch.as_tensor(x0s).to(dev, torch.float32)
            if tuple(x0s.shape) != (B,) + tuple(x0.shape):
                raise ValueError(
                    f"microsolve_batch: x0s shape {tuple(x0s.shape)} != "
                    f"{(B,) + tuple(x0.shape)}")
        if prox is not None:
            prox = _instance_anchors(kind, problem, prox, B, dev)
        tau0 = torch.as_tensor(tau0, dtype=torch.float32)
        if tau0.ndim > 1:
            raise ValueError(f"microsolve_batch: tau0 must be a scalar or a "
                             f"(B,) vector of per-instance stepsizes, got "
                             f"ndim={tau0.ndim}")
        if tau0.ndim == 1 and tuple(tau0.shape) != (B,):
            raise ValueError(f"microsolve_batch: per-instance tau0 shape "
                             f"{tuple(tau0.shape)} != ({B},)")
        tau0s = tau0.to(dev) if tau0.ndim else float(tau0)
        kw = dict(max_iters=max_iters, window=window, tol=tol,
                  shrink_factor=shrink_factor, max_backtracks=max_backtracks,
                  stop_rule=stop_rule, accelerate=accelerate, restart=restart,
                  restart_dd=restart_dd, record_fvals=record_fvals,
                  record_bts=record_bts, record_objs=record_objs,
                  record_nres=record_nres)
    t0 = time.perf_counter()
    with span("fasta.micro.launch"):
        if kind == "tv":
            out = microsolve_tv_batch(
                bs, x0s, tau0s, detail, hp=True if hp is None else bool(hp),
                **kw)
        elif kind == "planar":
            op = problem.op
            out = microsolve_planar_phasemax_batch(
                op.Ar.to(torch.float32), op.Ai.to(torch.float32), bs,
                problem.gterm.c.to(torch.float32) if prox is None else prox,
                x0s, tau0s, hp=bool(hp), **kw)
        else:
            loss, prox, mu = detail
            out = microsolve_lasso_batch(
                problem.op.A.to(torch.float32), bs, x0s, tau0s, mu,
                hp=bool(hp), loss=loss, prox=prox, **kw)
    return _pack_batch(out, B, t0)
