"""FASTA solver core (port of ``fasta_tpu/solver.py:58-191, 194-603,
664-672, 745-749, 771-930``).

Forward-backward splitting in the three modes of the reference — plain
(fixed stepsize), adaptive (the Zhou–Gao–Dai BB stepsize) and FISTA with
O'Donoghue–Candès restart — with nonmonotone backtracking, the five
stopping rules plus a custom ``stop_fn``, the nonfinite guard,
best-iterate tracking and full per-iteration diagnostics, and the
warm-started regularization path ``solve_path``.  The iteration math is
the JAX solver's — same update order, formulas and guard constants — so
trajectories agree within floating-point tolerance.

The loop runs eagerly in PyTorch on the device of the data.  Decisions
(backtracking, stopping) read one device scalar each, so an iteration
synchronises with the device; the whole-solve kernel
(``fasta_tpu_torch.micro.microsolve``) keeps them on the card.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .operators import LinearOp, as_linear_op, check_adjoint, randn_like
from .options import FastaOptions, stop_test
from .precision import dot64, norm2, real_dtype, redot, use_high_precision
from .terms import ProxTerm, SmoothTerm, as_prox_term, as_smooth_term

__all__ = ["fasta", "solve", "make_solver", "solve_path",
           "estimate_stepsize", "FastaResult", "DeviceResult"]

_EPS32 = float(np.finfo(np.float32).eps)


class DeviceResult(NamedTuple):
    """Raw solve output: tensors stay on the data's device; the
    iteration count and the flags are host values (the loop already
    read them)."""
    solution: Any
    best_iterate: Any
    iteration_count: int
    converged: bool
    residuals: Any
    norm_residuals: Any
    taus: Any
    fvals: Any
    objectives: Any
    backtracks: Any
    total_backtracks: int
    iterates: Any
    nonfinite: bool


@dataclass
class FastaResult:
    """Host-side result with trimmed diagnostic arrays — mirrors the
    oracle's ``FastaResult`` field for field."""
    solution: np.ndarray
    best_iterate: np.ndarray
    iteration_count: int
    converged: bool
    residuals: np.ndarray
    norm_residuals: np.ndarray
    taus: np.ndarray
    fvals: np.ndarray
    objectives: Optional[np.ndarray]
    backtracks: np.ndarray
    total_backtracks: int
    solve_time: float
    L_estimate: Optional[float]
    initial_tau: float
    iterates: Optional[np.ndarray] = None
    nonfinite: bool = False


def _norm(a):
    return torch.sqrt(norm2(a))


def estimate_stepsize(op: LinearOp, fterm: SmoothTerm, x0: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      points: Optional[tuple] = None) -> tuple:
    """Lipschitz / initial-stepsize estimate from two points:
    L ≈ ‖∇f̃(z₁)−∇f̃(z₂)‖/‖z₁−z₂‖ with ∇f̃(x) = Aᴴ∇f(Ax), τ₀ = (2/L)/10.

    ``points=(z1, z2)`` supplies the two points (generate them once in
    NumPy and feed the same pair to the oracle's ``est_points`` for auto-τ₀
    trajectory parity); otherwise they are drawn from ``generator``,
    which must live on ``x0``'s device.  Returns (τ₀, L) as 0-d tensors."""
    if points is not None:
        z1 = torch.as_tensor(points[0]).to(x0.device, x0.dtype)
        z2 = torch.as_tensor(points[1]).to(x0.device, x0.dtype)
    elif generator is None:
        raise ValueError("estimate_stepsize needs a torch.Generator or "
                         "explicit points")
    else:
        z1, z2 = randn_like(x0, generator), randn_like(x0, generator)
    g1 = op.rmatvec(fterm.grad(op(z1)))
    g2 = op.rmatvec(fterm.grad(op(z2)))
    L = _norm(g1 - g2) / torch.clamp_min(_norm(z2 - z1), 1e-30)
    L = torch.clamp_min(L, 1e-6)
    return 2.0 / L / 10.0, L


def _solve(opts: FastaOptions, op: LinearOp, fterm: SmoothTerm,
           gterm: ProxTerm, x0, tau0) -> DeviceResult:
    mode = opts.effective_mode      # the oracle's precedence
    accelerated = mode == "accelerated"
    x0 = torch.as_tensor(x0)
    dev = x0.device
    rdt = real_dtype(x0.dtype)
    hp = use_high_precision(opts.precision, x0.dtype)
    sdt = torch.float64 if hp else rdt       # decision-scalar dtype
    W, N = opts.window, opts.max_iters
    shrink_f = opts.shrink_factor
    tau = torch.as_tensor(tau0, dtype=rdt).to(dev)

    def fval(d):
        """f(d) in the decision precision."""
        return fterm.value_f64(d) if hp else fterm.value(d).to(rdt)

    fused = fterm.fused_gradmap(op) if opts.fuse else None
    # zero-matvec FISTA gradient extrapolation: valid when ∇f is affine in
    # d and the gradient at the prox point comes free from the fused pass
    affine_accel = accelerated and fused is not None and fterm.grad_affine

    d0 = op(x0)
    fwin = torch.full((W,), -math.inf, dtype=sdt, device=dev)
    fwin[0] = fval(d0)
    gradf = op.rmatvec(fterm.grad(d0))
    # FISTA carry: the last prox point, A·(it), its gradient map (affine
    # case only) and the momentum α
    one = torch.ones((), dtype=rdt, device=dev)
    accel = (((x0, d0, gradf, one) if affine_accel else (x0, d0, one))
             if accelerated else None)

    rec = opts.record_diagnostics

    def zeros(dtype=rdt, shape=()):
        return torch.zeros((N,) + shape, dtype=dtype, device=dev)

    residuals = zeros() if rec else None
    norm_residuals = zeros() if rec else None
    taus = zeros() if rec else None
    fvals = zeros() if rec else None
    objectives = zeros() if opts.record_objective else None
    backtracks = zeros(torch.int32) if rec else None
    iterates = (zeros(x0.dtype, tuple(x0.shape)) if opts.record_iterates
                else None)

    x = x0
    solution = x0
    best_x = x0
    min_obj = torch.tensor(math.inf, dtype=rdt, device=dev)
    max_res = torch.tensor(-math.inf, dtype=rdt, device=dev)
    total_bt = 0
    nonfinite = False
    stop = False
    k = 0
    while k < N and not stop:
        x_, g_ = x, gradf

        def fb_step(tau):
            """Forward (gradient) step, backward (prox) step, f at the
            trial point; the fused pass also returns its gradient."""
            x1hat = x_ - tau * g_
            x1 = gterm.prox(x1hat, tau)
            if fused is not None:
                d1, f1, grad1 = fused(x1)
                f1 = fval(d1) if hp else f1.to(rdt)
            else:
                d1 = op(x1)
                f1, grad1 = fval(d1), None
            return x1hat, x1, x1 - x_, d1, f1, grad1

        x1hat, x1, Dx, d1, f1, grad1 = fb_step(tau)
        bt = 0
        if opts.backtrack:
            # nonmonotone backtracking line search (Zhang–Hager window)
            M = torch.max(fwin)
            while bt < opts.max_backtracks:
                if hp:
                    # the JAX hp slack: 1e-12 plus 64 ulp (float32) of
                    # the f scale, since the iterates are float32-rounded
                    slack = 1e-12 + (64.0 * _EPS32) * (torch.abs(M)
                                                       + torch.abs(f1))
                    q = (norm2(Dx) / (2.0 * tau)).double()
                    suff = M + (dot64(Dx, g_) + q)
                    viol = f1 - suff > slack
                else:
                    suff = M + redot(Dx, g_) + norm2(Dx) / (2.0 * tau)
                    viol = f1 - 1e-12 > suff
                if not bool(viol):
                    break
                tau = tau * shrink_f
                x1hat, x1, Dx, d1, f1, grad1 = fb_step(tau)
                bt += 1

        # residuals, diagnostics, best-iterate tracking
        res = _norm(Dx) / tau
        max_res = torch.maximum(max_res, res)
        normalizer = (torch.maximum(_norm(g_), _norm(x1 - x1hat) / tau)
                      + opts.eps_n)
        nres = res / normalizer
        f1_f = f1.to(rdt)
        obj = (f1_f + gterm.value(x1).to(rdt) if opts.record_objective
               else None)
        if rec:
            residuals[k] = res
            norm_residuals[k] = nres
            taus[k] = tau
            backtracks[k] = bt
            if opts.record_objective:
                objectives[k] = obj
            if opts.record_iterates:
                iterates[k] = x1
        new_obj = obj if opts.record_objective else res
        better = new_obj < min_obj
        min_obj = torch.where(better, new_obj, min_obj)
        best_x = torch.where(better, x1, best_x)

        stop_t = stop_test(opts.stop_rule, res, nres, max_res, opts.tol,
                           opts.eps_r)
        if opts.stop_fn is not None:
            stop_t = stop_t | torch.as_tensor(
                opts.stop_fn(k, res, nres, max_res, f1_f), device=dev)
        if opts.guard_nonfinite:
            bad = ~(torch.isfinite(f1_f) & torch.isfinite(res))
            stop_t = stop_t | bad
            nonfinite = bool(bad)
        stop = bool(stop_t)
        if opts.verbose:
            print(f"[fasta-torch] iter {k}  tau {float(tau):.3e}  resid "
                  f"{float(res):.3e}  nresid {float(nres):.3e}  f "
                  f"{float(f1_f):.6e}  bt {bt}")

        # the mode's next point and stepsize; computed on the stopping
        # iteration too, as in the reference
        x_next, f_record = x1, f1
        if mode == "adaptive":
            # Zhou–Gao–Dai BB stepsize
            gradf1 = (grad1 if fused is not None
                      else op.rmatvec(fterm.grad(d1)))
            Dg = gradf1 + (x1hat - x_) / tau            # == gradf1 - g_
            dotprod = dot64(Dx, Dg).to(rdt) if hp else redot(Dx, Dg)
            nDx2, nDg2 = norm2(Dx), norm2(Dg)
            tau_s = torch.where(dotprod != 0.0, nDx2 / dotprod, math.inf)
            tau_m = torch.clamp_min(
                torch.where(nDg2 > 0.0, dotprod / nDg2, 0.0), 0.0)
            tau_next = torch.where(2.0 * tau_m > tau_s, tau_m,
                                   tau_s - 0.5 * tau_m)
            degenerate = ((tau_next <= 0.0) | torch.isinf(tau_next)
                          | torch.isnan(tau_next))
            tau_next = torch.where(degenerate, tau * 1.5, tau_next)
        elif accelerated:
            if affine_accel:
                x_acc, d_acc, g_acc, alpha0 = accel
            else:
                x_acc, d_acc, alpha0 = accel
            if opts.restart:
                # O'Donoghue–Candès gradient restart
                a, c = x_ - x1, x1 - x_acc
                rdot = dot64(a, c).to(rdt) if hp else redot(a, c)
                alpha0 = torch.where(rdot > 0.0, 1.0, alpha0)
            alpha1 = (1.0 + torch.sqrt(1.0 + 4.0 * alpha0 ** 2)) / 2.0
            beta = (alpha0 - 1.0) / alpha1
            x_next = x1 + beta * (x1 - x_acc)
            d_next = d1 + beta * (d1 - d_acc)           # A is linear
            if affine_accel:
                # Aᴴ∇f(d) is affine in d too: the same combination
                gradf1 = grad1 + beta * (grad1 - g_acc)
                accel = (x1, d1, grad1, alpha1)
            else:
                gradf1 = op.rmatvec(fterm.grad(d_next))
                accel = (x1, d1, alpha1)
            tau_next = tau
            # the window sees f at the next search point (the
            # extrapolated y); on a stop the prox-point value
            f_record = f1 if stop else fval(d_next)
        else:
            gradf1 = (grad1 if fused is not None
                      else op.rmatvec(fterm.grad(d1)))
            tau_next = tau
        if rec:
            fvals[k] = f_record.to(rdt)

        fwin[(k + 1) % W] = f_record
        total_bt += bt
        # on a stop the loop breaks at the prox iterate; at max_iters
        # FISTA returns the extrapolated point
        solution = x1 if (stop or not accelerated) else x_next
        x, gradf, tau = x_next, gradf1, tau_next
        k += 1

    return DeviceResult(
        solution=solution, best_iterate=best_x, iteration_count=k,
        converged=stop and not nonfinite, residuals=residuals,
        norm_residuals=norm_residuals, taus=taus, fvals=fvals,
        objectives=objectives, backtracks=backtracks,
        total_backtracks=total_bt, iterates=iterates, nonfinite=nonfinite)


def make_solver(opts: FastaOptions) -> Callable:
    """Return ``solve(op, fterm, gterm, x0, tau0) -> DeviceResult`` for
    one option set."""
    def solve_fn(op, fterm, gterm, x0, tau0):
        return _solve(opts, op, fterm, gterm, x0, tau0)
    return solve_fn


def solve(op: LinearOp, fterm: SmoothTerm, gterm: ProxTerm, x0, tau0,
          opts: Optional[FastaOptions] = None) -> DeviceResult:
    """Device-side solve — thin wrapper over ``make_solver``."""
    return make_solver(opts or FastaOptions())(op, fterm, gterm, x0, tau0)


def _path_terms(gterms) -> list:
    """The prox term of each path point: a sequence of terms as given, or
    an ``L1Norm`` / ``L2Norm2`` whose weight is a 1-D tensor or array
    (the leading path axis of the JAX package's ``gterms`` leaves)."""
    from .terms import L1Norm, L2Norm2
    if isinstance(gterms, (list, tuple)):
        return list(gterms)
    for cls, attr in ((L1Norm, "mu"), (L2Norm2, "lam")):
        if isinstance(gterms, cls):
            w = getattr(gterms, attr)
            if np.ndim(w) == 1:
                return [cls(w[i]) for i in range(len(w))]
    raise ValueError("solve_path needs a sequence of prox terms or an "
                     "L1Norm/L2Norm2 with a 1-D weight (one entry per path "
                     "point)")


def solve_path(op: LinearOp, fterm: SmoothTerm, gterms, x0, tau0,
               opts: Optional[FastaOptions] = None) -> DeviceResult:
    """Warm-started regularization path (continuation / homotopy).

    ``gterms`` gives one prox term per path point, strongest penalty
    first — a sequence, or e.g. ``L1Norm(torch.tensor([0.3, 0.1, 0.03]))``.
    The solves run in order, each from the previous solution and its last
    accepted stepsize.  Returns a :class:`DeviceResult` whose tensor
    fields are stacked along the path axis and whose host fields
    (iteration counts, flags, total backtracks) are NumPy arrays.

    The stepsize carry follows the reference: adaptive mode carries the
    last genuinely accepted τ (fewer than ``max_backtracks`` trials,
    τ > 0; the carried τ when there is none); FISTA and plain mode with
    backtracking, whose τ never grows, keep the caller's τ₀.  Prefer
    ``stop_rule="residual"``: the hybrid rule normalizes by the max
    residual seen within a solve, which a warm start makes small."""
    opts = opts or FastaOptions()
    if not opts.record_diagnostics:
        raise ValueError("solve_path warm-starts each leg from the "
                         "previous recorded taus; record_diagnostics "
                         "must stay True")
    tau_monotone = opts.accelerate or (opts.backtrack and not opts.adaptive)
    x, tau = torch.as_tensor(x0), tau0
    runs = []
    for g in _path_terms(gterms):
        r = _solve(opts, op, fterm, g, x, tau)
        runs.append(r)
        if not tau_monotone:
            k = r.iteration_count
            ok = ((r.backtracks[:k] < opts.max_backtracks)
                  & (r.taus[:k] > 0)).nonzero()
            if len(ok):
                tau = r.taus[int(ok[-1])]
        x = r.solution

    def stack(name):
        vals = [getattr(r, name) for r in runs]
        if vals[0] is None:
            return None
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals)
        return np.array(vals)

    return DeviceResult(*(stack(f) for f in DeviceResult._fields))


def _target_device(device, A, x0) -> torch.device:
    """``fasta``'s device for inputs that carry none, after checking the
    tensors the caller placed against an explicit ``device``."""
    target = torch.device("cuda" if device is None else device)
    if device is not None:
        for name, t in (("A", A), ("x0", x0)):
            if isinstance(t, torch.Tensor) and t.device != target:
                raise ValueError(
                    f"fasta: {name} lies on {t.device} but device="
                    f"{str(target)!r} was asked for; move it first "
                    f"(fasta never moves a placed tensor)")
    placeless = isinstance(A, np.ndarray) or not isinstance(x0,
                                                             torch.Tensor)
    if placeless and target.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fasta: the default device is 'cuda' and no CUDA device is "
            "available; pass device='cpu' to solve on the CPU")
    return target


def fasta(
    A: Any,
    At: Any,
    f: Any,
    gradf: Optional[Callable],
    g: Any,
    proxg: Optional[Callable],
    x0,
    *,
    options: Optional[FastaOptions] = None,
    tau0: Optional[float] = None,
    L: Optional[float] = None,
    generator: Union[torch.Generator, int] = 0,
    est_points: Optional[tuple] = None,
    check_adjoint_first: bool = False,
    device: Union[str, torch.device, None] = None,
    **opt_kwargs,
) -> FastaResult:
    """Reference-compatible entry point — the call shape of the upstream
    solver, the float64 oracle and ``fasta_tpu.fasta``: operator (a
    tensor or a LinearOp), smooth term (f, gradf — callables or a
    SmoothTerm), simple term (g, proxg — callables or a ProxTerm),
    initial iterate, keyword options.

    ``device`` (default "cuda") is where inputs that carry no device go:
    a NumPy ``x0`` or matrix ``A``.  Tensors the caller placed stay where
    they are, and one on another device than an explicitly passed
    ``device`` raises ``ValueError``; nothing is moved in silence.  With
    no CUDA device present the default raises instead of solving on the
    CPU: pass ``device="cpu"`` for that.  The solve runs on ``x0``'s
    device.  ``generator`` draws the random points of the stepsize
    estimate and the adjoint check: a ``torch.Generator`` on that device,
    or an int seed for one."""
    opts = options or FastaOptions()
    if opt_kwargs:
        opts = opts.replace(**opt_kwargs)
    target = _target_device(device, A, x0)
    op = as_linear_op(A, At, device=target)
    fterm = as_smooth_term(f, gradf)
    gterm = as_prox_term(g, proxg)
    x0 = torch.as_tensor(x0, device=None if isinstance(x0, torch.Tensor)
                         else target)
    if isinstance(generator, int):
        generator = torch.Generator(device=x0.device).manual_seed(generator)

    if check_adjoint_first:
        check_adjoint(op, x0, generator)

    L_est = None
    if tau0 is None:
        if L is None:
            tau0_t, L_t = estimate_stepsize(op, fterm, x0, generator,
                                            points=est_points)
            tau0, L_est = float(tau0_t), float(L_t)
        else:
            tau0 = 2.0 / L / 10.0
    initial_tau = float(tau0)

    t0 = time.perf_counter()
    out = make_solver(opts)(op, fterm, gterm, x0, tau0)
    if x0.device.type == "cuda":
        torch.cuda.synchronize(x0.device)
    solve_time = time.perf_counter() - t0

    k = out.iteration_count

    def host(a):
        return a.detach().cpu().numpy() if a is not None else None

    def trim(a):
        return host(a)[:k] if a is not None else None

    return FastaResult(
        solution=host(out.solution),
        best_iterate=host(out.best_iterate),
        iteration_count=k,
        converged=out.converged,
        residuals=trim(out.residuals),
        norm_residuals=trim(out.norm_residuals),
        taus=trim(out.taus),
        fvals=trim(out.fvals),
        objectives=trim(out.objectives),
        backtracks=trim(out.backtracks),
        total_backtracks=out.total_backtracks,
        solve_time=solve_time,
        L_estimate=L_est,
        initial_tau=initial_tau,
        iterates=trim(out.iterates),
        nonfinite=out.nonfinite,
    )
