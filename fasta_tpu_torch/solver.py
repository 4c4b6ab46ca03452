"""FASTA solver core (port of ``fasta_tpu/solver.py:58-191, 194-603,
664-672, 745-765, 771-930``).

Forward-backward splitting in the three modes of the reference — plain
(fixed stepsize), adaptive (the Zhou–Gao–Dai BB stepsize) and FISTA with
O'Donoghue–Candès restart — with nonmonotone backtracking, the five
stopping rules plus a custom ``stop_fn``, the nonfinite guard,
best-iterate tracking and full per-iteration diagnostics, the
warm-started regularization path ``solve_path`` and the batch solver
``make_batch_solver``.  The iteration math is the JAX solver's — same
update order, formulas and guard constants — so trajectories agree within
floating-point tolerance.

The loop runs eagerly in PyTorch on the device of the data, over a
leading lane axis: one solve is one lane, a batch many.  Decisions
(backtracking, stopping) read one device value each, so an iteration
synchronises with the device; the whole-solve kernels
(``fasta_tpu_torch.micro``) keep them on the card.  An L1 trial step of
real float32 data is kernel K-B4 (``kernels/prox_fused.py``), which
returns x₁ and the step's three sums in one pass.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .kernels.prox_fused import fused_shrink_step
from .operators import LinearOp, as_linear_op, check_adjoint, randn_like
from .options import FastaOptions, stop_test
from .precision import (lane, lane_dot64, lane_norm2, lane_redot, norm2,
                        real_dtype, use_high_precision)
from .terms import (L1Norm, ProxTerm, SmoothTerm, as_prox_term,
                    as_smooth_term)

__all__ = ["fasta", "solve", "make_solver", "make_batch_solver",
           "solve_path", "estimate_stepsize", "FastaResult", "DeviceResult"]

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


class _Trial(NamedTuple):
    """One line-search trial over the lanes: the prox point, A x₁, f(A x₁)
    in the decision precision, the fused pass's gradient (or None), ‖Δx‖²
    and ⟨Δx, g⟩ (the latter in the decision precision), and either
    ‖x₁ − x̂₁‖² (kernel K-B4) or the composition's x̂₁ and Δx."""
    x1: Any
    d1: Any
    f1: Any
    grad1: Any
    nd2: Any
    btd: Any
    nsm2: Any
    x1hat: Any
    Dx: Any


def _solve(opts: FastaOptions, op: LinearOp, fterm: SmoothTerm,
           gterm: ProxTerm, x0, tau0, lanes: bool = False) -> DeviceResult:
    """The FASTA loop over a leading lane axis.

    ``lanes=False`` is one solve: one lane, and a result without the lane
    axis.  ``lanes=True`` is ``make_batch_solver``'s batch: x0 (B, ...)
    and tau0 (B,) carry the lanes, and the terms' data is shared or has a
    leading axis of B.  The lanes follow a vmapped ``lax.while_loop``: the
    loop runs while any lane is live, a stopped lane is frozen and its
    records are not written past its own count, backtracking continues
    while a live lane violates the test with trials left (a lane that
    accepted keeps its trial), and τ, the window, the counts, the flags and
    the totals are per lane.  Each decision of the whole batch reads one
    device value (one ``any()`` per trial and per iteration)."""
    mode = opts.effective_mode      # the oracle's precedence
    accelerated = mode == "accelerated"
    x0 = torch.as_tensor(x0)
    if not lanes:
        x0 = x0[None]
    B = x0.shape[0]
    dev = x0.device
    rdt = real_dtype(x0.dtype)
    hp = use_high_precision(opts.precision, x0.dtype)
    sdt = torch.float64 if hp else rdt       # decision-scalar dtype
    W, N = opts.window, opts.max_iters
    shrink_f = opts.shrink_factor
    tau = torch.as_tensor(tau0, dtype=rdt).to(dev).expand(B).clone()

    def keep(new, old, live):
        """``new`` in the live lanes, ``old`` in the stopped ones (one lane
        is live while the loop runs)."""
        return new if B == 1 else torch.where(lane(live, new), new, old)

    def masked(m):
        """``m`` in the live lanes, False in the stopped ones."""
        return m if B == 1 else m & live

    def any_lane(m):
        """Whether ``m`` holds in some lane: one device read."""
        return bool(m) if B == 1 else bool(m.any())

    def fval(d):
        """f(d) per lane in the decision precision."""
        return (fterm.value_f64_lanes(d) if hp
                else fterm.value_lanes(d).to(rdt))

    # the one-pass gradient map serves one lane (the JAX batch solver runs
    # none either at this slice's sizes: supports_fusion's 64 MB gate)
    fused = fterm.fused_gradmap(op) if opts.fuse and B == 1 else None
    # zero-matvec FISTA gradient extrapolation: valid when ∇f is affine in
    # d and the gradient at the prox point comes free from the fused pass
    affine_accel = accelerated and fused is not None and fterm.grad_affine
    # kernel K-B4 takes the L1 trial step of real float32 lanes; complex
    # and float64 keep the composition, as in the reference
    if isinstance(gterm, L1Norm) and x0.dtype == torch.float32:
        mu_b4 = torch.as_tensor(gterm.mu, dtype=torch.float32, device=dev)
    else:
        mu_b4 = None

    d0 = op.lanes(x0)
    fwin = torch.full((B, W), -math.inf, dtype=sdt, device=dev)
    fwin[:, 0] = fval(d0)
    gradf = op.rmatvec_lanes(fterm.grad_lanes(d0))
    # FISTA carry: the last prox point, A·(it), its gradient map (affine
    # case only) and the momentum α
    one = torch.ones(B, dtype=rdt, device=dev)
    accel = (((x0, d0, gradf, one) if affine_accel else (x0, d0, one))
             if accelerated else None)

    rec = opts.record_diagnostics

    def zeros(dtype=rdt, shape=()):
        return torch.zeros((B, N) + shape, dtype=dtype, device=dev)

    residuals = zeros() if rec else None
    norm_residuals = zeros() if rec else None
    taus = zeros() if rec else None
    fvals = zeros() if rec else None
    objectives = zeros() if opts.record_objective else None
    backtracks = zeros(torch.int32) if rec else None
    iterates = (zeros(x0.dtype, tuple(x0.shape[1:])) if opts.record_iterates
                else None)

    x = x0
    solution = x0
    best_x = x0
    min_obj = torch.full((B,), math.inf, dtype=rdt, device=dev)
    max_res = torch.full((B,), -math.inf, dtype=rdt, device=dev)
    # a single lane keeps its counts on the host: its iteration count is
    # the loop's and its backtracks are the trials made
    k = None if B == 1 else torch.zeros(B, dtype=torch.int64, device=dev)
    total_bt = 0 if B == 1 else torch.zeros(B, dtype=torch.int64, device=dev)
    nonfinite = torch.zeros(B, dtype=torch.bool, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    it = 0              # every live lane's iteration count
    while it < N:
        x_, g_ = x, gradf

        def fb_step(tau):
            """Forward (gradient) step, backward (prox) step, the step's
            sums, f at the trial point; the fused pass also returns its
            gradient."""
            if mu_b4 is not None:
                x1, nd2, btd, nsm2 = fused_shrink_step(
                    x_.reshape(B, -1), g_.reshape(B, -1), tau, mu_b4)
                x1 = x1.reshape(x_.shape)
                # float64 sums, each used in the precision the
                # composition gives it
                nd2, nsm2 = nd2.to(rdt), nsm2.to(rdt)
                btd = btd if hp else btd.to(rdt)
                x1hat = Dx = None
            else:
                x1hat = x_ - lane(tau, x_) * g_
                x1 = gterm.prox_lanes(x1hat, tau)
                Dx = x1 - x_
                nd2 = lane_norm2(Dx)
                btd = lane_dot64(Dx, g_) if hp else lane_redot(Dx, g_)
                nsm2 = None
            if fused is not None:
                d1, f1, grad1 = fused(x1[0])
                d1, grad1 = d1[None], grad1[None]
                f1 = fval(d1) if hp else f1.to(rdt).reshape(1)
            else:
                d1 = op.lanes(x1)
                f1, grad1 = fval(d1), None
            return _Trial(x1, d1, f1, grad1, nd2, btd, nsm2, x1hat, Dx)

        t = fb_step(tau)
        bt = 0 if B == 1 else torch.zeros(B, dtype=torch.int32, device=dev)
        if opts.backtrack:
            # nonmonotone backtracking line search (Zhang–Hager window); a
            # lane that violates at trial j violated at every trial before,
            # so it has made j shrinks and the trial bound is its own
            M = torch.amax(fwin, dim=1)
            for _ in range(opts.max_backtracks):
                if hp:
                    # the JAX hp slack: 1e-12 plus 64 ulp (float32) of
                    # the f scale, since the iterates are float32-rounded
                    slack = 1e-12 + (64.0 * _EPS32) * (torch.abs(M)
                                                       + torch.abs(t.f1))
                    q = (t.nd2 / (2.0 * tau)).double()
                    suff = M + (t.btd + q)
                    viol = t.f1 - suff > slack
                else:
                    suff = M + t.btd + t.nd2 / (2.0 * tau)
                    viol = t.f1 - 1e-12 > suff
                need = masked(viol)
                if not any_lane(need):
                    break
                tau = torch.where(need, tau * shrink_f, tau)
                new = fb_step(tau)
                t = new if B == 1 else _Trial(*(
                    None if a is None else torch.where(lane(need, a), a, b)
                    for a, b in zip(new, t)))
                bt = bt + (1 if B == 1 else need)
        x1, d1, f1, grad1 = t.x1, t.d1, t.f1, t.grad1

        # residuals, diagnostics, best-iterate tracking
        res = torch.sqrt(t.nd2) / tau
        max_res_t = torch.maximum(max_res, res)
        nsm2 = t.nsm2 if t.nsm2 is not None else lane_norm2(x1 - t.x1hat)
        normalizer = (torch.maximum(torch.sqrt(lane_norm2(g_)),
                                    torch.sqrt(nsm2) / tau) + opts.eps_n)
        nres = res / normalizer
        f1_f = f1.to(rdt)
        obj = (f1_f + gterm.value_lanes(x1).to(rdt) if opts.record_objective
               else None)
        if rec:
            residuals[:, it] = keep(res, residuals[:, it], live)
            norm_residuals[:, it] = keep(nres, norm_residuals[:, it], live)
            taus[:, it] = keep(tau, taus[:, it], live)
            backtracks[:, it] = keep(bt, backtracks[:, it], live)
            if opts.record_objective:
                objectives[:, it] = keep(obj, objectives[:, it], live)
            if opts.record_iterates:
                iterates[:, it] = keep(x1, iterates[:, it], live)
        new_obj = obj if opts.record_objective else res
        better = masked(new_obj < min_obj)
        min_obj = torch.where(better, new_obj, min_obj)
        best_x = torch.where(lane(better, x1), x1, best_x)

        stop = stop_test(opts.stop_rule, res, nres, max_res_t, opts.tol,
                         opts.eps_r)
        if opts.stop_fn is not None:
            counts = k if B > 1 else torch.full((1,), it, device=dev)
            asked = (opts.stop_fn(counts, res, nres, max_res_t, f1_f) if lanes
                     else opts.stop_fn(it, res[0], nres[0], max_res_t[0],
                                       f1_f[0]))
            stop = stop | torch.as_tensor(asked, device=dev).reshape(-1)
        if opts.guard_nonfinite:
            bad = ~(torch.isfinite(f1_f) & torch.isfinite(res))
            stop = stop | bad
            nonfinite = nonfinite | masked(bad)
        if opts.verbose:
            print(f"[fasta-torch] iter {it}  lanes live {int(live.sum())}  "
                  f"tau {float(tau[0]):.3e}  resid {float(res[0]):.3e}  "
                  f"nresid {float(nres[0]):.3e}  f {float(f1_f[0]):.6e}  "
                  f"bt {int(bt[0])}")

        # the mode's next point and stepsize; computed on the stopping
        # iteration too, as in the reference
        x_next, f_record = x1, f1
        if mode == "adaptive":
            # Zhou–Gao–Dai BB stepsize; K-B4 returns neither x̂₁ nor Δx,
            # so they are recomputed for the accepted trial
            gradf1 = (grad1 if fused is not None
                      else op.rmatvec_lanes(fterm.grad_lanes(d1)))
            x1hat = (t.x1hat if t.x1hat is not None
                     else x_ - lane(tau, x_) * g_)
            Dx = t.Dx if t.Dx is not None else x1 - x_
            Dg = gradf1 + (x1hat - x_) / lane(tau, x_)   # == gradf1 - g_
            dotprod = lane_dot64(Dx, Dg).to(rdt) if hp else lane_redot(Dx, Dg)
            nDx2, nDg2 = t.nd2, lane_norm2(Dg)
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
                rdot = lane_dot64(a, c).to(rdt) if hp else lane_redot(a, c)
                alpha0 = torch.where(rdot > 0.0, 1.0, alpha0)
            alpha1 = (1.0 + torch.sqrt(1.0 + 4.0 * alpha0 ** 2)) / 2.0
            beta = (alpha0 - 1.0) / alpha1
            x_next = x1 + lane(beta, x1) * (x1 - x_acc)
            d_next = d1 + lane(beta, d1) * (d1 - d_acc)   # A is linear
            if affine_accel:
                # Aᴴ∇f(d) is affine in d too: the same combination
                gradf1 = grad1 + lane(beta, grad1) * (grad1 - g_acc)
                accel_next = (x1, d1, grad1, alpha1)
            else:
                gradf1 = op.rmatvec_lanes(fterm.grad_lanes(d_next))
                accel_next = (x1, d1, alpha1)
            accel = tuple(keep(a, b, live) for a, b in zip(accel_next, accel))
            tau_next = tau
            # the window sees f at the next search point (the
            # extrapolated y); on a stop the prox-point value
            f_record = torch.where(stop, f1, fval(d_next))
        else:
            gradf1 = (grad1 if fused is not None
                      else op.rmatvec_lanes(fterm.grad_lanes(d1)))
            tau_next = tau
        if rec:
            fvals[:, it] = keep(f_record.to(rdt), fvals[:, it], live)

        slot = (it + 1) % W          # each live lane's k + 1
        fwin[:, slot] = keep(f_record, fwin[:, slot], live)
        total_bt = total_bt + bt        # a stopped lane makes no trials
        # on a stop the loop breaks at the prox iterate; at max_iters
        # FISTA returns the extrapolated point
        sol = (torch.where(lane(stop, x1), x1, x_next) if accelerated
               else x1)
        solution = keep(sol, solution, live)
        x = keep(x_next, x, live)
        gradf = keep(gradf1, gradf, live)
        tau = keep(tau_next, tau, live)
        max_res = keep(max_res_t, max_res, live)
        if B > 1:
            k = k + live
        live = masked(~stop)
        it += 1
        if not any_lane(live):
            break

    converged = ~live & ~nonfinite
    if lanes:
        def host(v):
            return v.cpu().numpy() if torch.is_tensor(v) else np.full(B, v)
        return DeviceResult(
            solution=solution, best_iterate=best_x,
            iteration_count=host(it if B == 1 else k),
            converged=host(converged),
            residuals=residuals, norm_residuals=norm_residuals, taus=taus,
            fvals=fvals, objectives=objectives, backtracks=backtracks,
            total_backtracks=host(total_bt), iterates=iterates,
            nonfinite=host(nonfinite))

    def one_lane(v):
        return None if v is None else v[0]
    return DeviceResult(
        solution=solution[0], best_iterate=best_x[0], iteration_count=it,
        converged=bool(converged[0]), residuals=one_lane(residuals),
        norm_residuals=one_lane(norm_residuals), taus=one_lane(taus),
        fvals=one_lane(fvals), objectives=one_lane(objectives),
        backtracks=one_lane(backtracks), total_backtracks=total_bt,
        iterates=one_lane(iterates), nonfinite=bool(nonfinite[0]))


def make_solver(opts: FastaOptions) -> Callable:
    """Return ``solve(op, fterm, gterm, x0, tau0) -> DeviceResult`` for
    one option set."""
    def solve_fn(op, fterm, gterm, x0, tau0):
        return _solve(opts, op, fterm, gterm, x0, tau0)
    return solve_fn


def make_batch_solver(opts: FastaOptions, in_axes) -> Callable:
    """Return ``solve(op, fterm, gterm, x0, tau0) -> DeviceResult`` that
    solves a family of instances at once over a leading lane axis: a
    regularization sweep (μ of ``L1Norm`` or λ of ``L2Norm2`` per lane),
    many right-hand sides (the smooth term's data per lane), many starts or
    stepsizes; port of ``fasta_tpu/solver.py:751-765``.

    ``in_axes`` names, for (op, fterm, gterm, x0, tau0), ``None`` (shared
    by every lane) or ``0``: the term's one data tensor (b, y, μ, λ or c),
    x0 or τ₀ carries the lane axis.  The lanes run the loop of
    :func:`make_solver` with ``jax.vmap``'s semantics (see ``_solve``): a
    stopped lane is frozen until the last one stops, and each lane's
    trajectory is a separate solve's, up to the rounding of the batched
    products.  With more than one lane the gradient map is the plain
    composition (no fused pass).  The result's tensors gain a leading lane
    axis; its counts and flags are NumPy arrays."""
    axes = tuple(in_axes)
    if len(axes) != 5 or any(a not in (None, 0) for a in axes):
        raise ValueError(f"in_axes names None or 0 for each of (op, fterm, "
                         f"gterm, x0, tau0), got {in_axes!r}")
    if axes[0] == 0:
        raise NotImplementedError(
            "a batched operator (one per lane) is not ported: ROADMAP Queue "
            "A item 5 (make_batch_solver) batches terms, x0 and tau0")

    def solve_fn(op, fterm, gterm, x0, tau0):
        x0 = torch.as_tensor(x0)
        # numbers as float64, so that τ₀ rounds to the working dtype once,
        # as in a single solve
        tau0 = (tau0 if torch.is_tensor(tau0)
                else torch.as_tensor(np.asarray(tau0, np.float64)))
        sizes = {}
        terms = []
        for axis, term, what in ((axes[1], fterm, "fterm"),
                                 (axes[2], gterm, "gterm")):
            if axis == 0:
                term = _lane_term(term, what, x0.device)
                sizes[what] = getattr(term, term.lane_field).shape[0]
            terms.append(term)
        if axes[3] == 0:
            sizes["x0"] = x0.shape[0]
        if axes[4] == 0:
            sizes["tau0"] = tau0.shape[0]
        if not sizes:
            raise ValueError("in_axes batches nothing: name 0 for at least "
                             "one of fterm, gterm, x0 and tau0")
        if len(set(sizes.values())) != 1:
            raise ValueError(f"the batched inputs disagree on the number of "
                             f"lanes: {sizes}")
        B = next(iter(sizes.values()))
        xs = (x0 if axes[3] == 0
              else x0.expand((B,) + tuple(x0.shape))).clone()
        t0 = tau0 if axes[4] == 0 else tau0.expand(B)
        return _solve(opts, op, terms[0], terms[1], xs, t0, lanes=True)
    return solve_fn


def _lane_term(term, what, device):
    """A copy of ``term`` whose data tensor, its leading axis the lanes,
    lies on ``device``; raises for a term without one."""
    field = getattr(term, "lane_field", None)
    if field is None:
        raise ValueError(f"in_axes batches {what}, but "
                         f"{type(term).__name__} has no data tensor to "
                         f"batch")
    data = torch.as_tensor(getattr(term, field), device=device)
    if data.ndim < 1:
        raise ValueError(f"in_axes batches {what}, but its {field} has no "
                         f"leading lane axis")
    out = copy.copy(term)
    setattr(out, field, data)
    return out


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
