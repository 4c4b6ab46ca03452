"""FASTA solver core (port of ``fasta_tpu/solver.py``).

Forward-backward splitting in the three modes of the reference — plain
(fixed stepsize), adaptive (the Zhou–Gao–Dai BB stepsize) and FISTA with
O'Donoghue–Candès restart — with nonmonotone backtracking, the five
stopping rules plus a custom ``stop_fn``, the nonfinite guard,
best-iterate tracking and full per-iteration diagnostics, the
warm-started regularization path ``solve_path``, the batch solver
``make_batch_solver`` and exact mid-run resume (``make_stateful_solver``,
``resume_state``: the loop's carry is a ``SolverState``).  The iteration
math is the JAX solver's — same update order, formulas and guard
constants — so trajectories agree within floating-point tolerance.

Every sum over x goes through the operator's ``signal_sum`` hook
(``LinearOp``): a trial's sums in one call, the iteration's other sums in
one more.  On an operator whose rank holds all of x the hook returns its
arguments; on the x-sharded layouts of ``sharding.py`` each call is one
all-reduce, so the decisions read completed sums, the same on every rank.

The loop runs eagerly in PyTorch on the device of the data, over a
leading lane axis: one solve is one lane, a batch many.  A solve is a
set-up, which builds the state from (x0, τ₀), and the loop, which runs
from a state.  Decisions
(backtracking, stopping) read one device value each, so an iteration
synchronises with the device; the whole-solve kernels
(``fasta_tpu_torch.micro``) keep them on the card.  An L1 trial step of
real float32 data is kernel K-B4 (``kernels/prox_fused.py``), which
returns x₁ and the step's three sums in one pass.  On those lanes the
adaptive mode's sums and its update of the carried tensors are the
kernels of ``kernels/lane_fused.py``, which write only what the loop
carries (x, ∇f, the solution and the best iterate, in place in the
loop's own copies); with the plain least-squares term the residual
d − b and f come from one more, and the trial carries the residual to
the gradient map.
"""

from __future__ import annotations

import copy
import math
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .kernels import lane_fused
from .kernels.prox_fused import fused_shrink_step
from .operators import LinearOp, as_linear_op, check_adjoint
from .options import FastaOptions, stop_test
from .precision import (lane, lane_dot64, lane_norm2, lane_redot, norm2,
                        real_dtype, use_high_precision)
from .profiling import span
from .terms import (L1Norm, LeastSquares, ProxTerm, SmoothTerm,
                    as_prox_term, as_smooth_term)

__all__ = ["fasta", "solve", "make_solver", "make_stateful_solver",
           "resume_state", "make_batch_solver", "solve_path",
           "estimate_stepsize", "FastaResult", "DeviceResult", "SolverState",
           "Diagnostics"]

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


def estimate_stepsize(op: LinearOp, fterm: SmoothTerm, x0: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      points: Optional[tuple] = None) -> tuple:
    """Lipschitz / initial-stepsize estimate from two points:
    L ≈ ‖∇f̃(z₁)−∇f̃(z₂)‖/‖z₁−z₂‖ with ∇f̃(x) = Aᴴ∇f(Ax), τ₀ = (2/L)/10.

    ``points=(z1, z2)`` supplies the two points (generate them once in
    NumPy and feed the same pair to the oracle's ``est_points`` for auto-τ₀
    trajectory parity; on an x-sharded operator, this rank's blocks);
    otherwise they are drawn from ``generator``, which must live on
    ``x0``'s device, through the operator's ``signal_draw``.  The two
    norms are sums over x (``signal_sum``).  Returns (τ₀, L) as 0-d
    tensors."""
    if points is not None:
        z1 = torch.as_tensor(points[0]).to(x0.device, x0.dtype)
        z2 = torch.as_tensor(points[1]).to(x0.device, x0.dtype)
    elif generator is None:
        raise ValueError("estimate_stepsize needs a torch.Generator or "
                         "explicit points")
    else:
        z1, z2 = op.signal_draw(x0, generator), op.signal_draw(x0, generator)
    g1 = op.rmatvec(fterm.grad(op(z1)))
    g2 = op.rmatvec(fterm.grad(op(z2)))
    ng2, nz2 = op.signal_sum(norm2(g1 - g2), norm2(z2 - z1))
    L = torch.sqrt(ng2) / torch.clamp_min(torch.sqrt(nz2), 1e-30)
    L = torch.clamp_min(L, 1e-6)
    return 2.0 / L / 10.0, L


class Diagnostics(NamedTuple):
    """Per-iteration records, one row per iteration up to ``max_iters``
    (``fasta_tpu/solver.py:75-83``); None where the option is off."""
    residuals: Any
    norm_residuals: Any
    taus: Any
    fvals: Any
    objectives: Any        # None unless record_objective
    backtracks: Any
    iterates: Any          # None unless record_iterates


class SolverState(NamedTuple):
    """The loop's carry between two iterations — the whole solver state,
    with the reference's fields in its order (``fasta_tpu/solver.py:86-104``),
    so that ``checkpoint.save_pytree`` writes the same ``.npz`` keys in
    both packages.  One solve's state has no lane axis: ``k`` (int32) and
    ``stop`` (bool) are 0-d tensors, ``fwin`` (W,) in the decision
    precision (float64 under hp, where the JAX package keeps a double-word
    pair), the records (``max_iters``, ...).  ``accel`` is the FISTA carry
    — (x, A x, Aᴴ∇f, α) when the one-pass gradient map serves an affine
    loss, else (x, A x, α) — or None outside FISTA."""
    k: Any
    stop: Any
    x1: Any                # the next search point (y in FISTA terms)
    gradf1: Any            # Aᴴ ∇f(A x1)
    tau1: Any              # the stepsize entering the next iteration
    fwin: Any              # the nonmonotone window's ring (W,)
    solution: Any
    best_x: Any
    min_objective: Any
    max_residual: Any
    total_bt: Any
    accel: Any
    nonfinite: Any
    diags: Diagnostics


class _Trial(NamedTuple):
    """One line-search trial over the lanes: the prox point, A x₁, f(A x₁)
    in the decision precision, the fused pass's gradient (or None), ‖Δx‖²
    and ⟨Δx, g⟩ (the latter in the decision precision), either
    ‖x₁ − x̂₁‖² (kernel K-B4) or the composition's x̂₁ and Δx, and the
    residual A x₁ − b where the lane kernels computed it (or None)."""
    x1: Any
    d1: Any
    f1: Any
    grad1: Any
    nd2: Any
    btd: Any
    nsm2: Any
    x1hat: Any
    Dx: Any
    r: Any


class _Setting(NamedTuple):
    """What the set-up and the loop derive from the options, the terms and
    the lanes of the iterate x (B, ...)."""
    B: int
    dev: torch.device
    rdt: torch.dtype
    hp: bool
    sdt: torch.dtype          # decision-scalar dtype
    fused: Optional[Callable]
    fused_f64: bool           # the fused map's f is the hp decision value
    affine_accel: bool
    mu_b4: Optional[torch.Tensor]
    lanes_fused: bool         # the adaptive sums and update are lane_fused's
    residual: bool            # and the residual with f too


def _setting(opts: FastaOptions, op: LinearOp, fterm: SmoothTerm,
             gterm: ProxTerm, x) -> _Setting:
    B = x.shape[0]
    rdt = real_dtype(x.dtype)
    hp = use_high_precision(opts.precision, x.dtype)
    # the one-pass gradient map serves one lane (the JAX batch solver runs
    # none either at this slice's sizes: supports_fusion's 64 MB gate)
    fused = fterm.fused_gradmap(op) if opts.fuse and B == 1 else None
    # a map that gives f in the decision precision itself (the row-sharded
    # maps, whose one all-reduce then carries it): hp takes that f rather
    # than evaluate f(d) again, which would be a second collective
    fused_f64 = hp and hasattr(fused, "decision_precision")
    if fused_f64:
        fused = fused.decision_precision()
    # zero-matvec FISTA gradient extrapolation: valid when ∇f is affine in
    # d and the gradient at the prox point comes free from the fused pass
    # (a row-sharded map over a two-call pass says no: its ``affine``)
    affine_accel = (opts.effective_mode == "accelerated"
                    and fused is not None and fterm.grad_affine
                    and getattr(fused, "affine", True))
    # kernel K-B4 takes the L1 trial step of real float32 lanes (on this
    # rank's block where x is sharded); complex and float64 keep the
    # composition, as in the reference
    g_block = gterm.block_term
    mu_b4 = (torch.as_tensor(g_block.mu, dtype=torch.float32,
                             device=x.device)
             if isinstance(g_block, L1Norm) and x.dtype == torch.float32
             else None)
    # on those lanes the adaptive loop's sums and update are the lane
    # kernels (an iterate record keeps the composition), and the residual
    # with f is one more where f is the plain least-squares term; decided
    # here, once a solve
    lanes_fused = (mu_b4 is not None and opts.effective_mode == "adaptive"
                   and not opts.record_iterates
                   and lane_fused.lanes_route(x))
    residual = (lanes_fused and type(fterm) is LeastSquares
                and lane_fused.residual_route(fterm.b, B, x.device))
    return _Setting(B, x.device, rdt, hp, torch.float64 if hp else rdt,
                    fused, fused_f64, affine_accel, mu_b4, lanes_fused,
                    residual)


def _fval_r(st: _Setting, fterm: SmoothTerm, d):
    """f(d) per lane in the decision precision, and the residual d − b
    where the lane kernel computed it along (else None).  A real operator
    gives float32 d on every trial of a solve, a complex one never."""
    if st.residual and d.dtype == torch.float32:
        r, f = lane_fused.residual_value(d.contiguous(), fterm.b, st.hp)
        return f, r
    return (fterm.value_f64_lanes(d) if st.hp
            else fterm.value_lanes(d).to(st.rdt)), None


def _grad_map(op: LinearOp, fterm: SmoothTerm, d, r):
    """Aᴴ∇f(d), from the residual r = ∇f(d) where the trial carries it."""
    return op.rmatvec_lanes(fterm.grad_lanes(d) if r is None else r)


def _setup(opts: FastaOptions, st: _Setting, op: LinearOp,
           fterm: SmoothTerm, x0, tau0) -> SolverState:
    """The state before the first iteration, over the lanes of x0 (B, ...):
    A x0, the window holding f(A x0), the first gradient map, the FISTA
    carry and zeroed records.  The counts are host ints for one lane and
    tensors for several; ``stop`` is None (every lane live)."""
    B, dev, rdt = st.B, st.dev, st.rdt
    W, N = opts.window, opts.max_iters
    tau = torch.as_tensor(tau0, dtype=rdt).to(dev).expand(B).clone()
    d0 = op.lanes(x0)
    fwin = torch.full((B, W), -math.inf, dtype=st.sdt, device=dev)
    f0, r0 = _fval_r(st, fterm, d0)
    fwin[:, 0] = f0
    gradf = _grad_map(op, fterm, d0, r0)
    # FISTA carry: the last prox point, A·(it), its gradient map (affine
    # case only) and the momentum α
    one = torch.ones(B, dtype=rdt, device=dev)
    accel = (((x0, d0, gradf, one) if st.affine_accel else (x0, d0, one))
             if opts.effective_mode == "accelerated" else None)

    rec = opts.record_diagnostics

    def zeros(dtype=rdt, shape=()):
        return torch.zeros((B, N) + shape, dtype=dtype, device=dev)

    diags = Diagnostics(
        residuals=zeros() if rec else None,
        norm_residuals=zeros() if rec else None,
        taus=zeros() if rec else None,
        fvals=zeros() if rec else None,
        objectives=zeros() if opts.record_objective else None,
        backtracks=zeros(torch.int32) if rec else None,
        iterates=(zeros(x0.dtype, tuple(x0.shape[1:]))
                  if opts.record_iterates else None))
    # a single lane keeps its counts on the host: its iteration count is
    # the loop's and its backtracks are the trials made
    counts = (0 if B == 1
              else torch.zeros(B, dtype=torch.int64, device=dev))
    return SolverState(
        k=counts, stop=None, x1=x0, gradf1=gradf, tau1=tau, fwin=fwin,
        solution=x0, best_x=x0,
        min_objective=torch.full((B,), math.inf, dtype=rdt, device=dev),
        max_residual=torch.full((B,), -math.inf, dtype=rdt, device=dev),
        total_bt=(0 if B == 1
                  else torch.zeros(B, dtype=torch.int64, device=dev)),
        accel=accel,
        nonfinite=torch.zeros(B, dtype=torch.bool, device=dev),
        diags=diags)


def _run(opts: FastaOptions, st: _Setting, op: LinearOp, fterm: SmoothTerm,
         gterm: ProxTerm, s: SolverState, it: int, lanes: bool,
         with_state: bool = False):
    """The FASTA loop over a leading lane axis, from the lane state ``s``
    (of :func:`_setup`, or of :func:`_lane_state` on resume) and the loop
    count ``it``, up to ``opts.max_iters``.  Returns ``(DeviceResult,
    SolverState)``: the lane state after the last iteration when
    ``with_state``, else None.

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
    B, dev, rdt, hp = st.B, st.dev, st.rdt, st.hp
    fused, affine_accel, mu_b4 = st.fused, st.affine_accel, st.mu_b4
    W, N = opts.window, opts.max_iters
    shrink_f = opts.shrink_factor

    def keep(new, old, live):
        """``new`` in the live lanes, ``old`` in the stopped ones (one lane
        is live while the loop runs)."""
        return new if B == 1 else torch.where(lane(live, new), new, old)

    def masked(m):
        """``m`` in the live lanes, False in the stopped ones."""
        return m if B == 1 else m & live

    def any_lane(m, cause):
        """Whether ``m`` holds in some lane: one device read, the span
        ``fasta.loop.read.<cause>``."""
        with span(f"fasta.loop.read.{cause}"):
            return bool(m) if B == 1 else bool(m.any())

    def fval(d):
        return _fval_r(st, fterm, d)[0]

    x, gradf, tau, fwin = s.x1, s.gradf1, s.tau1, s.fwin
    solution, best_x = s.solution, s.best_x
    if st.lanes_fused:
        # the lane update writes these in place: the loop's own copies,
        # never the caller's x0 or state, nor a tensor an operator handed
        # back (a FunctionOp's adjoint may return its argument); in
        # adaptive mode the solution is x₁ at every point, so x is both
        x, gradf, best_x = (t.clone(memory_format=torch.contiguous_format)
                            for t in (x, gradf, best_x))
        solution = x
    min_obj, max_res = s.min_objective, s.max_residual
    k, total_bt, accel, nonfinite = s.k, s.total_bt, s.accel, s.nonfinite
    (residuals, norm_residuals, taus, fvals, objectives, backtracks,
     iterates) = s.diags
    rec = opts.record_diagnostics
    if s.stop is None:
        live, running = torch.ones(B, dtype=torch.bool, device=dev), True
    else:
        # a resumed state that has stopped runs no iteration (one device
        # read at the state's edge; a fresh solve reads none)
        live = ~s.stop
        running = any_lane(live, "resume")
    while running and it < N:
        with span("fasta.loop.iteration"):
            x_, g_ = x, gradf

            def fb_step(tau):
                """Forward (gradient) step, backward (prox) step, the step's
                sums, f at the trial point; the fused pass also returns its
                gradient."""
                if mu_b4 is not None:
                    x1, nd2, btd, nsm2 = fused_shrink_step(
                        x_.reshape(B, -1), g_.reshape(B, -1), tau, mu_b4)
                    x1 = x1.reshape(x_.shape)
                    # float64 sums over x, completed, each then used in the
                    # precision the composition gives it
                    nd2, btd, nsm2 = op.signal_sum(nd2, btd, nsm2)
                    nd2, nsm2 = nd2.to(rdt), nsm2.to(rdt)
                    btd = btd if hp else btd.to(rdt)
                    x1hat = Dx = None
                else:
                    x1hat = x_ - lane(tau, x_) * g_
                    x1 = gterm.prox_lanes(x1hat, tau)
                    Dx = x1 - x_
                    nd2, btd = op.signal_sum(
                        lane_norm2(Dx),
                        lane_dot64(Dx, g_) if hp else lane_redot(Dx, g_))
                    nsm2 = None
                r = None
                if fused is not None:
                    d1, f1, grad1 = fused(x1[0])
                    d1, grad1 = d1[None], grad1[None]
                    f1 = (fval(d1) if hp and not st.fused_f64
                          else f1.to(st.sdt).reshape(1))
                else:
                    d1, grad1 = op.lanes(x1), None
                    f1, r = _fval_r(st, fterm, d1)
                return _Trial(x1, d1, f1, grad1, nd2, btd, nsm2, x1hat, Dx,
                              r)

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
                    if not any_lane(need, "backtrack"):
                        break
                    tau = torch.where(need, tau * shrink_f, tau)
                    new = fb_step(tau)
                    t = new if B == 1 else _Trial(*(
                        None if a is None else torch.where(lane(need, a), a, b)
                        for a, b in zip(new, t)))
                    bt = bt + (1 if B == 1 else need)
            x1, d1, f1, grad1 = t.x1, t.d1, t.f1, t.grad1

            # the mode's inputs to the iteration's sums over x
            bb = None
            if mode == "adaptive":
                # Zhou–Gao–Dai BB stepsize; K-B4 returns neither x̂₁ nor Δx,
                # so they are recomputed for the accepted trial (in the
                # lane kernel's registers, where it takes the lanes)
                gradf1 = (grad1 if fused is not None
                          else _grad_map(op, fterm, d1, t.r))
                if st.lanes_fused:
                    gradf1 = gradf1.contiguous()
                    bb = lane_fused.adaptive_sums(x_, g_, x1, gradf1, tau,
                                                  hp)
                else:
                    x1hat = (t.x1hat if t.x1hat is not None
                             else x_ - lane(tau, x_) * g_)
                    Dx = t.Dx if t.Dx is not None else x1 - x_
                    Dg = gradf1 + (x1hat - x_) / lane(tau, x_)   # gradf1 - g_
            elif accelerated:
                if affine_accel:
                    x_acc, d_acc, g_acc, alpha0 = accel
                else:
                    x_acc, d_acc, alpha0 = accel
            # the iteration's sums over x, completed in one call of the hook:
            # the normalizer's ‖g‖² and ‖x₁ − x̂₁‖², the objective's g, the BB
            # pair, FISTA's restart dot
            parts = {"ng2": lane_norm2(g_) if bb is None else bb[0]}
            if t.nsm2 is None:
                parts["nsm2"] = lane_norm2(x1 - t.x1hat)
            g_part = (gterm.partial_value_lanes(x1) if opts.record_objective
                      else None)
            if g_part is not None:
                parts["g"] = g_part
            if bb is not None:
                parts["dot"], parts["nDg2"] = bb[1], bb[2]
            elif mode == "adaptive":
                parts["dot"] = (lane_dot64(Dx, Dg) if hp
                                else lane_redot(Dx, Dg))
                parts["nDg2"] = lane_norm2(Dg)
            elif accelerated and opts.restart:
                a, c = x_ - x1, x1 - x_acc
                parts["rdot"] = lane_dot64(a, c) if hp else lane_redot(a, c)
            sums = dict(zip(parts, op.signal_sum(*parts.values())))

            # residuals, diagnostics, best-iterate tracking
            res = torch.sqrt(t.nd2) / tau
            max_res_t = torch.maximum(max_res, res)
            nsm2 = t.nsm2 if t.nsm2 is not None else sums["nsm2"]
            normalizer = (torch.maximum(torch.sqrt(sums["ng2"]),
                                        torch.sqrt(nsm2) / tau) + opts.eps_n)
            nres = res / normalizer
            f1_f = f1.to(rdt)
            obj = None
            if opts.record_objective:
                g_val = (sums["g"] if g_part is not None
                         else gterm.value_lanes(x1))
                obj = f1_f + g_val.to(rdt)
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

            stop = stop_test(opts.stop_rule, res, nres, max_res_t, opts.tol,
                             opts.eps_r)
            if opts.stop_fn is not None:
                counts = k if B > 1 else torch.full((1,), it, device=dev)
                asked = (opts.stop_fn(counts, res, nres, max_res_t, f1_f)
                         if lanes
                         else opts.stop_fn(it, res[0], nres[0], max_res_t[0],
                                           f1_f[0]))
                stop = stop | torch.as_tensor(asked, device=dev).reshape(-1)
            if opts.guard_nonfinite:
                bad = ~(torch.isfinite(f1_f) & torch.isfinite(res))
                stop = stop | bad
                nonfinite = nonfinite | masked(bad)
            if opts.verbose:
                print(f"[fasta-torch] iter {it}  "
                      f"lanes live {int(live.sum())}  "
                      f"tau {float(tau[0]):.3e}  resid {float(res[0]):.3e}  "
                      f"nresid {float(nres[0]):.3e}  f {float(f1_f[0]):.6e}  "
                      f"bt {int(bt[0]) if torch.is_tensor(bt) else bt}")

            # the mode's next point and stepsize; computed on the stopping
            # iteration too, as in the reference
            x_next, f_record = x1, f1
            if mode == "adaptive":
                dotprod = sums["dot"].to(rdt) if hp else sums["dot"]
                nDx2, nDg2 = t.nd2, sums["nDg2"]
                tau_s = torch.where(dotprod != 0.0, nDx2 / dotprod, math.inf)
                tau_m = torch.clamp_min(
                    torch.where(nDg2 > 0.0, dotprod / nDg2, 0.0), 0.0)
                tau_next = torch.where(2.0 * tau_m > tau_s, tau_m,
                                       tau_s - 0.5 * tau_m)
                degenerate = ((tau_next <= 0.0) | torch.isinf(tau_next)
                              | torch.isnan(tau_next))
                tau_next = torch.where(degenerate, tau * 1.5, tau_next)
            elif accelerated:
                if opts.restart:
                    # O'Donoghue–Candès gradient restart
                    rdot = sums["rdot"].to(rdt) if hp else sums["rdot"]
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
                accel = tuple(keep(a, b, live)
                              for a, b in zip(accel_next, accel))
                tau_next = tau
                # the window sees f at the next search point (the
                # extrapolated y); on a stop the prox-point value
                f_record = torch.where(stop, f1, fval(d_next))
            else:
                gradf1 = (grad1 if fused is not None
                          else _grad_map(op, fterm, d1, t.r))
                tau_next = tau
            if rec:
                fvals[:, it] = keep(f_record.to(rdt), fvals[:, it], live)

            slot = (it + 1) % W          # each live lane's k + 1
            fwin[:, slot] = keep(f_record, fwin[:, slot], live)
            total_bt = total_bt + bt        # a stopped lane makes no trials
            # on a stop the loop breaks at the prox iterate; at max_iters
            # FISTA returns the extrapolated point
            if st.lanes_fused:
                # adaptive: the next point, and so the solution, is x₁
                lane_fused.lane_update(x1, gradf1, live, better, x, gradf,
                                       best_x)
            else:
                sol = (torch.where(lane(stop, x1), x1, x_next)
                       if accelerated else x1)
                solution = keep(sol, solution, live)
                x = keep(x_next, x, live)
                gradf = keep(gradf1, gradf, live)
                best_x = torch.where(lane(better, x1), x1, best_x)
            tau = keep(tau_next, tau, live)
            max_res = keep(max_res_t, max_res, live)
            if B > 1:
                k = k + live
            live = masked(~stop)
            it += 1
            if not any_lane(live, "stop"):
                break

    if B == 1:
        k = it
    diags = Diagnostics(residuals, norm_residuals, taus, fvals, objectives,
                        backtracks, iterates)
    state = (SolverState(
        k=k, stop=~live, x1=x, gradf1=gradf, tau1=tau, fwin=fwin,
        solution=solution, best_x=best_x, min_objective=min_obj,
        max_residual=max_res, total_bt=total_bt, accel=accel,
        nonfinite=nonfinite, diags=diags) if with_state else None)
    with span("fasta.loop.result"):
        converged = ~live & ~nonfinite
        if lanes:
            def host(v):
                return (v.cpu().numpy() if torch.is_tensor(v)
                        else np.full(B, v))
            return DeviceResult(
                solution=solution, best_iterate=best_x,
                iteration_count=host(k), converged=host(converged),
                residuals=residuals, norm_residuals=norm_residuals,
                taus=taus, fvals=fvals, objectives=objectives,
                backtracks=backtracks, total_backtracks=host(total_bt),
                iterates=iterates, nonfinite=host(nonfinite)), state

        def one_lane(v):
            return None if v is None else v[0]
        return DeviceResult(
            solution=solution[0], best_iterate=best_x[0],
            iteration_count=it, converged=bool(converged[0]),
            residuals=one_lane(residuals),
            norm_residuals=one_lane(norm_residuals), taus=one_lane(taus),
            fvals=one_lane(fvals), objectives=one_lane(objectives),
            backtracks=one_lane(backtracks), total_backtracks=total_bt,
            iterates=one_lane(iterates),
            nonfinite=bool(nonfinite[0])), state


def _solve(opts: FastaOptions, op: LinearOp, fterm: SmoothTerm,
           gterm: ProxTerm, x0, tau0, lanes: bool = False,
           with_state: bool = False):
    """Set-up from (x0, τ₀), then the loop: ``(DeviceResult, SolverState
    or None)``.  ``lanes=False``: one solve, x0 without a lane axis."""
    x0 = torch.as_tensor(x0)
    if not lanes:
        x0 = x0[None]
    with span("fasta.loop.setup"):
        st = _setting(opts, op, fterm, gterm, x0)
        s = _setup(opts, st, op, fterm, x0, tau0)
    return _run(opts, st, op, fterm, gterm, s, 0, lanes, with_state)


def _single_state(s: SolverState) -> SolverState:
    """One lane's loop state as the public state: no lane axis; the host
    counts and the flag as 0-d tensors (int32, bool), as in the JAX
    package."""
    dev = s.x1.device

    def one(v):
        return None if v is None else v[0]
    return SolverState(
        k=torch.tensor(s.k, dtype=torch.int32, device=dev),
        stop=s.stop[0], x1=s.x1[0], gradf1=s.gradf1[0], tau1=s.tau1[0],
        fwin=s.fwin[0], solution=s.solution[0], best_x=s.best_x[0],
        min_objective=s.min_objective[0], max_residual=s.max_residual[0],
        total_bt=torch.tensor(s.total_bt, dtype=torch.int32, device=dev),
        accel=None if s.accel is None else tuple(a[0] for a in s.accel),
        nonfinite=s.nonfinite[0],
        diags=Diagnostics(*(one(v) for v in s.diags)))


def _lane_state(state: SolverState, max_iters: int) -> SolverState:
    """A public state as the loop's one-lane state: the counts read to the
    host (the one device read of a resume), the window and the records
    copied — the loop writes them in place — and the records zero-padded
    to ``max_iters``."""
    def rows(a):
        if a is None:
            return None
        if a.shape[0] > max_iters:
            raise ValueError(
                f"resume_state: opts.max_iters={max_iters} is shorter than "
                f"the checkpoint's recorded diagnostics ({a.shape[0]}); "
                f"max_iters is the TOTAL budget including completed "
                f"iterations")
        pad = a.new_zeros((max_iters - a.shape[0],) + tuple(a.shape[1:]))
        return torch.cat([a, pad])[None]
    return SolverState(
        k=int(state.k), stop=state.stop.reshape(1), x1=state.x1[None],
        gradf1=state.gradf1[None], tau1=state.tau1.reshape(1),
        fwin=state.fwin[None].clone(), solution=state.solution[None],
        best_x=state.best_x[None],
        min_objective=state.min_objective.reshape(1),
        max_residual=state.max_residual.reshape(1),
        total_bt=int(state.total_bt),
        accel=(None if state.accel is None
               else tuple(a[None] for a in state.accel)),
        nonfinite=state.nonfinite.reshape(1),
        diags=Diagnostics(*(rows(a) for a in state.diags)))


class _LRUCache:
    """A bounded cache of solve functions, one per option set
    (``fasta_tpu/solver.py:606-638``): the least recently used entry goes
    when a new one would pass ``capacity``."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._d = OrderedDict()

    def get(self, key):
        fn = self._d.get(key)
        if fn is not None:
            self._d.move_to_end(key)
        return fn

    def put(self, key, fn):
        self._d[key] = fn
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


_SOLVER_CACHE = _LRUCache()


def _cached(kind: str, opts: FastaOptions, build: Callable) -> Callable:
    # keyed by the options alone: the JAX package adds the environment
    # variables its tracing reads, and the port reads none at solve time
    key = (kind, opts)
    fn = _SOLVER_CACHE.get(key)
    if fn is None:
        fn = build()
        _SOLVER_CACHE.put(key, fn)
    return fn


def make_solver(opts: FastaOptions) -> Callable:
    """Return ``solve(op, fterm, gterm, x0, tau0) -> DeviceResult`` for
    one option set; one function per option set, from a bounded cache."""
    def build():
        def solve_fn(op, fterm, gterm, x0, tau0):
            return _solve(opts, op, fterm, gterm, x0, tau0)[0]
        return solve_fn
    return _cached("solve", opts, build)


def make_stateful_solver(opts: FastaOptions) -> Callable:
    """Like :func:`make_solver`, but ``solve`` returns ``(DeviceResult,
    SolverState)``: the state after the last iteration, which
    ``checkpoint.save_pytree`` writes and :func:`resume_state` continues
    bit for bit (``fasta_tpu/solver.py:675-683``)."""
    def build():
        def solve_fn(op, fterm, gterm, x0, tau0):
            out, s = _solve(opts, op, fterm, gterm, x0, tau0,
                            with_state=True)
            return out, _single_state(s)
        return solve_fn
    return _cached("solve_state", opts, build)


def _check_resume_diags(state: SolverState, opts: FastaOptions):
    d = state.diags
    for optname, arr, want in (("record_diagnostics", d.taus,
                                opts.record_diagnostics),
                               ("record_objective", d.objectives,
                                opts.record_objective),
                               ("record_iterates", d.iterates,
                                opts.record_iterates)):
        if (arr is None) == bool(want):
            raise ValueError(
                f"resume_state: options.{optname}={want} does not match "
                f"the checkpointed state (which "
                f"{'has' if arr is not None else 'lacks'} that "
                f"recording); resume with the recording options the run "
                f"was saved under")


def resume_state(op: LinearOp, fterm: SmoothTerm, gterm: ProxTerm,
                 state: SolverState, opts: Optional[FastaOptions] = None):
    """Continue a solve exactly from its ``SolverState``
    (``fasta_tpu/solver.py:703-742``).

    ``state`` is what :func:`make_stateful_solver` or an earlier
    ``resume_state`` returned, or one loaded back with
    ``checkpoint.load_pytree`` (or built from the JAX package's state by
    ``convert.solver_state_from_arrays``), its tensors on the device of
    the problem.  The window, the FISTA momentum, the stepsize, the best
    iterate and the records' cursor all continue, so the resumed
    trajectory equals the uninterrupted run bit for bit (unlike
    ``checkpoint.resume``, which restarts from (x, τ)).

    ``opts.max_iters`` is the TOTAL budget (the count continues from
    ``state.k``); the records are zero-padded up to it, and a budget
    shorter than the records raises.  The other options must be the
    run's: they choose the loop, and a recording option or a FISTA carry
    that does not match the state raises.  A stopped state resumes as a
    no-op.  Returns ``(DeviceResult, SolverState)``."""
    opts = opts or FastaOptions()
    _check_resume_diags(state, opts)
    s = _lane_state(state, opts.max_iters)
    st = _setting(opts, op, fterm, gterm, s.x1)
    accelerated = opts.effective_mode == "accelerated"
    want = (4 if st.affine_accel else 3) if accelerated else None
    have = None if s.accel is None else len(s.accel)
    if want != have:
        raise ValueError(
            f"resume_state: the options' mode ({opts.effective_mode}) takes "
            f"a FISTA carry of {want} fields, the state holds {have}; "
            f"resume with the mode and the fuse option of the run")
    out, s = _run(opts, st, op, fterm, gterm, s, s.k, False,
                  with_state=True)
    return out, _single_state(s)


def make_batch_solver(opts: FastaOptions, in_axes) -> Callable:
    """Return ``solve(op, fterm, gterm, x0, tau0) -> DeviceResult`` that
    solves a family of instances at once over a leading lane axis: a
    regularization sweep (μ of ``L1Norm`` or λ of ``L2Norm2`` per lane),
    many right-hand sides (the smooth term's data per lane), many starts or
    stepsizes; port of ``fasta_tpu/solver.py:751-765``.

    ``in_axes`` names, for (op, fterm, gterm, x0, tau0), ``None`` (shared
    by every lane) or ``0``: the operator's matrix (a ``DenseOp``'s A, a
    ``PlanarDenseOp``'s Ar and Ai: one matrix a lane, their products
    ``torch.matmul`` over the lanes), the term's one data tensor (b, y, μ,
    λ or c), x0 or τ₀ carries the lane axis.  The lanes run the loop of
    :func:`make_solver` with ``jax.vmap``'s semantics (see ``_run``): a
    stopped lane is frozen until the last one stops, and each lane's
    trajectory is a separate solve's, up to the rounding of the batched
    products.  With more than one lane, or a batched operator, the
    gradient map is the plain composition (no fused pass).  The result's
    tensors gain a leading lane axis; its counts and flags are NumPy
    arrays.  Over an operator whose rank holds a block of the lanes
    (``sharding.shard_problem`` of a stacked operator) each rank runs its
    own lanes, and the result holds every rank's (the operator's
    ``gather_lanes``)."""
    axes = tuple(in_axes)
    if len(axes) != 5 or any(a not in (None, 0) for a in axes):
        raise ValueError(f"in_axes names None or 0 for each of (op, fterm, "
                         f"gterm, x0, tau0), got {in_axes!r}")

    def solve_fn(op, fterm, gterm, x0, tau0):
        x0 = torch.as_tensor(x0)
        # numbers as float64, so that τ₀ rounds to the working dtype once,
        # as in a single solve
        tau0 = (tau0 if torch.is_tensor(tau0)
                else torch.as_tensor(np.asarray(tau0, np.float64)))
        sizes = {}
        if axes[0] == 0:
            op = _lane_op(op, x0.device)
            sizes["op"] = getattr(op, op.lane_fields[0]).shape[0]
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
                             "one of op, fterm, gterm, x0 and tau0")
        if len(set(sizes.values())) != 1:
            raise ValueError(f"the batched inputs disagree on the number of "
                             f"lanes: {sizes}")
        B = next(iter(sizes.values()))
        xs = (x0 if axes[3] == 0
              else x0.expand((B,) + tuple(x0.shape))).clone()
        t0 = tau0 if axes[4] == 0 else tau0.expand(B)
        out = _solve(opts, op, terms[0], terms[1], xs, t0, lanes=True)[0]
        return op.gather_lanes(out)
    return solve_fn


def _lane_op(op, device):
    """A copy of ``op`` whose matrices, their leading axis the lanes, lie on
    ``device``; raises for an operator without a matrix to batch."""
    fields = getattr(op, "lane_fields", None)
    if fields is None:
        raise ValueError(f"in_axes batches op, but {type(op).__name__} has "
                         f"no matrix to batch (DenseOp and PlanarDenseOp "
                         f"have)")
    out = copy.copy(op)
    for field in fields:
        data = torch.as_tensor(getattr(op, field), device=device)
        if data.ndim != 3:
            raise ValueError(f"in_axes batches op, but its {field} of shape "
                             f"{tuple(data.shape)} is not a stack of "
                             f"matrices (lanes, m, n)")
        setattr(out, field, data)
    return out


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
        r = _solve(opts, op, fterm, g, x, tau)[0]
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
    key: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
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
    device.  ``key`` (an int, 0 when neither it nor ``generator`` is
    given) seeds the ``torch.Generator`` that draws the random points of
    the stepsize estimate and the adjoint check: the reference's
    ``key`` in the same role, not the same random points (torch's
    generator is not JAX's PRNG; ``est_points`` gives both packages one
    pair).  ``generator`` passes a ``torch.Generator`` on that device
    instead; passing both raises ``ValueError``."""
    if key is not None and generator is not None:
        raise ValueError("fasta: pass key (an int seed) or generator (a "
                         "torch.Generator), not both")
    opts = options or FastaOptions()
    if opt_kwargs:
        opts = opts.replace(**opt_kwargs)
    target = _target_device(device, A, x0)
    op = as_linear_op(A, At, device=target)
    fterm = as_smooth_term(f, gradf)
    gterm = as_prox_term(g, proxg)
    x0 = torch.as_tensor(x0, device=None if isinstance(x0, torch.Tensor)
                         else target)
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(
            0 if key is None else int(key))

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
