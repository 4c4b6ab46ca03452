"""FASTA's adaptive mode in plain PyTorch, many independent instances at
once: a frozen copy of the float64 oracle's algorithm
(``reference_oracle/fasta_numpy.py``, from arXiv:1411.3406 and
arXiv:1501.04979), in the dtype of the start it is given.

Each instance takes its own stepsizes, backtracks, window and stopping
decision, exactly as a separate call of the oracle would; a stopped
instance is frozen.  Only what the benchmark's configurations state is
implemented: the adaptive Zhou–Gao–Dai stepsize, nonmonotone
backtracking and the hybrid residual stopping rule."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Solved(NamedTuple):
    solution: torch.Tensor       # (N, ...) each instance's last iterate
    iterations: torch.Tensor     # (N,) int64
    backtracks: torch.Tensor     # (N,) int64, over all iterations
    converged: torch.Tensor      # (N,) bool


def _sum(a: torch.Tensor) -> torch.Tensor:
    """Per-instance sum over every axis but the first."""
    return a.reshape(a.shape[0], -1).sum(dim=1)


def _lane(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def solve(A: Callable, At: Callable, f: Callable, gradf: Callable,
          prox: Callable, x0: torch.Tensor, tau0: float, *, tol: float,
          max_iters: int, window: int = 10, max_backtracks: int = 20,
          shrink: float = 0.2, eps_r: float = 1e-8,
          eps_n: float = 1e-8) -> Solved:
    """Solve min f(A x) + g(x) for each instance of ``x0`` (N, ...) from
    τ₀, in ``x0``'s dtype.  ``A``, ``At`` and ``gradf`` map batches, ``f``
    gives one value an instance and ``prox(z, tau)`` takes one τ an
    instance (N,)."""
    N = x0.shape[0]
    dev, dt = x0.device, x0.dtype
    x1 = x0.clone()
    d1 = A(x1)
    f1 = f(d1)
    g1 = At(gradf(d1))
    tau1 = torch.full((N,), tau0, dtype=dt, device=dev)
    fwin = torch.full((N, window), -torch.inf, dtype=dt, device=dev)
    fwin[:, 0] = f1
    max_res = torch.full((N,), -torch.inf, dtype=dt, device=dev)
    live = torch.ones(N, dtype=torch.bool, device=dev)
    iters = torch.zeros(N, dtype=torch.int64, device=dev)
    bts = torch.zeros(N, dtype=torch.int64, device=dev)
    converged = torch.zeros(N, dtype=torch.bool, device=dev)
    sol = x1.clone()

    for i in range(max_iters):
        x0_, g0, tau = x1, g1, tau1

        def trial(tau):
            x1hat = x0_ - _lane(tau, x0_) * g0
            x1 = prox(x1hat, tau)
            dx = x1 - x0_
            d1 = A(x1)
            return x1hat, x1, dx, d1, f(d1)

        x1hat, x1, dx, d1, f1 = trial(tau)
        M = fwin.max(dim=1).values
        bt = torch.zeros(N, dtype=torch.int64, device=dev)
        for _ in range(max_backtracks):
            viol = live & (f1 - 1e-12 > M + _sum(dx * g0)
                           + _sum(dx * dx) / (2.0 * tau))
            if not bool(viol.any()):
                break
            tau = torch.where(viol, tau * shrink, tau)
            new = trial(tau)
            x1hat, x1, dx, d1, f1 = (torch.where(_lane(viol, a), a, b)
                                     for a, b in zip(new, (x1hat, x1, dx,
                                                           d1, f1)))
            bt = bt + viol
        res = torch.sqrt(_sum(dx * dx)) / tau
        max_res = torch.where(live, torch.maximum(max_res, res), max_res)
        normalizer = torch.maximum(torch.sqrt(_sum(g0 * g0)),
                                   torch.sqrt(_sum((x1 - x1hat) ** 2)) / tau)
        nres = res / (normalizer + eps_n)
        stop = (res / (max_res + eps_r) < tol) | (nres < tol)

        g1n = At(gradf(d1))
        dg = g1n + (x1hat - x0_) / _lane(tau, x0_)
        dot = _sum(dx * dg)
        ndg2 = _sum(dg * dg)
        tau_s = torch.where(dot != 0, _sum(dx * dx) / dot, torch.inf)
        tau_m = torch.clamp_min(torch.where(ndg2 > 0, dot / ndg2, 0.0), 0.0)
        tau_n = torch.where(2.0 * tau_m > tau_s, tau_m, tau_s - 0.5 * tau_m)
        bad = (tau_n <= 0) | torch.isinf(tau_n) | torch.isnan(tau_n)
        tau_n = torch.where(bad, tau * 1.5, tau_n)

        fwin[:, (i + 1) % window] = torch.where(live, f1,
                                                fwin[:, (i + 1) % window])
        iters = iters + live
        bts = bts + bt
        sol = torch.where(_lane(live, sol), x1, sol)
        converged = converged | (live & stop)
        keep = _lane(live, x1)
        x1 = torch.where(keep, x1, x0_)
        g1 = torch.where(keep, g1n, g0)
        tau1 = torch.where(live, tau_n, tau1)
        live = live & ~stop
        if not bool(live.any()):
            break
    return Solved(sol, iters, bts, converged)
