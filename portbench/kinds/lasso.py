"""LASSO against one dense Gaussian dictionary, many measurement vectors a
request (FASTA's E1, arXiv:1411.3406)."""

from __future__ import annotations

import math

import torch

from ..reference import lasso as ref


def make_inputs(cfg: dict, traffic: dict, gen: torch.Generator,
                device) -> dict:
    """A (m, n) Gaussian over √m, and for each instance a planted x♮ with
    k nonzeros on a uniformly drawn support, standard normal, and
    b = A x♮ + σ·noise (the math of ``reference_oracle/generators.py``'s
    ``make_lasso``, on the device), in float32."""
    m, n, k, sigma = cfg["m"], cfg["n"], cfg["k"], cfg["sigma"]
    P, B = traffic["pool"], traffic["batch"]
    A = torch.randn((m, n), generator=gen, device=device) / math.sqrt(m)
    pool = torch.empty((P, B, m), device=device)
    for p in range(P):
        support = torch.rand((B, n), generator=gen, device=device).topk(
            k, dim=1).indices
        x = torch.zeros((B, n), device=device).scatter_(
            1, support, torch.randn((B, k), generator=gen, device=device))
        torch.addmm(torch.randn((B, m), generator=gen, device=device),
                    x, A.mT, beta=sigma, out=pool[p])
    return dict(A=A, pool=pool)


def problem(cfg: dict, inputs: dict, ftt):
    A, pool = inputs["A"], inputs["pool"]
    return ftt.Problem(
        name=cfg["name"], op=ftt.DenseOp(A), fterm=ftt.LeastSquares(pool[0, 0]),
        gterm=ftt.L1Norm(cfg["mu"]),
        x0=torch.zeros(cfg["n"], device=A.device),
        tau0=cfg["options"]["tau0"])


def reference_inputs(inputs: dict, slots: list) -> dict:
    """A, and b of each kept (batch, lane) slot."""
    idx = torch.tensor(slots, device=inputs["pool"].device)
    return dict(A=inputs["A"].clone(),
                b=inputs["pool"][idx[:, 0], idx[:, 1]].clone())


def reference_solve(cfg: dict, data: dict, dtype: torch.dtype):
    return ref.solve(data["A"], data["b"], cfg, dtype)


def judge(cfg: dict, data: dict, kept: dict) -> dict:
    """The reference's float64 solve of the kept instances and the
    numbers compared: the largest relative distance of a solution, the
    largest relative gap of an objective (both sides' in float64) and the
    largest difference of iteration counts."""
    A, b = data["A"], data["b"]
    x = kept["solutions"].double()
    r = reference_solve(cfg, data, torch.float64)
    xr = r.solution.double()
    A64, b64 = A.double(), b.double()
    fp = ref.objective(A64, b64, x, cfg["mu"])
    fr = ref.objective(A64, b64, xr, cfg["mu"])
    dist = torch.linalg.vector_norm(x - xr, dim=1) / torch.clamp_min(
        torch.linalg.vector_norm(xr, dim=1), 1e-30)
    gap = (fp - fr).abs() / fr.abs()
    iters = (torch.as_tensor(kept["iterations"], device=r.iterations.device)
             - r.iterations).abs()
    return {"solution_rel_dist": float(dist.max()),
            "objective_rel_gap": float(gap.max()),
            "iteration_gap": float(iters.max()),
            "reference_unconverged": float((~r.converged).sum())}
