"""Phase retrieval by PhaseMax against one complex Gaussian operator, many
signals a request, each with its own magnitudes, anchor and start
(PhasePack, arXiv:1711.10175; PhaseMax, arXiv:1610.07531).

The request is a ``fasta_tpu_torch.serving.InstanceBatch``: the smooth
term's magnitudes b, the prox term's anchors c = δ·x̂₀ and the starts x̂₀,
one of each an instance, so that every signal is solved against its own
anchor."""

from __future__ import annotations

import math

import torch

from fasta_tpu_torch.serving import InstanceBatch

from ..reference import phase_retrieval as ref


def make_inputs(cfg: dict, traffic: dict, gen: torch.Generator,
                device) -> dict:
    """A = (Ar + i·Ai)/√(2m) with standard normal channels, and for each
    of the pool's P·B instances a complex standard normal x♮, b = |A x♮|
    and the anchor x̂₀ = x♮ + (σ‖x♮‖/√(2n))·(complex standard normal),
    scaled to unit norm (σ the ``anchor_noise``; the math of
    ``reference_oracle/generators.py``'s ``make_phase_retrieval``, on the
    device), in float32, planar: c = δ·x̂₀ and the start x̂₀."""
    m, n = cfg["m"], cfg["n"]
    P, B = traffic["pool"], traffic["batch"]
    N = P * B
    scale = 1.0 / math.sqrt(2 * m)
    Ar = torch.randn((m, n), generator=gen, device=device) * scale
    Ai = torch.randn((m, n), generator=gen, device=device) * scale
    x_true = torch.randn((N, n, 2), generator=gen, device=device)
    b = torch.linalg.vector_norm(ref.forward(Ar, Ai, x_true), dim=-1)
    norms = torch.linalg.vector_norm(x_true, dim=(1, 2), keepdim=True)
    xhat = x_true + (cfg["anchor_noise"] / math.sqrt(2 * n)) * norms * \
        torch.randn((N, n, 2), generator=gen, device=device)
    xhat = xhat / torch.linalg.vector_norm(xhat, dim=(1, 2), keepdim=True)
    pool = InstanceBatch(b.reshape(P, B, m),
                         prox=(cfg["delta"] * xhat).reshape(P, B, n, 2),
                         x0=xhat.reshape(P, B, n, 2))
    return dict(Ar=Ar, Ai=Ai, x_true=x_true.reshape(P, B, n, 2), pool=pool)


def problem(cfg: dict, inputs: dict, ftt):
    pool = inputs["pool"]
    return ftt.Problem(
        name=cfg["name"], op=ftt.PlanarDenseOp(inputs["Ar"], inputs["Ai"]),
        fterm=ftt.PlanarPhaseHinge(pool.data[0, 0]),
        gterm=ftt.PlanarLinearAnchor(pool.prox[0, 0]), x0=pool.x0[0, 0],
        tau0=cfg["options"]["tau0"])


def reference_inputs(inputs: dict, slots: list) -> dict:
    """A's channels, and b, c, the start and x♮ of each kept (batch,
    instance) slot."""
    pool = inputs["pool"]
    idx = torch.tensor(slots, device=pool.data.device)
    i, j = idx[:, 0], idx[:, 1]
    return dict(Ar=inputs["Ar"].clone(), Ai=inputs["Ai"].clone(),
                b=pool.data[i, j].clone(), c=pool.prox[i, j].clone(),
                x0=pool.x0[i, j].clone(), x_true=inputs["x_true"][i, j].clone())


def reference_solve(cfg: dict, data: dict, dtype: torch.dtype):
    return ref.solve(data["Ar"], data["Ai"], data["b"], data["c"],
                     data["x0"], cfg, dtype)


def product_bytes(m: int, n: int, lanes: int) -> float:
    """Bytes one planar product over ``lanes`` lanes needs (forward or
    adjoint): both channels of A read once (m·n float32 each) and each
    lane's planar vector in (n or m entries of 2 float32) and out (m or
    n)."""
    return 2.0 * m * n * 4 + lanes * (n + m) * 2 * 4


def product_flops(m: int, n: int, lanes: int) -> float:
    """float32 operations of that product: four real (m, n) products of a
    vector a lane, 2·m·n each."""
    return 8.0 * m * n * lanes


def judge(cfg: dict, data: dict, kept: dict) -> dict:
    """The reference's float64 solve of the kept instances and the
    numbers compared: the largest relative distance of a solution (the
    anchor fixes the global phase, so no alignment), the largest relative
    gap of an objective (both sides' in float64) and the largest
    difference of iteration counts; printed beside them, the largest
    phase-aligned recovery error to x♮ of the program's and of the
    reference's solutions."""
    Ar, Ai, b, c = (data[k].double() for k in ("Ar", "Ai", "b", "c"))
    x = kept["solutions"].double()
    r = reference_solve(cfg, data, torch.float64)
    xr = r.solution.double()
    fp = ref.objective(Ar, Ai, b, c, x)
    fr = ref.objective(Ar, Ai, b, c, xr)
    dist = torch.linalg.vector_norm(x - xr, dim=(1, 2)) / torch.clamp_min(
        torch.linalg.vector_norm(xr, dim=(1, 2)), 1e-30)
    gap = (fp - fr).abs() / torch.clamp_min(fr.abs(), 1e-30)
    iters = (torch.as_tensor(kept["iterations"], device=r.iterations.device)
             - r.iterations).abs()
    x_true = data["x_true"].double()
    return {"solution_rel_dist": float(dist.max()),
            "objective_rel_gap": float(gap.max()),
            "iteration_gap": float(iters.max()),
            "reference_unconverged": float((~r.converged).sum()),
            "recovery_error": float(ref.recovery_error(x, x_true).max()),
            "reference_recovery_error": float(
                ref.recovery_error(xr, x_true).max())}
