"""Phase retrieval by PhaseMax on the penalized form

    min  ½ Σᵢ max(|(A x)ᵢ| − bᵢ, 0)²  −  ⟨c, x⟩,   c = δ·x̂₀,

over many signals against one complex A (PhasePack, arXiv:1711.10175;
PhaseMax, arXiv:1610.07531), each signal with its own magnitudes b,
anchor c and start: the planar operator, the hinge, its gradient, the
anchor's prox and the objective in plain PyTorch, and the float64 solve
the benchmark judges the program's answers by.  A complex vector is
planar: its real and imaginary parts on a trailing axis of 2, so that
the real dot of two planar vectors is Re⟨·,·⟩ of the complex ones."""

from __future__ import annotations

import torch

from . import fasta


def forward(Ar: torch.Tensor, Ai: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """A x for A = Ar + i·Ai (m, n) and planar x (N, n, 2): (N, m, 2)."""
    xr, xi = x[..., 0], x[..., 1]
    return torch.stack([xr @ Ar.mT - xi @ Ai.mT, xi @ Ar.mT + xr @ Ai.mT],
                       dim=-1)


def adjoint(Ar: torch.Tensor, Ai: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Aᴴ y for planar y (N, m, 2): (N, n, 2)."""
    yr, yi = y[..., 0], y[..., 1]
    return torch.stack([yr @ Ar + yi @ Ai, yi @ Ar - yr @ Ai], dim=-1)


def hinge(d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """½ Σ max(|d| − b, 0)² for each instance of d (N, m, 2), b (N, m)."""
    r = torch.clamp_min(torch.linalg.vector_norm(d, dim=-1) - b, 0.0)
    return 0.5 * (r * r).sum(dim=1)


def hinge_grad(d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The hinge's gradient in d: max(|d| − b, 0)·d/|d|, with |d| floored
    at 1e-30 as the oracle floors it."""
    mag = torch.linalg.vector_norm(d, dim=-1)
    r = torch.clamp_min(mag - b, 0.0)
    return (r / torch.clamp_min(mag, 1e-30))[..., None] * d


def objective(Ar: torch.Tensor, Ai: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """½ Σ max(|Ax| − b, 0)² − ⟨c, x⟩ for each instance."""
    return hinge(forward(Ar, Ai, x), b) - (c * x).sum(dim=(1, 2))


def recovery_error(x: torch.Tensor, x_true: torch.Tensor) -> torch.Tensor:
    """‖e^{iφ}x − x♮‖/‖x♮‖ for each instance, φ the global phase that
    aligns x with x♮ (PhaseMax recovers a signal up to it)."""
    z = torch.complex(x[..., 0], x[..., 1])
    zt = torch.complex(x_true[..., 0], x_true[..., 1])
    inner = (z.conj() * zt).sum(dim=1, keepdim=True)
    phase = inner / torch.clamp_min(inner.abs(), 1e-30)
    return (torch.linalg.vector_norm(z * phase - zt, dim=1)
            / torch.linalg.vector_norm(zt, dim=1))


def solve(Ar: torch.Tensor, Ai: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor, x0: torch.Tensor, cfg: dict,
          dtype: torch.dtype = torch.float64) -> fasta.Solved:
    """The configuration's adaptive solve of each instance from its own
    start x0 (N, n, 2), with its own magnitudes b (N, m) and anchor c
    (N, n, 2), in ``dtype`` (the benchmark's reference: float64)."""
    Ar, Ai, b, c, x0 = (t.to(dtype) for t in (Ar, Ai, b, c, x0))
    opts = cfg["options"]
    return fasta.solve(
        lambda x: forward(Ar, Ai, x), lambda y: adjoint(Ar, Ai, y),
        lambda d: hinge(d, b), lambda d: hinge_grad(d, b),
        lambda z, tau: z + tau.reshape(-1, 1, 1) * c, x0, opts["tau0"],
        tol=opts["tol"], max_iters=opts["max_iters"])
