"""LASSO, ½‖Ax − b‖² + μ‖x‖₁, over many measurement vectors b against one
A: the operator, terms and objective in plain PyTorch, and the float64
solve the benchmark judges the program's answers by."""

from __future__ import annotations

import torch

from . import fasta


def shrink(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Soft threshold with one threshold an instance (N,)."""
    t = t.reshape(-1, 1)
    return torch.sign(z) * torch.clamp_min(z.abs() - t, 0.0)


def objective(A: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              mu: float) -> torch.Tensor:
    """½‖Ax − b‖² + μ‖x‖₁ for each row of x (N, n) against b (N, m)."""
    r = x @ A.mT - b
    return 0.5 * (r * r).sum(dim=1) + mu * x.abs().sum(dim=1)


def solve(A: torch.Tensor, b: torch.Tensor, cfg: dict,
          dtype: torch.dtype = torch.float64) -> fasta.Solved:
    """The configuration's adaptive solve of every row of b (N, m) from
    x = 0, in ``dtype`` (the benchmark's reference: float64)."""
    A, b = A.to(dtype), b.to(dtype)
    mu, opts = cfg["mu"], cfg["options"]
    x0 = torch.zeros((b.shape[0], A.shape[1]), dtype=dtype, device=b.device)
    return fasta.solve(
        lambda x: x @ A.mT, lambda y: y @ A, lambda d: 0.5 * ((d - b) ** 2)
        .sum(dim=1), lambda d: d - b, lambda z, tau: shrink(z, tau * mu),
        x0, opts["tau0"], tol=opts["tol"], max_iters=opts["max_iters"])
