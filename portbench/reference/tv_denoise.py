"""Total-variation denoising on the dual: min ½‖μ·div p − b‖² over the
box |p| ≤ 1, with the denoised image x = b − μ·div p; the stencils,
objective and the float64 solve in plain PyTorch over a batch of images.
``div`` is the adjoint of the forward-difference gradient with a zero
last row and column (the negative divergence), as in FASTA's TV
example."""

from __future__ import annotations

import torch

from . import fasta


def grad(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) → (N, 2, H, W): vertical and horizontal forward
    differences, zero in the last row and column."""
    g = torch.zeros((x.shape[0], 2) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    g[:, 0, :-1, :] = x[:, 1:, :] - x[:, :-1, :]
    g[:, 1, :, :-1] = x[:, :, 1:] - x[:, :, :-1]
    return g


def div(p: torch.Tensor) -> torch.Tensor:
    """(N, 2, H, W) → (N, H, W): the adjoint of ``grad``."""
    out = torch.zeros((p.shape[0],) + tuple(p.shape[2:]), dtype=p.dtype,
                      device=p.device)
    out[:, :-1, :] -= p[:, 0, :-1, :]
    out[:, 1:, :] += p[:, 0, :-1, :]
    out[:, :, :-1] -= p[:, 1, :, :-1]
    out[:, :, 1:] += p[:, 1, :, :-1]
    return out


def image(b: torch.Tensor, p: torch.Tensor, mu: float) -> torch.Tensor:
    """The denoised images b − μ·div p."""
    return b - mu * div(p)


def dual_objective(b: torch.Tensor, p: torch.Tensor,
                   mu: float) -> torch.Tensor:
    """½‖μ·div p − b‖² for each image."""
    r = mu * div(p) - b
    return 0.5 * (r * r).sum(dim=(1, 2))


def solve(b: torch.Tensor, cfg: dict,
          dtype: torch.dtype = torch.float64) -> fasta.Solved:
    """The configuration's adaptive solve of the dual of every image of b
    (N, H, W) from p = 0, in ``dtype``."""
    b = b.to(dtype)
    mu, opts = cfg["mu"], cfg["options"]
    p0 = torch.zeros((b.shape[0], 2) + tuple(b.shape[1:]), dtype=dtype,
                     device=b.device)
    return fasta.solve(
        lambda p: mu * div(p), lambda y: mu * grad(y),
        lambda d: 0.5 * ((d - b) ** 2).sum(dim=(1, 2)), lambda d: d - b,
        lambda z, tau: z.clamp(-1.0, 1.0), p0, opts["tau0"],
        tol=opts["tol"], max_iters=opts["max_iters"])
