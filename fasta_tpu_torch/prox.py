"""Proximal operators (port of ``fasta_tpu/prox.py``).

Each function takes one variable, as the JAX package's do; the ``*_lanes``
forms take a leading lane axis (the batch dimension of
``solver.make_batch_solver``) with one stepsize or radius per lane, and
never mix lanes: each lane's projection sees that lane's whole variable.
"""

from __future__ import annotations

import torch

from .precision import lane

__all__ = ["shrink", "prox_l1", "project_nonneg", "project_box",
           "project_l1_ball", "project_l1_ball_lanes", "prox_linf",
           "prox_linf_lanes", "svt", "shrink_rows", "prox_l21",
           "project_linf_ball", "project_max_row_norm", "prox_linear",
           "prox_zero"]


def shrink(z: torch.Tensor, t) -> torch.Tensor:
    """Soft threshold  sign(z)·max(|z|−t, 0)  — prox of t·‖·‖₁.

    Complex-safe: shrinks the magnitude, keeps the phase, with the
    reference's guard constant: z · max(|z|−t, 0)/max(|z|, 1e-30).
    ``clamp_min`` propagates NaN like ``jnp.maximum``."""
    mag = torch.abs(z)
    scale = torch.clamp_min(mag - t, 0.0) / torch.clamp_min(mag, 1e-30)
    return z * scale


def prox_l1(z: torch.Tensor, t, mu=1.0) -> torch.Tensor:
    """Prox of  t·μ‖·‖₁  (``fasta_tpu/prox.py:36``)."""
    return shrink(z, t * mu)


def project_nonneg(z: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative orthant (the NNLS indicator's
    prox); NaN stays NaN, as with ``jnp.maximum``."""
    return torch.clamp_min(z, 0.0)


def project_box(z: torch.Tensor, lo, hi) -> torch.Tensor:
    """Projection onto the box [lo, hi], per component (``jnp.clip``)."""
    return torch.clamp(z, lo, hi)


def project_linf_ball(z: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Projection onto {‖z‖∞ ≤ radius} (``fasta_tpu/prox.py:51``):
    complex z keeps its phases and clips its magnitudes."""
    if z.is_complex():
        mag = torch.abs(z)
        scale = (torch.clamp(mag, max=radius)
                 / torch.clamp_min(mag, 1e-30))
        return z * scale
    return torch.clamp(z, -radius, radius)


def project_l1_ball_lanes(z: torch.Tensor, radius) -> torch.Tensor:
    """:func:`project_l1_ball` of each lane of ``z`` (B, ...) with the
    lane's radius (a number or a (B,) tensor), in the JAX function's
    algorithm (``fasta_tpu/prox.py:61-84``): the magnitudes sorted in
    descending order, their running sums, ρ the last index where
    u_k·k > css_k − radius, θ = (css_ρ − radius)/ρ, and θ = 0 for a lane
    already inside the ball.  The sorted values do not depend on how
    ties are ordered, so ties land on the JAX function's vertex.  Where
    no index qualifies (only NaN can do that) ρ indexes the last sum, as
    a traced −1 index does in JAX."""
    B = z.shape[0]
    v = z.reshape(B, -1)
    N = v.shape[1]
    mag = torch.abs(v)
    radius = lane(torch.as_tensor(radius, dtype=mag.dtype,
                                  device=mag.device).expand(B), mag)
    inside = torch.sum(mag, dim=1, keepdim=True) <= radius
    u = torch.sort(mag, dim=1, descending=True).values
    css = torch.cumsum(u, dim=1)
    ks = torch.arange(1, N + 1, dtype=u.dtype, device=u.device)
    cond = u * ks > (css - radius)
    idx = torch.arange(N, device=u.device).expand(B, N)
    rho_i = torch.amax(torch.where(cond, idx, -1), dim=1, keepdim=True)
    rho = (rho_i + 1).to(u.dtype)
    theta = ((torch.gather(css, 1, torch.remainder(rho_i, N)) - radius)
             / torch.clamp_min(rho, 1.0))
    theta = torch.where(inside, 0.0, torch.clamp_min(theta, 0.0))
    return shrink(v, theta).reshape(z.shape)


def project_l1_ball(z: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Euclidean projection onto {x : ‖x‖₁ ≤ radius}, sort-based (Duchi
    et al.; ``fasta_tpu/prox.py:61``); inside-ball inputs pass through
    unchanged.  Complex z shrinks magnitudes and keeps phases."""
    return project_l1_ball_lanes(z[None], radius)[0]


def prox_linf_lanes(z: torch.Tensor, t) -> torch.Tensor:
    """:func:`prox_linf` of each lane of ``z`` (B, ...) at the lane's t
    (a number or a (B,) tensor)."""
    B = z.shape[0]
    t = torch.as_tensor(t, dtype=torch.abs(z).dtype,
                        device=z.device).expand(B)
    tl = lane(t, z)
    safe = z - tl * project_l1_ball_lanes(z / torch.clamp_min(tl, 1e-30),
                                          1.0)
    return torch.where(tl > 0, safe, z)


def prox_linf(z: torch.Tensor, t) -> torch.Tensor:
    """Prox of  t·‖·‖∞  by Moreau decomposition (``fasta_tpu/prox.py:87``):
    z − t·P_{‖·‖₁≤1}(z/t), the identity where t ≤ 0 (the prox of the zero
    function, not the NaN of z/0)."""
    return prox_linf_lanes(z[None], t)[0]


def svt(Z: torch.Tensor, t) -> torch.Tensor:
    """Singular-value thresholding — prox of t·‖·‖_* (``fasta_tpu/prox.py:
    99``): ``torch.linalg.svd(full_matrices=False)``, σ shrunk by t, the
    matrix rebuilt.  Leading axes are lanes, ``t`` a number or one per
    lane broadcast against σ (B, 1).  The SVD and the rebuild run in
    float64 (complex128) and the result is rounded to ``Z``'s dtype: in
    float32 the card's default SVD (cuSOLVER's Jacobi driver) leaves
    relative errors near 5e-5, forty times LAPACK's, which is above the
    solver's 1e-6 stopping tolerance; the JAX package pins
    ``Precision.HIGHEST`` for its float32 SVD."""
    wide = torch.complex128 if Z.is_complex() else torch.float64
    U, s, Vh = torch.linalg.svd(Z.to(wide), full_matrices=False)
    s = torch.clamp_min(s - t, 0.0)
    return torch.matmul(U * s[..., None, :].to(U.dtype), Vh).to(Z.dtype)


def shrink_rows(Z: torch.Tensor, t) -> torch.Tensor:
    """Row-wise group soft threshold — prox of t·‖·‖_{2,1}, the rows the
    last axis (``fasta_tpu/prox.py:111``)."""
    norms = torch.linalg.vector_norm(Z, dim=-1, keepdim=True)
    scale = torch.clamp_min(norms - t, 0.0) / torch.clamp_min(norms, 1e-30)
    return Z * scale


prox_l21 = shrink_rows


def project_max_row_norm(Z: torch.Tensor, radius) -> torch.Tensor:
    """Each row (the last axis) scaled onto the L2 ball of ``radius`` —
    the prox of the max-norm constraint (``MaxRowNormBall.prox``,
    ``fasta_tpu/terms.py:752``)."""
    norms = torch.linalg.vector_norm(Z, dim=-1, keepdim=True)
    scale = torch.clamp(norms, max=radius) / torch.clamp_min(norms, 1e-30)
    return Z * scale


def prox_linear(z: torch.Tensor, t, c) -> torch.Tensor:
    """Prox of the linear functional g(x) = −Re⟨c, x⟩:  z + t·c
    (``fasta_tpu/prox.py:122``)."""
    return z + t * c


def prox_zero(z: torch.Tensor, t) -> torch.Tensor:
    """Prox of g ≡ 0 (``fasta_tpu/prox.py:128``)."""
    del t
    return z
