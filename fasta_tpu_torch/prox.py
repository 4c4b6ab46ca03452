"""Proximal operators (port of ``fasta_tpu/prox.py``: the soft threshold
and the two real projections of the dense problems; the other proxes come
with their problems, ROADMAP Queue A item 7)."""

from __future__ import annotations

import torch

__all__ = ["shrink", "project_nonneg", "project_box"]


def shrink(z: torch.Tensor, t) -> torch.Tensor:
    """Soft threshold  sign(z)·max(|z|−t, 0)  — prox of t·‖·‖₁.

    Complex-safe: shrinks the magnitude, keeps the phase, with the
    reference's guard constant: z · max(|z|−t, 0)/max(|z|, 1e-30).
    ``clamp_min`` propagates NaN like ``jnp.maximum``."""
    mag = torch.abs(z)
    scale = torch.clamp_min(mag - t, 0.0) / torch.clamp_min(mag, 1e-30)
    return z * scale


def project_nonneg(z: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative orthant (the NNLS indicator's
    prox); NaN stays NaN, as with ``jnp.maximum``."""
    return torch.clamp_min(z, 0.0)


def project_box(z: torch.Tensor, lo, hi) -> torch.Tensor:
    """Projection onto the box [lo, hi], per component (``jnp.clip``)."""
    return torch.clamp(z, lo, hi)
