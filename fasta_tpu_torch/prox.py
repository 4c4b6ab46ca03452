"""Proximal operators (port of ``fasta_tpu/prox.py``; slice 1 needs the
soft threshold only — the other proxes come with their problems, ROADMAP
Queue A item 7)."""

from __future__ import annotations

import torch

__all__ = ["shrink"]


def shrink(z: torch.Tensor, t) -> torch.Tensor:
    """Soft threshold  sign(z)·max(|z|−t, 0)  — prox of t·‖·‖₁.

    Complex-safe: shrinks the magnitude, keeps the phase, with the
    reference's guard constant: z · max(|z|−t, 0)/max(|z|, 1e-30).
    ``clamp_min`` propagates NaN like ``jnp.maximum``."""
    mag = torch.abs(z)
    scale = torch.clamp_min(mag - t, 0.0) / torch.clamp_min(mag, 1e-30)
    return z * scale
