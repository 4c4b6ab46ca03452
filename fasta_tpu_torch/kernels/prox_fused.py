"""Kernel K-B4: the fused shrink step of an L1 line-search trial.

``fused_shrink_step(x0, g, tau, mu)`` computes in one pass over rows
(R, n) — R = 1 being the JAX function's (n,) form —

    x̂₁ = x₀ − τg,   x₁ = shrink(x̂₁, τμ),   Δx = x₁ − x₀,

and per row the three sums the loop's trial needs: ‖Δx‖², ⟨Δx, g⟩ and
‖x₁ − x̂₁‖², in float64; port of ``fasta_tpu/kernels/prox_fused.py:36-129``
(pallas_call at :101).  The CUDA source is
``fasta_tpu_torch/csrc/prox_fused.cu``; its header note gives the design.
The wrapper launches the kernel for CUDA tensors and runs the plain
version (``shrink_step_reference``) for CPU tensors.  Real float32 only,
as in the reference; the loop keeps the composition for other types.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..prox import shrink
from . import _build

__all__ = ["fused_shrink_step", "shrink_step_reference", "LAUNCHES"]

# Launches of the kernel, counted where it launches, nowhere else.
LAUNCHES = 0


def _per_row(v, R, dev, what):
    """τ or μ as a float32 tensor on ``dev`` holding one value or R."""
    t = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1)
    if t.numel() not in (1, R):
        raise ValueError(f"fused_shrink_step: {what} holds {t.numel()} "
                         f"values for {R} rows")
    return t


def _check(x0, g):
    if x0.shape != g.shape or x0.ndim not in (1, 2):
        raise ValueError(f"fused_shrink_step needs x0 and g of one shape, "
                         f"(n,) or (R, n); got {tuple(x0.shape)} and "
                         f"{tuple(g.shape)}")
    if x0.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"fused_shrink_step: x0 and g must be float32, got "
                         f"{x0.dtype} and {g.dtype}")
    if x0.device != g.device or x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_shrink_step: x0 and g must share a CPU or "
                         f"CUDA device, got {x0.device} and {g.device}")


def shrink_step_reference(x0, g, tau, mu):
    """The plain version of K-B4: the same separate operations in torch,
    the sums of float32 products accumulated in float64."""
    _check(x0, g)
    rows = x0.reshape(-1, x0.shape[-1])
    R = rows.shape[0]
    tau_t = _per_row(tau, R, x0.device, "tau")[:, None]
    mu_t = _per_row(mu, R, x0.device, "mu")[:, None]
    x1hat = rows - tau_t * g.reshape(rows.shape)
    x1 = shrink(x1hat, tau_t * mu_t)
    dx, sm = (x1 - rows).double(), (x1 - x1hat).double()
    sums = [torch.sum(dx * dx, dim=1),
            torch.sum(dx * g.reshape(rows.shape).double(), dim=1),
            torch.sum(sm * sm, dim=1)]
    if x0.ndim == 1:
        return (x1[0],) + tuple(s[0] for s in sums)
    return (x1,) + tuple(sums)


def fused_shrink_step(x0, g, tau, mu):
    """(x₁, ‖Δx‖², ⟨Δx,g⟩, ‖x₁−x̂₁‖²) in one pass over x0 and g, (n,) or
    (R, n) float32; τ and μ are numbers, 0-d tensors or (R,) tensors (one
    per row).  The sums are float64, 0-d for (n,) input, (R,) for rows.

    CUDA tensors launch kernel K-B4 (contiguous rows; τ and μ are read on
    the card, so a τ that lives there costs no host sync); CPU tensors run
    the plain version."""
    _check(x0, g)
    if x0.device.type == "cpu":
        return shrink_step_reference(x0, g, tau, mu)
    if not (x0.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_shrink_step: x0 and g must be contiguous")
    n = x0.shape[-1]
    R = x0.numel() // n
    dev = x0.device
    tau_t = _per_row(tau, R, dev, "tau")
    mu_t = _per_row(mu, R, dev, "mu")
    x1 = torch.empty_like(x0)
    sums = torch.empty((R, 3), device=dev, dtype=torch.float64)
    work = torch.empty(_work(R, n), device=dev, dtype=torch.float64)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_shrink_step(
            x0.data_ptr(), g.data_ptr(), tau_t.data_ptr(),
            int(tau_t.numel() > 1), mu_t.data_ptr(), int(mu_t.numel() > 1), R,
            n, x1.data_ptr(), sums.data_ptr(), work.data_ptr(), stream),
            "fasta_shrink_step")
    global LAUNCHES
    LAUNCHES += 1
    if x0.ndim == 1:
        return x1, sums[0, 0], sums[0, 1], sums[0, 2]
    return x1, sums[:, 0], sums[:, 1], sums[:, 2]


@functools.lru_cache(maxsize=None)
def _work(R: int, n: int) -> int:
    nd = ctypes.c_int()
    _build.check(_build.library().fasta_shrink_step_work(
        R, n, ctypes.byref(nd)), "fasta_shrink_step_work")
    return nd.value
