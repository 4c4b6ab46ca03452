"""Kernel K-B5: the fused TV-dual gradient map in one launch.

``fused_tv_gradmap(p, b, mu)`` returns (d, f, g) = (μ·div p,
½‖μ·div p − b‖², μ·grad(μ·div p − b)) for a dual field p (2, H, W) and
an image b (H, W); port of ``fasta_tpu/kernels/tv_fused.py:44-103``
(pallas_call at :82).  The CUDA source is
``fasta_tpu_torch/csrc/tv_fused.cu``; its header note gives the design.
The wrapper launches the kernel for CUDA tensors and runs the plain
version (``tv_gradmap_reference``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["fused_tv_gradmap", "tv_gradmap_reference", "LAUNCHES"]

# Launches of the CUDA kernel, counted where it launches, nowhere else.
LAUNCHES = 0


def tv_gradmap_reference(p: torch.Tensor, b: torch.Tensor, mu: float):
    """The plain composition: ``ScaledOp(μ, TVDiv2D())`` at p, then
    r = d − b, f = ½‖r‖², g = μ·TVGrad2D(r)."""
    from ..operators import ScaledOp, TVDiv2D, tv_grad_2d
    d = ScaledOp(mu, TVDiv2D())(p)
    r = d - b
    f = 0.5 * torch.sum(r * r)
    return d, f, mu * tv_grad_2d(r)


def _check(p, b, what):
    if b.ndim != 2 or p.ndim != 3 or p.shape[0] != 2 or \
            tuple(p.shape[1:]) != tuple(b.shape):
        raise ValueError(f"{what} needs p (2,H,W) and b (H,W); got "
                         f"{tuple(p.shape)} and {tuple(b.shape)}")
    if p.device != b.device:
        raise ValueError(f"{what}: p and b must share a device")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {p.device}")


def fused_tv_gradmap(p: torch.Tensor, b: torch.Tensor, mu: float):
    """One-pass (d: (H,W), f: 0-d, g: (2,H,W)) of the TV dual's
    least-squares term at p.

    CUDA tensors launch kernel K-B5 and must be contiguous float32, of
    any H × W; anything else raises.  CPU tensors run the plain
    version."""
    _check(p, b, "fused_tv_gradmap")
    if p.device.type == "cpu":
        return tv_gradmap_reference(p, b, mu)
    for name, t in (("p", p), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_tv_gradmap: {name} must be a "
                             f"contiguous float32 tensor, got {t.dtype}")
    H, W = b.shape
    dev = p.device
    d = torch.empty((H, W), device=dev, dtype=torch.float32)
    g = torch.empty((2, H, W), device=dev, dtype=torch.float32)
    f = torch.empty((), device=dev, dtype=torch.float32)
    # the block partials of f and the last-block ticket, per call
    work = torch.empty(_work(H, W), device=dev, dtype=torch.float64)
    with _build.on_device(dev) as stream:
        _build.check(_build.library().fasta_tv_gradmap(
            p.data_ptr(), b.data_ptr(), H, W, float(mu), d.data_ptr(),
            f.data_ptr(), g.data_ptr(), work.data_ptr(), stream),
            "fasta_tv_gradmap")
    global LAUNCHES
    LAUNCHES += 1
    return d, f, g


@functools.lru_cache(maxsize=None)
def _work(H: int, W: int) -> int:
    nd = ctypes.c_int()
    _build.check(_build.library().fasta_tv_gradmap_work(
        H, W, ctypes.byref(nd)), "fasta_tv_gradmap_work")
    return nd.value
