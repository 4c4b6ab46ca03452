"""Kernel K-B5: the fused TV-dual gradient map in one launch.

``fused_tv_gradmap(p, b, mu)`` returns (d, f, g) = (μ·div p,
½‖μ·div p − b‖², μ·grad(μ·div p − b)) for a dual field p (2, H, W) and
an image b (H, W); port of ``fasta_tpu/kernels/tv_fused.py:44-103``
(pallas_call at :82).  The CUDA source is
``fasta_tpu_torch/csrc/tv_fused.cu``; its header note gives the design,
and ``tv_plan`` cuts the image into the blocks' strips and bands.  The
wrapper launches the kernel for CUDA tensors and runs the plain version
(``tv_gradmap_reference``) for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["fused_tv_gradmap", "tv_gradmap_reference", "tv_plan", "TvPlan",
           "LAUNCHES"]

# Launches of the CUDA kernel, counted where it launches, nowhere else.
LAUNCHES = 0

# The plan's constants: a block of up to MAX_THREADS threads (4 columns
# each) covers a strip; the bands are as many as fill BLOCKS_PER_SM blocks
# an SM, but at least MIN_BAND_ROWS rows each, so that the one halo row a
# band recomputes stays a small share (PERF.md, K-B5:
# ``tools/call_split.py --sweep``).
MAX_THREADS = 256
BLOCKS_PER_SM = 2
MIN_BAND_ROWS = 4
MAX_BANDS = 65535


class TvPlan(NamedTuple):
    """How a launch covers an (H, W) image: ``strips`` strips of
    4·``threads`` columns, one block of ``threads`` each per band;
    ``bands`` the (first row, end row) of each band, top to bottom (each
    band also computes r on the row below it, where there is one);
    ``scratch_doubles`` the ticket and one FP64 partial per block (0 for
    a one-block grid)."""
    threads: int
    strips: int
    bands: tuple
    scratch_doubles: int


def tv_plan(H: int, W: int, sms: int) -> TvPlan:
    """The strips and bands of an (H, W) image on a card with ``sms``
    streaming multiprocessors: the fewest threads (32 to MAX_THREADS)
    whose four columns each cover W, else strips of MAX_THREADS; band k
    of nb holds rows ⌊kH/nb⌋ to ⌊(k+1)H/nb⌋.  A pure function of its
    arguments."""
    if H < 1 or W < 1 or sms < 1:
        raise ValueError(f"tv_plan needs H, W, sms >= 1; got {(H, W, sms)}")
    threads = 32
    while threads < MAX_THREADS and 4 * threads < W:
        threads *= 2
    strips = -(-W // (4 * threads))
    nb = max(1, min(BLOCKS_PER_SM * sms // strips, H // MIN_BAND_ROWS,
                    MAX_BANDS))
    bands = tuple((k * H // nb, (k + 1) * H // nb) for k in range(nb))
    blocks = strips * nb
    return TvPlan(threads, strips, bands, 0 if blocks == 1 else 1 + blocks)


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


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, H: int, W: int) -> TvPlan:
    return tv_plan(H, W, _build.sm_count(device_index))


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
    dev = p.device
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return fused_tv_gradmap(p, b, mu)
    return _launch(p, b, mu, _plan(dev.index, *b.shape))


def _launch(p, b, mu, plan):
    """One launch of K-B5 on checked card tensors, the current device's,
    over ``plan``."""
    dev = p.device
    H, W = b.shape
    d = torch.empty((H, W), device=dev, dtype=torch.float32)
    g = torch.empty((2, H, W), device=dev, dtype=torch.float32)
    f = torch.empty((), device=dev, dtype=torch.float32)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    work = (_build.stream_scratch(dev, stream, plan.scratch_doubles)
            if plan.scratch_doubles else None)
    err = _build.library().fasta_tv_gradmap(
        p.data_ptr(), b.data_ptr(), H, W, float(mu), plan.threads,
        len(plan.bands), d.data_ptr(), f.data_ptr(), g.data_ptr(),
        None if work is None else work.data_ptr(), stream)
    if err:
        _build.check(err, "fasta_tv_gradmap")
    global LAUNCHES
    LAUNCHES += 1
    return d, f, g
