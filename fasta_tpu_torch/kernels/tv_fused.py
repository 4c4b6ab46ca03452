"""Kernel K-B5: the fused TV-dual gradient map in one launch.

``fused_tv_gradmap(p, b, mu)`` returns (d, f, g) = (μ·div p,
½‖μ·div p − b‖², μ·grad(μ·div p − b)) for a dual field p (2, H, W) and
an image b (H, W); port of ``fasta_tpu/kernels/tv_fused.py:44-103``
(pallas_call at :82).  The CUDA source is
``fasta_tpu_torch/csrc/tv_fused.cu``; its header note gives the design,
and ``tv_plan`` cuts the image into the blocks' strips and bands.  The
wrapper launches the kernel for CUDA tensors and runs the plain version
(``tv_gradmap_reference``) for CPU tensors.

``fused_tv_gradmap_band`` is the same kernel over one rank's band of rows
of a taller image (``sharding.RowShardedTVDivOp``): the rows above and
below the band come from halo rows, and f counts the band's own rows.
Its plain version is ``tv_gradmap_band_reference``, built from the band
stencils ``tv_div_band`` and ``tv_grad_band``, which the sharded TV
operator's legs use too.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["fused_tv_gradmap", "tv_gradmap_reference", "tv_plan", "TvPlan",
           "fused_tv_gradmap_band", "tv_gradmap_band_reference",
           "tv_div_band", "tv_grad_band", "LAUNCHES", "BAND_LAUNCHES"]

# Launches of the CUDA kernel, counted where it launches, nowhere else: by
# fused_tv_gradmap and by fused_tv_gradmap_band.
LAUNCHES = 0
BAND_LAUNCHES = 0

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


def tv_div_band(p: torch.Tensor, above=None, last: bool = True):
    """``tv_div_2d`` of a band of rows of a taller image, (2, Hb, W) →
    (Hb, W), in its order of operations: the vertical term of the band's
    first row takes ``above`` (W,), the row of p's vertical channel above
    the band (zeros when None: the image's first row), and the band's last
    row keeps its own vertical dual unless ``last`` (the image's last
    row).  ``tv_div_band(p)`` is ``tv_div_2d(p)``."""
    pv, ph = p[0], p[1]
    zrow = torch.zeros_like(pv[:1])
    zcol = torch.zeros_like(ph[:, :1])
    up = torch.cat([zrow if above is None else above[None], pv[:-1]])
    down = torch.cat([pv[:-1], zrow]) if last else pv
    return (up - down) + (torch.cat([zcol, ph[:, :-1]], dim=1)
                          - torch.cat([ph[:, :-1], zcol], dim=1))


def tv_grad_band(r: torch.Tensor, below=None):
    """``tv_grad_2d`` of a band of rows, (Hb, W) → (2, Hb, W): the band's
    last vertical difference takes ``below`` (W,), the image row under the
    band (None: the band ends the image, and that difference is zero).
    ``tv_grad_band(r)`` is ``tv_grad_2d(r)``."""
    zrow = torch.zeros_like(r[:1])
    zcol = torch.zeros_like(r[:, :1])
    dv = (torch.cat([r[1:] - r[:-1], zrow]) if below is None
          else torch.cat([r[1:], below[None]]) - r)
    dh = torch.cat([r[:, 1:] - r[:, :-1], zcol], dim=1)
    return torch.stack([dv, dh])


def tv_gradmap_band_reference(p: torch.Tensor, b: torch.Tensor, mu: float,
                              above=None, below=None, b_below=None):
    """The plain version of the band form: d = μ·div p on the band's Hb
    rows (``above``: the row of p's vertical channel above the band, None
    at the image's top), r = d − b, f = ½‖r‖² over the band's rows, and
    g = μ·grad r, whose last vertical difference takes r on the row below
    the band, formed from ``below`` (2, W) — that row's vertical and
    horizontal duals, the vertical one zero where the row is the image's
    last — and ``b_below`` (W,), its image row (both None at the image's
    bottom).  With no halo rows it is ``tv_gradmap_reference``."""
    d = mu * tv_div_band(p, above, below is None)
    r = d - b
    f = 0.5 * torch.sum(r * r)
    r_below = None
    if below is not None:
        d_below = mu * tv_div_band(below[:, None], p[0, -1], last=False)
        r_below = d_below[0] - b_below
    return d, f, mu * tv_grad_band(r, r_below)


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


def _check_band(p, b, above, below, b_below):
    _check(p, b, "fused_tv_gradmap_band")
    W = b.shape[1]
    if (below is None) != (b_below is None):
        raise ValueError("fused_tv_gradmap_band: below and b_below go "
                         "together (both None at the image's bottom)")
    for name, t, shape in (("above", above, (W,)), ("below", below, (2, W)),
                           ("b_below", b_below, (W,))):
        if t is not None and (tuple(t.shape) != shape
                              or t.device != p.device):
            raise ValueError(f"fused_tv_gradmap_band: {name} must be "
                             f"{shape} on {p.device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def fused_tv_gradmap_band(p: torch.Tensor, b: torch.Tensor, mu: float,
                          above=None, below=None, b_below=None):
    """One-pass (d: (Hb,W), f: 0-d, g: (2,Hb,W)) of the TV dual's
    least-squares term on a band p (2, Hb, W), b (Hb, W) of a taller
    image, with the halo rows of :func:`tv_gradmap_band_reference`; f is
    the band's share of ½‖r‖².

    CUDA tensors launch kernel K-B5's band form and must all be contiguous
    float32; anything else raises.  CPU tensors run the plain version.
    With no halo rows it is K-B5's own launch over the band as a whole
    image: the same plan and the same bits as :func:`fused_tv_gradmap`."""
    _check_band(p, b, above, below, b_below)
    if p.device.type == "cpu":
        return tv_gradmap_band_reference(p, b, mu, above, below, b_below)
    for name, t in (("p", p), ("b", b), ("above", above), ("below", below),
                    ("b_below", b_below)):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"fused_tv_gradmap_band: {name} must be a "
                             f"contiguous float32 tensor, got {t.dtype}")
    dev = p.device
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return fused_tv_gradmap_band(p, b, mu, above, below, b_below)
    plan = _plan(dev.index, *b.shape)
    Hb, W = b.shape
    d = torch.empty((Hb, W), device=dev, dtype=torch.float32)
    g = torch.empty((2, Hb, W), device=dev, dtype=torch.float32)
    f = torch.empty((), device=dev, dtype=torch.float32)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    work = (_build.stream_scratch(dev, stream, plan.scratch_doubles)
            if plan.scratch_doubles else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = _build.library().fasta_tv_gradmap_band(
        p.data_ptr(), b.data_ptr(), Hb, W, float(mu), ptr(above), ptr(below),
        ptr(b_below), int(above is None), int(below is None), plan.threads,
        len(plan.bands), d.data_ptr(), f.data_ptr(), g.data_ptr(),
        None if work is None else work.data_ptr(), stream)
    if err:
        _build.check(err, "fasta_tv_gradmap_band")
    global BAND_LAUNCHES
    BAND_LAUNCHES += 1
    return d, f, g
