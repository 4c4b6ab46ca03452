"""Kernel K-B4: the fused shrink step of an L1 line-search trial.

``fused_shrink_step(x0, g, tau, mu)`` computes in one pass over rows
(R, n) — R = 1 being the JAX function's (n,) form —

    x̂₁ = x₀ − τg,   x₁ = shrink(x̂₁, τμ),   Δx = x₁ − x₀,

and per row the three sums the loop's trial needs: ‖Δx‖², ⟨Δx, g⟩ and
‖x₁ − x̂₁‖², in float64; port of ``fasta_tpu/kernels/prox_fused.py:36-129``
(pallas_call at :101).  The CUDA source is
``fasta_tpu_torch/csrc/prox_fused.cu``; its header note gives the design,
and ``shrink_plan`` picks its route.  The wrapper launches the kernel for
CUDA tensors and runs the plain version (``shrink_step_reference``) for
CPU tensors.  Real float32 only, as in the reference; the loop keeps the
composition for other types.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..prox import shrink
from . import _build

__all__ = ["fused_shrink_step", "shrink_step_reference", "shrink_plan",
           "ShrinkPlan", "LAUNCHES"]

# Launches of the kernel, counted where it launches, nowhere else.
LAUNCHES = 0

# The route plan's constants (csrc/prox_fused.cu: kRowThreads,
# kStreamThreads, kStreamBlocksPerSm, kUnroll).  Rows up to ROW_MAX_N
# take the row route, a block each; longer rows take the stream route,
# STREAM_BLOCKS_PER_SM blocks an SM in all, unless that leaves one block
# a row anyway (PERF.md, K-B4: the sweep of n on the card that set
# ROW_MAX_N, ``tools/call_split.py --sweep``).
ROW_THREADS = 512
ROW_MAX_N = 8192
STREAM_THREADS = 256
STREAM_BLOCKS_PER_SM = 3
UNROLL = 4
MAX_ROWS = 65535

# τ's and μ's modes in the C interface: read from a pointer, as doubles,
# one per row (csrc/prox_fused.cu: kFromPtr, kDouble, kPerRow)
_FROM_PTR, _DOUBLE, _PER_ROW = 1, 2, 4


class ShrinkPlan(NamedTuple):
    """How a launch over R rows of n covers them: ``route`` "row" (one
    block of ``threads`` a row, no scratch) or "stream" (``grid[0]``
    blocks a row; a ticket and three FP64 partials a block in
    ``scratch_doubles``); on both, block c of a row walks it from
    c·threads in strides of grid[0]·threads.  ``grid`` is (blocks a row,
    R)."""
    route: str
    grid: tuple
    threads: int
    scratch_doubles: int


def shrink_plan(R: int, n: int, sms: int) -> ShrinkPlan:
    """The route of a launch over R rows of n on a card with ``sms``
    streaming multiprocessors.  A pure function of its arguments; refuses
    what the kernel does not take (R or n below 1, R past 65535)."""
    if R < 1 or n < 1 or R > MAX_ROWS or sms < 1:
        raise ValueError(f"fused_shrink_step takes 1 <= R <= {MAX_ROWS} rows "
                         f"of n >= 1 (got R={R}, n={n}, sms={sms})")
    items = -(-n // 4)                # float4s a row (scalars past that)
    want = -(-items // (STREAM_THREADS * UNROLL))
    per_row = min(want, max(1, STREAM_BLOCKS_PER_SM * sms // R))
    if n <= ROW_MAX_N or per_row == 1:
        return ShrinkPlan("row", (1, R), ROW_THREADS, 0)
    return ShrinkPlan("stream", (per_row, R), STREAM_THREADS,
                      1 + 3 * R * per_row)


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


def _param(v, R, dev, what):
    """(tensor kept alive or None, pointer, value, mode) of τ or μ for the
    kernel: a number, or a one-value CPU tensor, by value; a card tensor
    of one value or R, float32 or float64, read where it lies."""
    if not isinstance(v, torch.Tensor):
        return None, None, float(v), 0
    k = v.numel()
    if k not in (1, R):
        raise ValueError(f"fused_shrink_step: {what} holds {k} values for "
                         f"{R} rows")
    if v.device.type == "cpu" and k == 1:
        return None, None, float(v), 0
    if v.device != dev or v.dtype not in (torch.float32, torch.float64):
        v = v.to(device=dev, dtype=torch.float32)
    v = v.contiguous()
    mode = (_FROM_PTR | (_DOUBLE if v.dtype == torch.float64 else 0)
            | (_PER_ROW if k > 1 else 0))
    return v, v.data_ptr(), 0.0, mode


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, R: int, n: int) -> ShrinkPlan:
    return shrink_plan(R, n, _build.sm_count(device_index))


def fused_shrink_step(x0, g, tau, mu):
    """(x₁, ‖Δx‖², ⟨Δx,g⟩, ‖x₁−x̂₁‖²) in one pass over x0 and g, (n,) or
    (R, n) float32; τ and μ are numbers, 0-d tensors or (R,) tensors (one
    per row).  The sums are float64, 0-d for (n,) input, (R,) for rows.

    CUDA tensors launch kernel K-B4 (contiguous rows; τ and μ on the card,
    float32 or float64, are read there, so they cost no host sync and no
    conversion); CPU tensors run the plain version."""
    _check(x0, g)
    if x0.device.type == "cpu":
        return shrink_step_reference(x0, g, tau, mu)
    if not (x0.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_shrink_step: x0 and g must be contiguous")
    dev = x0.device
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return fused_shrink_step(x0, g, tau, mu)
    n = x0.shape[-1]
    return _launch(x0, g, tau, mu, _plan(dev.index,
                                         x0.numel() // n if n else 0, n))


def _launch(x0, g, tau, mu, plan):
    """One launch of K-B4 on checked card tensors, the current device's,
    over ``plan``."""
    dev, n = x0.device, x0.shape[-1]
    R = plan.grid[1]
    tau_t, tau_p, tau_v, tau_m = _param(tau, R, dev, "tau")
    mu_t, mu_p, mu_v, mu_m = _param(mu, R, dev, "mu")
    x1 = torch.empty_like(x0)
    sums = torch.empty((3, R) if x0.ndim == 2 else (3,), device=dev,
                       dtype=torch.float64)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    work = (None if plan.route == "row" else
            _build.stream_scratch(dev, stream, plan.scratch_doubles))
    err = _build.library().fasta_shrink_step(
        x0.data_ptr(), g.data_ptr(), tau_p, tau_v, mu_p, mu_v,
        tau_m | mu_m << 4, R, n,
        0 if plan.route == "row" else plan.grid[0], x1.data_ptr(),
        sums.data_ptr(), None if work is None else work.data_ptr(), stream)
    if err:
        _build.check(err, "fasta_shrink_step")
    global LAUNCHES
    LAUNCHES += 1
    return (x1,) + sums.unbind(0)
