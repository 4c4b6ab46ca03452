"""The adaptive loop's elementwise chain over the lanes, fused.

Three kernels over rows (R, ...) of float32, one row a lane of the loop
(``solver._run``; a single solve is one row):

* ``residual_value(d, b, hp)`` → (r, f): r = d − b and each row's
  f = ½‖r‖² (float64 with ``hp``, else float32), b shared by the rows or
  one row a lane.  The trial carries r, so the gradient map of the
  accepted trial reads it and does not subtract again.
* ``adaptive_sums(x, g, x1, gf1, tau, hp)`` → (‖g‖², ⟨Δx, Δg⟩, ‖Δg‖²) a
  row, with x̂₁ = x − τg, Δx = x₁ − x and Δg = ∇f₁ + (x̂₁ − x)/τ kept in
  registers; ⟨Δx, Δg⟩ in float64 with ``hp``, the others float32.
* ``lane_update(x1, gf1, live, better, x, gradf, best_x)``: x and ∇f
  take x₁ and ∇f₁ in the rows where ``live`` is set, the best iterate x₁
  where ``better`` is, in place; every other row is left as it was.  (In
  adaptive mode the solution is x₁ at every point, so the loop returns x
  as the solution.)

The CUDA source is ``fasta_tpu_torch/csrc/lane_fused.cu``; its header note
gives the design.  A wrapper launches its kernel for CUDA tensors that
``lane_plan`` admits and raises for the others; for CPU tensors it runs
the plain version beside it, which is the composition of PyTorch
operations that the loop runs where the kernels do not engage.  The
loop decides once a solve whether they engage (``lanes_route``,
``residual_route``) and then calls them on every trial and iteration.
The float64 sums differ from the plain versions' only in their order; every
elementwise output is the plain version's, bit for bit.
"""

from __future__ import annotations

import math

import torch

from ..precision import lane, lane_dot64, lane_norm2, lane_redot
from . import _build

__all__ = ["residual_value", "adaptive_sums", "lane_update",
           "residual_value_reference", "adaptive_sums_reference",
           "lane_update_reference", "lane_plan", "lanes_route",
           "residual_route", "RESIDUAL_LAUNCHES", "SUMS_LAUNCHES",
           "UPDATE_LAUNCHES"]

# Launches of each kernel, counted where it launches, nowhere else.
RESIDUAL_LAUNCHES = 0
SUMS_LAUNCHES = 0
UPDATE_LAUNCHES = 0

# A warp a row (csrc/lane_fused.cu: kWarps rows a block).  Rows of up to
# ROW_MAX_N entries take the kernels at any count (chip_smoke.py phase 36
# times 1×8192 against the composition); a longer row would keep one warp
# busy while the card idles, and the loop keeps the composition there.
ROW_MAX_N = 8192


def lane_plan(R: int, n: int) -> bool:
    """Whether the kernels take R rows of n.  A pure function of its
    arguments."""
    return 1 <= R < 1 << 31 and 1 <= n <= ROW_MAX_N


def _row(t) -> int:
    return math.prod(t.shape[1:])


def lanes_route(x) -> bool:
    """Whether the sums and the update take the lanes of x (B, ...): real
    float32 on a CPU (their plain versions) or CUDA device, in rows that
    ``lane_plan`` admits.  The loop decides this once a solve."""
    return (x.ndim >= 1 and x.dtype == torch.float32
            and x.device.type in ("cpu", "cuda")
            and lane_plan(x.shape[0], _row(x)))


def residual_route(b, R: int, device) -> bool:
    """Whether the residual takes the data b of R lanes on ``device``:
    float32, contiguous, there, and rows (b's own, or its rows where it
    has one a lane) that ``lane_plan`` admits.  The loop decides this
    once a solve."""
    if not (torch.is_tensor(b) and b.dtype == torch.float32
            and b.device == device and b.is_contiguous() and b.ndim >= 1):
        return False
    m = _row(b) if b.ndim >= 2 and b.shape[0] == R else b.numel()
    return device.type in ("cpu", "cuda") and lane_plan(R, m)


def _check(what, rows, flags=(), b=None) -> None:
    """Raise unless ``rows`` are contiguous float32 tensors of one shape
    (R, ...) on one CPU or CUDA device, ``flags`` (tensor, dtype) pairs of
    shape (R,) there, and b float32 there, contiguous, with a row's
    entries or all of them.  A kernel given other tensors would read or
    write past them, so this check stays on."""
    first = rows[0]
    shape, dev = first.shape, first.device
    fault = None
    if first.ndim < 1 or dev.type not in ("cpu", "cuda"):
        fault = f"needs rows (R, ...) on a CPU or CUDA device, got {shape}"
    elif any(t.dtype != torch.float32 or t.shape != shape
             or t.device != dev or not t.is_contiguous() for t in rows):
        fault = (f"needs contiguous float32 rows of one shape {tuple(shape)} "
                 f"on one device, got "
                 f"{[(t.dtype, tuple(t.shape)) for t in rows]}")
    elif any(t.dtype != dt or t.shape != shape[:1] or t.device != dev
             or not t.is_contiguous() for t, dt in flags):
        fault = (f"needs per-row values of shape {tuple(shape[:1])}, got "
                 f"{[(t.dtype, tuple(t.shape)) for t, _ in flags]}")
    elif b is not None and (
            b.dtype != torch.float32 or b.device != dev
            or not b.is_contiguous()
            or b.numel() not in (first.numel(), _row(first))):
        fault = (f"needs a contiguous float32 b with a row's entries or "
                 f"all of them, got {b.dtype} {tuple(b.shape)}")
    elif dev.type == "cuda" and not lane_plan(shape[0], _row(first)):
        fault = (f"rows of {_row(first)} take the kernels only when at "
                 f"most {ROW_MAX_N} long (lane_plan)")
    if fault is not None:
        raise ValueError(f"{what}: {fault}")


def residual_value_reference(d, b, hp: bool):
    """The plain version: ``LeastSquares``'s value in the loop's decision
    precision, with its residual."""
    r = d - b
    return r, (0.5 * lane_dot64(r, r) if hp else 0.5 * lane_redot(r, r))


def adaptive_sums_reference(x, g, x1, gf1, tau, hp: bool):
    """The plain version: the adaptive branch's composition."""
    t = lane(tau, x)
    x1hat = x - t * g
    dx = x1 - x
    dg = gf1 + (x1hat - x) / t
    return (lane_norm2(g), lane_dot64(dx, dg) if hp else lane_redot(dx, dg),
            lane_norm2(dg))


def lane_update_reference(x1, gf1, live, better, x, gradf, best_x) -> None:
    """The plain version: the loop's keeps, written into the old
    tensors."""
    for old, new, flag in ((x, x1, live), (gradf, gf1, live),
                           (best_x, x1, better)):
        torch.where(lane(flag, new), new, old, out=old)


def residual_value(d, b, hp: bool):
    """(r, f) = (d − b, ½‖d − b‖² a row) for d (R, ...) float32 and b
    shaped like a row of d (shared) or like d; f float64 with ``hp``,
    else float32.  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check("residual_value", [d], b=b)
    if d.device.type == "cpu":
        return residual_value_reference(d, b, hp)
    R = d.shape[0]
    r = torch.empty_like(d)
    f = torch.empty(R, device=d.device,
                    dtype=torch.float64 if hp else torch.float32)
    with _build.on_device(d.device) as stream:
        err = _build.library().fasta_lane_residual(
            d.data_ptr(), b.data_ptr(), int(b.numel() == d.numel()), R,
            _row(d), int(hp), r.data_ptr(), f.data_ptr(), stream)
    _build.check(err, "fasta_lane_residual")
    global RESIDUAL_LAUNCHES
    RESIDUAL_LAUNCHES += 1
    return r, f


def adaptive_sums(x, g, x1, gf1, tau, hp: bool):
    """(‖g‖², ⟨Δx, Δg⟩, ‖Δg‖²) a row for rows x, g, x₁, ∇f₁ (R, ...)
    float32 and τ (R,) float32, with Δx = x₁ − x and Δg = ∇f₁ + (x̂₁ −
    x)/τ, x̂₁ = x − τg; ⟨Δx, Δg⟩ float64 with ``hp``, the others float32.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check("adaptive_sums", [x, g, x1, gf1], [(tau, torch.float32)])
    if x.device.type == "cpu":
        return adaptive_sums_reference(x, g, x1, gf1, tau, hp)
    R = x.shape[0]
    fsums = torch.empty((2, R), device=x.device, dtype=torch.float32)
    dot = torch.empty(R, device=x.device,
                      dtype=torch.float64 if hp else torch.float32)
    with _build.on_device(x.device) as stream:
        err = _build.library().fasta_lane_sums(
            x.data_ptr(), g.data_ptr(), x1.data_ptr(), gf1.data_ptr(),
            tau.data_ptr(), R, _row(x), int(hp), fsums.data_ptr(),
            dot.data_ptr(), stream)
    _build.check(err, "fasta_lane_sums")
    global SUMS_LAUNCHES
    SUMS_LAUNCHES += 1
    return fsums[0], dot, fsums[1]


def lane_update(x1, gf1, live, better, x, gradf, best_x) -> None:
    """x and gradf take x1 and gf1 in the rows where ``live`` (R,) is
    set, best_x takes x1 where ``better`` (R,) is set, in place; rows
    (R, ...) float32.  CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _check("lane_update", [x1, gf1, x, gradf, best_x],
           [(live, torch.bool), (better, torch.bool)])
    if x1.device.type == "cpu":
        return lane_update_reference(x1, gf1, live, better, x, gradf, best_x)
    with _build.on_device(x1.device) as stream:
        err = _build.library().fasta_lane_update(
            x1.data_ptr(), gf1.data_ptr(), live.data_ptr(),
            better.data_ptr(), x1.shape[0], _row(x1), x.data_ptr(),
            gradf.data_ptr(), best_x.data_ptr(), stream)
    _build.check(err, "fasta_lane_update")
    global UPDATE_LAUNCHES
    UPDATE_LAUNCHES += 1
