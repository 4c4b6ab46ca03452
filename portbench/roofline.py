"""The yardstick of the kernels' roofline shares: the card's published
rates, and the operations and bytes each kernel needs for the work it was given, counted from
shapes and iteration counts.  The formulas are copies of
``chip_smoke.py``'s ``bound``, ``tv_flops`` and K-B6b's bytes, so that
they read the same work whatever implements it."""

from __future__ import annotations

from typing import Optional

# Published rates of the cards the benchmark knows, matched as a substring
# of the device name: bytes/s of device memory and float32 FLOP/s outside
# the tensor cores (NVIDIA's data sheet, H100 SXM at 700 W).
PEAKS = {
    "H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12},
}


def peaks(device_name: str) -> Optional[dict]:
    """The rates of ``device_name``, or None for a card not in the table
    (a roofline is then not reported)."""
    for key, rates in PEAKS.items():
        if key in device_name:
            return rates
    return None


def bound_s(nbytes: float, flops: float, rates: dict) -> float:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``flops`` over the float32 peak."""
    return max(nbytes / rates["hbm_bytes_per_s"], flops / rates["f32_flops"])


def kb4_bytes(rows: int, n: int) -> float:
    """Bytes one K-B4 call over (rows, n) float32 needs: x and g read
    once and x̂₁ written once (4 B an element each), and per row its τ
    (4 B) and its three float64 sums (24 B)."""
    return 12.0 * rows * n + 28.0 * rows


def tv_flops(h: int, w: int, tried: int, points: int) -> float:
    """float32 operations of K-B6 on the TV dual in the adaptive mode,
    per pixel (both channels), as ``chip_smoke.py::tv_flops`` counts
    them: 53 a trial, 11 a start."""
    return float(h * w * (tried * 53 + points * 11))


def kb6b_bytes(images: int, h: int, w: int, accepted: int) -> float:
    """Bytes one K-B6b launch over ``images`` needs, as ``chip_smoke.py``
    counts them: the images, the shared dual start and τ₀ in; each
    image's dual field and its ``accepted`` entries of τ, residual and
    backtracks out."""
    return 4.0 * (images * h * w + 2 * h * w + 1 + images * 2 * h * w
                  + 3 * accepted)
