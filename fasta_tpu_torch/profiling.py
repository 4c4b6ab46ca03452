"""Tracing and timing utilities: the port of ``fasta_tpu/profiling.py``.

  * ``trace(logdir)`` — ``torch.profiler`` around a block, writing a Chrome
    trace (the card's kernels too when one is present);
  * ``time_blocking(fn, *args)`` — the best time of a call, ended by a
    completion wait (CUDA events and a synchronize on the card);
  * ``roofline_report(bytes_per_call, fn, *args)`` — achieved GB/s
    against the card's memory rate;
  * ``device_memory_stats()`` — ``torch.cuda.memory_stats`` per card.

Per-iteration diagnostics are tensors in the solvers' results, so no
separate tracer is needed.  Rates are keyed on
``torch.cuda.get_device_name()``; the TPU table of the JAX module does not
carry over.  On the CPU, or on a card not in the table, the roofline is
None.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["trace", "roofline_report", "device_memory_stats",
           "time_blocking", "H100_HBM_GBPS"]

# The H100 SXM's data-sheet HBM3 rate (GB/s), the one card the port is
# measured on; ``chip_smoke.py``'s bounds read it from here.
H100_HBM_GBPS = 3350.0

# Device-memory rate by card, matched as a substring of the lower-cased
# device name.  "h100" alone would also match the PCIe part (2000 GB/s),
# so the SXM part is named by its HBM3.
_HBM_ROOFLINE_GBPS = {"h100 80gb hbm3": H100_HBM_GBPS}


def _on_card(args) -> bool:
    return torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda for a in args)


@contextlib.contextmanager
def trace(logdir: str = "build/fasta_tpu_torch_trace"):
    """Profile a block; its Chrome trace goes to ``logdir/trace.json``.
    The card's activity is recorded when a card is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_blocking(fn, *args, repeats: int = 3, warmup: int = 1,
                  subtract_barrier: bool = True) -> float:
    """Best time in seconds of ``fn(*args)``, each run ended by a
    completion wait.  With CUDA tensors among ``args`` a run is timed by
    CUDA events and ended by ``torch.cuda.synchronize()``; otherwise by
    the host clock.  ``subtract_barrier`` measures the cost of a wait with
    nothing pending (the counterpart of the JAX module's host readback)
    and subtracts it."""
    card = _on_card(args)

    def wait():
        if card:
            torch.cuda.synchronize()

    for _ in range(max(warmup, 1)):
        fn(*args)
    wait()
    barrier = 0.0
    if subtract_barrier:
        barrier = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            wait()
            barrier = min(barrier, time.perf_counter() - t0)
    best = float("inf")
    for _ in range(repeats):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn(*args)
            end.record()
            wait()
            # the events time the card; the host clock the whole call
            took = max(start.elapsed_time(end) * 1e-3,
                       time.perf_counter() - t0 - barrier)
        else:
            t0 = time.perf_counter()
            fn(*args)
            took = time.perf_counter() - t0 - barrier
        best = min(best, took)
    return max(best, 1e-12)


def _device_kind() -> str:
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _chip_roofline() -> Optional[float]:
    kind = _device_kind().lower()
    for key, bw in _HBM_ROOFLINE_GBPS.items():
        if key in kind:
            return bw
    return None


def roofline_report(bytes_per_call: int, fn, *args, repeats: int = 5,
                    warmup: int = 1) -> dict:
    """Time ``fn(*args)`` (``time_blocking``) and report achieved GB/s
    against the card's data-sheet memory rate (None on the CPU or an
    unknown card)."""
    best = time_blocking(fn, *args, repeats=repeats, warmup=warmup)
    gbps = bytes_per_call / best / 1e9
    roof = _chip_roofline() if _on_card(args) else None
    return {
        "seconds": best,
        "achieved_GBps": gbps,
        "roofline_GBps": roof,
        "fraction_of_roofline": (gbps / roof) if roof else None,
        "device_kind": _device_kind() if _on_card(args) else "cpu",
    }


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` for each CUDA device; without a card
    one entry, the CPU, which exposes none (None)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
