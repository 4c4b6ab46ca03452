"""Tracing and timing utilities: the port of ``fasta_tpu/profiling.py``.

  * ``trace(logdir)`` — ``torch.profiler`` around a block, writing a Chrome
    trace (the card's kernels too when one is present);
  * ``time_blocking(fn, *args)`` — the best time of a call, ended by a
    completion wait (CUDA events and a synchronize on the card);
  * ``roofline_report(bytes_per_call, fn, *args)`` — achieved GB/s
    against the card's memory rate;
  * ``device_memory_stats()`` — ``torch.cuda.memory_stats`` per card;
  * ``device_ops(fn)`` — the device operations (kernels, memsets, copies)
    of a run of calls and their card time, read from a trace;
  * ``host_us(fn)`` — the host's time per call, with no wait for the card;
  * ``graph_node_kinds(graph)`` — the kinds of a captured CUDA graph's
    nodes (kernels, memsets, copies), read from the CUDA driver;
  * ``span(name)`` — the program's own named span: a
    ``torch.profiler.record_function`` while a profiler runs, else a
    shared null context that costs one attribute read.

Per-iteration diagnostics are tensors in the solvers' results; where the
host's time goes in a request, the spans tell.  The serving path, the
PyTorch loop and the whole-solve routes open them (``fasta.serve``,
``fasta.route.<route>``, ``fasta.loop.*``, ``fasta.micro.*``; README),
and any ``torch.profiler`` run records them in the same trace as the
card's kernels, on the same clock.  No switch turns them on.

Rates are keyed on ``torch.cuda.get_device_name()``; the TPU table of the
JAX module does not carry over.  On the CPU, or on a card not in the table, the roofline is
None.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import time
from typing import Optional

import torch

__all__ = ["trace", "roofline_report", "device_memory_stats",
           "time_blocking", "device_ops", "host_us", "graph_node_kinds",
           "span", "H100_HBM_GBPS"]

# The H100 SXM's data-sheet HBM3 rate (GB/s), the one card the port is
# measured on; ``chip_smoke.py``'s bounds read it from here.
H100_HBM_GBPS = 3350.0

# Device-memory rate by card, matched as a substring of the lower-cased
# device name.  "h100" alone would also match the PCIe part (2000 GB/s),
# so the SXM part is named by its HBM3.
_HBM_ROOFLINE_GBPS = {"h100 80gb hbm3": H100_HBM_GBPS}


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The context of the program's span ``name``: a
    ``torch.profiler.record_function`` while a profiler runs, else one
    shared null context.  The profiler's flag is read from its module on
    every call (torch has no public form of it): an entered
    ``record_function`` costs the host microseconds even with no
    profiler, the read a small fraction of one."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


# the Chrome trace's categories of the card's own operations
DEVICE_OP_KINDS = ("kernel", "gpu_memset", "gpu_memcpy")


def device_ops(fn, calls: int = 20,
               logdir: str = "build/fasta_tpu_torch_trace") -> dict:
    """What ``calls`` calls of ``fn`` did on the card, from the Chrome
    trace of ``trace(logdir)``: ``events``, how many operations of each
    kind in ``DEVICE_OP_KINDS``; ``dur_us``, their summed duration; the
    kernels' ``names``.  One call runs before the trace, so that nothing
    is built or allocated inside it.  The profiler can drop an event now
    and then, so a count may fall short of the calls'."""
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with trace(logdir) as d:
        for _ in range(calls):
            fn()
    with open(os.path.join(d, "trace.json")) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("cat") in DEVICE_OP_KINDS]
    return dict(
        events={k: sum(e["cat"] == k for e in events)
                for k in DEVICE_OP_KINDS},
        dur_us=sum(float(e.get("dur", 0.0)) for e in events),
        names=sorted({e.get("name", "?")[:80] for e in events
                      if e["cat"] == "kernel"}))


def host_us(fn, calls: int = 200) -> float:
    """The host's time per call of ``fn`` in µs: the host clock around
    ``calls`` calls with no wait for the card between them (after a
    warm-up call and a wait).  Where the card finishes a call sooner than
    the host issues one, this is the call's whole cost to a loop."""
    card = torch.cuda.is_available()
    fn()
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    if card:
        torch.cuda.synchronize()
    return took / calls * 1e6


# The CUDA driver's CUgraphNodeType codes of the kinds ``graph_node_kinds`` names
_GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_node_kinds(graph) -> dict:
    """How many nodes of each kind (``kernel``, ``memcpy``, ``memset``,
    ``other``) a captured CUDA graph holds, read through the CUDA driver's
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType``.  The graph must keep
    its captured form: ``torch.cuda.CUDAGraph(keep_graph=True)``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed with CUDA driver error {err}")

    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)),
          "cuGraphGetNodes")
    kinds = dict.fromkeys((*_GRAPH_NODE_KINDS.values(), "other"), 0)
    for node in nodes[:count.value]:
        code = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(code)),
              "cuGraphNodeGetType")
        kinds[_GRAPH_NODE_KINDS.get(code.value, "other")] += 1
    return kinds


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
