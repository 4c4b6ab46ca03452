"""Reading a ``torch.profiler`` trace of the traced requests: the card's
operations and their union, the host's runtime calls by name, and what
the host was doing while the card idled.

The traced segment is the user annotation ``TRACED``; each request in it
is the annotation ``REQUEST``.  Times are the trace's own (ns)."""

from __future__ import annotations

import re
from collections import Counter
from typing import NamedTuple

TRACED = "portbench.traced"
REQUEST = "portbench.request"

# runtime calls that launch a device operation, and those where the host
# waits for the card (a copy to the host ends in a stream synchronize)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaMemsetAsync")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")


class Trace(NamedTuple):
    """What one traced segment held: ``device`` its card operations
    (name, start, end), ``calls`` the host's events by name, the
    segment's ``window`` (start, end), and ``host`` the main thread's
    events (name, start, end) for ``idle_gaps``."""
    device: list
    calls: Counter
    window: tuple
    host: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the card's operations inside the window, as
        disjoint (start, end) intervals in order."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernels(self, pattern: str) -> list:
        """Durations (s) of the card operations whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        return [(e - s) * 1e-9 for name, s, e in self.device
                if rx.search(name)]

    def device_ops(self, top: int = 10) -> list:
        """The card's operations that took the most time: [name, s]."""
        total = Counter()
        for name, s, e in self.device:
            total[short(name)] += (e - s) * 1e-9
        return [[n, t] for n, t in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The card's idle time inside the window, by the innermost host
        event open at the middle of each gap: [name, s]."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        total, stack, i = Counter(), [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + e) / 2
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            total[short(stack[-1][0]) if stack else "(none)"] += (e - s) * 1e-9
        return [[n, t] for n, t in total.most_common(top)]


def short(name: str) -> str:
    """A kernel's or call's name as at most 64 letters, digits, ``_``,
    ``.``, ``:`` and ``-``."""
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def _is_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA")


def read(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose
    traced requests ran inside the annotation ``TRACED``."""
    events = prof.profiler.kineto_results.events()
    device, host, calls = [], [], Counter()
    window, thread = None, None
    for ev in events:
        name = ev.name()
        if _is_device(ev):
            if not name.startswith("portbench.") and not (
                    hasattr(ev, "is_user_annotation")
                    and ev.is_user_annotation()):
                device.append((name, ev.start_ns(), ev.end_ns()))
            continue
        calls[name] += 1
        if name == TRACED:
            window, thread = (ev.start_ns(), ev.end_ns()), ev.start_thread_id()
    if window is None:
        raise RuntimeError(f"the trace holds no {TRACED!r} annotation")
    host = [(ev.name(), ev.start_ns(), ev.end_ns()) for ev in events
            if not _is_device(ev) and ev.start_thread_id() == thread]
    return Trace(device, calls, window, host)
