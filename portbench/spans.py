"""Reading the program's own spans (``fasta.*``, opened by
``fasta_tpu_torch.profiling.span``) from a traced segment: each span with
the ones inside it, and the card's idle gaps charged to the span the host
was in when each gap began.

The spans are the main thread's events in ``Trace.host``, on the clock of
the card's operations.  A gap begins at the end of the last device
operation before it (or at the segment's start), when the card's queue
ran dry; the innermost ``fasta.*`` span open at that instant says what
the host was doing then, and the whole gap is charged to it."""

from __future__ import annotations

import re
from collections import Counter

PREFIX = "fasta."
SERVE = "fasta.serve"
ROUTE = "fasta.route."
ITERATION = "fasta.loop.iteration"
# the loop's device reads, and where the host issues the loop's launches
READS = ("fasta.loop.read.backtrack", "fasta.loop.read.stop",
         "fasta.loop.read.resume")
LAUNCHES = (ITERATION, "fasta.loop.setup")
# a copy to the host, which every device read ends with
TO_HOST = re.compile(r"Memcpy DtoH|Memcpy_DtoH")


def spans(trace) -> list:
    """The ``fasta.*`` spans inside the segment as (name, start, end),
    outer before inner."""
    lo, hi = trace.window
    return sorted(((n, s, e) for n, s, e in trace.host
                   if n.startswith(PREFIX) and s >= lo and e <= hi),
                  key=lambda sp: (sp[1], -sp[2]))


def count(trace, name: str) -> int:
    return sum(n == name for n, _, _ in spans(trace))


def serving_host_s(trace) -> list:
    """For each ``fasta.serve`` span, its duration less that of the
    ``fasta.route.*`` spans inside it (s)."""
    all_spans = spans(trace)
    routes = [sp for sp in all_spans if sp[0].startswith(ROUTE)]
    out = []
    for name, s, e in all_spans:
        if name == SERVE:
            inside = sum(re - rs for _, rs, re in routes
                         if rs >= s and re <= e)
            out.append((e - s - inside) * 1e-9)
    return out


def gaps(trace) -> list:
    """The card's idle gaps inside the segment as (start, end)."""
    lo, hi = trace.window
    out, at = [], lo
    for s, e in trace.busy_intervals():
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def idle_by_span(trace) -> Counter:
    """The card's idle time (s) by the innermost ``fasta.*`` span open
    when each gap began; ``None`` holds the gaps that began outside every
    span."""
    todo = spans(trace)
    total, stack, i = Counter(), [], 0
    for s, e in gaps(trace):
        while i < len(todo) and todo[i][1] <= s:
            while stack and stack[-1][2] <= todo[i][1]:
                stack.pop()
            stack.append(todo[i])
            i += 1
        while stack and stack[-1][2] <= s:
            stack.pop()
        total[stack[-1][0] if stack else None] += (e - s) * 1e-9
    return total


def idle_pct(r, names) -> float | None:
    """The card's idle share of the segment (%) in gaps that began in one
    of the spans ``names``; None without loop spans.  A count of
    ``fasta.loop.iteration`` spans other than the harness's loop
    iterations is noted."""
    if r.trace is None or not r.trace.device:
        return None
    iterations = count(r.trace, ITERATION)
    if not iterations:
        return None
    if r.traced is not None and iterations != r.traced.loop_iterations:
        r.note(f"spans: the trace holds {iterations} {ITERATION} spans for "
               f"{r.traced.loop_iterations} loop iterations")
    idle = idle_by_span(r.trace)
    return 100.0 * sum(idle[n] for n in names) / r.trace.window_s


def reads_holding_a_copy(trace) -> tuple:
    """(read spans inside which a copy to the host ends, read spans): the
    check that the spans and the card's operations share one clock."""
    ends = sorted(e for n, _, e in trace.device if TO_HOST.search(n))
    reads = [sp for sp in spans(trace) if sp[0] in READS]
    held, j = 0, 0
    for _, s, e in sorted(reads, key=lambda sp: sp[1]):
        while j < len(ends) and ends[j] < s:
            j += 1
        held += j < len(ends) and ends[j] <= e
    return held, len(reads)
