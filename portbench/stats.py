"""The arithmetic of the end-to-end metrics and of their spread."""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple, Sequence


class Request(NamedTuple):
    """One request of a closed loop: issued and completed on the host's
    clock (seconds), and how many instances it solved."""
    issued: float
    completed: float
    instances: int


def solves_per_s(requests: Sequence[Request], start: float) -> float:
    """Every instance solved, over the time from the window's ``start``
    to the completion of its last request."""
    took = requests[-1].completed - start
    return sum(r.instances for r in requests) / took


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value with at
    least q% of the values at or below it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def request_ms(requests: Sequence[Request]) -> list:
    return [(r.completed - r.issued) * 1e3 for r in requests]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile over the median,
    as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
