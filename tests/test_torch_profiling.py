"""The port's profiling utilities on the CPU (the port of
tests/unit/test_profiling.py): the API surface; rates come from the card.
"""

import json
import os
import types

import torch

from fasta_tpu_torch import profiling

torch.set_num_threads(1)


def test_time_blocking_positive_and_barrier_subtracted(monkeypatch):
    """The subtraction, checked exactly against a stubbed host clock (no
    outcome depends on the machine's load): the two barrier waits read
    0.25 s and 0.5 s, the two runs 1.0 s and 0.5 s; the best run less the
    best barrier is 0.25 s, and without the barrier the best run, 0.5 s."""
    x = torch.ones((64, 64))
    barrier_reads = [0.0, 0.25, 1.0, 1.5]
    run_reads = [10.0, 11.0, 20.0, 20.5]

    def clock(reads):
        it = iter(reads)
        monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
            perf_counter=lambda: next(it)))
        return it

    left = clock(barrier_reads + run_reads)
    t = profiling.time_blocking(torch.matmul, x, x, repeats=2)
    assert next(left, None) is None
    assert t == 0.25 > 0
    left = clock(run_reads)
    t_raw = profiling.time_blocking(torch.matmul, x, x, repeats=2,
                                    subtract_barrier=False)
    assert next(left, None) is None
    assert t_raw == 0.5 and t_raw - t == 0.25   # raw keeps the barrier


def test_roofline_report_fields():
    x = torch.ones((64, 64))
    rep = profiling.roofline_report(64 * 64 * 8 * 2, torch.matmul, x, x,
                                    repeats=2)
    assert rep["seconds"] > 0 and rep["achieved_GBps"] > 0
    assert rep["device_kind"] == "cpu"
    # no card, no roofline: a CPU rate is never read against the card's
    assert rep["roofline_GBps"] is None and rep["fraction_of_roofline"] is None


def test_trace_context_manager(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as d:
        float(torch.sum(torch.ones(128) ** 2))
    assert d == logdir
    with open(os.path.join(logdir, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)


def test_device_memory_stats_shape():
    stats = profiling.device_memory_stats()
    assert len(stats) == max(torch.cuda.device_count(), 1)


def test_device_ops_and_host_us_on_the_cpu(tmp_path):
    """Without a card the trace holds no device operation: no card time,
    every kind counted zero; the host time per call is positive."""
    calls = []
    ops = profiling.device_ops(lambda: calls.append(torch.ones(8).sum()), 3,
                               str(tmp_path / "trace"))
    assert len(calls) == 4            # one call before the trace, three in it
    assert ops["dur_us"] == 0.0 and ops["names"] == []
    assert ops["events"] == {k: 0 for k in profiling.DEVICE_OP_KINDS}
    assert profiling.host_us(lambda: torch.ones(8).sum(), 5) > 0.0
