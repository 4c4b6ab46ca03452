"""The port's profiling utilities on the CPU (the port of
tests/unit/test_profiling.py): the API surface; rates come from the card.
"""

import json
import os

import torch

from fasta_tpu_torch import profiling

torch.set_num_threads(1)


def test_time_blocking_positive_and_barrier_subtracted():
    x = torch.ones((64, 64))
    t = profiling.time_blocking(torch.matmul, x, x, repeats=2)
    assert t > 0
    t_raw = profiling.time_blocking(torch.matmul, x, x, repeats=2,
                                    subtract_barrier=False)
    assert t_raw >= t * 0.5  # raw includes the barrier; both positive


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
