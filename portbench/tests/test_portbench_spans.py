"""The readers of the program's spans on a synthetic trace: idle gaps
charged whole to the span the host was in when each began, the serving
layer's own time, and nothing read without the spans."""

import collections

import pytest

import fasta_tpu_torch as ftt
from portbench import harness, spans, tracing

MS = 1_000_000
READERS = ("serving_host_ms", "loop_read_idle_pct", "loop_launch_idle_pct")


def synthetic_trace(with_spans=True):
    """20 ms: two requests, the first through two loop iterations.  The
    card is busy 1-3, 5-6.5 (a copy to the host last), 9-10, 12-13 and
    15-16 ms; its gaps begin at 0 (no span), 3 (iteration), 6.5 (a
    backtrack read, running on into the next iteration), 10 (iteration),
    13 (a stop read) and 16 ms (the loop's result)."""
    device = [("k", 1 * MS, 3 * MS), ("k", 5 * MS, 6 * MS),
              ("Memcpy DtoH (Device -> Pageable)", 6 * MS, 6.5 * MS),
              ("k", 9 * MS, 10 * MS), ("k", 12 * MS, 13 * MS),
              ("k", 15 * MS, 16 * MS)]
    host = [("portbench.traced", 0, 20 * MS),
            ("portbench.request", 0, 18.1 * MS),
            ("aten::mm", 9.5 * MS, 10.5 * MS),
            ("portbench.request", 18.1 * MS, 19.8 * MS)]
    if with_spans:
        host += [("fasta.serve", 0.2 * MS, 18 * MS),
                 ("fasta.route.batch_solver", 0.7 * MS, 17.5 * MS),
                 ("fasta.loop.setup", 0.8 * MS, 1.5 * MS),
                 ("fasta.loop.iteration", 1.5 * MS, 8 * MS),
                 ("fasta.loop.read.backtrack", 4 * MS, 7 * MS),
                 ("fasta.loop.iteration", 8 * MS, 13.8 * MS),
                 ("fasta.loop.read.stop", 12.5 * MS, 13.5 * MS),
                 ("fasta.loop.result", 13.8 * MS, 16.5 * MS),
                 ("fasta.serve", 18.2 * MS, 19.5 * MS),
                 ("fasta.route.microsolve_batch", 18.4 * MS, 19 * MS)]
    return tracing.Trace(device, collections.Counter(n for n, _, _ in host),
                         (0, 20 * MS), host)


def readings(trace, loop_iterations=2):
    traced = harness.Tally()
    traced.loop_iterations = loop_iterations
    return harness.Readings({}, {}, None, harness.Tally(), traced, trace, {},
                            [])


def test_each_gap_goes_whole_to_the_span_it_began_in():
    idle = spans.idle_by_span(synthetic_trace())
    assert dict(idle) == pytest.approx({
        None: 1e-3,
        "fasta.loop.iteration": 4e-3,
        "fasta.loop.read.backtrack": 2.5e-3,
        "fasta.loop.read.stop": 2e-3,
        "fasta.loop.result": 4e-3})


@pytest.mark.parametrize("name, share", [("loop_read_idle_pct", 22.5),
                                         ("loop_launch_idle_pct", 20.0)])
def test_loop_shares(name, share):
    r = readings(synthetic_trace())
    assert harness.reader(name).read(r) == pytest.approx(share)
    idle = harness.reader("device_idle_pct").read(r)
    # the result's gap and the one before the first span are the loop's
    # neither: they stay in the device's idle share alone
    assert idle == pytest.approx(67.5)
    assert not [n for n in r.notes if "loop iterations" in n]


def test_the_loop_shares_and_the_rest_make_the_idle_share():
    r = readings(synthetic_trace())
    parts = sum(harness.reader(n).read(r) for n in READERS[1:])
    rest = 100.0 * (1e-3 + 4e-3) / 20e-3
    assert parts + rest == pytest.approx(
        harness.reader("device_idle_pct").read(r))


def test_serving_host_ms_leaves_out_the_route():
    # (17.8 - 16.8 + 1.3 - 0.6) / 2 ms
    r = readings(synthetic_trace())
    assert harness.reader("serving_host_ms").read(r) == pytest.approx(0.85)


@pytest.mark.parametrize("name", READERS)
def test_without_the_spans_nothing_is_read(name):
    r = readings(synthetic_trace(with_spans=False))
    assert harness.reader(name).read(r) is None
    assert harness.reader(name).read(r._replace(trace=None)) is None


def test_a_count_of_iterations_apart_from_the_harness_is_noted():
    r = readings(synthetic_trace(), loop_iterations=3)
    assert harness.reader("loop_launch_idle_pct").read(r) == pytest.approx(
        20.0)
    assert r.notes == ["spans: the trace holds 2 fasta.loop.iteration "
                       "spans for 3 loop iterations"]


def test_the_clock_check_counts_reads_holding_a_copy():
    t = synthetic_trace()
    assert spans.reads_holding_a_copy(t) == (1, 2)
    r = readings(t)
    harness.reader("loop_read_idle_pct").read(r)
    assert r.notes == ["spans: a copy to the host ends inside 1 of 2 loop "
                       "read spans"]


@pytest.mark.parametrize("name", ["lasso-1000x2000.batch16384",
                                  "tv-512x512.batch8"])
def test_a_traced_run_holds_the_programs_spans(cells, name):
    s = harness.Session(cells[name], 2 ** 31 + 7, "cpu", ftt,
                        log=lambda t: None)
    s.setup()
    s.window(count=1)
    s.traced()
    s.read_trace()
    assert harness.reader("serving_host_ms").read(s.readings()) > 0
    assert spans.count(s.trace, spans.SERVE) == len(s.traced_tally.requests)
    assert not [n for n, _, _ in s.trace.device if n.startswith("fasta.")]
    iterations = spans.count(s.trace, spans.ITERATION)
    assert iterations == s.traced_tally.loop_iterations
    assert (iterations > 0) == name.startswith("lasso")
