"""The end-to-end arithmetic: the rate is all the work over all the time of
the window, the tail is over every request, and a stall moves both."""

import pytest

from portbench import stats


def closed_loop(times, instances=100, start=10.0):
    """A closed loop of one client: each request issued at the previous
    one's completion."""
    out, t = [], start
    for dt in times:
        out.append(stats.Request(t, t + dt, instances))
        t += dt
    return out


def test_rate_is_all_instances_over_all_the_time():
    reqs = closed_loop([0.2] * 10)
    assert stats.solves_per_s(reqs, 10.0) == pytest.approx(1000 / 2.0)
    # time before the first issue counts too
    assert stats.solves_per_s(reqs, 9.0) == pytest.approx(1000 / 3.0)


def test_the_rate_is_not_whole_requests_over_nominal_seconds():
    # 10 requests of 0.2 s completing at 2.0 s, and a window asked for
    # 1.9 s: the rate is over the 2.0 s spent, not over 1.9
    reqs = closed_loop([0.2] * 10)
    assert stats.solves_per_s(reqs, 10.0) != pytest.approx(1000 / 1.9)


def test_percentile_by_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[:20], 95) == 19
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2


def test_a_stall_moves_the_rate_and_the_tail():
    steady = closed_loop([0.2] * 200)
    stalled = closed_loop([0.2] * 180 + [0.5] * 20)
    assert stats.solves_per_s(stalled, 10.0) < stats.solves_per_s(steady,
                                                                   10.0)
    assert (stats.percentile(stats.request_ms(stalled), 95)
            > stats.percentile(stats.request_ms(steady), 95))
    # one stalled request of 200 moves the rate but not the p95
    one = closed_loop([0.2] * 199 + [2.0])
    assert stats.solves_per_s(one, 10.0) < stats.solves_per_s(steady, 10.0)
    assert stats.percentile(stats.request_ms(one), 95) == pytest.approx(200)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)
    assert stats.spread([7.0] * 6) == 0.0
