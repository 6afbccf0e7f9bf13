"""The metric arithmetic on synthetic event times."""

import statistics

import pytest

from mmfbench import stats


def test_rate_takes_every_step_over_the_whole_window():
    steps = [10.0] * 9 + [100.0]          # ms: one slow GCM boundary
    assert stats.rate(1000, steps) == pytest.approx(1000 * 10 / 0.19)


def test_p95_is_over_all_steps():
    steps = [10.0] * 95 + [50.0] * 5
    assert stats.p95(steps) == pytest.approx(
        statistics.quantiles(steps, n=20, method="inclusive")[-1])
    assert 10.0 < stats.p95(steps) <= 50.0
    assert stats.p95([1.0] * 100) == 1.0
    with pytest.raises(ValueError):
        stats.p95([1.0])


def test_idle_is_the_window_outside_the_bracketed_calls():
    # calls of 8, 8 and 2 ms in a window of 20 ms: 2 ms idle
    assert stats.idle_pct([8.0, 8.0, 2.0], 20.0) == pytest.approx(10.0)
    assert stats.idle_pct([20.0], 20.0) == 0.0


def test_union():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([]) == 0
