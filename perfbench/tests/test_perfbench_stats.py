"""The end-to-end statistics: all work over all time, and a p90 over
every step."""

import pytest

from perfbench import stats


def test_step_time_is_the_window_over_all_steps():
    # the steps' own times do not enter the mean: 10 s over 50 steps
    m = stats.window_metrics(10.0, [150.0] * 49 + [2650.0])
    assert m["train_step_ms"] == pytest.approx(200.0)


def test_rate_counts_every_step_whatever_their_times():
    fast = stats.window_metrics(10.0, [100.0] * 100)
    uneven = stats.window_metrics(10.0, [50.0] * 50 + [150.0] * 50)
    assert fast["train_step_ms"] == uneven["train_step_ms"] == 100.0


def test_p90_moves_when_a_step_stalls():
    steps = [100.0] * 10
    base = stats.window_metrics(1.0, steps)["train_step_ms_p90"]
    for i in range(10):
        stalled = list(steps)
        stalled[i] = 400.0
        got = stats.window_metrics(1.3, stalled)["train_step_ms_p90"]
        assert got > base


def test_p90_is_over_all_steps():
    steps = [100.0] * 89 + [300.0] * 11
    assert stats.window_metrics(1.0, steps)["train_step_ms_p90"] == 300.0
    assert stats.percentile(list(range(11)), 90) == pytest.approx(9.0)


def test_each_step_takes_its_slowest_rank():
    per_rank = [[100.0, 101.0, 99.0], [98.0, 130.0, 100.0]]
    assert stats.slowest_rank(per_rank) == [100.0, 130.0, 100.0]
    with pytest.raises(ValueError):
        stats.slowest_rank([[1.0, 2.0], [1.0]])
