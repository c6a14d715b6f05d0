"""The window rule and the nearest-rank percentile."""

import pytest

from benchmark import stats


def test_window_closes_at_last_completion_before_deadline():
    window, n = stats.close_window(10.0, 55.0, [12.5, 15.0, 54.9, 57.4])
    assert n == 3 and window == pytest.approx(44.9)


def test_window_with_nothing_completed():
    assert stats.close_window(0.0, 5.0, [6.0]) == (0.0, 0)


@pytest.mark.parametrize("q, want", [(0.9, 9.0), (0.5, 5.0), (1.0, 10.0), (0.01, 1.0)])
def test_nearest_rank(q, want):
    assert stats.nearest_rank([float(v) for v in range(10, 0, -1)], q) == want


def test_nearest_rank_of_seventeen():
    values = list(range(1, 18))  # ceil(0.9 * 17) = 16th smallest
    assert stats.nearest_rank(values, 0.9) == 16


def test_spread():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9.0, 10.0, 10.0, 11.0]) > 0
