"""The window rule and the statistics of the end-to-end metrics."""

from __future__ import annotations

import math
import statistics
from typing import List, Sequence, Tuple


def close_window(t_open: float, deadline: float, done: Sequence[float]) -> Tuple[float, int]:
    """(window seconds, units completed in it): the window opens at
    ``t_open`` and closes at the last completion at or before ``deadline``;
    work still in flight then is left out of both the count and the time."""
    inside = [t for t in done if t_open <= t <= deadline]
    if not inside:
        return 0.0, 0
    return max(inside) - t_open, len(inside)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the ceil(q * n)-th
    smallest value."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q * len(ordered))) - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def mean(values: List[float]) -> float:
    return sum(values) / len(values)
