"""The arithmetic of the metrics, from times alone, so that it reads the
same whatever the program does."""

from __future__ import annotations

import statistics


def rate(units_per_step: float, step_ms: list) -> float:
    """Units a second over the window: every step completed in it, over
    its whole length (the sum of the steps' intervals, which follow one
    another)."""
    return units_per_step * len(step_ms) / (sum(step_ms) / 1e3)


def p95(values: list) -> float:
    """The 95th percentile of all ``values`` (Python's inclusive
    quantiles: the 19th of the 20-quantiles)."""
    if len(values) < 2:
        raise ValueError(f"a 95th percentile needs two values or more, got "
                         f"{len(values)}")
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def idle_pct(busy_ms: list, window_ms: float) -> float:
    """100 x (1 - the sum of the intervals ``busy_ms`` over the window):
    the share of the window outside them."""
    return 100.0 * (1.0 - sum(busy_ms) / window_ms)


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
