"""The benchmark's arithmetic on what a run measured: percentiles, window
rates, the busy share of a set of device intervals, and the quartile
spread that bounds are set from."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q ≤ 100): the smallest value
    that at least q% of the values do not exceed."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def rate(count: int, seconds: float) -> float:
    """Work completed over the whole window: ``count`` per second."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def per_item(total: float, count: int):
    """``total`` shared over ``count`` items, or None where there is none."""
    return total / count if count else None


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) stretches of [lo, hi] that no interval
    covers, longest first."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


def idle_pct(busy: float, window: float):
    """100 × (1 − busy / window), or None for an empty window."""
    return 100.0 * (1.0 - busy / window) if window > 0 else None


def spread(values) -> float:
    """(Q3 − Q1) / median, the quartiles as ``statistics.quantiles``
    gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
