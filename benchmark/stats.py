"""The statistics the harness reports and the bounds were set from."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``values`` (all of them:
    the sorted value at rank ceil(q/100 * N))."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, with the quartiles of
    ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]
