"""Exact percentiles and goodput from raw request records.

A request that was shed, failed or never answered is a miss: it counts
in every denominator, fails every budget and ranks beyond every served
latency (``math.inf``). Percentiles are nearest-rank over all requests,
so nothing is binned or interpolated.
"""
from __future__ import annotations

import math
import statistics

MISS = math.inf


def percentile(values: list, q: float) -> float:
    """Nearest-rank ``q``-quantile (0 < q <= 1) of ``values``; misses are
    ``math.inf`` and rank last."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    return xs[max(math.ceil(q * len(xs)), 1) - 1]


def beyond(values: list, q: float) -> int:
    """How many values rank beyond the nearest-rank ``q``-quantile."""
    return len(values) - max(math.ceil(q * len(values)), 1)


def goodput(latencies: list, budgets: list, seconds: float) -> float:
    """Requests answered within their budget, per second of window."""
    ok = sum(1 for lat, b in zip(latencies, budgets) if lat <= b)
    return ok / seconds


def spread(values: list) -> float:
    """Quartile distance over the median (``statistics.quantiles``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
