"""The arithmetic the benchmark reduces its samples with."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the two
    nearest ranks (numpy's default): rank (n - 1) * q / 100."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    if not 0 <= q <= 100:
        raise ValueError(f"percentile {q} outside 0..100")
    pos = (len(xs) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_request_ms(window_s: float, completed: int) -> float:
    """The window's length over the requests completed in it, in ms: the
    time per request of a closed loop, all work and all time counted."""
    if completed <= 0:
        raise ValueError("no request completed in the window")
    return window_s * 1e3 / completed


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median (statistics.quantiles' default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals) -> float:
    """Total length covered by a list of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]
