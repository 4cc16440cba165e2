"""The benchmark's arithmetic: rates, ratios, percentiles, the device's
busy time from a kernel timeline, and roofline shares.  Plain Python, so
that its answers can be checked by hand."""

from __future__ import annotations

import math

# Published peak of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet):
# HBM3 at 3.35 TB/s, reached at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12


def rate_gbps(nbytes: float, seconds: float) -> float:
    """GB/s (10^9 bytes a second) over the whole window."""
    return nbytes / seconds / 1e9


def ratio(part: float, whole: float) -> float:
    return part / whole


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all ``values``:
    the smallest value with at least q% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals, lo: float = -math.inf, hi: float = math.inf) -> float:
    """Seconds of [lo, hi] in which at least one interval runs."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merge(intervals))


def idle_pct(busy_s: float, window_s: float) -> float:
    """The share of the window in which the device ran nothing, in %."""
    return 100.0 * (1.0 - busy_s / window_s)


def roofline_pct(nbytes: float, seconds: float,
                 bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The least time ``nbytes`` of memory traffic takes at the peak rate,
    over the time the kernel took, in %."""
    return 100.0 * (nbytes / bytes_per_s) / seconds
