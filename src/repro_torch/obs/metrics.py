"""Metrics registry: counters, gauges and fixed-bucket histograms with a
JSON snapshot — the part of ``repro.obs.metrics`` the launchers use,
copied so the port's snapshots read like the reference's (same keys, same
bucket bounds, same interpolated p50/p95/p99).
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Sequence

DEFAULT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                   256.0, 512.0, 1024.0)
QUANTILE_KEYS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins sampled value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed upper-bound buckets plus an overflow bucket, with sum and
    count."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or b != tuple(sorted(b)):
            raise ValueError(f"buckets must be sorted and non-empty: {b}")
        self.buckets = b
        self.counts: List[int] = [0] * (len(b) + 1)   # last = overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        # value lands in the first bucket whose upper bound is >= v
        self.counts[bisect.bisect_left(self.buckets, v)] += 1


def hist_quantile(h: Dict, q: float) -> float:
    """Quantile interpolated linearly inside the bucket holding the rank;
    a rank in the overflow bucket reports the last finite bound."""
    bounds = [float(b) for b in h["buckets"]]
    counts = [int(c) for c in h["counts"]]
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = min(max(q, 0.0), 1.0) * total
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else min(0.0, bounds[0])
            hi = bounds[i]
            return lo + (hi - lo) * (target - cum) / c
        cum += c
    return bounds[-1]


class MetricsRegistry:
    """Get-or-create accessors keyed by slash-separated names."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(buckets or DEFAULT_BUCKETS)
        return h

    def snapshot(self) -> Dict:
        """Point-in-time JSON-able view of every registered metric."""
        hists = {}
        for n, h in sorted(self._histograms.items()):
            d = {"buckets": list(h.buckets), "counts": list(h.counts),
                 "sum": h.sum, "count": h.count}
            for key, q in QUANTILE_KEYS:
                d[key] = hist_quantile(d, q)
            hists[n] = d
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": hists,
        }

    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
        return path
