"""Metrics registry: counters, gauges, and fixed-bucket histograms with
snapshot / delta JSON export, the port's copy of ``repro.obs.metrics``.

This replaces the ad-hoc stat plumbing that used to be scattered across
the stack: ``EngineStats.to_metrics()`` exports every engine count and
derived rate, ``RolloutBuffer`` records the per-version staleness
distribution, ``ControlPlane`` records admission latency, and the
simulators record per-device busy/idle.  A snapshot is a plain
JSON-able dict; ``delta`` subtracts two snapshots so periodic exporters
can emit rates without the registry keeping history.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Sequence

# Power-of-two upper bounds cover the repo's native ranges: staleness in
# versions (0..η, small ints) and latencies in seconds (sub-second to
# ~20 min).  Sites with tighter needs pass explicit buckets on first
# creation.
DEFAULT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                   256.0, 512.0, 1024.0)


class Counter:
    """Monotonically increasing value (float increments allowed, e.g.
    busy-seconds)."""

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
    """Fixed upper-bound buckets plus an overflow bucket; tracks sum and
    count so the mean survives export.  Quantiles are estimated by linear
    interpolation inside the bucket that holds the target rank
    (Prometheus-style), so p50/p95/p99 survive export too."""

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

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 ≤ q ≤ 1) from the bucket counts."""
        return hist_quantile({"buckets": self.buckets,
                              "counts": self.counts}, q)

    def frac_ge(self, x: float) -> float:
        """Estimated fraction of observations ≥ x (interpolated CDF
        complement) — the burn-rate detectors' tail probe."""
        return hist_frac_ge({"buckets": self.buckets,
                             "counts": self.counts}, x)


QUANTILE_KEYS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def hist_quantile(h: Dict, q: float) -> float:
    """Interpolated quantile from an exported histogram dict (the
    ``{"buckets": [...], "counts": [...]}`` shape ``snapshot()`` emits).

    Each finite bucket i covers ``(bounds[i-1], bounds[i]]`` (the first
    covers ``[min(0, bounds[0]), bounds[0]]``); the rank is interpolated
    linearly inside its bucket.  The overflow bucket has no upper edge,
    so any rank landing there reports the last finite bound — a floor,
    which is the conservative direction for SLO tail checks."""
    bounds = [float(b) for b in h["buckets"]]
    counts = [int(c) for c in h["counts"]]
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = min(max(q, 0.0), 1.0) * total
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            if i >= len(bounds):               # overflow: no upper edge
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else min(0.0, bounds[0])
            hi = bounds[i]
            return lo + (hi - lo) * (target - cum) / c
        cum += c
    return bounds[-1]


def hist_frac_ge(h: Dict, x: float) -> float:
    """Estimated fraction of observations ≥ x from an exported histogram
    dict, linearly interpolating inside the bucket containing x."""
    bounds = [float(b) for b in h["buckets"]]
    counts = [int(c) for c in h["counts"]]
    total = sum(counts)
    if total <= 0:
        return 0.0
    below = 0.0
    for i, c in enumerate(counts):
        lo = bounds[i - 1] if 0 < i < len(bounds) else (
            min(0.0, bounds[0]) if i == 0 else bounds[-1])
        if i >= len(bounds):                   # overflow bucket: all ≥ last
            break
        hi = bounds[i]
        if hi < x:
            below += c
        elif lo < x:
            below += c * (x - lo) / (hi - lo) if hi > lo else 0.0
        # buckets entirely ≥ x contribute nothing to `below`
    return max(0.0, min(1.0, (total - below) / total))


def _hist_export(buckets, counts, total, count) -> Dict:
    h = {"buckets": list(buckets), "counts": list(counts),
         "sum": total, "count": count}
    for key, q in QUANTILE_KEYS:
        h[key] = hist_quantile(h, q)
    return h


class MetricsRegistry:
    """Get-or-create accessors keyed by slash-separated names
    (``engine/decode_steps``, ``sim/staleness``, ...)."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(buckets or DEFAULT_BUCKETS)
        return h

    # -------------------------------------------------------------- export
    def snapshot(self) -> Dict:
        """Point-in-time JSON-able view of every registered metric."""
        return {
            "counters": {n: c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {
                n: _hist_export(h.buckets, h.counts, h.sum, h.count)
                for n, h in sorted(self._histograms.items())},
        }

    def delta(self, prev: Dict) -> Dict:
        """Current snapshot minus ``prev``: counters and histogram
        counts/sums subtract (missing-in-prev treated as zero); gauges
        keep their current value (a gauge has no meaningful rate)."""
        return snapshot_delta(self.snapshot(), prev)

    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
        return path


def snapshot_delta(cur: Dict, prev: Dict) -> Dict:
    """Pure-snapshot form of :meth:`MetricsRegistry.delta`."""
    pc = prev.get("counters", {})
    ph = prev.get("histograms", {})
    out = {
        "counters": {n: v - pc.get(n, 0.0)
                     for n, v in cur.get("counters", {}).items()},
        "gauges": dict(cur.get("gauges", {})),
        "histograms": {},
    }
    for n, h in cur.get("histograms", {}).items():
        p = ph.get(n)
        if p is None or list(p.get("buckets", [])) != list(h["buckets"]):
            out["histograms"][n] = dict(h)
            continue
        counts = [a - b for a, b in zip(h["counts"], p["counts"])]
        out["histograms"][n] = _hist_export(
            h["buckets"], counts, h["sum"] - p["sum"],
            h["count"] - p["count"])
    return out
