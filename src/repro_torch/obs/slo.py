"""SLO specs and burn-rate arithmetic for the health monitor, the port's
copy of ``repro.obs.slo``.

An SLO here is a *fraction-good* objective over a rolling window: e.g.
"≥ 75% of consumed rollouts are comfortably inside the staleness bound"
or "≥ 95% of admissions complete within 60 s".  The complement of the
objective is the error budget; the **burn rate** is the observed bad
fraction divided by that budget (SRE convention: burn 1.0 = exactly
consuming budget, 10.0 = burning it 10× too fast).  The monitor turns
burn rates into alert severities via :func:`classify_burn`.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Tuple

# (min_burn, severity), checked in order.  Below the last threshold the
# SLO is healthy and no alert fires.
BURN_SEVERITIES: Tuple[Tuple[float, str], ...] = (
    (10.0, "critical"),
    (1.0, "warn"),
)


@dataclass(frozen=True)
class SLOSpec:
    """A fraction-good objective: ``objective`` of events must be good."""

    name: str
    objective: float            # e.g. 0.95 → 5% error budget
    description: str = ""

    def __post_init__(self) -> None:
        if not (0.0 < self.objective < 1.0):
            raise ValueError(
                f"objective must be in (0, 1): {self.objective}")

    @property
    def budget(self) -> float:
        """Allowed bad fraction (never zero so burn stays finite)."""
        return max(1.0 - self.objective, 1e-12)


def burn_rate(bad_frac: float, slo: SLOSpec) -> float:
    """How fast ``bad_frac`` consumes the SLO's error budget."""
    return max(0.0, bad_frac) / slo.budget


def classify_burn(burn: float) -> str:
    """Map a burn rate to a severity ("" = healthy, no alert)."""
    for threshold, severity in BURN_SEVERITIES:
        if burn >= threshold:
            return severity
    return ""


class BurnWindow:
    """Rolling-window good/bad tracker for one SLO.

    ``observe(t, bad)`` appends an event; ``burn(now)`` evicts events
    older than ``window_s`` and returns the current burn rate.  Events
    are assumed to arrive in non-decreasing time order (both the sim
    clock and ``Tracer.now()`` guarantee that)."""

    def __init__(self, slo: SLOSpec, window_s: float) -> None:
        if window_s <= 0:
            raise ValueError(f"window_s must be positive: {window_s}")
        self.slo = slo
        self.window_s = float(window_s)
        self._events: Deque[Tuple[float, bool]] = deque()
        self._bad = 0

    def observe(self, t: float, bad: bool) -> None:
        self._events.append((float(t), bool(bad)))
        if bad:
            self._bad += 1

    def _evict(self, now: float) -> None:
        horizon = now - self.window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            _, was_bad = ev.popleft()
            if was_bad:
                self._bad -= 1

    def n(self, now: float) -> int:
        self._evict(now)
        return len(self._events)

    def bad_frac(self, now: float) -> float:
        self._evict(now)
        return self._bad / len(self._events) if self._events else 0.0

    def burn(self, now: float) -> float:
        return burn_rate(self.bad_frac(now), self.slo)

    def reset(self) -> None:
        self._events.clear()
        self._bad = 0
