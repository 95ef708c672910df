"""Online health monitor: rolling-window detectors over the metrics
registry and trace stream, emitting typed alerts that feed the
control-plane replan path (the port's copy of ``repro.obs.monitor``).

The trace and metrics substrate is passive — traces and metrics are
recorded, and ``obs.analyze`` inspects them *after* the run.  The
:class:`HealthMonitor` closes the loop online: it consumes the same
signals on rolling windows and raises a typed :class:`Alert` when a
detector trips.  The simulators and the control plane poll it on a
bounded cadence and route sustained straggler / imbalance alerts into
the existing predictive-replan path, so a sick replica is drained on
*evidence* (its span rates fell out of the fleet distribution) instead
of waiting for the job-level throughput EWMA to sag.

Detectors (each individually toggleable in :class:`MonitorConfig`):

``straggler``
    Per-replica generation rate (tokens / span duration) vs. the fleet.
    Robust z-score: the replica's median rate against the median of all
    replica medians, scaled by 1.4826·MAD with a floor, so one outlier
    can't hide itself by inflating the spread.
``buffer``
    Producer–consumer imbalance from buffer-depth samples and stall
    events: depth pinned high + capacity stalls → generation outpacing
    train ("gen_ahead"); depth pinned low + data stalls → train starved
    ("train_starved").
``staleness``
    SLO burn rate of the fraction of consumed rollouts within
    ``staleness_margin`` of the η bound (``staleness ≥ η − margin``).
``bubble``
    Per-stage bubble fraction (1 − merged span coverage of the window)
    vs. a reference locked from the first few polls; alerts on drift.
``admission``
    SLO burn rate of admission latencies above ``admission_slo_s``.
``snapshot``
    Recovery-snapshot age vs the configured cadence: if the last
    ``RecoveryManager`` snapshot is older than ``snapshot_interval_s``
    the crash-loss bound is silently growing — warn past the interval,
    critical past twice it.  Enabled by setting ``snapshot_interval_s``
    > 0 (the cadence is deployment-specific, so there is no default).

Everything is default-off: no component constructs a monitor unless one
is passed in, and every feed site is behind ``if monitor is not None``,
so results stay bit-identical without one (asserted in
``tests/test_torch_monitor.py``).

One-timebase rule, same as :class:`~repro_torch.obs.trace.Tracer`: simulators
feed sim-time seconds; runtime components feed
:meth:`HealthMonitor.now` wall-clock seconds.  Never mix the two in one
monitor.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import log
from .metrics import MetricsRegistry, hist_frac_ge, snapshot_delta
from .slo import BurnWindow, SLOSpec, classify_burn

# Consistency scale factor making MAD comparable to a standard
# deviation under normality.
_MAD_SCALE = 1.4826


@dataclass(frozen=True)
class Alert:
    """One detector firing: what, how bad, when, and the evidence."""

    detector: str          # "straggler" | "buffer" | "staleness" | ...
    severity: str          # "warn" | "critical"
    t: float               # monitor-timebase seconds
    window_s: float        # rolling window the evidence covers
    key: str               # subject, e.g. "job_a/r3" or "generation"
    message: str           # one human-readable line
    evidence: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"detector": self.detector, "severity": self.severity,
                "t": self.t, "window_s": self.window_s, "key": self.key,
                "message": self.message, "evidence": dict(self.evidence)}


@dataclass(frozen=True)
class MonitorConfig:
    """Rolling-window sizes and per-detector thresholds.

    Detector booleans default on *within* a constructed monitor — the
    system-level default-off lives one level up (``monitor=None``
    everywhere), matching the tracer/metrics convention."""

    window_s: float = 30.0          # rolling evidence window
    poll_interval_s: float = 2.0    # detector evaluation cadence
    cooldown_s: float = 30.0        # per (detector, key) re-alert gap

    # straggler: robust z-score of per-replica median rate vs fleet
    detect_straggler: bool = True
    straggler_z: float = 3.0        # alert at z ≤ −straggler_z
    straggler_min_samples: int = 2  # spans per replica before judging
    straggler_min_peers: int = 3    # replicas before a fleet exists
    straggler_mad_floor: float = 0.05   # MAD floor as fraction of fleet

    # buffer: producer–consumer imbalance
    detect_buffer: bool = True
    depth_hi: float = 0.9           # depth/capacity pinned-high bound
    depth_lo: float = 0.1           # depth/capacity pinned-low bound
    min_stalls: int = 2             # stall events to corroborate depth

    # staleness: burn rate of near-η consumption
    detect_staleness: bool = True
    staleness_slo: SLOSpec = SLOSpec(
        "staleness", 0.75,
        "≥75% of consumed rollouts below η − margin")
    staleness_margin: float = 1.0   # bad if staleness ≥ η − margin
    min_staleness_n: int = 8        # consumptions before judging

    # bubble: per-stage busy-coverage drift vs an early reference
    detect_bubble: bool = True
    bubble_ref_polls: int = 3       # polls averaged into the reference
    bubble_drift: float = 0.25      # alert at bubble − ref ≥ drift

    # admission: latency SLO burn
    detect_admission: bool = True
    admission_slo_s: float = 60.0   # good admission completes within
    admission_slo: SLOSpec = SLOSpec(
        "admission", 0.90, "≥90% of admissions within admission_slo_s")
    min_admission_n: int = 4        # admissions before judging

    # snapshot: recovery-snapshot age vs the expected cadence
    detect_snapshot: bool = True
    snapshot_interval_s: float = 0.0    # expected cadence; 0 disables

    def __post_init__(self) -> None:
        if self.window_s <= 0 or self.poll_interval_s <= 0:
            raise ValueError("window_s and poll_interval_s must be > 0")


def _median_sorted(vals: List[float]) -> float:
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def _median(vals: List[float]) -> float:
    return _median_sorted(sorted(vals))


def _evict(dq: Deque[Tuple[float, Any]], horizon: float) -> None:
    while dq and dq[0][0] < horizon:
        dq.popleft()


def _coverage(spans: List[Tuple[float, float]], lo: float,
              hi: float) -> float:
    """Total length of ``[lo, hi]`` covered by the union of spans."""
    clipped = sorted((max(t, lo), min(t + d, hi)) for t, d in spans)
    covered = 0.0
    cur_lo = cur_hi = None
    for a, b in clipped:
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return covered


class HealthMonitor:
    """Streaming detectors over rolling windows; see module docstring.

    Feed methods (``on_*``) are O(1) appends; all detector math happens
    in :meth:`poll`, which the host calls on its own cadence
    (``cfg.poll_interval_s`` is the suggested interval — the sim
    schedules a ``monitor_poll`` event chain from it)."""

    def __init__(self, cfg: Optional[MonitorConfig] = None,
                 tracer=None) -> None:
        self.cfg = cfg or MonitorConfig()
        self.alerts: List[Alert] = []
        self._tracer = tracer
        self._wall0 = time.perf_counter()
        # (job, replica) -> deque[(t, tokens_per_s)]
        self._gen: Dict[Tuple[str, int], Deque[Tuple[float, float]]] = {}
        # job -> deque[(t, depth_fraction)]
        self._depth: Dict[str, Deque[Tuple[float, float]]] = {}
        # job -> deque[(t, stall_kind)]
        self._stalls: Dict[str, Deque[Tuple[float, str]]] = {}
        # job -> staleness burn window (+ last seen η for evidence)
        self._staleness: Dict[str, BurnWindow] = {}
        self._eta: Dict[str, float] = {}
        # stage -> deque[(t, dur)]
        self._stages: Dict[str, Deque[Tuple[float, float]]] = {}
        # stage -> early-poll bubble samples / locked reference
        self._bubble_samples: Dict[str, List[float]] = {}
        self._bubble_ref: Dict[str, float] = {}
        self._admission = BurnWindow(self.cfg.admission_slo,
                                     self.cfg.window_s)
        self._last_snapshot_t: Optional[float] = None
        self._last_alert: Dict[Tuple[str, str], float] = {}
        self._last_reg_snap: Optional[Dict] = None
        self.polls = 0

    # ------------------------------------------------------------ timebase
    def now(self) -> float:
        """Wall-clock seconds since creation (runtime timebase only;
        simulators pass sim-time directly)."""
        return time.perf_counter() - self._wall0

    # ---------------------------------------------------------------- feeds
    def on_gen_span(self, job: str, replica: int, t: float, dur: float,
                    tokens: float) -> None:
        """A finished generation span on one replica."""
        if dur <= 0:
            return
        dq = self._gen.get((job, replica))
        if dq is None:
            dq = self._gen[(job, replica)] = deque()
        dq.append((t, tokens / dur))

    def on_buffer(self, job: str, t: float, depth: float,
                  capacity: float) -> None:
        """A buffer-depth sample (depth and its capacity bound)."""
        dq = self._depth.get(job)
        if dq is None:
            dq = self._depth[job] = deque()
        dq.append((t, depth / capacity if capacity > 0 else 0.0))

    def on_stall(self, job: str, t: float, kind: str) -> None:
        """A producer/consumer stall: ``kind`` in {"data", "capacity"}."""
        dq = self._stalls.get(job)
        if dq is None:
            dq = self._stalls[job] = deque()
        dq.append((t, kind))

    def on_staleness(self, job: str, t: float, staleness: float,
                     eta: float) -> None:
        """One consumed rollout's staleness against its η bound."""
        bw = self._staleness.get(job)
        if bw is None:
            bw = self._staleness[job] = BurnWindow(
                self.cfg.staleness_slo, self.cfg.window_s)
        self._eta[job] = eta
        bw.observe(t, staleness >= eta - self.cfg.staleness_margin)

    def on_stage_span(self, stage: str, t: float, dur: float) -> None:
        """A finished pipeline-stage span (generation/train/sync/...)."""
        dq = self._stages.get(stage)
        if dq is None:
            dq = self._stages[stage] = deque()
        dq.append((t, dur))

    def on_admission(self, job: str, t: float, latency_s: float) -> None:
        """One admitted job's submit→commit latency."""
        self._admission.observe(t, latency_s > self.cfg.admission_slo_s)

    def on_snapshot(self, t: float) -> None:
        """A recovery snapshot completed (``RecoveryManager`` feeds this).
        Survives :meth:`reset` — the snapshot cadence is a controller
        property, not a per-plan distribution."""
        self._last_snapshot_t = t

    # -------------------------------------------------- trace-stream sink
    def on_trace_event(self, ph: str, group: str, track: str, name: str,
                       t: float, dur: float, args: Dict) -> None:
        """Tracer sink (install with ``tracer.add_sink``): routes the
        repo's span conventions — ``replica``/``r{i}`` or
        ``{job}/r{i}`` tracks carry ``tokens``; ``stage`` tracks are
        pipeline stages — into the direct feeds above."""
        if ph != "X":
            return
        if group == "replica":
            job, _, rep = track.rpartition("/")
            if rep.startswith("r"):
                try:
                    idx = int(rep[1:])
                except ValueError:
                    return
                tokens = args.get("tokens")
                if tokens is not None:
                    self.on_gen_span(job or "job", idx, t, dur,
                                     float(tokens))
        elif group == "stage":
            self.on_stage_span(track, t, dur)

    # ------------------------------------------------- registry consumption
    def observe_registry(self, reg, t: float) -> None:
        """Consume a :class:`MetricsRegistry` (or raw snapshot dict)
        incrementally: the delta since the previous call is routed into
        the staleness / buffer / admission feeds, so components that
        already publish metrics need no extra monitor plumbing."""
        snap = reg.snapshot() if isinstance(reg, MetricsRegistry) else reg
        prev, self._last_reg_snap = self._last_reg_snap, snap
        d = snapshot_delta(snap, prev or {})
        gauges = d.get("gauges", {})
        for name, h in d.get("histograms", {}).items():
            n = int(h.get("count", 0))
            if n <= 0:
                continue
            prefix = name.rsplit("/", 1)[0]
            if name.endswith("/staleness"):
                eta = gauges.get(f"{prefix}/eta")
                if eta is None:
                    continue
                bad_frac = hist_frac_ge(
                    h, eta - self.cfg.staleness_margin)
                bad_n = int(round(n * bad_frac))
                bw = self._staleness.get(prefix)
                if bw is None:
                    bw = self._staleness[prefix] = BurnWindow(
                        self.cfg.staleness_slo, self.cfg.window_s)
                self._eta[prefix] = eta
                for k in range(n):
                    bw.observe(t, k < bad_n)
            elif name.endswith("admission_latency_s"):
                bad_frac = hist_frac_ge(h, self.cfg.admission_slo_s)
                bad_n = int(round(n * bad_frac))
                for k in range(n):
                    self._admission.observe(t, k < bad_n)
        for name, v in gauges.items():
            if name.endswith("/depth"):
                prefix = name.rsplit("/", 1)[0]
                cap = gauges.get(f"{prefix}/capacity")
                if cap:
                    self.on_buffer(prefix, t, v, cap)
        for name, v in d.get("counters", {}).items():
            if name.endswith("/dropped") and v > 0:
                prefix = name.rsplit("/", 1)[0]
                # each drop is a capacity-pressure event; bound the
                # fan-out so a large delta can't flood the window
                for _ in range(min(int(v), 16)):
                    self.on_stall(prefix, t, "capacity")

    # ---------------------------------------------------------------- reset
    def reset_job(self, job: str) -> None:
        """Drop a job's rolling state (call when its plan changes — the
        new fleet is a new distribution).  Cooldowns survive so a replan
        can't re-arm an alert storm."""
        for key in [k for k in self._gen if k[0] == job]:
            del self._gen[key]
        self._depth.pop(job, None)
        self._stalls.pop(job, None)
        self._staleness.pop(job, None)
        self._eta.pop(job, None)

    def reset(self) -> None:
        """Drop all rolling state (global plan swap / weight update)."""
        self._gen.clear()
        self._depth.clear()
        self._stalls.clear()
        self._staleness.clear()
        self._eta.clear()
        self._stages.clear()
        self._bubble_samples.clear()
        self._bubble_ref.clear()
        self._admission.reset()
        self._last_reg_snap = None

    # ----------------------------------------------------------------- poll
    def poll(self, now: float) -> List[Alert]:
        """Evaluate every enabled detector; returns the alerts that
        cleared their cooldown (also appended to :attr:`alerts`,
        recorded as trace instants, and logged)."""
        cfg = self.cfg
        self.polls += 1
        horizon = now - cfg.window_s
        candidates: List[Alert] = []
        if cfg.detect_straggler:
            candidates += self._detect_stragglers(now, horizon)
        if cfg.detect_buffer:
            candidates += self._detect_buffer(now, horizon)
        if cfg.detect_staleness:
            candidates += self._detect_staleness(now)
        if cfg.detect_bubble:
            candidates += self._detect_bubble(now, horizon)
        if cfg.detect_admission:
            candidates += self._detect_admission(now)
        if cfg.detect_snapshot and cfg.snapshot_interval_s > 0:
            candidates += self._detect_snapshot_age(now)
        fresh: List[Alert] = []
        for a in candidates:
            gate = (a.detector, a.key)
            last = self._last_alert.get(gate)
            if last is not None and now - last < cfg.cooldown_s:
                continue
            self._last_alert[gate] = now
            self._emit(a)
            fresh.append(a)
        return fresh

    def _emit(self, a: Alert) -> None:
        self.alerts.append(a)
        if self._tracer is not None:
            self._tracer.instant("health", a.detector, a.key, a.t,
                                 severity=a.severity, message=a.message,
                                 evidence=dict(a.evidence))
        log.info(f"[health] {a.severity} {a.detector} {a.key}: "
                 f"{a.message}", detector=a.detector,
                 severity=a.severity, key=a.key, t=round(a.t, 3),
                 evidence=a.evidence)

    # ------------------------------------------------------------ detectors
    def _detect_stragglers(self, now: float,
                           horizon: float) -> List[Alert]:
        cfg = self.cfg
        by_job: Dict[str, Dict[int, float]] = {}
        for (job, rep), dq in self._gen.items():
            _evict(dq, horizon)
            if len(dq) >= cfg.straggler_min_samples:
                by_job.setdefault(job, {})[rep] = _median(
                    [r for _, r in dq])
        out: List[Alert] = []
        for job in sorted(by_job):
            meds = by_job[job]
            if len(meds) < cfg.straggler_min_peers:
                continue
            vals = sorted(meds.values())
            fleet = _median_sorted(vals)
            if fleet <= 0:
                continue
            mad = _median([abs(v - fleet) for v in vals])
            scale = max(_MAD_SCALE * mad,
                        cfg.straggler_mad_floor * fleet)
            for rep in sorted(meds):
                z = (meds[rep] - fleet) / scale
                if z > -cfg.straggler_z:
                    continue
                sev = ("critical" if z <= -2.0 * cfg.straggler_z
                       else "warn")
                out.append(Alert(
                    "straggler", sev, now, cfg.window_s,
                    f"{job}/r{rep}" if job else f"r{rep}",
                    f"replica r{rep} at {meds[rep]:.1f} tok/s vs fleet "
                    f"{fleet:.1f} (z={z:.1f})",
                    {"job": job, "replica": rep,
                     "rate": meds[rep], "fleet_rate": fleet,
                     "z": z, "n_peers": len(meds)}))
        return out

    def _detect_buffer(self, now: float, horizon: float) -> List[Alert]:
        cfg = self.cfg
        out: List[Alert] = []
        for job in sorted(self._depth):
            dq = self._depth[job]
            _evict(dq, horizon)
            if not dq:
                continue
            fracs = [f for _, f in dq]
            mean_frac = sum(fracs) / len(fracs)
            slope = ((fracs[-1] - fracs[0]) /
                     max(dq[-1][0] - dq[0][0], 1e-9)
                     if len(fracs) > 1 else 0.0)
            stalls = self._stalls.get(job)
            if stalls is not None:
                _evict(stalls, horizon)
            n_cap = sum(1 for _, k in (stalls or ()) if k == "capacity")
            n_data = sum(1 for _, k in (stalls or ()) if k == "data")
            mode = None
            if mean_frac >= cfg.depth_hi and n_cap >= cfg.min_stalls:
                mode, n_stalls = "gen_ahead", n_cap
            elif mean_frac <= cfg.depth_lo and n_data >= cfg.min_stalls:
                mode, n_stalls = "train_starved", n_data
            if mode is None:
                continue
            out.append(Alert(
                "buffer", "warn", now, cfg.window_s, job,
                f"{mode}: depth at {mean_frac:.0%} of capacity with "
                f"{n_stalls} stalls",
                {"job": job, "mode": mode, "mean_depth_frac": mean_frac,
                 "depth_slope_per_s": slope, "stalls_capacity": n_cap,
                 "stalls_data": n_data}))
        return out

    def _detect_staleness(self, now: float) -> List[Alert]:
        cfg = self.cfg
        out: List[Alert] = []
        for job in sorted(self._staleness):
            bw = self._staleness[job]
            if bw.n(now) < cfg.min_staleness_n:
                continue
            burn = bw.burn(now)
            sev = classify_burn(burn)
            if not sev:
                continue
            out.append(Alert(
                "staleness", sev, now, cfg.window_s, job,
                f"staleness burn {burn:.1f}×: {bw.bad_frac(now):.0%} of "
                f"rollouts within {cfg.staleness_margin:g} of η="
                f"{self._eta.get(job, 0):g}",
                {"job": job, "burn": burn,
                 "bad_frac": bw.bad_frac(now), "n": bw.n(now),
                 "eta": self._eta.get(job),
                 "objective": cfg.staleness_slo.objective}))
        return out

    def _detect_bubble(self, now: float, horizon: float) -> List[Alert]:
        cfg = self.cfg
        out: List[Alert] = []
        lo = max(horizon, 0.0)
        span = now - lo
        if span <= 0:
            return out
        for stage in sorted(self._stages):
            dq = self._stages[stage]
            # keep spans that still overlap the window (a long span may
            # start before the horizon)
            while dq and dq[0][0] + dq[0][1] < horizon:
                dq.popleft()
            bubble = 1.0 - _coverage(list(dq), lo, now) / span
            ref = self._bubble_ref.get(stage)
            if ref is None:
                samples = self._bubble_samples.setdefault(stage, [])
                samples.append(bubble)
                if len(samples) >= cfg.bubble_ref_polls:
                    self._bubble_ref[stage] = (sum(samples)
                                               / len(samples))
                continue
            drift = bubble - ref
            if drift < cfg.bubble_drift:
                continue
            sev = ("critical"
                   if drift >= 2.0 * cfg.bubble_drift else "warn")
            out.append(Alert(
                "bubble", sev, now, cfg.window_s, stage,
                f"stage {stage} bubble {bubble:.0%} vs reference "
                f"{ref:.0%} (+{drift:.0%})",
                {"stage": stage, "bubble": bubble, "reference": ref,
                 "drift": drift}))
        return out

    def _detect_admission(self, now: float) -> List[Alert]:
        cfg = self.cfg
        bw = self._admission
        if bw.n(now) < cfg.min_admission_n:
            return []
        burn = bw.burn(now)
        sev = classify_burn(burn)
        if not sev:
            return []
        return [Alert(
            "admission", sev, now, cfg.window_s, "pool",
            f"admission burn {burn:.1f}×: {bw.bad_frac(now):.0%} over "
            f"{cfg.admission_slo_s:g}s",
            {"burn": burn, "bad_frac": bw.bad_frac(now), "n": bw.n(now),
             "slo_s": cfg.admission_slo_s,
             "objective": cfg.admission_slo.objective})]

    def _detect_snapshot_age(self, now: float) -> List[Alert]:
        cfg = self.cfg
        if self._last_snapshot_t is None:
            return []                # no snapshot regime observed yet
        age = now - self._last_snapshot_t
        if age <= cfg.snapshot_interval_s:
            return []
        sev = ("critical" if age > 2.0 * cfg.snapshot_interval_s
               else "warn")
        return [Alert(
            "snapshot", sev, now, cfg.window_s, "controller",
            f"last recovery snapshot {age:.0f}s old vs "
            f"{cfg.snapshot_interval_s:g}s cadence — crash-loss bound "
            f"growing",
            {"age_s": age, "interval_s": cfg.snapshot_interval_s,
             "last_snapshot_t": self._last_snapshot_t})]
