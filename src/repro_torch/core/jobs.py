"""Multi-tenant control plane: typed job lifecycle + admission control,
the port's copy of ``repro.core.jobs``.

The pool layer (core/pool.py) answers "given these jobs, how do we split
the hardware?"; this module answers the *service* questions around it —
who may enter the pool, when, and what happens to their state when they
leave.  It is pure bookkeeping (no torch), shared by the runtime and
the discrete-event simulator.

Lifecycle state machine
-----------------------
Every job a tenant submits moves through a typed state machine (modelled
on a scheduler-client TaskState design; transitions outside the arrows
raise ``InvalidTransitionError``)::

                 submit                admit (pool placed it)
    (tenant) ──────────▶ PENDING ─────────────────▶ ADMITTED ──▶ RUNNING
                            │                                       │
                            │ reject (priced floor,                 │ drain
                            │  infeasible, queue full)              ▼
                            ▼                                   DRAINING
                        REJECTED                                    │
                                                   complete ◀───────┤
                                                      │             │ preempt
                                                      ▼             ▼
                                                  COMPLETED     PREEMPTED

  * PENDING   — accepted into the submission queue; owns no devices.
  * ADMITTED  — the arbitration placed it (a ``replan_pool`` seeded its
    slice from donors' surplus); the drain/commit swap is in flight.
  * RUNNING   — its plan is live; the job consumes rollouts and owns a
    slice in the ``PoolPlan`` ownership table.
  * DRAINING  — the job finished (or is being preempted) and its fleet
    stopped launching; the slice is still owned until the next pool
    commit reclaims it.
  * COMPLETED / REJECTED / PREEMPTED — terminal.  On every terminal
    transition the job's version stream (``PoolStalenessRegistry
    .remove_job``) and rollout buffer (``JobBuffers.remove_job``) are
    reclaimed by the caller — no dangling state outlives the job.

Admission policy
----------------
``ControlPlane.submit`` prices a job before it may queue, turning what
used to be an ``InfeasibleScheduleError`` crash into a *decision*:

  1. **Feasibility** — run the single-job scheduler on the full (current)
     cluster.  If even a solo placement is infeasible the job is REJECTED
     with the scheduler's own diagnostic (``PoolInfeasibleError`` is the
     typed boundary; no raw scheduler exception escapes).
  2. **Priced throughput floor** — the solo plan's δ(η)-priced throughput
     (Eq. 1: δ·tokens_per_step / max{C_T, C_I}) is the *optimistic upper
     bound* of what the pool can give the job.  If it already misses the
     job's ``min_tput`` floor (scaled by ``floor_margin``), sharing can
     only be worse: REJECT rather than admit-then-starve.
  3. **Queue bound** — at most ``max_queue`` PENDING jobs; beyond that,
     REJECT (bounded admission latency beats unbounded queueing).

A queued job is placed by the next ``replan_pool`` with it in
``arrivals``: it enters arbitration with an empty slice — trivially
starved — and the existing starved-slice repair transfers feed it from
donors' surplus.  If the donors cannot afford its minimum slice, the
arrival is shed into ``PoolPlan.infeasible`` and simply stays PENDING
until a departure frees capacity.

Priorities × water-filling
--------------------------
Two knobs interact with the Eq. (1') arbitration:

  * ``JobSpec.weight`` (w_j) shapes the *objective*: the water level each
    job's throughput is filled to is proportional to w_j, so a heavier
    job ends up with a proportionally larger slice at the optimum.
  * ``JobSpec.tier`` shapes *survival*: when the pool cannot place every
    job, shedding order is ``_drop_order`` — highest tier number first,
    then lowest weight, then latest arrival.  Tiers never bend the water
    level (a tier-0 job does not get more devices than its weight
    warrants); they only decide who is dropped/preempted when feasibility
    forces a choice.

Predictive replanning
---------------------
``EwmaThroughputTrend`` watches a job's per-step throughput samples (the
runtime's ``PlanEpochStat`` granularity).  After ``min_samples`` it locks
a reference level; when the EWMA sinks below ``threshold`` × reference it
signals a *trend* trigger, so the pool replans on sustained degradation
(creeping stragglers) instead of waiting for a hard failure event.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .cluster import Cluster
from .pool import (JobSpec, PoolConfig, PoolInfeasibleError, PoolPlan,
                   schedule_pool)


class JobState(enum.Enum):
    PENDING = "PENDING"
    ADMITTED = "ADMITTED"
    RUNNING = "RUNNING"
    DRAINING = "DRAINING"
    COMPLETED = "COMPLETED"
    REJECTED = "REJECTED"
    PREEMPTED = "PREEMPTED"

    @property
    def terminal(self) -> bool:
        return self in (JobState.COMPLETED, JobState.REJECTED,
                        JobState.PREEMPTED)


_TRANSITIONS: Dict[JobState, Tuple[JobState, ...]] = {
    JobState.PENDING: (JobState.ADMITTED, JobState.REJECTED),
    JobState.ADMITTED: (JobState.RUNNING, JobState.PREEMPTED),
    JobState.RUNNING: (JobState.DRAINING, JobState.COMPLETED,
                       JobState.PREEMPTED),
    JobState.DRAINING: (JobState.COMPLETED, JobState.PREEMPTED),
    JobState.COMPLETED: (),
    JobState.REJECTED: (),
    JobState.PREEMPTED: (),
}


class InvalidTransitionError(RuntimeError):
    """A lifecycle move outside the state machine's arrows."""


@dataclass
class JobRecord:
    """One job's lifecycle ledger: current state + stamped transitions."""

    spec: JobSpec
    t_submit: float
    n_steps: Optional[int] = None          # per-job step budget override
    state: JobState = JobState.PENDING
    reason: str = ""                       # last transition's why
    t_admit: Optional[float] = None
    t_start: Optional[float] = None        # RUNNING (plan went live)
    t_end: Optional[float] = None          # terminal transition
    t_last_price: Optional[float] = None   # last admission (re-)pricing
    retries: int = 0                       # periodic-retry re-pricings
    history: List[Tuple[JobState, float, str]] = field(default_factory=list)

    def __post_init__(self):
        if not self.history:
            self.history.append((self.state, self.t_submit, "submit"))

    @property
    def name(self) -> str:
        return self.spec.name

    def to(self, state: JobState, t: float, reason: str = "") -> "JobRecord":
        if state not in _TRANSITIONS[self.state]:
            raise InvalidTransitionError(
                f"job {self.name!r}: {self.state.value} → {state.value}")
        self.state = state
        self.reason = reason
        self.history.append((state, t, reason))
        if state is JobState.ADMITTED:
            self.t_admit = t
        elif state is JobState.RUNNING:
            self.t_start = t
        elif state.terminal:
            self.t_end = t
        return self

    @property
    def admission_latency_s(self) -> Optional[float]:
        """submit → plan-live latency; None until RUNNING (or for rejects)."""
        if self.t_start is None:
            return None
        return self.t_start - self.t_submit


@dataclass
class AdmissionConfig:
    """Admission-controller knobs (policy steps 1–3 in the module doc)."""

    max_queue: int = 8                 # PENDING bound: beyond this, reject
    floor_margin: float = 1.0          # min_tput must be ≤ margin·solo_tput
    price_on_submit: bool = True       # run the solo feasibility/floor check
    #                                    (False: queue everything, let the
    #                                    arbitration shed — cheaper, blinder)
    retry_interval_s: Optional[float] = None
    #                                    periodic re-pricing of PENDING jobs
    #                                    (``ControlPlane.tick``); None = no
    #                                    retry tick — queued jobs wait for
    #                                    the next departure-driven replan


@dataclass(frozen=True)
class AdmissionDecision:
    """What the controller decided for one submission."""

    job: str
    action: str                        # "queue" | "reject" | "retry"
    reason: str = ""
    solo_tput: float = 0.0             # priced optimistic bound (0 unpriced)


class ControlPlane:
    """Job lifecycle registry + admission controller over one pool.

    The runtime (or simulator) drives it: ``submit`` on arrival events,
    ``on_pool_commit`` after every committed pool plan (which jobs got
    placed, which queued arrivals were shed), ``complete``/``preempt`` on
    departures.  It never touches devices itself — ownership is the
    ``PoolPlan``/``DeviceLedger``'s job; this is the who-and-when layer.
    """

    def __init__(self, cluster: Cluster,
                 pool_cfg: Optional[PoolConfig] = None,
                 cfg: Optional[AdmissionConfig] = None,
                 tracer=None, metrics=None, monitor=None):
        self.cluster = cluster
        self.pool_cfg = pool_cfg or PoolConfig()
        self.cfg = cfg or AdmissionConfig()
        self.records: Dict[str, JobRecord] = {}
        self.decisions: List[AdmissionDecision] = []
        # observability (obs Tracer / MetricsRegistry /
        # HealthMonitor, all optional): lifecycle instants on the "jobs"
        # group, decision counters, the admission-latency histogram, and
        # the monitor's admission-SLO burn feed.  None = no-op.
        self.tracer = tracer
        self.metrics = metrics
        self.monitor = monitor

    def _observe(self, dec: AdmissionDecision, t: float) -> None:
        if self.tracer is not None:
            self.tracer.instant("jobs", dec.job, f"admission:{dec.action}",
                                t, reason=dec.reason)
        if self.metrics is not None:
            self.metrics.counter(f"jobs/decisions/{dec.action}").inc()

    # ------------------------------------------------------------- intake
    def register_initial(self, jobs: Sequence[JobSpec],
                         t: float = 0.0) -> None:
        """Jobs that were in the pool at t=0 (the offline ``schedule_pool``
        set): their lifecycle starts already RUNNING."""
        for spec in jobs:
            rec = JobRecord(spec, t_submit=t)
            rec.to(JobState.ADMITTED, t, "initial")
            rec.to(JobState.RUNNING, t, "initial")
            self.records[spec.name] = rec

    def submit(self, spec: JobSpec, t: float,
               n_steps: Optional[int] = None,
               cluster: Optional[Cluster] = None) -> AdmissionDecision:
        """Admission decision for one arriving job (module-doc policy).

        ``cluster`` overrides the pricing cluster (pass the *surviving*
        cluster when devices have been excluded since construction).
        """
        if spec.name in self.records:
            raise ValueError(f"job {spec.name!r} already submitted")
        rec = JobRecord(spec, t_submit=t, n_steps=n_steps)
        self.records[spec.name] = rec
        if self.tracer is not None:
            self.tracer.instant("jobs", spec.name, "submit", t)
        solo_tput = 0.0
        if self.cfg.price_on_submit:
            rec.t_last_price = t
            solo_tput, why = self._price(spec, cluster)
            if why is not None:
                return self._reject(rec, t, why, solo_tput)
        if len(self.queued()) > self.cfg.max_queue:   # rec already counted
            return self._reject(rec, t, "queue_full", solo_tput)
        dec = AdmissionDecision(spec.name, "queue", "priced feasible",
                                solo_tput)
        self.decisions.append(dec)
        self._observe(dec, t)
        return dec

    def _price(self, spec: JobSpec,
               cluster: Optional[Cluster] = None
               ) -> Tuple[float, Optional[str]]:
        """Solo feasibility/floor pricing (policy steps 1–2).  Returns the
        optimistic solo throughput bound and a rejection reason, or None
        if the job prices as admissible on the given cluster."""
        try:
            solo = schedule_pool([spec], cluster or self.cluster,
                                 self.pool_cfg)
            solo_tput = solo.throughput(spec.name)
        except PoolInfeasibleError as e:
            return 0.0, f"infeasible: {e}"
        if (spec.min_tput > 0
                and solo_tput * self.cfg.floor_margin < spec.min_tput):
            return solo_tput, (
                f"floor: solo bound {solo_tput:.0f} tok/s < "
                f"min_tput {spec.min_tput:.0f}")
        return solo_tput, None

    def _reject(self, rec: JobRecord, t: float, reason: str,
                solo_tput: float) -> AdmissionDecision:
        rec.to(JobState.REJECTED, t, reason)
        dec = AdmissionDecision(rec.name, "reject", reason, solo_tput)
        self.decisions.append(dec)
        self._observe(dec, t)
        return dec

    # ------------------------------------------------------------ lifecycle
    def queued(self) -> List[JobRecord]:
        """PENDING jobs in submission order — the next replan's arrivals."""
        return [r for r in self.records.values()
                if r.state is JobState.PENDING]

    def on_pool_commit(self, pool: PoolPlan, t: float) -> List[str]:
        """A pool plan committed: queued arrivals that made it into the
        plan go PENDING → ADMITTED → RUNNING (both stamped at the commit —
        placement and plan-liveness coincide in the drain/commit swap);
        arrivals in ``pool.infeasible`` stay PENDING (re-tried on the next
        replan).  Returns the names that started RUNNING."""
        started: List[str] = []
        placed = {j.name for j in pool.jobs}
        for rec in self.queued():
            if rec.name in placed:
                rec.to(JobState.ADMITTED, t, "placed")
                rec.to(JobState.RUNNING, t, "pool commit")
                started.append(rec.name)
                if self.tracer is not None:
                    self.tracer.instant("jobs", rec.name, "running", t)
                lat = rec.admission_latency_s
                if self.metrics is not None and lat is not None:
                    self.metrics.histogram(
                        "jobs/admission_latency_s").observe(lat)
                if self.monitor is not None and lat is not None:
                    self.monitor.on_admission(rec.name, t, lat)
        return started

    def tick(self, t: float,
             cluster: Optional[Cluster] = None) -> List[str]:
        """Periodic admission retry (``retry_interval_s``): re-price every
        PENDING job that has waited at least one interval since its last
        pricing against the *current* cluster.  Jobs whose solo bound has
        sunk below their floor (capacity shrank while they queued) are
        rejected now instead of starving in the queue; the rest are due
        for another placement attempt — their names are returned so the
        caller can drive a ``replan_pool`` with them as arrivals."""
        if self.cfg.retry_interval_s is None:
            return []
        due: List[str] = []
        for rec in self.queued():
            last = rec.t_last_price if rec.t_last_price is not None \
                else rec.t_submit
            if t - last < self.cfg.retry_interval_s:
                continue
            rec.t_last_price = t
            rec.retries += 1
            if self.cfg.price_on_submit:
                solo_tput, why = self._price(rec.spec, cluster)
                if why is not None:
                    self._reject(rec, t, f"retry: {why}", solo_tput)
                    continue
            due.append(rec.name)
            dec = AdmissionDecision(
                rec.name, "retry", f"re-priced after {rec.retries} tick(s)")
            self.decisions.append(dec)
            self._observe(dec, t)
        return due

    def drain(self, name: str, t: float, reason: str = "finished") -> None:
        self.records[name].to(JobState.DRAINING, t, reason)
        if self.tracer is not None:
            self.tracer.instant("jobs", name, "drain", t, reason=reason)

    def complete(self, name: str, t: float,
                 reason: str = "slice reclaimed") -> None:
        self.records[name].to(JobState.COMPLETED, t, reason)
        if self.tracer is not None:
            self.tracer.instant("jobs", name, "complete", t, reason=reason)

    def preempt(self, name: str, t: float, reason: str = "") -> None:
        self.records[name].to(JobState.PREEMPTED, t, reason)
        if self.tracer is not None:
            self.tracer.instant("jobs", name, "preempt", t, reason=reason)

    # ---------------------------------------------------------------- stats
    def admission_latencies(self) -> Dict[str, float]:
        return {n: r.admission_latency_s for n, r in self.records.items()
                if r.admission_latency_s is not None}


# ------------------------------------------------------------------- trend
@dataclass
class TrendConfig:
    """EWMA throughput-trend detector knobs."""

    alpha: float = 0.5                 # EWMA smoothing (1 = last sample)
    min_samples: int = 3               # samples before the reference locks
    threshold: float = 0.6             # trigger: ewma < threshold · reference


class EwmaThroughputTrend:
    """Per-job sustained-degradation detector (predictive replanning).

    Feed it per-step throughput samples; after ``min_samples`` the EWMA
    level is locked as the healthy reference, and ``observe`` returns
    True once the EWMA sinks below ``threshold`` × reference.  ``reset``
    after every committed plan swap — a new plan is a new baseline.
    """

    def __init__(self, cfg: Optional[TrendConfig] = None):
        self.cfg = cfg or TrendConfig()
        self.ewma: Optional[float] = None
        self.reference: Optional[float] = None
        self.n = 0

    def observe(self, sample: float) -> bool:
        a = self.cfg.alpha
        self.ewma = sample if self.ewma is None \
            else a * sample + (1 - a) * self.ewma
        self.n += 1
        if self.n == self.cfg.min_samples:
            self.reference = self.ewma
        return (self.reference is not None
                and self.n > self.cfg.min_samples
                and self.ewma < self.cfg.threshold * self.reference)

    def reset(self) -> None:
        self.ewma = None
        self.reference = None
        self.n = 0
