"""Event and fault-injection primitives for the async-RL simulator (the
port's copy of ``repro.sim.events``).

Event kinds used by ``AsyncRLSimulator``:

  * ``rollout_done``  — a replica finished one trajectory (+ reward stage);
  * ``train_done``    — the trainer finished a step + weight broadcast;
  * ``straggle``      — a ``StragglerInjection`` takes effect;
  * ``fail``          — a ``FailureInjection`` takes effect;
  * ``recover``       — a transient failure's downtime elapsed;
  * ``replan_drain``  — a (possibly debounce-deferred) replan starts its
    drain: new launches stop, ``replan_ready`` is scheduled;
  * ``replan_ready``  — the elastic replanner finished recomputing the plan
    (``replan_latency_s`` after the drain started; commits the hot swap).

``MultiJobSimulator`` adds pool-level kinds: ``fail`` / ``job_recover``
(per-job failures, transient when the injection has a downtime),
``job_straggle``, ``job_submit`` (online arrival through the admission
controller), plus ``pool_drain`` / ``pool_ready`` for the pool-wide plan
swap.

Crash-recovery kinds shared by both loops (``repro_torch.recovery``):

  * ``snapshot``      — the attached ``RecoveryManager`` captures the full
    controller state and truncates its journal (self-re-arming cadence);
  * ``crash``         — a ``ControllerCrash`` fires: every
    controller-internal event is wiped, state rolls back to the last
    snapshot + journal replay;
  * ``resume``        — the controller comes back ``restore_latency_s``
    after the crash: fresh snapshot, relaunch, timers re-armed;
  * ``trainer_wake``  — end of a ``snapshot_cost_s`` stop-the-world
    pause: a no-op event whose arrival re-runs the trainer probe.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

if TYPE_CHECKING:                          # pragma: no cover
    from repro_torch.core.pool import JobSpec


@dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = field(compare=False)     # rollout_done | train_done | ...
    payload: Any = field(compare=False, default=None)


class EventQueue:
    def __init__(self):
        self._h: List[Event] = []
        self._c = itertools.count()

    def push(self, time: float, kind: str, payload: Any = None) -> None:
        heapq.heappush(self._h, Event(time, next(self._c), kind, payload))

    def pop(self) -> Event:
        return heapq.heappop(self._h)

    def __len__(self) -> int:
        return len(self._h)

    def retain(self, kinds) -> int:
        """Drop every pending event whose kind is not in ``kinds``
        (controller-crash semantics: in-memory timers and completions
        die with the controller, external injections survive).  Returns
        the number of events dropped; seq numbers are preserved so
        relative order of survivors is unchanged."""
        kinds = set(kinds)
        before = len(self._h)
        self._h = [e for e in self._h if e.kind in kinds]
        heapq.heapify(self._h)
        return before - len(self._h)


@dataclass
class StragglerInjection:
    """Replica ``replica_idx`` runs at ``factor``× throughput from t_start.

    ``replica_idx`` refers to the flattened replica order of the plan that
    is *live when the injection fires* (plan epochs renumber replicas).
    """
    replica_idx: int
    factor: float = 0.3
    t_start: float = 0.0


@dataclass
class FailureInjection:
    """Replica dies at t_fail; optionally recovers after ``downtime``."""
    replica_idx: int
    t_fail: float
    downtime: Optional[float] = None      # None = permanent


@dataclass
class JobFailure:
    """Multi-job fault injection: replica ``replica_idx`` of ``job``'s live
    plan dies at ``t_fail`` (MultiJobSimulator); recovers after ``downtime``
    when set (transient), else permanently."""
    job: str
    replica_idx: int
    t_fail: float
    downtime: Optional[float] = None      # None = permanent


@dataclass
class JobStraggler:
    """Multi-job straggler injection: replica ``replica_idx`` of ``job``'s
    live plan runs at ``factor``× throughput from ``t_start``."""
    job: str
    replica_idx: int
    factor: float = 0.3
    t_start: float = 0.0


@dataclass
class JobArrival:
    """Online job submission: ``spec`` arrives at ``t_submit`` and asks the
    admission controller (core/jobs.py) to place it mid-run.  ``n_steps``
    overrides the pool-wide step budget for this job (short jobs are how a
    trace exercises departure + slice reclaim)."""
    spec: "JobSpec"                       # type: ignore[name-defined]
    t_submit: float
    n_steps: Optional[int] = None


@dataclass
class ControllerCrash:
    """Controller dies at ``t_crash`` (both simulator loops).

    Everything since the last ``RecoveryManager`` snapshot is discarded:
    the event queue keeps only external injections, state rolls back to
    snapshot + journal replay, and work resumes ``restore_latency_s``
    later (the modeled MTTR: detect + reload + replay).  Requires a
    ``recovery=`` manager on the sim config."""
    t_crash: float
    restore_latency_s: Optional[float] = None   # None = manager's config


@dataclass
class HandoffRecord:
    """One cross-job device transfer committed by a pool replan: the device
    ledger's audit trail that no device ever serves two jobs."""
    t: float
    from_job: str
    to_job: str
    n_devices: int
    device_indices: List[int]


@dataclass
class ReplanTrigger:
    """Why the simulator asked the scheduler for a new plan."""
    time: float
    reason: str                 # "failure" | "straggler"
    replica_idx: int            # replica (in the then-live plan) that tripped it


@dataclass
class PlanSwapRecord:
    """Provenance of one committed hot swap (simulator output).

    Staleness fields snapshot the consumed-rollout staleness stream so the
    η bound can be checked on both sides of the swap: ``*_before`` covers
    everything consumed up to the commit, ``*_after`` everything consumed
    from the commit to the end of the run (filled when the run finishes).
    """
    epoch: int                  # plan epoch committed by this swap
    t_request: float            # when the trigger fired (draining starts)
    t_commit: float             # when the new plan went live
    reason: str
    n_replicas_before: int
    n_replicas_after: int
    mean_staleness_before: float = 0.0
    max_staleness_before: int = 0
    mean_staleness_after: float = 0.0
    max_staleness_after: int = 0
