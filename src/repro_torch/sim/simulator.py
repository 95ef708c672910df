"""Discrete-event simulator for asynchronous RL over a scheduled plan, the
port's copy of ``repro.sim.simulator``: host numpy, no torch, and the
same ``numpy.random.Generator`` draws, so a plan gives the reference's
result bit for bit.

Executes a ``ScheduledPlan`` (replica set with throughputs h_ψ, train-step
cost, weight-sync cost) over simulated time with AReaL semantics:

  * each rollout replica generates trajectories back-to-back; lengths are
    sampled from the profiled distribution P;
  * completed rollouts pass the constant-cost reward stage, then enter the
    staleness-bounded buffer ((η+1)·B capacity control — generation pauses
    when the bound would be violated);
  * the trainer consumes B rollouts per step (t_train seconds), bumps the
    weight version, and broadcasts (t_sync seconds, pausing generation —
    paper Fig. 1);
  * stragglers run at a reduced rate; failed replicas stop.

Elastic replanning (§4.3: the runtime analogue of re-running the
repartition phase) closes the loop back to the scheduler.  When an
``ElasticReplanner`` is attached, the simulator runs this plan-swap state
machine:

    RUNNING ──(permanent failure │ sustained straggler)──▶ DRAINING
      ▲                                                        │
      │  commit: swap replica set + t_train/t_sync, epoch += 1 │
      └──────────────── replan_ready (after replan_latency_s) ─┘

  * RUNNING   — normal operation on the current plan epoch.
  * DRAINING  — no *new* rollouts launch while the replanner recomputes,
    but in-flight rollouts run to completion and keep their weight-version
    tags (their work is preserved), and the trainer keeps consuming from
    the buffer.  Further failures during the drain accumulate into the
    same replan.  When ``min_interval_s`` debounces a trigger, the commit
    is deferred — never dropped — and the drain starts only
    ``replan_latency_s`` before the deferred commit, so the surviving
    fleet keeps generating through the deferral window.
  * commit    — the survivors are snapshotted into a reduced ``Cluster``
    and the repartition phase re-runs (γ- and δ-warm-started
    ``core.scheduler.reschedule``).  The new plan's replica set and
    train/sync costs hot-swap in; weight-version accounting carries over
    unchanged, so the η staleness bound holds across the swap (asserted in
    tests, recorded per swap in ``PlanSwapRecord``).  If no feasible plan
    exists the old plan continues minus the dead replicas.  Transient
    failures (a ``downtime``) are tracked per *device*: a swap re-places
    work onto a still-down device as a dead replica that recovers when
    the original outage ends.

Rollout-completion events are tagged with the plan epoch that launched
them: a rollout finishing after a swap still enters the buffer (admission
is by weight version, not by epoch) but does not re-launch its —
possibly reassigned — replica.

This is how the paper's throughput tables are reproduced without H800/H20
hardware, and how fault-tolerance is validated at scale.

``MultiJobSimulator`` (below) generalizes the machinery to N jobs sharing
one pool: N plan state machines over a shared ``DeviceLedger``, with
pool-level drain/commit swaps that can hand whole ICI domains between
jobs (core/pool.py arbitration) while preserving every job's η bound.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.cost_model import (EnvCostModel, GenTimeModel,
                                   LengthDistribution)
from repro_torch.core.jobs import (AdmissionConfig, ControlPlane,
                             EwmaThroughputTrend, JobRecord, JobState,
                             TrendConfig)
from repro_torch.core.plan import ScheduledPlan
from repro_torch.core.pool import JobSpec, PoolPlan
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.monitor import HealthMonitor
from repro_torch.obs.trace import Tracer
from repro_torch.recovery.snapshot import (RecoveryError, RecoveryEvent,
                                     RecoveryManager)
from .events import (ControllerCrash, EventQueue, FailureInjection,
                     HandoffRecord, JobArrival, JobFailure, JobStraggler,
                     PlanSwapRecord, ReplanTrigger, StragglerInjection)
from .replan import ElasticReplanner, PoolReplanner, replica_device_map


@dataclass
class SimConfig:
    n_steps: int = 30                      # matches the paper's 30-step avg
    rollouts_per_step: int = 256           # B
    eta: int = 4
    reward_cost_s: float = 0.5
    seed: int = 0
    stragglers: Sequence[StragglerInjection] = field(default_factory=list)
    failures: Sequence[FailureInjection] = field(default_factory=list)
    replanner: Optional[ElasticReplanner] = None   # attach to go elastic
    check_invariants: bool = False         # assert conservation per event
    # length-distribution-aware generation time (serve.feedback fit or
    # GenTimeModel.from_replica_cost); None = the historical fixed
    # per-token constant — existing runs are bit-identical
    gen_time: Optional[GenTimeModel] = None
    # agentic multi-turn env/tool pool: each episode waits out sampled
    # inter-turn env gaps before its reward (stochastic counterpart of the
    # scheduler's EnvCostModel.stage_time); None = no gaps, no extra rng
    # draws — existing runs are bit-identical
    env: Optional[EnvCostModel] = None
    # observability (obs): default-off.  With both None the event
    # stream, rng draws, and SimResult are bit-identical to an
    # uninstrumented run (asserted in tests/test_torch_sim.py).
    # Timestamps on the tracer are sim-time seconds.
    trace: Optional[Tracer] = None
    metrics: Optional[MetricsRegistry] = None
    # online health monitor (obs.monitor): default-off.  When set,
    # a self-re-arming "monitor_poll" event evaluates the detectors
    # every monitor.cfg.poll_interval_s sim-seconds; with
    # monitor_replan=True a straggler alert routes into the replan path
    # (needs a replanner).  With monitor=None no poll events exist and
    # runs are bit-identical (asserted in tests/test_torch_sim.py).
    monitor: Optional[HealthMonitor] = None
    monitor_replan: bool = False
    # crash-consistent recovery (recovery): a RecoveryManager
    # snapshots the full controller state every recovery.cfg.interval_s
    # sim-seconds and write-ahead-journals work between snapshots; a
    # ControllerCrash injection rolls the run back to the last snapshot
    # + journal replay and resumes restore_latency_s later.  crashes
    # require a manager; with recovery=None (or attached but no crash)
    # runs are bit-identical (asserted in tests/test_torch_sim.py).
    recovery: Optional[RecoveryManager] = None
    crashes: Sequence[ControllerCrash] = field(default_factory=list)


@dataclass
class PlanEpochStat:
    """Throughput attribution for one plan generation."""
    epoch: int
    provenance: str
    t_start: float
    t_end: float
    steps: int
    tokens: float

    @property
    def throughput_tps(self) -> float:
        dt = self.t_end - self.t_start
        return self.tokens / dt if dt > 0 else 0.0


@dataclass
class SimResult:
    wall_time_s: float
    steps: int
    tokens_consumed: float
    throughput_tps: float
    train_busy_frac: float
    gen_busy_frac: float
    mean_staleness: float
    max_staleness: int
    stalls_capacity: int                  # generation pauses (staleness cap)
    stalls_data: int                      # trainer waits on rollouts
    # latency fields report the FINAL plan epoch's costs (per-epoch values
    # live in plan_epochs when the run swapped plans mid-flight)
    infer_latency_s: float                # mean per-step rollout-supply time
    train_latency_s: float
    sync_latency_s: float
    dropped: int = 0
    # --- conservation ledger (every launched rollout is accounted for)
    rollouts_launched: int = 0
    rollouts_trained: int = 0
    rollouts_in_buffer: int = 0           # at end of run
    rollouts_generating: int = 0          # at end of run
    # --- elastic replanning provenance
    swaps: List[PlanSwapRecord] = field(default_factory=list)
    replan_triggers: List[ReplanTrigger] = field(default_factory=list)
    plan_epochs: List[PlanEpochStat] = field(default_factory=list)
    # --- crash recovery provenance (one record per ControllerCrash)
    recoveries: List[RecoveryEvent] = field(default_factory=list)

    def summary(self) -> str:
        extra = f" swaps={len(self.swaps)}" if self.swaps else ""
        return (f"steps={self.steps} wall={self.wall_time_s:.1f}s "
                f"tput={self.throughput_tps:.0f} t/s "
                f"train_busy={self.train_busy_frac:.2f} "
                f"staleness μ={self.mean_staleness:.2f} "
                f"max={self.max_staleness}{extra}")


def _flatten_replicas(plan: ScheduledPlan) -> List[float]:
    out: List[float] = []
    for a in plan.rollout_plan.assignments:
        for _ in range(a.count):
            out.append(a.cost.tokens_per_sec)
    return out


class AsyncRLSimulator:
    def __init__(self, plan: ScheduledPlan, P: LengthDistribution,
                 cfg: SimConfig = SimConfig()):
        self.plan = plan
        self.P = P
        self.cfg = cfg
        # flatten replicas: (throughput tokens/s)
        self.replicas: List[float] = _flatten_replicas(plan)
        self.t_train = plan.cost_train / max(plan.delta, 1)
        self.t_sync = plan.cost_update / max(plan.delta, 1)

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        B = cfg.rollouts_per_step
        capacity = (cfg.eta + 1) * B
        q = EventQueue()
        replanner = cfg.replanner
        elastic = replanner.elastic if replanner is not None else None

        cur_plan = self.plan
        epoch = cur_plan.plan_epoch
        n_rep = len(self.replicas)
        rate = list(self.replicas)            # current tokens/s per replica
        alive = [True] * n_rep
        cum_factor = [1.0] * n_rep            # cumulative straggler slowdown
        t_train, t_sync = self.t_train, self.t_sync
        version = 0
        buffer: List[tuple] = []              # (version, length)
        in_flight = 0
        paused: List[int] = []                # replicas paused on capacity
        idle: Set[int] = set()                # drained replicas awaiting swap
        steps = 0
        tokens_consumed = 0.0
        stale_hist: List[int] = []
        stalls_capacity = 0
        stalls_data = 0
        dropped = 0
        launched = 0
        consumed = 0
        generating = 0
        train_busy = 0.0
        gen_busy_sum = 0.0
        rep_seconds = 0.0                     # ∫ fleet-size dt across epochs
        trainer_busy_until = 0.0
        t = 0.0

        # --- plan-swap state machine
        state = "RUNNING"                     # RUNNING | DRAINING
        drain_scheduled = False               # a deferred drain is queued
        pending_dead: Set[int] = set()        # replicas to vacate at commit
        down_until: Dict[int, float] = {}     # device idx → transient-recovery t
        drain_reason = ""
        drain_t0 = 0.0
        last_commit = -np.inf
        swaps: List[PlanSwapRecord] = []
        triggers: List[ReplanTrigger] = []
        epoch_stats: List[PlanEpochStat] = []
        epoch_open = dict(epoch=epoch, provenance=cur_plan.provenance,
                          t_start=0.0, steps0=0, tokens0=0.0)
        swap_hist_idx: List[int] = []         # stale_hist cut per swap
        tr = cfg.trace                        # None = zero-cost no-op
        mx = cfg.metrics
        mon = cfg.monitor

        # --- crash-consistent recovery (recovery)
        rec = cfg.recovery
        if cfg.crashes and rec is None:
            raise ValueError("ControllerCrash injection requires "
                             "SimConfig.recovery (a RecoveryManager)")
        journaling = rec is not None and rec.cfg.journal
        recoveries: List[RecoveryEvent] = []
        controller_down = False
        next_rid = 0                          # monotonic rollout id, never reused
        consumed_rids: Set[int] = set()       # exactly-once guard (journal mode)
        consume_seq = 0                       # serial train-consumption counter
        pending_train: Optional[dict] = None  # consumed-but-uncommitted step
        cap_slack = 0                         # transient post-rollback overshoot

        def close_epoch(now: float) -> None:
            epoch_stats.append(PlanEpochStat(
                epoch=epoch_open["epoch"], provenance=epoch_open["provenance"],
                t_start=epoch_open["t_start"], t_end=now,
                steps=steps - epoch_open["steps0"],
                tokens=tokens_consumed - epoch_open["tokens0"]))

        def check(now: float) -> None:
            nonlocal cap_slack
            if not cfg.check_invariants:
                return
            assert in_flight == generating + len(buffer), \
                (now, in_flight, generating, len(buffer))
            assert launched == consumed + dropped + in_flight, \
                (now, launched, consumed, dropped, in_flight)
            # cap_slack: a crash-rollback of an uncommitted consumption can
            # transiently overshoot capacity by at most one batch (launches
            # the rolled-back step enabled pre-crash are preserved, never
            # discarded); launch gating admits nothing until it drains
            assert 0 <= in_flight <= capacity + cap_slack, \
                (now, in_flight, capacity, cap_slack)
            if in_flight <= capacity:
                cap_slack = 0

        def launch(i: int, now: float) -> None:
            nonlocal in_flight, stalls_capacity, launched, generating
            nonlocal gen_busy_sum, next_rid
            if i >= len(alive) or not alive[i]:
                return
            if controller_down:               # nobody to hand out prompts
                return
            if state == "DRAINING":           # no new work while replanning
                idle.add(i)
                return
            if in_flight >= capacity:
                paused.append(i)          # staleness capacity reached:
                stalls_capacity += 1      # generation pauses (paper Fig. 1)
                if mx is not None:
                    mx.counter("sim/stalls_capacity").inc()
                if mon is not None:
                    mon.on_stall("sim", now, "capacity")
                return
            in_flight += 1
            launched += 1
            generating += 1
            rid = next_rid
            next_rid += 1
            length = float(np.clip(rng.lognormal(
                *_lognorm(self.P)), 16, self.P.max_len))
            dur = _gen_duration(cfg.gen_time, length, self.P, rate[i])
            gen_busy_sum += dur
            # env gaps are wall time the replica stalls, not generation —
            # they delay the rollout but do not count as gen_busy
            gap = _env_gap(cfg.env, rng)
            q.push(now + dur + gap + cfg.reward_cost_s,
                   "rollout_done", (epoch, i, version, length, rid))
            if journaling:
                rec.journal({"k": "launch", "rid": rid, "dur": dur})
            if tr is not None:
                tr.span("replica", f"r{i}", "generate", now, dur,
                        tokens=length, version=version, epoch=epoch)
                tr.span("stage", "generation", "generate", now, dur,
                        replica=i)
                if gap > 0.0:
                    tr.span("stage", "env", "env_wait", now + dur, gap,
                            replica=i)
                if cfg.reward_cost_s > 0.0:
                    tr.span("stage", "reward", "reward", now + dur + gap,
                            cfg.reward_cost_s, replica=i)
            if mx is not None:
                mx.counter("sim/rollouts_launched").inc()
                mx.counter(f"sim/gen_busy_s/r{i}").inc(dur)
            if mon is not None:
                mon.on_gen_span("", i, now, dur, length)
                mon.on_stage_span("generation", now, dur)

        def maybe_train(now: float) -> None:
            nonlocal steps, tokens_consumed, version, in_flight, consumed
            nonlocal train_busy, trainer_busy_until, stalls_data, dropped
            nonlocal consume_seq, pending_train
            if steps >= cfg.n_steps or now < trainer_busy_until:
                return
            # evict over-stale entries (frees their capacity slots)
            fresh = [r for r in buffer if version - r[0] <= cfg.eta]
            n_evicted = len(buffer) - len(fresh)
            if n_evicted:
                if journaling:
                    rec.journal({"k": "evict",
                                 "rids": [r[2] for r in buffer
                                          if version - r[0] > cfg.eta]})
                dropped += n_evicted
                in_flight -= n_evicted
                buffer[:] = fresh
                if tr is not None:
                    tr.instant("stage", "train", "evict_stale", now,
                               n=n_evicted)
                if mx is not None:
                    mx.counter("sim/dropped").inc(n_evicted)
            if len(buffer) < B:
                stalls_data += 1
                if mx is not None:
                    mx.counter("sim/stalls_data").inc()
                if mon is not None:
                    mon.on_stall("sim", now, "data")
                return
            batch = buffer[:B]
            del buffer[:B]
            in_flight -= B
            consumed += B
            tok0 = tokens_consumed
            for vtag, ln, _rid in batch:
                stale_hist.append(version - vtag)
                tokens_consumed += ln + self.P.prompt_len
            if journaling:
                # the write-ahead record for this step: journaled at
                # train_done (the commit point), rolled back whole on a
                # crash in between.  The exactly-once assertion: no
                # rollout id is ever consumed twice.
                rids = [r[2] for r in batch]
                for rid_ in rids:
                    if rid_ in consumed_rids:
                        raise RecoveryError(
                            f"rollout {rid_} consumed twice")
                    consumed_rids.add(rid_)
                consume_seq += 1
                pending_train = {
                    "k": "train", "seq": consume_seq, "rids": rids,
                    "batch": list(batch), "n": B,
                    "stalenesses": [version - r[0] for r in batch],
                    "tokens": tokens_consumed - tok0, "t_train": t_train}
            dur = t_train + t_sync
            train_busy += t_train
            trainer_busy_until = now + dur
            q.push(now + dur, "train_done", None)
            if tr is not None:
                tr.span("stage", "train", "train_step", now, t_train,
                        step=steps, tokens=tokens_consumed - tok0,
                        version=version)
                if t_sync > 0.0:
                    tr.span("stage", "sync", "weight_sync", now + t_train,
                            t_sync, version=version + 1)
                tr.counter("sim", "buffer", now, depth=len(buffer),
                           in_flight=in_flight)
            if mx is not None:
                h = mx.histogram("sim/staleness")
                for vtag, _ln, _rid in batch:
                    h.observe(version - vtag)
                mx.counter("sim/rollouts_trained").inc(B)
            if mon is not None:
                for vtag, _ln, _rid in batch:
                    mon.on_staleness("sim", now, version - vtag, cfg.eta)
                mon.on_buffer("sim", now, len(buffer), capacity)
                mon.on_stage_span("train", now, t_train)
                if t_sync > 0.0:
                    mon.on_stage_span("sync", now + t_train, t_sync)
            # resume capacity-paused replicas; drain a snapshot so a replica
            # that immediately re-pauses (capacity still full) is not popped
            # again in the same pass (that would spin forever whenever
            # n_rep exceeds the (η+1)·B capacity)
            resume = paused[:]
            paused.clear()
            for i in resume:
                launch(i, now)
            check(now)

        def trigger_replan(now: float, reason: str, replica_idx: int) -> None:
            nonlocal drain_scheduled, drain_reason, drain_t0
            if replanner is None:
                return
            pending_dead.add(replica_idx)
            triggers.append(ReplanTrigger(now, reason, replica_idx))
            if controller_down:
                return          # accumulate; resume re-schedules the drain
            if state == "DRAINING" or drain_scheduled:
                return                        # accumulate into pending swap
            # debounce defers the commit past min_interval_s after the last
            # swap — it never drops a trigger (a dropped permanent failure
            # would silently disable recovery for the rest of the run), and
            # the fleet keeps generating until the drain actually starts
            # (replan_latency_s before the deferred commit, not the trigger)
            ready = max(now + elastic.replan_latency_s,
                        last_commit + elastic.min_interval_s)
            drain_scheduled = True
            drain_reason = reason
            drain_t0 = now
            q.push(ready - elastic.replan_latency_s, "replan_drain", None)

        def commit_swap(now: float) -> None:
            nonlocal state, drain_scheduled, cur_plan, epoch, n_rep, rate
            nonlocal alive, cum_factor, t_train, t_sync, last_commit
            nonlocal rep_seconds
            n_before = sum(alive)
            replanner.exclude_replicas(cur_plan, sorted(pending_dead))
            new_plan = replanner.replan(cur_plan, drain_reason)
            for i in pending_dead:            # vacated either way
                if i < len(alive):
                    alive[i] = False
            pending_dead.clear()
            state = "RUNNING"
            drain_scheduled = False
            last_commit = now
            if mon is not None:
                # new fleet = new rate distribution; stale evidence from
                # the old plan must not trip the detectors
                mon.reset()
            if tr is not None:
                # the drain window: launches stopped replan_latency_s ago
                tr.span("sim", "plan", "drain", now - elastic.replan_latency_s,
                        elastic.replan_latency_s, reason=drain_reason)
            if new_plan is None:
                # no feasible plan: continue on the old one minus the dead
                if tr is not None:
                    tr.instant("sim", "plan", "commit_infeasible", now,
                               reason=drain_reason)
                for i in sorted(idle):
                    launch(i, now)
                idle.clear()
                return
            close_epoch(now)
            rep_seconds += n_rep * (now - epoch_open["t_start"])
            cur_plan = new_plan
            epoch = new_plan.plan_epoch
            epoch_open.update(epoch=epoch, provenance=new_plan.provenance,
                              t_start=now, steps0=steps,
                              tokens0=tokens_consumed)
            rate = _flatten_replicas(new_plan)
            n_rep = len(rate)
            alive = [True] * n_rep
            cum_factor = [1.0] * n_rep
            t_train = new_plan.cost_train / max(new_plan.delta, 1)
            t_sync = new_plan.cost_update / max(new_plan.delta, 1)
            h = stale_hist
            swaps.append(PlanSwapRecord(
                epoch=epoch, t_request=drain_t0, t_commit=now,
                reason=drain_reason, n_replicas_before=n_before,
                n_replicas_after=n_rep,
                mean_staleness_before=float(np.mean(h)) if h else 0.0,
                max_staleness_before=int(np.max(h)) if h else 0))
            swap_hist_idx.append(len(h))
            if tr is not None:
                tr.instant("sim", "plan", "commit", now, epoch=epoch,
                           replicas=n_rep, reason=drain_reason)
            if mx is not None:
                mx.counter("sim/plan_swaps").inc()
            paused.clear()
            idle.clear()
            # transiently-down devices (failures with a downtime) keep their
            # remaining outage across the swap: any new replica placed on
            # them starts dead and recovers when the original outage ends
            still_down = {d: until for d, until in down_until.items()
                          if until > now}
            if still_down:
                for i, devs in enumerate(replanner.replica_devices(new_plan)):
                    t_up = max((still_down.get(d.index, 0.0) for d in devs),
                               default=0.0)
                    if t_up > now:
                        alive[i] = False
                        q.push(t_up, "recover", (epoch, i))
            # in-flight rollouts from the old epoch drain into the buffer as
            # they finish; the new replica fleet starts fresh here
            for i in range(n_rep):
                launch(i, now)

        # ----------------------------------------------- crash recovery
        def capture() -> dict:
            """Full controller state as one atomic unit (fresh containers;
            plans are shared by reference — immutable inputs)."""
            return {
                "version": version, "buffer": list(buffer),
                "in_flight": in_flight, "generating": generating,
                "steps": steps, "tokens": tokens_consumed,
                "stale_hist": list(stale_hist),
                "stalls_capacity": stalls_capacity,
                "stalls_data": stalls_data,
                "dropped": dropped, "launched": launched,
                "consumed": consumed, "train_busy": train_busy,
                "gen_busy_sum": gen_busy_sum, "rep_seconds": rep_seconds,
                "plan": cur_plan, "epoch": epoch,
                "t_train": t_train, "t_sync": t_sync,
                "rate": list(rate), "alive": list(alive),
                "cum_factor": list(cum_factor),
                "pending_dead": set(pending_dead),
                "down_until": dict(down_until),
                "last_commit": last_commit,
                "swaps": [copy.copy(r) for r in swaps],
                "triggers": list(triggers),
                "epoch_stats": list(epoch_stats),
                "epoch_open": dict(epoch_open),
                "swap_hist_idx": list(swap_hist_idx),
                "next_rid": next_rid, "consume_seq": consume_seq,
                "consumed_rids": set(consumed_rids),
                "pending_train": (dict(pending_train)
                                  if pending_train is not None else None),
                "cap_slack": cap_slack,
                "rng": rng.bit_generator.state,
                "excluded": (set(replanner.excluded)
                             if replanner is not None else None),
            }

        def do_crash(c: ControllerCrash, now: float) -> None:
            """Total controller loss: wipe every in-memory event, roll back
            to the last snapshot, replay the write-ahead journal to
            exactly-once, verify invariants, and schedule the resume."""
            nonlocal version, in_flight, generating, steps, tokens_consumed
            nonlocal stalls_capacity, stalls_data, dropped, launched
            nonlocal consumed, train_busy, gen_busy_sum, rep_seconds
            nonlocal trainer_busy_until, cur_plan, epoch, t_train, t_sync
            nonlocal rate, alive, cum_factor, n_rep, pending_dead, down_until
            nonlocal last_commit, swaps, triggers, epoch_stats, epoch_open
            nonlocal swap_hist_idx, next_rid, consume_seq, consumed_rids
            nonlocal pending_train, paused, idle, state, drain_scheduled
            nonlocal drain_reason, drain_t0, controller_down, stale_hist
            nonlocal buffer, cap_slack
            snap_t, st, entries = rec.latest()
            # a consumption uncommitted at the crash instant rolls back no
            # matter where the snapshot fell: explicitly (snapshot captured
            # it mid-flight) or implicitly (post-snapshot consumption whose
            # commit never reached the journal — replay re-fills the
            # buffer).  Either way the overshoot bound is one batch.
            live_pt_n = pending_train["n"] if pending_train is not None else 0
            # pre-crash progress baseline counts only *committed* steps:
            # the live uncommitted batch is work in flight, not progress
            steps_b, consumed_b = steps, consumed - live_pt_n
            # controller-internal timers and completions die with the
            # controller; external injections (hardware faults, future
            # crashes) keep happening to the world
            q.retain(("straggle", "fail", "recover", "crash"))
            # --- roll back to the snapshot
            version = st["version"]
            buffer = list(st["buffer"])
            in_flight = st["in_flight"]
            generating = st["generating"]
            steps = st["steps"]
            tokens_consumed = st["tokens"]
            stale_hist = list(st["stale_hist"])
            stalls_capacity = st["stalls_capacity"]
            stalls_data = st["stalls_data"]
            dropped = st["dropped"]
            launched = st["launched"]
            consumed = st["consumed"]
            train_busy = st["train_busy"]
            gen_busy_sum = st["gen_busy_sum"]
            rep_seconds = st["rep_seconds"]
            cur_plan = st["plan"]
            epoch = st["epoch"]
            t_train, t_sync = st["t_train"], st["t_sync"]
            rate = list(st["rate"])
            alive = list(st["alive"])
            cum_factor = list(st["cum_factor"])
            n_rep = len(rate)
            pending_dead = set(st["pending_dead"])
            down_until = dict(st["down_until"])
            last_commit = st["last_commit"]
            swaps = [copy.copy(r) for r in st["swaps"]]
            triggers = list(st["triggers"])
            epoch_stats = list(st["epoch_stats"])
            epoch_open = dict(st["epoch_open"])
            swap_hist_idx = list(st["swap_hist_idx"])
            next_rid = st["next_rid"]
            consume_seq = st["consume_seq"]
            consumed_rids = set(st["consumed_rids"])
            rng.bit_generator.state = st["rng"]
            if replanner is not None and st["excluded"] is not None:
                replanner.excluded = set(st["excluded"])
            paused = []
            idle = set()
            state = "RUNNING"
            drain_scheduled = False
            drain_reason = ""
            drain_t0 = 0.0
            pending_train = None
            # --- replay the journal (exactly-once: every entry keyed by
            # a never-reused rollout id, duplicates are a hard error)
            completed = {e["rid"] for e in entries if e["k"] == "rollout"}
            seen_launch: Set[int] = set()
            seen_rollout: Set[int] = set()
            pt = st["pending_train"]
            lost_post = 0
            for e in entries:
                k = e["k"]
                if k == "launch":
                    if e["rid"] in seen_launch:
                        raise RecoveryError(
                            f"journal: duplicate launch rid {e['rid']}")
                    seen_launch.add(e["rid"])
                    next_rid += 1      # every journaled launch used an id
                    if e["rid"] not in completed:
                        lost_post += 1     # in-flight at the crash: lost
                        continue
                    launched += 1
                    in_flight += 1
                    generating += 1
                    gen_busy_sum += e["dur"]
                elif k == "rollout":
                    if e["rid"] in seen_rollout:
                        raise RecoveryError(
                            f"journal: duplicate completion rid {e['rid']}")
                    seen_rollout.add(e["rid"])
                    generating -= 1
                    if e["admitted"]:
                        buffer.append((e["vtag"], e["length"], e["rid"]))
                    else:
                        dropped += 1
                        in_flight -= 1
                elif k == "evict":
                    rids = set(e["rids"])
                    keep = [r for r in buffer if r[2] not in rids]
                    if len(buffer) - len(keep) != len(rids):
                        raise RecoveryError("journal: evicted rollouts "
                                            "missing from buffer")
                    buffer = keep
                    dropped += len(rids)
                    in_flight -= len(rids)
                elif k == "train":
                    if pt is not None and e["seq"] == pt["seq"]:
                        # consumption was in flight at the snapshot: its
                        # pop + counters are already captured — apply only
                        # the step commit
                        pt = None
                    else:
                        head = buffer[:e["n"]]
                        if [r[2] for r in head] != list(e["rids"]):
                            raise RecoveryError(
                                "journal: train batch does not match "
                                "buffer head")
                        del buffer[:e["n"]]
                        in_flight -= e["n"]
                        consumed += e["n"]
                        tokens_consumed += e["tokens"]
                        stale_hist.extend(e["stalenesses"])
                        train_busy += e["t_train"]
                        for rid_ in e["rids"]:
                            if rid_ in consumed_rids:
                                raise RecoveryError(
                                    f"rollout {rid_} consumed twice "
                                    f"across the crash boundary")
                            consumed_rids.add(rid_)
                    steps += 1
                    version += 1
                elif k == "fail":
                    i_ = e["idx"]
                    if i_ < len(alive):
                        alive[i_] = False
                    for d in e.get("devs", ()):
                        down_until[d] = max(down_until.get(d, 0.0),
                                            e["until"])
                    if (e["downtime"] is None and elastic is not None
                            and elastic.replan_on_failure):
                        pending_dead.add(i_)
                        triggers.append(ReplanTrigger(e["t"], "failure", i_))
                elif k == "straggle":
                    i_ = e["idx"]
                    if i_ < len(rate):
                        rate[i_] *= e["factor"]
                        cum_factor[i_] *= e["factor"]
                        if (elastic is not None and cum_factor[i_]
                                <= elastic.straggler_threshold):
                            pending_dead.add(i_)
                            triggers.append(
                                ReplanTrigger(e["t"], "straggler", i_))
            # a consumption whose step never committed rolls back whole:
            # the batch returns to the buffer head, nothing was trained
            rolled_back = 0
            if pt is not None:
                n = pt["n"]
                rolled_back = n
                buffer[:0] = pt["batch"]
                in_flight += n
                consumed -= n
                tokens_consumed -= pt["tokens"]
                del stale_hist[-n:]
                train_busy -= pt["t_train"]
                for rid_ in pt["rids"]:
                    consumed_rids.discard(rid_)
            # pre-snapshot in-flight that never completed: lost work
            lost_pre = generating
            if lost_pre:
                dropped += lost_pre
                in_flight -= lost_pre
                generating = 0
            # --- prove the invariants across the crash boundary (gate c)
            if in_flight != generating + len(buffer):
                raise RecoveryError(
                    f"restore: in_flight {in_flight} != generating "
                    f"{generating} + buffered {len(buffer)}")
            if launched != consumed + dropped + in_flight:
                raise RecoveryError(
                    f"restore: conservation broken: launched {launched} "
                    f"!= {consumed}+{dropped}+{in_flight}")
            # a rolled-back consumption may transiently overshoot capacity
            # by at most one batch: the launches it enabled pre-crash are
            # preserved, and launch gating drains the excess
            allowed = capacity + st["cap_slack"] + max(rolled_back, live_pt_n)
            if not 0 <= in_flight <= allowed:
                raise RecoveryError(
                    f"restore: in_flight {in_flight} outside "
                    f"[0, {allowed}]")
            cap_slack = max(0, in_flight - capacity)
            if stale_hist and int(np.max(stale_hist)) > cfg.eta:
                raise RecoveryError(
                    f"restore: η bound violated: max staleness "
                    f"{int(np.max(stale_hist))} > η={cfg.eta}")
            # --- schedule the comeback
            lat = (c.restore_latency_s if c.restore_latency_s is not None
                   else rec.cfg.restore_latency_s)
            controller_down = True
            trainer_busy_until = now + lat
            q.push(now + lat, "resume", None)
            recoveries.append(RecoveryEvent(
                t_crash=now, t_snapshot=snap_t, t_resume=now + lat,
                mttr_s=lat, steps_before=steps_b, steps_after=steps,
                consumed_before=consumed_b, consumed_after=consumed,
                lost_inflight=lost_pre + lost_post,
                lost_consumed=max(consumed_b - consumed, 0),
                journal_replayed=len(entries)))
            if tr is not None:
                tr.span("recovery", "controller", "restore", now, lat,
                        snapshot_t=snap_t, replayed=len(entries),
                        lost_inflight=lost_pre + lost_post)
            if mx is not None:
                mx.counter("sim/crashes").inc()

        def do_resume(now: float) -> None:
            nonlocal controller_down, drain_scheduled, drain_reason, drain_t0
            controller_down = False
            # fresh base: a second crash must replay from a clean journal
            # (ids freed by the loss cancellation are about to be reissued)
            rec.snapshot(now, capture())
            for i in range(n_rep):
                launch(i, now)
            if pending_dead and replanner is not None:
                ready = max(now + elastic.replan_latency_s,
                            last_commit + elastic.min_interval_s)
                drain_scheduled = True
                drain_reason = "recovery"
                drain_t0 = now
                q.push(ready - elastic.replan_latency_s, "replan_drain",
                       None)
            if mon is not None:
                mon.reset()
                q.push(now + mon.cfg.poll_interval_s, "monitor_poll", None)
            q.push(now + rec.cfg.interval_s, "snapshot", None)

        for s in cfg.stragglers:
            if s.t_start <= 0 and s.replica_idx < n_rep:
                rate[s.replica_idx] *= s.factor
                cum_factor[s.replica_idx] *= s.factor
                if (elastic is not None and
                        cum_factor[s.replica_idx]
                        <= elastic.straggler_threshold):
                    trigger_replan(0.0, "straggler", s.replica_idx)
            else:
                q.push(s.t_start, "straggle", s)
        for f in cfg.failures:
            q.push(f.t_fail, "fail", f)
        for c in cfg.crashes:
            q.push(c.t_crash, "crash", c)

        if rec is not None:
            # t=0 baseline: a crash before the first cadence snapshot
            # restores here and replays the initial launches
            rec.snapshot(0.0, capture())
        for i in range(n_rep):
            launch(i, 0.0)
        if rec is not None:
            q.push(rec.cfg.interval_s, "snapshot", None)
        if mon is not None:
            q.push(mon.cfg.poll_interval_s, "monitor_poll", None)

        while len(q) and steps < cfg.n_steps:
            ev = q.pop()
            t = ev.time
            if ev.kind == "rollout_done":
                ev_epoch, i, vtag, length, rid = ev.payload
                generating -= 1
                admitted = version - vtag <= cfg.eta
                if not admitted:
                    # over-stale at entry (rare under capacity control):
                    # evicted, its capacity slot freed
                    dropped += 1
                    in_flight -= 1
                    if mx is not None:
                        mx.counter("sim/dropped").inc()
                else:
                    buffer.append((vtag, length, rid))
                if journaling:
                    rec.journal({"k": "rollout", "rid": rid, "vtag": vtag,
                                 "length": length, "admitted": admitted})
                if ev_epoch == epoch:         # old-epoch replicas don't relaunch
                    launch(i, t)
                maybe_train(t)
            elif ev.kind == "train_done":
                steps += 1
                version += 1
                if journaling and pending_train is not None:
                    # the commit point: this step survives a crash from
                    # here on (replayed from the journal)
                    pending_train["t"] = t
                    rec.journal(pending_train)
                    pending_train = None
                maybe_train(t)
            elif ev.kind == "straggle":
                s = ev.payload
                if s.replica_idx < n_rep:
                    rate[s.replica_idx] *= s.factor
                    cum_factor[s.replica_idx] *= s.factor
                    if journaling:
                        rec.journal({"k": "straggle", "idx": s.replica_idx,
                                     "factor": s.factor, "t": t})
                    if (elastic is not None and
                            cum_factor[s.replica_idx]
                            <= elastic.straggler_threshold):
                        trigger_replan(t, "straggler", s.replica_idx)
            elif ev.kind == "fail":
                f = ev.payload
                if f.replica_idx < n_rep:
                    alive[f.replica_idx] = False
                    devs: List[int] = []
                    if f.downtime is not None:
                        q.push(t + f.downtime, "recover",
                               (epoch, f.replica_idx))
                        if replanner is not None:
                            # remember the outage per device so a plan swap
                            # can't silently cancel the remaining downtime
                            rmap = replanner.replica_devices(cur_plan)
                            if f.replica_idx < len(rmap):
                                for d in rmap[f.replica_idx]:
                                    down_until[d.index] = max(
                                        down_until.get(d.index, 0.0),
                                        t + f.downtime)
                                    devs.append(d.index)
                    if journaling:
                        # hardware state is world state: it must survive
                        # a controller crash via replay
                        rec.journal({"k": "fail", "idx": f.replica_idx,
                                     "downtime": f.downtime, "t": t,
                                     "devs": devs,
                                     "until": (t + f.downtime
                                               if f.downtime is not None
                                               else 0.0)})
                    if (f.downtime is None and elastic is not None
                            and elastic.replan_on_failure):
                        trigger_replan(t, "failure", f.replica_idx)
            elif ev.kind == "recover":
                ev_epoch, i = ev.payload
                if ev_epoch == epoch and i < n_rep:   # plan still live
                    alive[i] = True
                    launch(i, t)
            elif ev.kind == "replan_drain":
                state = "DRAINING"
                q.push(t + elastic.replan_latency_s, "replan_ready", None)
            elif ev.kind == "replan_ready":
                commit_swap(t)
            elif ev.kind == "snapshot":
                rec.snapshot(t, capture())
                if rec.cfg.snapshot_cost_s > 0.0:
                    # modeled stop-the-world capture cost: the trainer
                    # pauses while state is serialized.  The pause needs
                    # its own wake-up — if every replica is capacity-
                    # paused the queue holds only future snapshots, each
                    # re-bumping the pause past itself, and the trailing
                    # trainer probe would never fire again
                    trainer_busy_until = max(trainer_busy_until,
                                             t + rec.cfg.snapshot_cost_s)
                    q.push(t + rec.cfg.snapshot_cost_s,
                           "trainer_wake", None)
                # re-arm only while the sim can still make progress (same
                # liveness condition as the monitor poll chain)
                if (generating > 0 or len(buffer) >= B
                        or drain_scheduled or state == "DRAINING"):
                    q.push(t + rec.cfg.interval_s, "snapshot", None)
                if rec.cfg.snapshot_cost_s <= 0.0:
                    # pure observation: skip the trailing trainer probe so
                    # a free snapshot cannot perturb stall accounting
                    # (bit-identity with no manager attached)
                    continue
            elif ev.kind == "trainer_wake":
                pass                     # falls to the trailing probe
            elif ev.kind == "crash":
                do_crash(ev.payload, t)
            elif ev.kind == "resume":
                do_resume(t)
            elif ev.kind == "monitor_poll":
                if rec is not None:
                    rec.observe_age(t)
                for a in mon.poll(t):
                    if (cfg.monitor_replan and replanner is not None
                            and a.detector == "straggler"):
                        trigger_replan(t, "monitor_straggler",
                                       a.evidence["replica"])
                # re-arm only while the sim can still make progress —
                # otherwise the poll chain would keep an otherwise-dead
                # run spinning forever
                if (generating > 0 or len(buffer) >= B
                        or drain_scheduled or state == "DRAINING"):
                    q.push(t + mon.cfg.poll_interval_s,
                           "monitor_poll", None)
            # trainer may have become unblocked by time passing
            if t >= trainer_busy_until:
                maybe_train(t)
            check(t)

        wall = t if t > 0 else 1e-9
        rep_seconds += n_rep * max(wall - epoch_open["t_start"], 0.0)
        close_epoch(wall)
        # fill post-swap staleness snapshots now that the stream is complete
        for swr, cut in zip(swaps, swap_hist_idx):
            h = stale_hist[cut:]
            swr.mean_staleness_after = float(np.mean(h)) if h else 0.0
            swr.max_staleness_after = int(np.max(h)) if h else 0
        if tr is not None:
            # conservation ledger → otherData.ledger: the analyzer
            # cross-checks trace-derived throughput/busy-time against it
            tr.meta["ledger"] = {
                "wall_time_s": wall, "steps": steps,
                "tokens_consumed": tokens_consumed,
                "throughput_tps": tokens_consumed / wall,
                "gen_busy_s": gen_busy_sum, "rep_seconds": rep_seconds,
                "rollouts_launched": launched,
                "rollouts_trained": consumed, "dropped": dropped,
                "mean_staleness": (float(np.mean(stale_hist))
                                   if stale_hist else 0.0),
                "max_staleness": (int(np.max(stale_hist))
                                  if stale_hist else 0),
                "stalls_capacity": stalls_capacity,
                "stalls_data": stalls_data,
            }
        if mx is not None:
            mx.gauge("sim/gen_busy_frac").set(
                gen_busy_sum / rep_seconds if rep_seconds > 0 else 0.0)
            mx.gauge("sim/train_busy_frac").set(train_busy / wall)
            mx.gauge("sim/wall_time_s").set(wall)
        return SimResult(
            wall_time_s=wall,
            steps=steps,
            tokens_consumed=tokens_consumed,
            throughput_tps=tokens_consumed / wall,
            train_busy_frac=train_busy / wall,
            gen_busy_frac=(gen_busy_sum / rep_seconds
                           if rep_seconds > 0 else 0.0),
            mean_staleness=float(np.mean(stale_hist)) if stale_hist else 0.0,
            max_staleness=int(np.max(stale_hist)) if stale_hist else 0,
            stalls_capacity=stalls_capacity,
            stalls_data=stalls_data,
            infer_latency_s=wall / max(steps, 1) - t_train - t_sync,
            train_latency_s=t_train,
            sync_latency_s=t_sync,
            dropped=dropped,
            rollouts_launched=launched,
            rollouts_trained=consumed,
            rollouts_in_buffer=len(buffer),
            rollouts_generating=generating,
            swaps=swaps,
            replan_triggers=triggers,
            plan_epochs=epoch_stats,
            recoveries=recoveries,
        )


def _lognorm(P: LengthDistribution):
    return P.lognorm_params()


def _gen_duration(gtm: Optional[GenTimeModel], length: float,
                  P: LengthDistribution, rate: float) -> float:
    """Rollout generation time: length-aware when a GenTimeModel is
    attached, the historical fixed per-token constant otherwise."""
    if gtm is None:
        return (length + P.prompt_len) / max(rate, 1e-9)
    return gtm.duration(length, prompt_len=P.prompt_len,
                        tokens_per_sec=max(rate, 1e-9), mean_len=P.mean())


def _env_gap(env: Optional[EnvCostModel], rng: np.random.Generator) -> float:
    """Sampled inter-turn env/tool wall time one episode waits out (0.0 and
    no rng draw without a model — keeps existing streams bit-identical)."""
    if env is None:
        return 0.0
    calls = int(round(env.calls_per_episode))
    return float(env.sample_gaps(rng, calls).sum())


# ===================================================================== multi
class DeviceLedger:
    """Shared device-ownership ledger for N concurrent jobs.

    Every device is owned by exactly one job (or excluded as dead); a pool
    replan commits ownership changes atomically through ``apply``, which
    records cross-job ``HandoffRecord``s and rejects resurrections of
    excluded devices.  ``conserved`` is the global invariant the tests
    assert after every swap: owned ⊎ excluded == the initial device set.
    """

    def __init__(self, owner: Dict[int, str]):
        self.owner: Dict[int, str] = dict(owner)
        self.excluded: Set[int] = set()
        self.initial: Set[int] = set(owner)
        self.handoffs: List[HandoffRecord] = []

    def exclude(self, indices) -> None:
        for i in indices:
            self.owner.pop(i, None)
            self.excluded.add(i)

    def apply(self, new_owner: Dict[int, str], t: float) -> List[HandoffRecord]:
        moves: Dict[tuple, List[int]] = {}
        for i, nj in new_owner.items():
            assert i not in self.excluded, f"dead device {i} resurrected"
            oj = self.owner.get(i)
            if oj is not None and oj != nj:
                moves.setdefault((oj, nj), []).append(i)
        recs = [HandoffRecord(t, a, b, len(v), sorted(v))
                for (a, b), v in sorted(moves.items())]
        self.handoffs.extend(recs)
        self.owner = dict(new_owner)
        return recs

    @property
    def conserved(self) -> bool:
        return (set(self.owner) | self.excluded == self.initial
                and not set(self.owner) & self.excluded)


@dataclass
class MultiSimConfig:
    """Shared knobs of a multi-job run (per-job η comes from each JobSpec)."""
    n_steps: int = 20                      # training steps per job
    rollouts_per_step: int = 32            # B, per job
    reward_cost_s: float = 0.1
    seed: int = 0
    failures: Sequence[JobFailure] = field(default_factory=list)
    stragglers: Sequence[JobStraggler] = field(default_factory=list)
    arrivals: Sequence[JobArrival] = field(default_factory=list)
    replanner: Optional[PoolReplanner] = None
    check_invariants: bool = False
    gen_time: Optional[GenTimeModel] = None  # see SimConfig.gen_time
    env: Optional[EnvCostModel] = None       # see SimConfig.env
    # --- control plane: online arrivals + departure
    admission: Optional[AdmissionConfig] = None   # defaulted when arrivals
    depart_on_completion: bool = False     # finished jobs leave the pool and
    #                                        their slices are reclaimed (vs
    #                                        frozen-in-place, the old default)
    trend: Optional[TrendConfig] = None    # EWMA predictive-replan detector
    # observability (see SimConfig.trace/metrics): default-off, zero-cost
    # no-op when None; sim-time timebase
    trace: Optional[Tracer] = None
    metrics: Optional[MetricsRegistry] = None
    # online health monitor (see SimConfig.monitor): default-off.  With
    # monitor_replan=True a sustained straggler / imbalance alert routes
    # into the pool replan path ahead of the throughput-EWMA trigger.
    monitor: Optional[HealthMonitor] = None
    monitor_replan: bool = False
    # crash-consistent recovery (see SimConfig.recovery): the manager
    # snapshots the whole pool — every job's run state, the device
    # ledger, the control-plane records, the incumbent PoolPlan — as one
    # atomic unit, and a ControllerCrash rolls the entire pool back
    # together (a multi-tenant controller has exactly one memory to lose)
    recovery: Optional[RecoveryManager] = None
    crashes: Sequence[ControllerCrash] = field(default_factory=list)


@dataclass
class MultiJobSimResult:
    per_job: Dict[str, SimResult]
    handoffs: List[HandoffRecord]          # cross-job device transfers
    pool_swaps: int                        # committed pool replans
    wall_time_s: float
    owner_final: Dict[int, str]
    excluded: Set[int]
    # control-plane outputs (empty when the run had no arrivals/departures)
    records: Dict[str, JobRecord] = field(default_factory=dict)
    replan_triggers: List[ReplanTrigger] = field(default_factory=list)
    # --- crash recovery provenance (one record per ControllerCrash)
    recoveries: List[RecoveryEvent] = field(default_factory=list)

    def weighted_throughput(self, weights: Dict[str, float]) -> float:
        return sum(weights.get(n, 1.0) * r.throughput_tps
                   for n, r in self.per_job.items())

    def admission_latencies(self) -> Dict[str, float]:
        return {n: r.admission_latency_s for n, r in self.records.items()
                if r.admission_latency_s is not None}

    def summary(self) -> str:
        rows = [f"{n}: {r.summary()}" for n, r in sorted(self.per_job.items())]
        rows.append(f"pool: swaps={self.pool_swaps} "
                    f"handoffs={len(self.handoffs)} "
                    f"excluded={len(self.excluded)}dev")
        return "\n".join(rows)


class _JobRun:
    """One job's plan state machine inside the shared event loop — the same
    semantics as ``AsyncRLSimulator`` (capacity control, η admission,
    drain/commit swaps) scoped to the job's slice and version stream."""

    def __init__(self, job: JobSpec, plan: ScheduledPlan,
                 cfg: MultiSimConfig, n_steps: Optional[int] = None,
                 t0: float = 0.0):
        self.job = job
        self.name = job.name
        self.plan = plan
        self.P = job.P
        self.eta = job.eta
        self.B = cfg.rollouts_per_step
        self.n_steps = n_steps if n_steps is not None else cfg.n_steps
        self.t0 = t0                           # admitted mid-run: plan-live t
        self.capacity = (self.eta + 1) * self.B
        self.rate: List[float] = _flatten_replicas(plan)
        self.n_rep = len(self.rate)
        self.alive = [True] * self.n_rep
        self.cum_factor = [1.0] * self.n_rep   # cumulative straggler slowdown
        self.epoch = plan.plan_epoch
        self.t_train = plan.cost_train / max(plan.delta, 1)
        self.t_sync = plan.cost_update / max(plan.delta, 1)
        self.version = 0
        self.buffer: List[tuple] = []          # (version, length)
        self.in_flight = 0
        self.generating = 0
        self.paused: List[int] = []
        self.idle: Set[int] = set()            # drained, awaiting commit
        self.pending_dead: Set[int] = set()
        self.steps = 0
        self.tokens = 0.0
        self.stale_hist: List[int] = []
        self.stalls_capacity = 0
        self.stalls_data = 0
        self.dropped = 0
        self.launched = 0
        self.consumed = 0
        self.gen_busy_sum = 0.0
        self.train_busy = 0.0
        self.rep_seconds = 0.0
        self.trainer_busy_until = 0.0
        self.done_t: Optional[float] = None    # when step n_steps completed
        self.swaps: List[PlanSwapRecord] = []
        self.swap_hist_idx: List[int] = []
        self.epoch_stats: List[PlanEpochStat] = []
        self.epoch_open = dict(epoch=self.epoch, provenance=plan.provenance,
                               t_start=t0, steps0=0, tokens0=0.0)
        # predictive replanning: per-step throughput trend (cfg.trend)
        self.trend = (EwmaThroughputTrend(cfg.trend)
                      if cfg.trend is not None else None)
        self.last_step_t = t0                  # previous train_done time
        self.last_step_tokens = 0.0
        # crash recovery (recovery): write-ahead consumption protocol
        self.consume_seq = 0                   # serial train-consumption counter
        self.pending_train: Optional[dict] = None  # consumed, step uncommitted
        self.cap_slack = 0                     # transient rollback overshoot

    # ------------------------------------------------------------ bookkeeping
    def check(self, now: float) -> None:
        assert self.in_flight == self.generating + len(self.buffer), \
            (self.name, now, self.in_flight, self.generating, len(self.buffer))
        assert self.launched == (self.consumed + self.dropped
                                 + self.in_flight), \
            (self.name, now, self.launched, self.consumed, self.dropped,
             self.in_flight)
        # cap_slack: bounded transient overshoot after a crash rollback of
        # an uncommitted consumption (see the single-job check note)
        assert 0 <= self.in_flight <= self.capacity + self.cap_slack, \
            (self.name, now, self.in_flight, self.capacity, self.cap_slack)
        if self.in_flight <= self.capacity:
            self.cap_slack = 0

    def close_epoch(self, now: float) -> None:
        self.epoch_stats.append(PlanEpochStat(
            epoch=self.epoch_open["epoch"],
            provenance=self.epoch_open["provenance"],
            t_start=self.epoch_open["t_start"], t_end=now,
            steps=self.steps - self.epoch_open["steps0"],
            tokens=self.tokens - self.epoch_open["tokens0"]))

    def commit(self, new_plan: ScheduledPlan, now: float, reason: str,
               t_request: float) -> None:
        """Hot-swap this job onto ``new_plan`` (its slice may have grown or
        shrunk via a cross-job handoff).  The version stream and buffer
        carry over untouched — that is what keeps η_j intact."""
        n_before = sum(self.alive)
        self.close_epoch(now)
        self.rep_seconds += self.n_rep * (now - self.epoch_open["t_start"])
        self.plan = new_plan
        self.epoch = new_plan.plan_epoch
        self.epoch_open.update(epoch=self.epoch,
                               provenance=new_plan.provenance,
                               t_start=now, steps0=self.steps,
                               tokens0=self.tokens)
        self.rate = _flatten_replicas(new_plan)
        self.n_rep = len(self.rate)
        self.alive = [True] * self.n_rep
        self.cum_factor = [1.0] * self.n_rep
        self.t_train = new_plan.cost_train / max(new_plan.delta, 1)
        self.t_sync = new_plan.cost_update / max(new_plan.delta, 1)
        if self.trend is not None:             # new plan = new baseline
            self.trend.reset()
            self.last_step_t = now
            self.last_step_tokens = self.tokens
        h = self.stale_hist
        self.swaps.append(PlanSwapRecord(
            epoch=self.epoch, t_request=t_request, t_commit=now,
            reason=reason, n_replicas_before=n_before,
            n_replicas_after=self.n_rep,
            mean_staleness_before=float(np.mean(h)) if h else 0.0,
            max_staleness_before=int(np.max(h)) if h else 0))
        self.swap_hist_idx.append(len(h))
        self.paused.clear()
        self.idle.clear()

    def result(self, wall: float) -> SimResult:
        job_wall = self.done_t if self.done_t is not None else wall
        # utilization is measured over the job's own lifetime, t0 → done (a
        # finished job's fleet idles until the pool's last event, and a
        # mid-run arrival was not running before its admission — neither
        # span is the job's to waste), matching the single-job simulator
        job_wall = max(job_wall - self.t0, 1e-9)
        self.rep_seconds += self.n_rep * max(
            job_wall + self.t0 - self.epoch_open["t_start"], 0.0)
        self.close_epoch(job_wall + self.t0)
        for rec, cut in zip(self.swaps, self.swap_hist_idx):
            h = self.stale_hist[cut:]
            rec.mean_staleness_after = float(np.mean(h)) if h else 0.0
            rec.max_staleness_after = int(np.max(h)) if h else 0
        h = self.stale_hist
        return SimResult(
            wall_time_s=job_wall,
            steps=self.steps,
            tokens_consumed=self.tokens,
            throughput_tps=self.tokens / job_wall,
            train_busy_frac=self.train_busy / job_wall,
            gen_busy_frac=(self.gen_busy_sum / self.rep_seconds
                           if self.rep_seconds > 0 else 0.0),
            mean_staleness=float(np.mean(h)) if h else 0.0,
            max_staleness=int(np.max(h)) if h else 0,
            stalls_capacity=self.stalls_capacity,
            stalls_data=self.stalls_data,
            infer_latency_s=(job_wall / max(self.steps, 1)
                             - self.t_train - self.t_sync),
            train_latency_s=self.t_train,
            sync_latency_s=self.t_sync,
            dropped=self.dropped,
            rollouts_launched=self.launched,
            rollouts_trained=self.consumed,
            rollouts_in_buffer=len(self.buffer),
            rollouts_generating=self.generating,
            swaps=self.swaps,
            plan_epochs=self.epoch_stats,
        )


class MultiJobSimulator:
    """N concurrent plan state machines over one shared device ledger.

    Executes a ``PoolPlan``: each job runs the AReaL async-RL semantics on
    its own slice, with its own rollout buffer, weight-version stream, and
    η_j staleness budget.  A permanent ``JobFailure`` in one job's slice
    triggers a *pool-level* replan (``PoolReplanner`` →
    ``core.pool.replan_pool``): the whole pool drains (a stop-the-world
    arbitration window — no job launches new rollouts while ownership is
    in flux), the new ``PoolPlan`` may hand surviving ICI domains between
    jobs, and every job whose slice changed commits its new plan through
    the same drain/commit path as a single-job swap.  In-flight rollouts
    finish into their job's buffer; version streams never cross jobs, so
    each η_j bound is preserved independently (asserted in
    tests/test_torch_sim.py).

    The machine honors every injection the single-job simulator does:
    permanent failures, *transient* failures (a ``JobFailure.downtime``
    recovers the replica; per-device outages survive plan swaps), and
    ``JobStraggler`` slowdowns (a sustained straggler — cumulative factor
    under ``ElasticConfig.straggler_threshold`` — triggers a pool replan).

    On top of that sits the multi-tenant control plane (core/jobs.py):

      * ``cfg.arrivals`` submits jobs mid-run through the admission
        controller — priced-infeasible jobs are REJECTED, queued jobs are
        handed to the next ``replan_pool`` as arrivals and seeded from
        donors' surplus via the same drain/commit swap;
      * ``cfg.depart_on_completion`` lets finished jobs leave: the next
        pool commit reclaims their slices for the survivors (instead of
        freezing the fleet in place, the historical default);
      * ``cfg.trend`` arms per-job EWMA throughput-trend detection, so a
        *creeping* degradation replans predictively instead of waiting
        for a failure event.
    """

    def __init__(self, pool: PoolPlan, cfg: MultiSimConfig = None):
        self.pool = pool
        self.cfg = cfg or MultiSimConfig()
        if self.cfg.replanner is None:
            need = [k for k, v in
                    (("arrivals", self.cfg.arrivals),
                     ("depart_on_completion",
                      self.cfg.depart_on_completion),
                     ("trend", self.cfg.trend),
                     ("monitor_replan", self.cfg.monitor_replan)) if v]
            if need:
                raise ValueError(
                    f"MultiSimConfig.{'/'.join(need)} require a replanner: "
                    f"admission, departure and predictive replanning all "
                    f"commit through pool replans")
        self.jobs: Dict[str, _JobRun] = {
            j.name: _JobRun(j, pool.plans[j.name], self.cfg)
            for j in pool.jobs}

    # ------------------------------------------------------------------ run
    def run(self) -> MultiJobSimResult:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        q = EventQueue()
        replanner = cfg.replanner
        elastic = replanner.elastic if replanner is not None else None
        ledger = DeviceLedger(self.pool.owner)
        cur_pool = self.pool
        jobs = self.jobs
        retired: Dict[str, SimResult] = {}     # departed jobs' final results

        tr = cfg.trace                         # None = zero-cost no-op
        mx = cfg.metrics
        mon = cfg.monitor

        control: Optional[ControlPlane] = None
        if (cfg.arrivals or cfg.admission is not None
                or cfg.depart_on_completion):
            control = ControlPlane(replanner.cluster, replanner.pool_cfg,
                                   cfg.admission, tracer=tr, metrics=mx,
                                   monitor=mon)
            control.register_initial(cur_pool.jobs)

        state = "RUNNING"                      # pool-level: RUNNING | DRAINING
        drain_scheduled = False
        drain_reason = ""
        drain_t0 = 0.0
        last_commit = -np.inf
        pool_swaps = 0
        pending_submits = 0                    # job_submit events still queued
        down_until: Dict[int, float] = {}      # device → transient-recovery t
        triggers: List[ReplanTrigger] = []
        t = 0.0

        # --- crash-consistent recovery (recovery)
        rmgr = cfg.recovery
        if cfg.crashes and rmgr is None:
            raise ValueError("ControllerCrash injection requires "
                             "MultiSimConfig.recovery (a RecoveryManager)")
        journaling = rmgr is not None and rmgr.cfg.journal
        recoveries: List[RecoveryEvent] = []
        controller_down = False
        resume_t = 0.0                         # valid while controller_down
        next_rid = 0                           # pool-global id, never reused
        consumed_rids: Set[int] = set()        # exactly-once guard (journal)

        def launch(jr: _JobRun, i: int, now: float) -> None:
            nonlocal next_rid
            if i >= jr.n_rep or not jr.alive[i] or jr.steps >= jr.n_steps:
                return
            if controller_down:                # nobody to hand out prompts
                return
            if state == "DRAINING":            # ownership in flux: hold fire
                jr.idle.add(i)
                return
            if jr.in_flight >= jr.capacity:
                jr.paused.append(i)
                jr.stalls_capacity += 1
                if mon is not None:
                    mon.on_stall(jr.name, now, "capacity")
                return
            jr.in_flight += 1
            jr.launched += 1
            jr.generating += 1
            rid = next_rid
            next_rid += 1
            length = float(np.clip(rng.lognormal(*_lognorm(jr.P)),
                                   16, jr.P.max_len))
            dur = _gen_duration(cfg.gen_time, length, jr.P, jr.rate[i])
            jr.gen_busy_sum += dur
            gap = _env_gap(cfg.env, rng)
            q.push(now + dur + gap + cfg.reward_cost_s,
                   "rollout_done",
                   (jr.name, jr.epoch, i, jr.version, length, rid))
            if journaling:
                rmgr.journal({"k": "launch", "job": jr.name, "rid": rid,
                              "dur": dur})
            if tr is not None:
                tr.span("replica", f"{jr.name}/r{i}", "generate", now, dur,
                        tokens=length, version=jr.version, job=jr.name)
                tr.span("stage", "generation", "generate", now, dur,
                        job=jr.name, replica=i)
                if gap > 0.0:
                    tr.span("stage", "env", "env_wait", now + dur, gap,
                            job=jr.name)
                if cfg.reward_cost_s > 0.0:
                    tr.span("stage", "reward", "reward", now + dur + gap,
                            cfg.reward_cost_s, job=jr.name)
            if mx is not None:
                mx.counter(f"sim/{jr.name}/rollouts_launched").inc()
            if mon is not None:
                mon.on_gen_span(jr.name, i, now, dur, length)
                mon.on_stage_span("generation", now, dur)

        def maybe_train(jr: _JobRun, now: float) -> None:
            if jr.steps >= jr.n_steps or now < jr.trainer_busy_until:
                return
            fresh = [r for r in jr.buffer if jr.version - r[0] <= jr.eta]
            n_evicted = len(jr.buffer) - len(fresh)
            if n_evicted:
                if journaling:
                    rmgr.journal({"k": "evict", "job": jr.name,
                                  "rids": [r[2] for r in jr.buffer
                                           if jr.version - r[0] > jr.eta]})
                jr.dropped += n_evicted
                jr.in_flight -= n_evicted
                jr.buffer[:] = fresh
            if len(jr.buffer) < jr.B:
                jr.stalls_data += 1
                if mon is not None:
                    mon.on_stall(jr.name, now, "data")
                return
            batch = jr.buffer[: jr.B]
            del jr.buffer[: jr.B]
            jr.in_flight -= jr.B
            jr.consumed += jr.B
            tok0 = jr.tokens
            for vtag, ln, _rid in batch:
                jr.stale_hist.append(jr.version - vtag)
                jr.tokens += ln + jr.P.prompt_len
            if journaling:
                # write-ahead record for this step: journaled at train_done
                # (the commit point), rolled back whole on a crash between.
                # Exactly-once: no rollout id is ever consumed twice.
                rids = [r[2] for r in batch]
                for rid_ in rids:
                    if rid_ in consumed_rids:
                        raise RecoveryError(f"rollout {rid_} consumed twice")
                    consumed_rids.add(rid_)
                jr.consume_seq += 1
                jr.pending_train = {
                    "k": "train", "job": jr.name, "seq": jr.consume_seq,
                    "rids": rids, "batch": list(batch), "n": jr.B,
                    "stalenesses": [jr.version - r[0] for r in batch],
                    "tokens": jr.tokens - tok0, "t_train": jr.t_train}
            dur = jr.t_train + jr.t_sync
            jr.train_busy += jr.t_train
            jr.trainer_busy_until = now + dur
            q.push(now + dur, "train_done", (jr.name,))
            if tr is not None:
                tr.span("stage", "train", "train_step", now, jr.t_train,
                        job=jr.name, step=jr.steps, tokens=jr.tokens - tok0,
                        version=jr.version)
                if jr.t_sync > 0.0:
                    tr.span("stage", "sync", "weight_sync",
                            now + jr.t_train, jr.t_sync, job=jr.name)
            if mx is not None:
                h = mx.histogram(f"sim/{jr.name}/staleness")
                for vtag, _ln, _rid in batch:
                    h.observe(jr.version - vtag)
                mx.counter(f"sim/{jr.name}/rollouts_trained").inc(jr.B)
            if mon is not None:
                for vtag, _ln, _rid in batch:
                    mon.on_staleness(jr.name, now, jr.version - vtag,
                                     jr.eta)
                mon.on_buffer(jr.name, now, len(jr.buffer), jr.capacity)
                mon.on_stage_span("train", now, jr.t_train)
                if jr.t_sync > 0.0:
                    mon.on_stage_span("sync", now + jr.t_train, jr.t_sync)
            # snapshot-drain: see the single-job maybe_train note
            resume = jr.paused[:]
            jr.paused.clear()
            for i in resume:
                launch(jr, i, now)
            if cfg.check_invariants:
                jr.check(now)

        def request_replan(now: float, reason: str) -> None:
            """Ask for a pool-level drain/commit swap (debounced, deferred —
            never dropped).  Failure, straggler, trend, arrival and
            departure triggers all funnel through here."""
            nonlocal drain_scheduled, drain_reason, drain_t0
            if controller_down:
                return          # accumulate; resume re-schedules the drain
            if replanner is None or state == "DRAINING" or drain_scheduled:
                return                         # accumulate into pending swap
            ready = max(now + elastic.replan_latency_s,
                        last_commit + elastic.min_interval_s)
            drain_scheduled = True
            drain_reason = reason
            drain_t0 = now
            q.push(ready - elastic.replan_latency_s, "pool_drain", None)

        def trigger_replan(now: float, jr: _JobRun, replica_idx: int,
                           kind: str = "failure") -> None:
            if replanner is None:
                return
            jr.pending_dead.add(replica_idx)
            triggers.append(ReplanTrigger(now, kind, replica_idx))
            request_replan(now, f"{kind}:{jr.name}")

        def replace_down(jr: _JobRun, now: float) -> None:
            """Re-placed work on a still-down device starts dead and
            recovers when the original outage ends (mirrors the
            single-job swap semantics)."""
            still = {d: until for d, until in down_until.items()
                     if until > now}
            if not still:
                return
            for i, devs in enumerate(replanner.replica_devices(jr.plan)):
                t_up = max((still.get(d.index, 0.0) for d in devs),
                           default=0.0)
                if t_up > now and i < jr.n_rep:
                    jr.alive[i] = False
                    q.push(t_up, "job_recover", (jr.name, jr.epoch, i))

        def commit_pool(now: float) -> None:
            nonlocal state, drain_scheduled, cur_pool, last_commit, pool_swaps
            for jr in jobs.values():
                dead = replanner.exclude_replicas(jr.plan,
                                                  sorted(jr.pending_dead))
                ledger.exclude(dead)
                for i in jr.pending_dead:
                    if i < jr.n_rep:
                        jr.alive[i] = False
                jr.pending_dead.clear()
            finished = sorted(n for n, jr in jobs.items()
                              if jr.steps >= jr.n_steps)
            # finished jobs either depart (slices reclaimed for the
            # survivors) or are frozen in place (keep slice and plan but
            # never receive devices a running job could still use)
            departing = finished if cfg.depart_on_completion else []
            frozen = tuple(n for n in finished if n not in departing)
            arrival_specs = ([r.spec for r in control.queued()]
                             if control is not None else [])
            new_pool = replanner.replan(cur_pool, drain_reason,
                                        frozen=frozen, departed=departing,
                                        arrivals=arrival_specs)
            state = "RUNNING"
            drain_scheduled = False
            last_commit = now
            if tr is not None:
                tr.span("pool", "plan", "drain",
                        now - elastic.replan_latency_s,
                        elastic.replan_latency_s, reason=drain_reason)
            if new_pool is None:
                # no feasible pool: every job keeps its plan minus the dead
                # (queued arrivals stay PENDING for the next trigger)
                if tr is not None:
                    tr.instant("pool", "plan", "commit_infeasible", now,
                               reason=drain_reason)
                for jr in jobs.values():
                    for i in sorted(jr.idle):
                        launch(jr, i, now)
                    jr.idle.clear()
                return
            pool_swaps += 1
            recs = ledger.apply(new_pool.owner, now)
            if tr is not None:
                tr.instant("pool", "plan", "commit", now,
                           reason=drain_reason, epoch=new_pool.pool_epoch,
                           handoffs=len(recs))
                for rec in recs:
                    tr.instant("pool", "plan", "handoff", now,
                               src=rec.from_job, dst=rec.to_job,
                               devices=rec.n_devices)
            if mx is not None:
                mx.counter("pool/swaps").inc()
                mx.counter("pool/handoffs").inc(len(recs))
            # departures: the plan dropped them — retire their runs and
            # reclaim the lifecycle state (slice ownership already moved)
            for name in departing:
                if name not in new_pool.plans:
                    jr = jobs.pop(name)
                    retired[name] = jr.result(now)
                    if control is not None:
                        control.complete(name, now)
            for jr in jobs.values():
                new_plan = new_pool.plans[jr.name]
                if new_plan is jr.plan:        # slice untouched: just resume
                    for i in sorted(jr.idle):
                        launch(jr, i, now)
                    jr.idle.clear()
                else:
                    jr.commit(new_plan, now, drain_reason, drain_t0)
                    if mon is not None:
                        # new slice = new rate distribution; evidence from
                        # the old fleet must not trip the detectors
                        mon.reset_job(jr.name)
                    replace_down(jr, now)
                    for i in range(jr.n_rep):
                        launch(jr, i, now)
            # placed arrivals go live on their fresh slices (seeded from
            # donors' surplus by the arbitration's repair transfers)
            if control is not None:
                for name in control.on_pool_commit(new_pool, now):
                    rec = control.records[name]
                    jr = _JobRun(rec.spec, new_pool.plans[name], cfg,
                                 n_steps=rec.n_steps, t0=now)
                    jobs[name] = jr
                    replace_down(jr, now)
                    for i in range(jr.n_rep):
                        launch(jr, i, now)
            cur_pool = new_pool
            if cfg.check_invariants:
                assert ledger.conserved

        # ----------------------------------------------- crash recovery
        def capture() -> dict:
            """Full pool-controller state as one atomic unit: every job's
            run state, the device ledger, the control plane, the incumbent
            PoolPlan (by reference — plans are immutable inputs)."""
            job_states = {}
            for name, jr in jobs.items():
                job_states[name] = {
                    "spec": jr.job, "n_steps": jr.n_steps, "t0": jr.t0,
                    "plan": jr.plan, "epoch": jr.epoch,
                    "rate": list(jr.rate), "alive": list(jr.alive),
                    "cum_factor": list(jr.cum_factor),
                    "t_train": jr.t_train, "t_sync": jr.t_sync,
                    "version": jr.version, "buffer": list(jr.buffer),
                    "in_flight": jr.in_flight, "generating": jr.generating,
                    "steps": jr.steps, "tokens": jr.tokens,
                    "stale_hist": list(jr.stale_hist),
                    "stalls_capacity": jr.stalls_capacity,
                    "stalls_data": jr.stalls_data,
                    "dropped": jr.dropped, "launched": jr.launched,
                    "consumed": jr.consumed,
                    "gen_busy_sum": jr.gen_busy_sum,
                    "train_busy": jr.train_busy,
                    "rep_seconds": jr.rep_seconds,
                    "pending_dead": set(jr.pending_dead),
                    "done_t": jr.done_t,
                    "swaps": [copy.copy(r) for r in jr.swaps],
                    "swap_hist_idx": list(jr.swap_hist_idx),
                    "epoch_stats": list(jr.epoch_stats),
                    "epoch_open": dict(jr.epoch_open),
                    "trend": (copy.copy(jr.trend)
                              if jr.trend is not None else None),
                    "last_step_t": jr.last_step_t,
                    "last_step_tokens": jr.last_step_tokens,
                    "consume_seq": jr.consume_seq,
                    "pending_train": (dict(jr.pending_train)
                                      if jr.pending_train is not None
                                      else None),
                    "cap_slack": jr.cap_slack,
                }
            from repro_torch.recovery.restore import capture_control_plane
            return {
                "jobs": job_states,
                "retired": dict(retired),
                "pool": cur_pool,
                "ledger": {"owner": dict(ledger.owner),
                           "excluded": set(ledger.excluded),
                           "handoffs": list(ledger.handoffs)},
                "control": (capture_control_plane(control)
                            if control is not None else None),
                "pending_submits": pending_submits,
                "down_until": dict(down_until),
                "last_commit": last_commit,
                "pool_swaps": pool_swaps,
                "triggers": list(triggers),
                "next_rid": next_rid,
                "consumed_rids": set(consumed_rids),
                "rng": rng.bit_generator.state,
                "excluded": (set(replanner.excluded)
                             if replanner is not None else None),
            }

        def _restore_job(js: dict) -> _JobRun:
            jr = _JobRun(js["spec"], js["plan"], cfg,
                         n_steps=js["n_steps"], t0=js["t0"])
            jr.epoch = js["epoch"]
            jr.rate = list(js["rate"])
            jr.n_rep = len(jr.rate)
            jr.alive = list(js["alive"])
            jr.cum_factor = list(js["cum_factor"])
            jr.t_train, jr.t_sync = js["t_train"], js["t_sync"]
            jr.version = js["version"]
            jr.buffer = list(js["buffer"])
            jr.in_flight = js["in_flight"]
            jr.generating = js["generating"]
            jr.steps = js["steps"]
            jr.tokens = js["tokens"]
            jr.stale_hist = list(js["stale_hist"])
            jr.stalls_capacity = js["stalls_capacity"]
            jr.stalls_data = js["stalls_data"]
            jr.dropped = js["dropped"]
            jr.launched = js["launched"]
            jr.consumed = js["consumed"]
            jr.gen_busy_sum = js["gen_busy_sum"]
            jr.train_busy = js["train_busy"]
            jr.rep_seconds = js["rep_seconds"]
            jr.pending_dead = set(js["pending_dead"])
            jr.done_t = js["done_t"]
            jr.swaps = [copy.copy(r) for r in js["swaps"]]
            jr.swap_hist_idx = list(js["swap_hist_idx"])
            jr.epoch_stats = list(js["epoch_stats"])
            jr.epoch_open = dict(js["epoch_open"])
            jr.trend = (copy.copy(js["trend"])
                        if js["trend"] is not None else None)
            jr.last_step_t = js["last_step_t"]
            jr.last_step_tokens = js["last_step_tokens"]
            jr.consume_seq = js["consume_seq"]
            jr.pending_train = None            # rolled back below if open
            jr.cap_slack = js["cap_slack"]
            return jr

        def do_crash(c: ControllerCrash, now: float) -> None:
            """Total pool-controller loss: wipe every in-memory event, roll
            every job back to the last snapshot together, replay the
            write-ahead journal to exactly-once, verify the invariants
            (η, conservation, ledger), and schedule the resume."""
            nonlocal state, drain_scheduled, drain_reason, drain_t0
            nonlocal cur_pool, last_commit, pool_swaps, pending_submits
            nonlocal down_until, triggers, next_rid, consumed_rids
            nonlocal controller_down, resume_t
            from repro_torch.recovery.restore import restore_control_plane
            snap_t, st, entries = rmgr.latest()

            def totals():
                s = (sum(jr.steps for jr in jobs.values())
                     + sum(r.steps for r in retired.values()))
                cns = (sum(jr.consumed for jr in jobs.values())
                       + sum(r.rollouts_trained for r in retired.values()))
                return s, cns

            # consumptions uncommitted at the crash instant roll back —
            # explicitly or via replay (see the single-job do_crash note);
            # record their sizes before the job objects are rebuilt
            live_pt_n = {name: (jr.pending_train["n"]
                                if jr.pending_train is not None else 0)
                         for name, jr in jobs.items()}
            steps_b, consumed_b = totals()
            # committed-progress baseline: uncommitted batches are work in
            # flight, not progress
            consumed_b -= sum(live_pt_n.values())
            # controller-internal timers and completions die with the
            # controller; external injections (hardware faults, recoveries,
            # submission requests, future crashes) keep happening
            q.retain(("fail", "job_straggle", "job_submit", "job_recover",
                      "crash"))
            # --- roll back to the snapshot (in place: self.jobs aliases)
            jobs.clear()
            for name, js in st["jobs"].items():
                jobs[name] = _restore_job(js)
            retired.clear()
            retired.update(st["retired"])
            cur_pool = st["pool"]
            ledger.owner = dict(st["ledger"]["owner"])
            ledger.excluded = set(st["ledger"]["excluded"])
            ledger.handoffs = list(st["ledger"]["handoffs"])
            if control is not None and st["control"] is not None:
                restore_control_plane(control, st["control"])
            pending_submits = st["pending_submits"]
            down_until = dict(st["down_until"])
            last_commit = st["last_commit"]
            pool_swaps = st["pool_swaps"]
            triggers = list(st["triggers"])
            next_rid = st["next_rid"]
            consumed_rids = set(st["consumed_rids"])
            rng.bit_generator.state = st["rng"]
            if replanner is not None and st["excluded"] is not None:
                replanner.excluded = set(st["excluded"])
            state = "RUNNING"
            drain_scheduled = False
            drain_reason = ""
            drain_t0 = 0.0
            # --- replay the journal (exactly-once: entries keyed by
            # never-reused pool-global rollout ids)
            completed = {e["rid"] for e in entries if e["k"] == "rollout"}
            seen_launch: Set[int] = set()
            seen_rollout: Set[int] = set()
            per_pt = {n: js["pending_train"]
                      for n, js in st["jobs"].items()}
            lost_post = 0
            for e in entries:
                k = e["k"]
                if k == "submit":
                    pending_submits -= 1
                    control.submit(e["spec"], e["t"], n_steps=e["n_steps"],
                                   cluster=replanner.surviving_cluster())
                    continue
                jr = jobs.get(e["job"])
                if k == "launch":
                    if e["rid"] in seen_launch:
                        raise RecoveryError(
                            f"journal: duplicate launch rid {e['rid']}")
                    seen_launch.add(e["rid"])
                    next_rid += 1      # every journaled launch used an id
                    if jr is None:     # job placed by a rolled-back commit
                        continue
                    if e["rid"] not in completed:
                        lost_post += 1     # in-flight at the crash: lost
                        continue
                    jr.launched += 1
                    jr.in_flight += 1
                    jr.generating += 1
                    jr.gen_busy_sum += e["dur"]
                elif k == "rollout":
                    if e["rid"] in seen_rollout:
                        raise RecoveryError(
                            f"journal: duplicate completion rid {e['rid']}")
                    seen_rollout.add(e["rid"])
                    if jr is None:
                        continue
                    jr.generating -= 1
                    if e["admitted"]:
                        jr.buffer.append((e["vtag"], e["length"], e["rid"]))
                    else:
                        jr.dropped += 1
                        jr.in_flight -= 1
                elif k == "evict":
                    if jr is None:
                        continue
                    rids = set(e["rids"])
                    keep = [r for r in jr.buffer if r[2] not in rids]
                    if len(jr.buffer) - len(keep) != len(rids):
                        raise RecoveryError("journal: evicted rollouts "
                                            "missing from buffer")
                    jr.buffer = keep
                    jr.dropped += len(rids)
                    jr.in_flight -= len(rids)
                elif k == "train":
                    if jr is None:
                        continue
                    pt = per_pt.get(e["job"])
                    if pt is not None and e["seq"] == pt["seq"]:
                        # consumption in flight at the snapshot: its pop +
                        # counters are captured — apply only the commit
                        per_pt[e["job"]] = None
                    else:
                        head = jr.buffer[:e["n"]]
                        if [r[2] for r in head] != list(e["rids"]):
                            raise RecoveryError(
                                "journal: train batch does not match "
                                "buffer head")
                        del jr.buffer[:e["n"]]
                        jr.in_flight -= e["n"]
                        jr.consumed += e["n"]
                        jr.tokens += e["tokens"]
                        jr.stale_hist.extend(e["stalenesses"])
                        jr.train_busy += e["t_train"]
                        for rid_ in e["rids"]:
                            if rid_ in consumed_rids:
                                raise RecoveryError(
                                    f"rollout {rid_} consumed twice "
                                    f"across the crash boundary")
                            consumed_rids.add(rid_)
                    jr.steps += 1
                    jr.version += 1
                    if jr.steps >= jr.n_steps and jr.done_t is None:
                        jr.done_t = e["t"]
                        if control is not None:
                            control.drain(jr.name, e["t"], "finished")
                elif k == "fail":
                    for d in e.get("devs", ()):
                        down_until[d] = max(down_until.get(d, 0.0),
                                            e["until"])
                    if jr is None or e["idx"] >= jr.n_rep:
                        continue
                    jr.alive[e["idx"]] = False
                    if (e["downtime"] is None and elastic is not None
                            and elastic.replan_on_failure):
                        jr.pending_dead.add(e["idx"])
                        triggers.append(
                            ReplanTrigger(e["t"], "failure", e["idx"]))
                elif k == "straggle":
                    if jr is None or e["idx"] >= len(jr.rate):
                        continue
                    jr.rate[e["idx"]] *= e["factor"]
                    jr.cum_factor[e["idx"]] *= e["factor"]
                    if (elastic is not None and jr.cum_factor[e["idx"]]
                            <= elastic.straggler_threshold):
                        jr.pending_dead.add(e["idx"])
                        triggers.append(
                            ReplanTrigger(e["t"], "straggler", e["idx"]))
            # a consumption whose step never committed rolls back whole
            lost_pre = 0
            for name, jr in jobs.items():
                pt = per_pt.get(name)
                rolled_back = 0
                if pt is not None:
                    n = pt["n"]
                    rolled_back = n
                    jr.buffer[:0] = pt["batch"]
                    jr.in_flight += n
                    jr.consumed -= n
                    jr.tokens -= pt["tokens"]
                    del jr.stale_hist[-n:]
                    jr.train_busy -= pt["t_train"]
                    for rid_ in pt["rids"]:
                        consumed_rids.discard(rid_)
                # pre-snapshot in-flight that never completed: lost work
                lost = jr.generating
                if lost:
                    jr.dropped += lost
                    jr.in_flight -= lost
                    jr.generating = 0
                    lost_pre += lost
                # --- prove the invariants across the crash boundary
                if jr.in_flight != jr.generating + len(jr.buffer):
                    raise RecoveryError(
                        f"restore {name!r}: in_flight {jr.in_flight} != "
                        f"generating {jr.generating} + "
                        f"buffered {len(jr.buffer)}")
                if jr.launched != jr.consumed + jr.dropped + jr.in_flight:
                    raise RecoveryError(
                        f"restore {name!r}: conservation broken: launched "
                        f"{jr.launched} != {jr.consumed}+{jr.dropped}+"
                        f"{jr.in_flight}")
                # bounded transient overshoot after a consumption rollback
                # (see the single-job do_crash note)
                allowed = (jr.capacity + jr.cap_slack
                           + max(rolled_back, live_pt_n.get(name, 0)))
                if not 0 <= jr.in_flight <= allowed:
                    raise RecoveryError(
                        f"restore {name!r}: in_flight {jr.in_flight} "
                        f"outside [0, {allowed}]")
                jr.cap_slack = max(0, jr.in_flight - jr.capacity)
                if jr.stale_hist and int(np.max(jr.stale_hist)) > jr.eta:
                    raise RecoveryError(
                        f"restore {name!r}: η bound violated: max "
                        f"staleness {int(np.max(jr.stale_hist))} > "
                        f"η={jr.eta}")
            if not ledger.conserved:
                raise RecoveryError(
                    "restore: device ledger not conserved")
            # --- schedule the comeback
            lat = (c.restore_latency_s if c.restore_latency_s is not None
                   else rmgr.cfg.restore_latency_s)
            controller_down = True
            resume_t = now + lat
            for jr in jobs.values():
                jr.trainer_busy_until = resume_t
            q.push(resume_t, "resume", None)
            steps_a, consumed_a = totals()
            recoveries.append(RecoveryEvent(
                t_crash=now, t_snapshot=snap_t, t_resume=resume_t,
                mttr_s=lat, steps_before=steps_b, steps_after=steps_a,
                consumed_before=consumed_b, consumed_after=consumed_a,
                lost_inflight=lost_pre + lost_post,
                lost_consumed=max(consumed_b - consumed_a, 0),
                journal_replayed=len(entries)))
            if tr is not None:
                tr.span("recovery", "controller", "restore", now, lat,
                        snapshot_t=snap_t, replayed=len(entries),
                        lost_inflight=lost_pre + lost_post)
            if mx is not None:
                mx.counter("pool/crashes").inc()

        def do_resume(now: float) -> None:
            nonlocal controller_down
            controller_down = False
            # fresh base: a second crash must replay from a clean journal
            rmgr.snapshot(now, capture())
            for jr in jobs.values():
                for i in range(jr.n_rep):
                    launch(jr, i, now)
            if replanner is not None and (
                    any(jr.pending_dead for jr in jobs.values())
                    or (control is not None and control.queued())
                    or (cfg.depart_on_completion
                        and any(jr.steps >= jr.n_steps
                                for jr in jobs.values()))):
                request_replan(now, "recovery")
            if control is not None and retry_s is not None and (
                    pending_submits or control.queued()):
                q.push(now + retry_s, "admission_tick", None)
            if mon is not None:
                mon.reset()
                q.push(now + mon.cfg.poll_interval_s, "monitor_poll", None)
            q.push(now + rmgr.cfg.interval_s, "snapshot", None)

        for f in cfg.failures:
            q.push(f.t_fail, "fail", f)
        for s in cfg.stragglers:
            jr = jobs.get(s.job)
            if s.t_start <= 0 and jr is not None and s.replica_idx < jr.n_rep:
                jr.rate[s.replica_idx] *= s.factor
                jr.cum_factor[s.replica_idx] *= s.factor
                if (elastic is not None and jr.cum_factor[s.replica_idx]
                        <= elastic.straggler_threshold):
                    trigger_replan(0.0, jr, s.replica_idx, "straggler")
            else:
                q.push(s.t_start, "job_straggle", s)
        for a in cfg.arrivals:
            pending_submits += 1
            q.push(a.t_submit, "job_submit", a)
        # periodic admission retry (ControlPlane.tick): re-price queued jobs
        # every retry_interval_s instead of waiting for the next
        # departure/failure-driven replan.  No tick events when the knob is
        # unset — existing event streams are untouched.
        retry_s = (cfg.admission.retry_interval_s
                   if cfg.admission is not None else None)
        if control is not None and retry_s is not None:
            q.push(retry_s, "admission_tick", None)
        for c in cfg.crashes:
            q.push(c.t_crash, "crash", c)
        if rmgr is not None:
            # t=0 baseline: a crash before the first cadence snapshot
            # restores here and replays the initial launches
            rmgr.snapshot(0.0, capture())
        for jr in jobs.values():
            for i in range(jr.n_rep):
                launch(jr, i, 0.0)
        if rmgr is not None:
            q.push(rmgr.cfg.interval_s, "snapshot", None)
        if mon is not None:
            q.push(mon.cfg.poll_interval_s, "monitor_poll", None)

        def all_done() -> bool:
            if pending_submits or (control is not None and control.queued()):
                return False
            return all(jr.steps >= jr.n_steps for jr in jobs.values())

        while len(q) and not all_done():
            ev = q.pop()
            t = ev.time
            if ev.kind == "rollout_done":
                name, ev_epoch, i, vtag, length, rid = ev.payload
                jr = jobs.get(name)             # None: job already departed
                if jr is not None:
                    jr.generating -= 1
                    admitted = jr.version - vtag <= jr.eta
                    if not admitted:
                        jr.dropped += 1
                        jr.in_flight -= 1
                    else:
                        jr.buffer.append((vtag, length, rid))
                    if journaling:
                        rmgr.journal({"k": "rollout", "job": name,
                                      "rid": rid, "vtag": vtag,
                                      "length": length,
                                      "admitted": admitted})
                    if ev_epoch == jr.epoch:   # old-epoch replicas stay down
                        launch(jr, i, t)
                    maybe_train(jr, t)
            elif ev.kind == "train_done":
                (name,) = ev.payload
                jr = jobs[name]
                jr.steps += 1
                jr.version += 1
                if journaling and jr.pending_train is not None:
                    # the commit point: this step survives a crash from
                    # here on (replayed from the journal)
                    jr.pending_train["t"] = t
                    rmgr.journal(jr.pending_train)
                    jr.pending_train = None
                if jr.steps >= jr.n_steps:
                    if jr.done_t is None:
                        jr.done_t = t
                        if control is not None:
                            control.drain(jr.name, t, "finished")
                        if cfg.depart_on_completion:
                            request_replan(t, f"departure:{jr.name}")
                elif jr.trend is not None:
                    # predictive replanning: per-step throughput sample
                    dt = t - jr.last_step_t
                    step_tokens = jr.tokens - jr.last_step_tokens
                    jr.last_step_t = t
                    jr.last_step_tokens = jr.tokens
                    if dt > 0 and jr.trend.observe(step_tokens / dt):
                        worst = min(range(jr.n_rep),
                                    key=lambda k: jr.cum_factor[k])
                        if jr.cum_factor[worst] < 1.0:
                            # evict the most-degraded replica so the replan
                            # actually removes the sick hardware
                            trigger_replan(t, jr, worst, "trend")
                        else:
                            request_replan(t, f"trend:{jr.name}")
                        jr.trend.reset()
                maybe_train(jr, t)
            elif ev.kind == "fail":
                f = ev.payload
                jr = jobs.get(f.job)
                if jr is not None and f.replica_idx < jr.n_rep:
                    jr.alive[f.replica_idx] = False
                    devs: List[int] = []
                    if f.downtime is not None:
                        # transient: recovers in place; remember the outage
                        # per device so a swap can't cancel the downtime
                        q.push(t + f.downtime, "job_recover",
                               (f.job, jr.epoch, f.replica_idx))
                        if replanner is not None:
                            rmap = replanner.replica_devices(jr.plan)
                            if f.replica_idx < len(rmap):
                                for d in rmap[f.replica_idx]:
                                    down_until[d.index] = max(
                                        down_until.get(d.index, 0.0),
                                        t + f.downtime)
                                    devs.append(d.index)
                    if journaling:
                        # hardware state is world state: it must survive
                        # a controller crash via replay
                        rmgr.journal({"k": "fail", "job": f.job,
                                      "idx": f.replica_idx,
                                      "downtime": f.downtime, "t": t,
                                      "devs": devs,
                                      "until": (t + f.downtime
                                                if f.downtime is not None
                                                else 0.0)})
                    if (f.downtime is None and elastic is not None
                            and elastic.replan_on_failure):
                        trigger_replan(t, jr, f.replica_idx)
            elif ev.kind == "job_recover":
                name, ev_epoch, i = ev.payload
                jr = jobs.get(name)
                if (jr is not None and ev_epoch == jr.epoch
                        and i < jr.n_rep):     # plan still live
                    jr.alive[i] = True
                    launch(jr, i, t)
            elif ev.kind == "job_straggle":
                s = ev.payload
                jr = jobs.get(s.job)
                if jr is not None and s.replica_idx < jr.n_rep:
                    jr.rate[s.replica_idx] *= s.factor
                    jr.cum_factor[s.replica_idx] *= s.factor
                    if journaling:
                        rmgr.journal({"k": "straggle", "job": s.job,
                                      "idx": s.replica_idx,
                                      "factor": s.factor, "t": t})
                    if (elastic is not None and jr.cum_factor[s.replica_idx]
                            <= elastic.straggler_threshold):
                        trigger_replan(t, jr, s.replica_idx, "straggler")
            elif ev.kind == "job_submit":
                a = ev.payload
                if controller_down:
                    # nobody to admit it: the request waits out the outage
                    q.push(resume_t, "job_submit", a)
                else:
                    pending_submits -= 1
                    dec = control.submit(a.spec, t, n_steps=a.n_steps,
                                         cluster=replanner.surviving_cluster())
                    if journaling:
                        # submissions are world state: the request already
                        # happened, its admission must survive the crash
                        rmgr.journal({"k": "submit", "spec": a.spec,
                                      "n_steps": a.n_steps, "t": t})
                    if dec.action == "queue":
                        request_replan(t, f"arrival:{a.spec.name}")
            elif ev.kind == "admission_tick":
                due = control.tick(t, cluster=replanner.surviving_cluster())
                if due:
                    request_replan(t, "admission_retry:" + ",".join(due))
                # keep ticking while there is (or will be) a queue AND some
                # job is still running to share with — otherwise the tick
                # chain ends and the event queue can drain
                if (pending_submits
                        or (control.queued()
                            and any(jr.steps < jr.n_steps
                                    for jr in jobs.values()))):
                    q.push(t + retry_s, "admission_tick", None)
            elif ev.kind == "pool_drain":
                state = "DRAINING"
                q.push(t + elastic.replan_latency_s, "pool_ready", None)
            elif ev.kind == "pool_ready":
                commit_pool(t)
            elif ev.kind == "snapshot":
                rmgr.snapshot(t, capture())
                if rmgr.cfg.snapshot_cost_s > 0.0:
                    # modeled stop-the-world capture: every trainer
                    # pauses, and the pause gets its own wake-up (see
                    # the single-job snapshot branch)
                    for jr in jobs.values():
                        jr.trainer_busy_until = max(
                            jr.trainer_busy_until,
                            t + rmgr.cfg.snapshot_cost_s)
                    q.push(t + rmgr.cfg.snapshot_cost_s,
                           "trainer_wake", None)
                # re-arm only while the pool can still make progress (same
                # liveness condition as the monitor poll chain)
                if (drain_scheduled or state == "DRAINING"
                        or any(jr.steps < jr.n_steps
                               and (jr.generating > 0
                                    or len(jr.buffer) >= jr.B)
                               for jr in jobs.values())):
                    q.push(t + rmgr.cfg.interval_s, "snapshot", None)
                if rmgr.cfg.snapshot_cost_s <= 0.0:
                    # pure observation: skip the trailing trainer probe so
                    # a free snapshot cannot perturb stall accounting
                    # (bit-identity with no manager attached)
                    continue
            elif ev.kind == "trainer_wake":
                pass                     # falls to the trailing probe
            elif ev.kind == "crash":
                do_crash(ev.payload, t)
            elif ev.kind == "resume":
                do_resume(t)
            elif ev.kind == "monitor_poll":
                if rmgr is not None:
                    rmgr.observe_age(t)
                for a in mon.poll(t):
                    if not cfg.monitor_replan or replanner is None:
                        continue
                    if a.detector == "straggler":
                        jr = jobs.get(a.evidence.get("job"))
                        if jr is not None and jr.steps < jr.n_steps:
                            trigger_replan(t, jr, a.evidence["replica"],
                                           "monitor_straggler")
                    elif a.detector == "buffer":
                        name = a.evidence.get("job")
                        jr = jobs.get(name)
                        if jr is not None and jr.steps < jr.n_steps:
                            request_replan(
                                t, f"monitor_{a.evidence['mode']}:{name}")
                # re-arm only while some job can still make progress —
                # otherwise the poll chain would keep a dead pool
                # spinning forever
                if (drain_scheduled or state == "DRAINING"
                        or any(jr.steps < jr.n_steps
                               and (jr.generating > 0
                                    or len(jr.buffer) >= jr.B)
                               for jr in jobs.values())):
                    q.push(t + mon.cfg.poll_interval_s,
                           "monitor_poll", None)
            for jr in jobs.values():
                if t >= jr.trainer_busy_until:
                    maybe_train(jr, t)
                if cfg.check_invariants:
                    jr.check(t)

        wall = t if t > 0 else 1e-9
        per_job = {n: jr.result(wall) for n, jr in jobs.items()}
        per_job.update(retired)
        if tr is not None:
            total_tokens = sum(r.tokens_consumed for r in per_job.values())
            tr.meta["ledger"] = {
                "wall_time_s": wall,
                "tokens_consumed": total_tokens,
                "throughput_tps": total_tokens / wall,
                "pool_swaps": pool_swaps,
                "handoffs": len(ledger.handoffs),
                "jobs": {n: {"steps": r.steps,
                             "tokens_consumed": r.tokens_consumed,
                             "throughput_tps": r.throughput_tps,
                             "dropped": r.dropped}
                         for n, r in sorted(per_job.items())},
            }
        if mx is not None:
            mx.gauge("pool/wall_time_s").set(wall)
        return MultiJobSimResult(
            per_job=per_job,
            handoffs=ledger.handoffs,
            pool_swaps=pool_swaps,
            wall_time_s=wall,
            owner_final=dict(ledger.owner),
            excluded=set(ledger.excluded),
            records=dict(control.records) if control is not None else {},
            replan_triggers=triggers,
            recoveries=recoveries,
        )
