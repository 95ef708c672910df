"""Multi-job arbitration: one heterogeneous pool shared by N RL jobs, the
port's copy of ``repro.core.pool``.

Eq. (1) prices a *single* job: its slice is bipartitioned into (D_T, D_I)
and the plan's rate is  tput_j = δ_j · tokens_per_step_j / max{C_T, C_I}_j.
A production pool multiplexes several jobs with different model scales,
staleness budgets η_j, and priorities w_j over the same hardware, so the
top-level objective generalizes Eq. (1) to a weighted water-filling over
per-job throughputs:

    max_{S_1 ⊎ … ⊎ S_N = D}   Σ_j  w_j · log tput_j(S_j)            (1')

where each tput_j(S_j) is itself the optimum of Eq. (1) on slice S_j.
The log utility is the classic water-filling/proportional-fair choice: the
marginal value of giving job j one more domain is w_j / tput_j, so compute
flows to whichever job currently has the lowest weighted throughput level
until levels equalize — a starved job can never be traded away entirely
for aggregate tokens.

The arbitration loop works at ICI-domain granularity (whole machines, the
same unit the γ repartition moves):

  1. seed slices proportionally to each job's weighted FLOP demand;
  2. run the two-phase scheduler (Search + Repartition) on every slice;
  3. hill-climb: try moving one domain from a rich job to a poor one,
     re-running both jobs' Search/Repartition phases on their new slices;
     accept the first transfer that raises Σ w_j log tput_j, repeat until a
     full sweep admits no improving single-domain transfer.

``replan_pool`` is the elastic analogue: after a failure shrinks the pool,
each damaged job is re-planned via the warm-started δ-pinned
``reschedule`` and the same transfer loop may hand *surviving* domains
between jobs — the cross-job preemption path the runtime drains/commits
through (sim/simulator.py MultiJobSimulator).  δ(η_j) stays pinned per
job, so every job's η staleness contract is preserved independently.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

from .cluster import Cluster, Device
from .cost_model import CostProvider, LengthDistribution
from .graph_partition import ici_domains, subcluster
from .model_spec import ModelSpec
from .plan import ScheduledPlan


@dataclass
class JobSpec:
    """One RL job competing for the pool."""

    name: str
    model: ModelSpec
    P: LengthDistribution = field(default_factory=LengthDistribution)
    sched_cfg: "SchedulerConfig" = None        # type: ignore[assignment]
    weight: float = 1.0                        # w_j: priority in Eq. (1')
    tier: int = 0                              # priority tier (0 = highest);
    #                                            breaks drop/preempt order in
    #                                            admission (core/jobs.py)
    min_tput: float = 0.0                      # throughput floor, tokens/s
    #                                            (0 = best-effort): the priced
    #                                            admission feasibility bar

    def __post_init__(self):
        if self.sched_cfg is None:
            from .scheduler import SchedulerConfig
            self.sched_cfg = SchedulerConfig()

    @property
    def eta(self) -> int:
        return self.sched_cfg.staleness.eta

    @property
    def tokens_per_step(self) -> float:
        return self.sched_cfg.tokens_per_step

    def flop_demand(self) -> float:
        """Weighted training FLOPs per step — the seeding heuristic."""
        return self.weight * self.model.train_flops_per_token() \
            * self.tokens_per_step


@dataclass
class PoolConfig:
    """Arbitration-loop knobs."""

    max_rounds: int = 8                # climb budget: sweeps *per domain*
    min_domains_per_job: int = 2       # a slice needs ≥2 machines (D_T | D_I)
    rel_tol: float = 1e-3              # min relative Σ w log tput gain


@dataclass(frozen=True)
class JobInfeasibility:
    """Typed per-job placement failure — the admission controller's input.

    ``reason`` is machine-readable:
      * ``"starved"``     — arbitration could not repair a feasible slice
        for the job (every donor is at its minimum);
      * ``"min_domains"`` — the pool has fewer ICI domains than
        ``min_domains_per_job`` × jobs, so this job was shed;
      * ``"infeasible"``  — the per-slice scheduler found no plan even on
        the full pool (Algorithm 1's own diagnostic in ``detail``).
    """

    job: str
    reason: str
    detail: str = ""


class PoolInfeasibleError(RuntimeError):
    """The pool cannot place one or more jobs.

    This is the *typed* boundary the control plane consumes: per-job
    ``JobInfeasibility`` records instead of a raw
    ``InfeasibleScheduleError`` escaping mid-arbitration (which used to
    crash the whole pool when every seed left a job starved).  Callers
    that can degrade — the admission controller, ``replan_pool`` via
    ``allow_partial`` — turn this into a queueing/rejection decision.
    """

    def __init__(self, infeasible: Dict[str, JobInfeasibility]):
        self.infeasible = dict(infeasible)
        msg = "; ".join(f"{k}: {v.reason}" + (f" ({v.detail})" if v.detail
                                              else "")
                        for k, v in sorted(infeasible.items()))
        super().__init__(f"no feasible slice for job(s): {msg}")


def _drop_order(jobs: Sequence[JobSpec]) -> List[int]:
    """Indices least-important-first: highest tier number sheds first, then
    lowest weight, then latest arrival (list order) — the deterministic
    shed/preempt priority shared with the admission controller."""
    return sorted(range(len(jobs)),
                  key=lambda k: (-jobs[k].tier, jobs[k].weight, -k))


@dataclass
class PoolPlan:
    """The pool-level answer: per-job plans + the device-ownership table."""

    jobs: Tuple[JobSpec, ...]
    plans: Dict[str, ScheduledPlan]
    owner: Dict[int, str]              # device index → job name
    objective: float                   # Σ_j w_j · log tput_j  (Eq. 1')
    transfers: int = 0                 # accepted cross-job domain moves
    wall_time_s: float = 0.0
    pool_epoch: int = 0                # bumped by every replan_pool
    provenance: str = "initial"
    # jobs the pool could NOT place (allow_partial mode): they own no
    # devices and have no plan; the admission controller queues/rejects
    # them instead of the arbitration crashing.
    infeasible: Dict[str, JobInfeasibility] = field(default_factory=dict)

    # ------------------------------------------------------------- queries
    def job_devices(self, name: str) -> List[int]:
        return sorted(i for i, j in self.owner.items() if j == name)

    def throughput(self, name: str) -> float:
        job = next(j for j in self.jobs if j.name == name)
        return self.plans[name].throughput_tokens_per_sec(job.tokens_per_step)

    def weighted_throughput(self) -> float:
        """Σ_j w_j · tput_j — the benchmark's headline scalar."""
        return sum(j.weight * self.throughput(j.name) for j in self.jobs)

    def signature(self) -> Tuple:
        """Decision fingerprint: ownership + every job's plan signature."""
        return (tuple(sorted(self.owner.items())),
                tuple((n, self.plans[n].signature())
                      for n in sorted(self.plans)))

    def assert_partition(self, cluster: Cluster) -> None:
        """Device conservation: ownership exactly partitions the cluster and
        every plan stays inside its slice."""
        live = {d.index for d in cluster.devices}
        owned = set(self.owner)
        assert owned == live, (sorted(owned ^ live))
        names = {j.name for j in self.jobs}
        assert set(self.owner.values()) <= names
        for name, plan in self.plans.items():
            used = set(plan.train_devices) | set(plan.infer_devices)
            slice_ = {i for i, j in self.owner.items() if j == name}
            assert used <= slice_, (name, sorted(used - slice_))

    def describe(self) -> str:
        lines = [f"[pool epoch {self.pool_epoch}: {self.provenance}]  "
                 f"Σw·tput={self.weighted_throughput():.0f} tok/s  "
                 f"transfers={self.transfers}"]
        for j in self.jobs:
            lines.append(
                f"-- {j.name} (w={j.weight:g}, η={j.eta}, "
                f"{len(self.job_devices(j.name))} dev, "
                f"tput={self.throughput(j.name):.0f} tok/s)\n"
                f"{self.plans[j.name].describe()}")
        return "\n".join(lines)


# ---------------------------------------------------------------- internals
def _pool_objective(jobs: Sequence[JobSpec],
                    plans: Dict[str, ScheduledPlan]) -> float:
    obj = 0.0
    for j in jobs:
        tput = plans[j.name].throughput_tokens_per_sec(j.tokens_per_step)
        if tput <= 0:
            return -math.inf
        obj += j.weight * math.log(tput)
    return obj


class _SliceScheduler:
    """Memoizing per-slice scheduler: the hill climb revisits allocations,
    and Algorithm 1 is deterministic in its slice, so (job, device-set)
    keys the plan exactly."""

    def __init__(self, cluster: Cluster,
                 solver: Callable[[JobSpec, Cluster], Optional[ScheduledPlan]]):
        self.cluster = cluster
        self.solver = solver
        self.cache: Dict[Tuple[str, FrozenSet[int]],
                         Optional[ScheduledPlan]] = {}

    def plan(self, job: JobSpec,
             devices: Sequence[Device]) -> Optional[ScheduledPlan]:
        from .scheduler import InfeasibleScheduleError
        key = (job.name, frozenset(d.index for d in devices))
        if key not in self.cache:
            if not devices:
                # an arriving job starts with an empty slice: trivially
                # infeasible, the repair loop seeds it from donors
                self.cache[key] = None
                return None
            try:
                self.cache[key] = self.solver(
                    job, subcluster(self.cluster, devices))
            except InfeasibleScheduleError:
                # the one expected failure; anything else is a bug and
                # must propagate, not steer the arbitration
                self.cache[key] = None
        return self.cache[key]


def _even_allocation(jobs: Sequence[JobSpec],
                     domains: Sequence[List[Device]]) -> List[int]:
    """Type-blind static split: for each device type, deal nodes round-robin
    across jobs in job order — the 'static even split' baseline, and one of
    the arbitration seeds (hill climbing from several seeds avoids the
    local optima a single demand-proportional seed can strand us in)."""
    by_type: Dict[str, List[int]] = {}
    for i, dom in enumerate(domains):
        by_type.setdefault(dom[0].type_name, []).append(i)
    alloc = [-1] * len(domains)
    for t in sorted(by_type):
        for pos, i in enumerate(by_type[t]):
            alloc[i] = pos % len(jobs)
    return alloc


def _seed_allocation(jobs: Sequence[JobSpec],
                     domains: Sequence[List[Device]],
                     min_domains: int) -> List[int]:
    """Deterministic initial split: hand domains (largest-FLOPs first) to the
    job whose weighted demand is least satisfied; then repair any job below
    ``min_domains`` from the most-oversupplied donor."""
    order = sorted(range(len(domains)),
                   key=lambda i: (-sum(d.profile.flops for d in domains[i]), i))
    demand = [max(j.flop_demand(), 1e-9) for j in jobs]
    got = [0.0] * len(jobs)
    alloc = [-1] * len(domains)
    for i in order:
        k = min(range(len(jobs)), key=lambda k: (got[k] / demand[k], k))
        alloc[i] = k
        got[k] += sum(d.profile.flops for d in domains[i])

    def count(k: int) -> int:
        return sum(1 for a in alloc if a == k)

    for k in range(len(jobs)):
        while count(k) < min_domains:
            donors = [j for j in range(len(jobs))
                      if j != k and count(j) > min_domains]
            if not donors:
                raise RuntimeError(
                    f"pool of {len(domains)} ICI domains cannot give "
                    f"{len(jobs)} jobs {min_domains} domains each")
            dk = max(donors, key=lambda j: (got[j] / demand[j], j))
            cands = [i for i in range(len(domains)) if alloc[i] == dk]
            i = min(cands, key=lambda i: (sum(d.profile.flops
                                              for d in domains[i]), i))
            alloc[i] = k
            got[dk] -= sum(d.profile.flops for d in domains[i])
            got[k] += sum(d.profile.flops for d in domains[i])
    return alloc


def _score(jobs: Sequence[JobSpec],
           plans: Dict[str, Optional[ScheduledPlan]]) -> Tuple[int, float]:
    """Lexicographic allocation score: (feasible jobs, Σ w log tput over
    the feasible ones).  Making one more job feasible always dominates —
    this is what lets the transfer loop *repair* a slice that a failure
    (or a bad seed) left unable to host its model, instead of aborting."""
    n_feas = sum(1 for p in plans.values() if p is not None)
    obj = sum(j.weight * math.log(max(
        plans[j.name].throughput_tokens_per_sec(j.tokens_per_step), 1e-9))
        for j in jobs if plans[j.name] is not None)
    return n_feas, obj


def _arbitrate(jobs: Sequence[JobSpec],
               domains: Sequence[List[Device]],
               alloc: List[int],
               sched: _SliceScheduler,
               cfg: PoolConfig) -> Tuple[List[int],
                                         Dict[str, Optional[ScheduledPlan]],
                                         int]:
    """The water-filling hill climb: single-domain transfers (richest job
    donates to the poorest first), then — when transfers stall — pairwise
    cross-type domain *exchanges* (the KL-style move that rebalances which
    job holds the scarce fast machines without changing slice sizes).
    First improvement in canonical order, until a sweep admits no move.

    Infeasible slices score as (fewer feasible jobs, …) and sort poorest,
    so repair transfers flow to them first.  If a job is still infeasible
    when the climb converges and no donor has slack, the job's entry in
    the returned ``plans`` stays ``None`` — the *caller* decides whether
    that means shed-and-retry (partial placement), queue (admission), or
    raise (strict mode).  Raising from here used to let infeasibility
    escape as an untyped crash.
    """

    def slice_devs(k: int, a: List[int]) -> List[Device]:
        return [d for i, dom in enumerate(domains) if a[i] == k for d in dom]

    plans: Dict[str, Optional[ScheduledPlan]] = {
        j.name: sched.plan(j, slice_devs(k, alloc))
        for k, j in enumerate(jobs)}
    best = _score(jobs, plans)
    transfers = 0
    force_budget = len(domains)

    while True:
        transfers, alloc, plans, best = _climb_rounds(
            jobs, domains, alloc, plans, best, transfers, sched, cfg,
            slice_devs)
        starved = sorted(n for n, p in plans.items() if p is None)
        if not starved:
            return alloc, plans, transfers
        # a starved slice may need *several* domains before it becomes
        # feasible at all (a slice needs ≥2 machines to bipartition), so
        # score-gated moves alone can plateau: force-feed the starved job
        # one domain from the richest donor with slack and re-climb
        k = next(i for i, j in enumerate(jobs) if j.name == starved[0])
        donors = [dk for dk in range(len(jobs))
                  if dk != k and plans[jobs[dk].name] is not None
                  and sum(1 for a in alloc if a == dk)
                  > cfg.min_domains_per_job]
        if not donors or force_budget <= 0:
            return alloc, plans, transfers     # starved jobs stay None
        force_budget -= 1
        dk = max(donors, key=lambda d: (
            plans[jobs[d].name].throughput_tokens_per_sec(
                jobs[d].tokens_per_step) / jobs[d].weight, -d))
        i = min((i for i in range(len(domains)) if alloc[i] == dk),
                key=lambda i: (sum(d.profile.flops for d in domains[i]), i))
        alloc = list(alloc)
        alloc[i] = k
        plans = dict(plans)
        plans[jobs[dk].name] = sched.plan(jobs[dk], slice_devs(dk, alloc))
        plans[jobs[k].name] = sched.plan(jobs[k], slice_devs(k, alloc))
        best = _score(jobs, plans)
        transfers += 1


def _climb_rounds(jobs, domains, alloc, plans, best, transfers, sched, cfg,
                  slice_devs):
    """Score-gated hill-climb sweeps (transfers, then exchanges) until a
    sweep admits no move.  Each accepted move restarts the sweep (the
    water-filling donor/recipient ordering depends on the new levels), so
    the bound scales with the pool — ``max_rounds`` per domain — rather
    than silently capping the climb at ``max_rounds`` moves."""
    for _ in range(cfg.max_rounds * max(1, len(domains))):
        # richest job (highest weighted level) donates first; the poorest —
        # infeasible slices poorest of all — receives first.
        levels = [plans[j.name].throughput_tokens_per_sec(j.tokens_per_step)
                  / j.weight if plans[j.name] is not None else -math.inf
                  for j in jobs]
        donors = sorted(range(len(jobs)), key=lambda k: (-levels[k], k))
        recips = sorted(range(len(jobs)), key=lambda k: (levels[k], k))
        moved = False

        def try_move(trial: List[int], dk: int, rk: int) -> bool:
            nonlocal alloc, plans, best, transfers, moved
            cand = dict(plans)
            cand[jobs[dk].name] = sched.plan(jobs[dk], slice_devs(dk, trial))
            cand[jobs[rk].name] = sched.plan(jobs[rk], slice_devs(rk, trial))
            n_feas, obj = _score(jobs, cand)
            better = (n_feas > best[0]
                      or (n_feas == best[0]
                          and obj > best[1] + cfg.rel_tol * abs(best[1])))
            if better:
                alloc, plans, best = trial, cand, (n_feas, obj)
                transfers += 1
                moved = True
                return True
            return False

        for dk in donors:
            # a feasible donor keeps its minimum slice; an infeasible one
            # may donate everything (its slice is dead weight anyway)
            if (plans[jobs[dk].name] is not None
                    and sum(1 for a in alloc if a == dk)
                    <= cfg.min_domains_per_job):
                continue
            for rk in recips:
                if rk == dk:
                    continue
                for i in range(len(domains)):
                    if alloc[i] != dk:
                        continue
                    trial = list(alloc)
                    trial[i] = rk
                    if try_move(trial, dk, rk):
                        break
                if moved:
                    break
            if moved:
                break

        if not moved:
            # transfers stalled: try cross-type exchanges (sizes preserved)
            for dk in donors:
                for rk in recips:
                    if rk == dk:
                        continue
                    for i in range(len(domains)):
                        if alloc[i] != dk:
                            continue
                        for j in range(len(domains)):
                            if alloc[j] != rk or (domains[i][0].type_name
                                                  == domains[j][0].type_name):
                                continue
                            trial = list(alloc)
                            trial[i], trial[j] = rk, dk
                            if try_move(trial, dk, rk):
                                break
                        if moved:
                            break
                    if moved:
                        break
                if moved:
                    break
        if not moved:
            break
    return transfers, alloc, plans, best


def _finish(jobs: Sequence[JobSpec], domains: Sequence[List[Device]],
            alloc: List[int], plans: Dict[str, ScheduledPlan],
            transfers: int, t0: float,
            infeasible: Optional[Dict[str, JobInfeasibility]] = None
            ) -> PoolPlan:
    owner: Dict[int, str] = {}
    for i, dom in enumerate(domains):
        for d in dom:
            owner[d.index] = jobs[alloc[i]].name
    return PoolPlan(jobs=tuple(jobs), plans=plans, owner=owner,
                    objective=_pool_objective(jobs, plans),
                    transfers=transfers,
                    wall_time_s=time.perf_counter() - t0,
                    infeasible=dict(infeasible or {}))


def _shed_victim(jobs: Sequence[JobSpec],
                 candidates: Sequence[str]) -> JobSpec:
    """The least-important job among ``candidates`` (shed first)."""
    cand = set(candidates)
    for k in _drop_order(jobs):
        if jobs[k].name in cand:
            return jobs[k]
    raise AssertionError(candidates)


def _place_jobs(jobs: Sequence[JobSpec],
                domains: Sequence[List[Device]],
                sched: _SliceScheduler,
                cfg: PoolConfig) -> Tuple[List[JobSpec], List[int],
                                          Dict[str, ScheduledPlan], int,
                                          Dict[str, JobInfeasibility]]:
    """Seed + arbitrate, shedding unplaceable jobs one at a time.

    Returns (placed jobs, alloc, plans, transfers, infeasible).  Shedding
    order is ``_drop_order`` restricted to the currently-starved jobs, so
    a high-priority job is never shed to save a low-priority one.  The
    loop terminates: every retry removes one job.
    """
    from .scheduler import InfeasibleScheduleError
    infeasible: Dict[str, JobInfeasibility] = {}
    active = list(jobs)
    while active:
        if len(active) == 1:
            # degenerate pool: the job owns everything, no arbitration
            # possible; call the solver directly so infeasibility keeps
            # the scheduler's own diagnostic
            job = active[0]
            try:
                plan = sched.solver(job, subcluster(sched.cluster,
                                                    sched.cluster.devices))
            except InfeasibleScheduleError as e:
                infeasible[job.name] = JobInfeasibility(
                    job.name, "infeasible", str(e))
                return [], [], {}, 0, infeasible
            return ([job], [0] * len(domains), {job.name: plan}, 0,
                    infeasible)

        if len(domains) < cfg.min_domains_per_job * len(active):
            victim = _shed_victim(active, [j.name for j in active])
            infeasible[victim.name] = JobInfeasibility(
                victim.name, "min_domains",
                f"{len(domains)} ICI domains cannot give {len(active)} "
                f"jobs {cfg.min_domains_per_job} each")
            active = [j for j in active if j.name != victim.name]
            continue

        # pick the best-scoring candidate seed (a partially-infeasible
        # seed is allowed — the climb's repair transfers can fix it)
        seeds = [_even_allocation(active, domains)]
        try:
            seeds.insert(0, _seed_allocation(active, domains,
                                             cfg.min_domains_per_job))
        except RuntimeError:
            pass                       # demand seed unrepairable: even only
        best_seed, best_score = None, (-1, -math.inf)
        for seed in seeds:
            counts = [sum(1 for a in seed if a == k)
                      for k in range(len(active))]
            if min(counts) < cfg.min_domains_per_job:
                continue
            plans = {j.name: sched.plan(j, [d for i, dom
                                            in enumerate(domains)
                                            if seed[i] == k for d in dom])
                     for k, j in enumerate(active)}
            score = _score(active, plans)
            if score > best_score:
                best_seed, best_score = seed, score
        if best_seed is None:
            # no seed gives every job its minimum: shed the least
            # important and retry (the domain count above admits it, but
            # per-type round-robin may not — e.g. lopsided type mixes)
            victim = _shed_victim(active, [j.name for j in active])
            infeasible[victim.name] = JobInfeasibility(
                victim.name, "min_domains",
                "no seed allocation satisfies min_domains_per_job")
            active = [j for j in active if j.name != victim.name]
            continue

        alloc, plans, transfers = _arbitrate(active, domains, best_seed,
                                             sched, cfg)
        starved = sorted(n for n, p in plans.items() if p is None)
        if not starved:
            return active, alloc, plans, transfers, infeasible
        victim = _shed_victim(active, starved)
        infeasible[victim.name] = JobInfeasibility(
            victim.name, "starved",
            "arbitration could not repair a feasible slice")
        active = [j for j in active if j.name != victim.name]
    return [], [], {}, 0, infeasible


# ------------------------------------------------------------- entry points
def schedule_pool(jobs: Sequence[JobSpec], cluster: Cluster,
                  cfg: Optional[PoolConfig] = None, *,
                  cost_provider: Optional[CostProvider] = None,
                  allow_partial: bool = False,
                  trace=None, metrics=None) -> PoolPlan:
    """Offline pool arbitration: Eq. (1') over a fresh cluster.

    ``cost_provider`` (when given) overrides the efficiency-factor source in
    every job's SchedulerConfig — the provider then travels with the jobs
    into ``replan_pool`` via ``PoolPlan.jobs``.  Default (None) keeps each
    job's own configuration, i.e. the analytic constant tables.

    ``allow_partial=False`` (strict, the historical contract): raises
    ``PoolInfeasibleError`` when any job cannot be placed — a *typed*
    error carrying per-job ``JobInfeasibility``; no code path lets the
    scheduler's ``InfeasibleScheduleError`` escape.  ``allow_partial=True``
    (the admission controller's mode): unplaceable jobs are shed in
    ``_drop_order`` and reported in ``PoolPlan.infeasible``; the returned
    plan covers the placed subset and still partitions the whole cluster.
    Raises even in partial mode when *no* job can be placed.
    """
    from .scheduler import schedule_slice
    if not jobs:
        raise ValueError("schedule_pool needs at least one job")
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate job names: {names}")
    if cost_provider is not None:
        jobs = [replace(j, sched_cfg=replace(j.sched_cfg,
                                             cost_provider=cost_provider))
                for j in jobs]
    cfg = cfg or PoolConfig()
    t0 = time.perf_counter()
    domains = ici_domains(cluster)

    sched = _SliceScheduler(
        cluster, lambda j, c: schedule_slice(j.model, c, j.P, j.sched_cfg,
                                             job=j.name))
    placed, alloc, plans, transfers, infeasible = _place_jobs(
        jobs, domains, sched, cfg)
    if not placed or (infeasible and not allow_partial):
        raise PoolInfeasibleError(infeasible)
    plan = _finish(placed, domains, alloc, plans, transfers, t0,
                   infeasible=infeasible)
    if trace is not None:       # wall-clock span over the arbitration
        now = trace.now()
        trace.span("scheduler", "pool", "schedule_pool",
                   now - plan.wall_time_s, plan.wall_time_s,
                   jobs=len(placed), transfers=plan.transfers)
    if metrics is not None:     # obs.metrics.MetricsRegistry (default-off)
        metrics.histogram("pool/schedule_latency_s").observe(
            plan.wall_time_s)
    return plan


def _greedy_backfill(jobs: Sequence[JobSpec],
                     domains: Sequence[List[Device]],
                     owner_of: List[Optional[str]]) -> List[int]:
    """Alloc from per-domain owner names; orphaned domains (owner ``None``
    or not in ``jobs``) go — largest first — to the job with the least
    satisfied weighted FLOP demand, counting current holdings.  Arrivals
    hold nothing yet, so a departed job's surplus flows to them first."""
    def flops(dom: List[Device]) -> float:
        return sum(d.profile.flops for d in dom)

    name_to_k = {j.name: k for k, j in enumerate(jobs)}
    demand = [max(j.flop_demand(), 1e-9) for j in jobs]
    got = [0.0] * len(jobs)
    alloc = [-1] * len(domains)
    orphans: List[int] = []
    for i, nm in enumerate(owner_of):
        k = name_to_k.get(nm)
        if k is None:
            orphans.append(i)
        else:
            alloc[i] = k
            got[k] += flops(domains[i])
    for i in sorted(orphans, key=lambda i: (-flops(domains[i]), i)):
        k = min(range(len(jobs)), key=lambda k: (got[k] / demand[k], k))
        alloc[i] = k
        got[k] += flops(domains[i])
    return alloc


def replan_pool(prev: PoolPlan, cluster: Cluster,
                cfg: Optional[PoolConfig] = None, *,
                reason: str = "failure",
                frozen: Sequence[str] = (),
                departed: Sequence[str] = (),
                arrivals: Sequence[JobSpec] = (),
                allow_partial: bool = False,
                trace=None, metrics=None) -> PoolPlan:
    """Elastic pool re-arbitration over the *surviving* ``cluster``.

    Ownership is warm-started from ``prev`` (dead devices dropped); each
    job whose slice changed is re-planned with the δ-pinned ``reschedule``
    warm start, then the transfer loop may hand surviving domains across
    jobs.  Every job's δ(η_j) is pinned to its previous window, so each
    staleness contract survives the swap independently — including for
    jobs that only *gained* devices through a cross-job handoff.

    ``frozen`` jobs (e.g. finished in the runtime but not yet reclaimed)
    keep their plan and slice verbatim and are excluded from the objective
    and the transfer loop — arbitration must not hand devices to a job
    that can no longer consume them.

    ``departed`` jobs leave the pool: they are removed from the job set
    and their domains are backfilled to the remaining jobs (largest-domain
    first, least-satisfied weighted demand — so new arrivals are seeded
    from the departed surplus before the hill climb rebalances).

    ``arrivals`` are new ``JobSpec``s submitted mid-run.  Each starts with
    an empty slice — trivially starved — and is fed by the arbitration's
    existing starved-slice repair transfers from donors' surplus.  An
    arrival the donors cannot afford is shed and reported in
    ``PoolPlan.infeasible`` when ``allow_partial`` (the admission
    controller keeps it queued); carried-over jobs are never shed — if one
    ends up starved the whole replan raises ``PoolInfeasibleError`` and
    the runtime keeps executing the previous plan.
    """
    from .scheduler import reschedule, schedule_slice
    cfg = cfg or PoolConfig()
    t0 = time.perf_counter()
    departed = set(departed)
    frozen = set(frozen) - departed            # departure beats freezing
    carried = [j for j in prev.jobs if j.name not in departed]
    prev_names = {j.name for j in prev.jobs}
    for a in arrivals:
        if a.name in prev_names:
            raise ValueError(f"arrival {a.name!r} collides with a pool job")
    active = [j for j in carried if j.name not in frozen] + list(arrivals)
    if not active:
        raise ValueError("replan_pool: every job is frozen")
    domains = ici_domains(cluster)

    def domain_owner(dom: List[Device]) -> str:
        owners = {prev.owner.get(d.index) for d in dom}
        owners.discard(None)
        # survivors keep their owner; a domain is never split across jobs,
        # so the (unique) owner of its surviving devices carries over
        assert len(owners) == 1, owners
        return owners.pop()

    # frozen jobs' domains stay out of arbitration; domains owned by
    # departed jobs join it as orphans (backfilled below)
    arb_idx = [i for i, dom in enumerate(domains)
               if domain_owner(dom) not in frozen]
    arb_domains = [domains[i] for i in arb_idx]

    def solver(job: JobSpec, sl: Cluster) -> Optional[ScheduledPlan]:
        prev_plan = prev.plans.get(job.name)
        if prev_plan is None:                  # an arrival: no warm start
            return schedule_slice(job.model, sl, job.P, job.sched_cfg,
                                  job=job.name)
        prev_devs = set(prev_plan.train_devices) | set(prev_plan.infer_devices)
        slice_devs = {d.index for d in sl.devices}
        if slice_devs == prev_devs:
            return prev_plan                   # slice untouched: keep plan
        return reschedule(job.model, sl, prev_plan, job.P,
                          job.sched_cfg, reason=reason)

    sched = _SliceScheduler(cluster, solver)
    arrival_names = {a.name for a in arrivals}
    infeasible: Dict[str, JobInfeasibility] = {}
    jobs_now = list(active)
    transfers = 0
    while True:
        owner_of = [domain_owner(arb_domains[p])
                    for p in range(len(arb_domains))]
        alloc = _greedy_backfill(jobs_now, arb_domains, owner_of)
        alloc, plans, transfers = _arbitrate(jobs_now, arb_domains, alloc,
                                             sched, cfg)
        starved = sorted(n for n, p in plans.items() if p is None)
        if not starved:
            break
        shed_cands = [n for n in starved if n in arrival_names]
        if not shed_cands or not allow_partial:
            # a carried job (or strict mode): the pool has no valid
            # successor plan — typed failure, the runtime keeps the old one
            raise PoolInfeasibleError({
                n: JobInfeasibility(n, "starved",
                                    "replan could not repair a slice")
                for n in starved})
        victim = _shed_victim(jobs_now, shed_cands)
        infeasible[victim.name] = JobInfeasibility(
            victim.name, "starved",
            "donors cannot afford the arrival's minimum slice")
        jobs_now = [j for j in jobs_now if j.name != victim.name]

    arb_pos = {i: pos for pos, i in enumerate(arb_idx)}
    owner: Dict[int, str] = {}
    for i, dom in enumerate(domains):
        name = (jobs_now[alloc[arb_pos[i]]].name if i in arb_pos
                else domain_owner(dom))
        for d in dom:
            owner[d.index] = name
    # objective covers active jobs only — frozen jobs are excluded from
    # arbitration, so their (unconsumable) throughput must not score
    objective = _score(jobs_now, plans)[1]
    for name in frozen:
        plans[name] = prev.plans[name]         # carried over verbatim
    placed = set(plans)
    result_jobs = tuple([j for j in carried if j.name in placed]
                        + [a for a in arrivals if a.name in placed])
    pool = PoolPlan(jobs=result_jobs, plans=plans, owner=owner,
                    objective=objective,
                    transfers=transfers,
                    wall_time_s=time.perf_counter() - t0,
                    pool_epoch=prev.pool_epoch + 1,
                    provenance=f"replan:{reason}",
                    infeasible=infeasible)
    if trace is not None:       # wall-clock span over the re-arbitration
        now = trace.now()
        trace.span("scheduler", "pool", "replan_pool",
                   now - pool.wall_time_s, pool.wall_time_s,
                   jobs=len(placed), transfers=pool.transfers,
                   reason=reason)
    if metrics is not None:     # obs.metrics.MetricsRegistry (default-off)
        metrics.histogram("pool/replan_latency_s").observe(pool.wall_time_s)
    return pool
