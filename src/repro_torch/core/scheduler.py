"""Algorithm 1 — the two-phase AReaL-Hex scheduler, the port's copy of
``repro.core.scheduler``.

EM-style alternation:
  Search-Phase:       σ ← Constrained_Search(D_T);  τ ← MILP(D_I, P, δ(η))
  Repartition-Phase:  (D_T, D_I) ← Graph_Partition(C_T, C_I, D)
until max{C_T, C_I} stable for K iterations.

The γ (training compute fraction) window of the repartition phase is driven by
binary search on the C_T vs C_I imbalance (§4.3 'Iterative refinement'):
γ_L = γ_H = (q+r)/2 with  C_T < C_I ⇒ r ← mid,  else q ← mid, until C_T ≈ C_I.
The node-granular partitioner receives a *widened* window around the midpoint
(so an integral partition exists), preferring partitions closest to γ*.

Exhaustive baselines for Table 5 are provided by ``schedule_exhaustive_*``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .cluster import Cluster, Device
from .constrained_search import constrained_search, exhaustive_search
from .cost_model import (CostProvider, EnvCostModel, LengthDistribution,
                         TrainCost, weight_sync_cost)
from .graph_partition import (PartitionResult, compute_fraction, partition,
                              partition_exhaustive)
from .milp import solve_rollout_milp, solve_rollout_milp_bisection
from .model_spec import ModelSpec
from .plan import RolloutPlan, ScheduledPlan
from .staleness import StalenessConfig, adaptive_delta


@dataclass
class SchedulerConfig:
    tokens_per_step: float = 2_097_152.0   # global batch tokens per train step
    seq_len: float = 8192.0                # mean training sequence length
    reward_cost_s: float = 1.0             # profiled constant (§4.2.2)
    stable_iters: int = 20                 # K
    max_iters: int = 64
    gamma_width: float = 0.08              # half-width of window handed to partitioner
    staleness: StalenessConfig = None      # type: ignore[assignment]
    adapt_delta: bool = True
    milp_bisection: bool = False           # paper-literal Eq. 2 path
    # None → the analytic constant tables (bit-identical to the pre-provider
    # scheduler); a ServingCostModel overlays serving-engine measurements.
    cost_provider: Optional[CostProvider] = None
    # the paper's THIRD stage: reward/environment computation for multi-turn
    # agentic rollouts.  None (or turns=1) keeps plans bit-identical; set,
    # it deflates every h_ψ by the replica's env-stall utilization and adds
    # the env pool's stage time to C_I, so env latency moves γ.
    env: Optional[EnvCostModel] = None

    def __post_init__(self):
        if self.staleness is None:
            self.staleness = StalenessConfig()


class InfeasibleScheduleError(RuntimeError):
    """Algorithm 1 found no feasible plan for the given slice — the one
    failure the pool arbitration is allowed to treat as 'slice infeasible'
    (any other error is a bug and must propagate)."""


@dataclass
class _PhaseResult:
    plan: ScheduledPlan
    c_t: float
    c_i: float


def _evaluate_allocation(
    spec: ModelSpec,
    cluster: Cluster,
    part: PartitionResult,
    P: LengthDistribution,
    cfg: SchedulerConfig,
    delta: int,
) -> Optional[ScheduledPlan]:
    """Search-Phase: price one (D_T, D_I) allocation."""
    sigma, tcost = constrained_search(
        spec, cluster, part.train_devices,
        tokens_per_step=cfg.tokens_per_step, seq_len=cfg.seq_len,
        cost_provider=cfg.cost_provider)
    if sigma is None:
        return None

    rollouts_per_step = cfg.tokens_per_step / max(P.mean(), 1.0)
    solver = (solve_rollout_milp_bisection if cfg.milp_bisection
              else solve_rollout_milp)
    milp_res = solver(spec, part.infer_devices, P,
                      total_rollouts=delta * rollouts_per_step,
                      cost_provider=cfg.cost_provider, env=cfg.env)
    tau = milp_res.plan
    if not tau.assignments or not math.isfinite(tau.makespan):
        return None

    c_update = weight_sync_cost(spec, cluster, part.train_devices,
                                part.infer_devices)
    # third stage: env-pool wall time for the window's episodes (the flat
    # reward_cost_s constant stays — env calls are IN ADDITION to terminal
    # reward computation, and 0.0 without an EnvCostModel)
    c_env = (cfg.env.stage_time(delta * rollouts_per_step)
             if cfg.env is not None else 0.0)
    c_t = delta * tcost.total
    c_i = tau.makespan + cfg.reward_cost_s * delta + c_update * delta + c_env
    return ScheduledPlan(
        train_devices=[d.index for d in part.train_devices],
        infer_devices=[d.index for d in part.infer_devices],
        train_plan=sigma, rollout_plan=tau,
        cost_train=c_t, cost_infer=c_i,
        cost_update=c_update * delta, cost_reward=cfg.reward_cost_s * delta,
        cost_env=c_env,
        delta=delta, gamma=part.gamma_actual,
    )


def _gamma_bisection(
    cluster: Cluster,
    cfg: SchedulerConfig,
    evaluate: Callable[[PartitionResult], Optional[ScheduledPlan]],
    q: float = 0.0,
    r: float = 1.0,
    max_iters: Optional[int] = None,
    stable_iters: Optional[int] = None,
) -> Tuple[Optional[ScheduledPlan], int]:
    """The γ binary search of the repartition phase (§4.3), shared by the
    offline `schedule`, the elastic `reschedule` warm start, and the
    Table-5 baselines.

    Each iteration partitions inside a window around the bracket midpoint
    (widening until a node-granular partition exists), prices it with
    ``evaluate``, and pushes γ toward the loaded side: C_T < C_I shrinks
    training's share, infeasibility pushes compute toward training.  With
    ``stable_iters`` set, stops early once the objective stabilizes.
    Returns (best plan or None, iterations used).
    """
    max_iters = cfg.max_iters if max_iters is None else max_iters
    best: Optional[ScheduledPlan] = None
    stable = 0
    prev_obj = math.inf
    iters = 0
    for it in range(max_iters):
        iters = it + 1
        mid = (q + r) / 2.0
        width = cfg.gamma_width
        part = partition(cluster, max(0.0, mid - width),
                         min(1.0, mid + width))
        while part is None and width < 1.0:
            # widen progressively until a node-granular partition exists
            width *= 2.0
            part = partition(cluster, max(0.0, mid - width),
                             min(1.0, mid + width))
        if part is None:
            break
        plan = evaluate(part)
        if plan is not None:
            if best is None or plan.objective < best.objective:
                best = plan
            # --- binary search update on γ
            if plan.cost_train < plan.cost_infer:
                r = mid            # training under-loaded → shrink its share
            else:
                q = mid
            if stable_iters is not None:
                obj = plan.objective
                if abs(obj - prev_obj) <= 1e-3 * max(prev_obj, 1e-9):
                    stable += 1
                    if stable >= stable_iters:
                        break
                else:
                    stable = 0
                prev_obj = obj
        else:
            # infeasible at this γ: push compute toward training
            q = mid
        if r - q < 1e-4:
            break
    return best, iters


def schedule_slice(
    spec: ModelSpec,
    cluster: Cluster,
    P: Optional[LengthDistribution] = None,
    cfg: Optional[SchedulerConfig] = None,
    *,
    job: str = "job0",
    cost_provider: Optional[CostProvider] = None,
) -> ScheduledPlan:
    """Run Algorithm 1 on one device slice and return the best plan found.

    This is the per-job engine: ``cluster`` is the slice the pool
    arbitration (core/pool.py) granted to ``job`` — for single-job use it
    is simply the whole pool (see ``schedule``).
    """
    P = P or LengthDistribution()
    cfg = cfg or SchedulerConfig()
    if cost_provider is not None:
        cfg = replace(cfg, cost_provider=cost_provider)
    t0 = time.perf_counter()

    def solve_for_delta(delta: int) -> Tuple[Optional[ScheduledPlan], float]:
        best, iters = _gamma_bisection(
            cluster, cfg,
            lambda part: _evaluate_allocation(spec, cluster, part, P, cfg,
                                              delta),
            stable_iters=cfg.stable_iters)
        if best is not None:
            best.iterations = iters
        return best, (best.objective if best else math.inf)

    # --- adaptive δ(η)
    if cfg.adapt_delta:
        cache: Dict[int, Optional[ScheduledPlan]] = {}

        def run_window(delta: int) -> float:
            plan, obj = solve_for_delta(delta)
            cache[delta] = plan
            return obj

        delta = adaptive_delta(run_window, cfg.staleness)
        plan = cache.get(delta)
        if plan is None:
            plan, _ = solve_for_delta(delta)
    else:
        plan, _ = solve_for_delta(cfg.staleness.delta0())

    if plan is None:
        raise InfeasibleScheduleError(
            "scheduler found no feasible plan for cluster "
            f"{cluster.type_counts} / model {spec.name}")
    plan.job = job
    plan.wall_time_s = time.perf_counter() - t0
    return plan


def schedule(
    spec: ModelSpec,
    cluster: Cluster,
    P: Optional[LengthDistribution] = None,
    cfg: Optional[SchedulerConfig] = None,
    *,
    cost_provider: Optional[CostProvider] = None,
) -> ScheduledPlan:
    """Single-job entry point: schedule one RL job over the whole pool.

    Thin wrapper over a one-job ``core.pool.schedule_pool`` — a pool with a
    single job grants it every ICI domain and degenerates to Algorithm 1 on
    the full cluster, so existing callers see identical plans.

    ``cost_provider`` selects the efficiency-factor source (default: the
    analytic constant tables — plans are bit-identical to passing nothing).
    """
    from .pool import JobSpec, schedule_pool   # local import: pool → scheduler
    cfg = cfg or SchedulerConfig()
    if cost_provider is not None:
        cfg = replace(cfg, cost_provider=cost_provider)
    job = JobSpec(name="job0", model=spec,
                  P=P or LengthDistribution(),
                  sched_cfg=cfg)
    return schedule_pool([job], cluster).plans["job0"]


# ------------------------------------------------------ elastic replanning
def reschedule(
    spec: ModelSpec,
    cluster: Cluster,
    prev_plan: ScheduledPlan,
    P: Optional[LengthDistribution] = None,
    cfg: Optional[SchedulerConfig] = None,
    *,
    reason: str = "failure",
    gamma_halfwidth: float = 0.15,
    cost_provider: Optional[CostProvider] = None,
) -> ScheduledPlan:
    """Fast incremental re-run of the repartition phase for elastic recovery.

    When the runtime loses devices (failure) or effectively loses them
    (sustained straggler), the simulator/runtime hands the *surviving*
    ``cluster`` plus the plan it was executing here.  Instead of the full
    Algorithm 1 we warm-start from ``prev_plan``:

      * δ(η) is pinned to the previous window — the staleness contract the
        running buffer already operates under must not change mid-run;
      * the γ binary search starts in a ``±gamma_halfwidth`` bracket around
        the previous γ* (capacity loss moves the optimum, but rarely far);
      * the iteration budget is a quarter of the offline budget.

    Falls back to the full ``schedule`` (with δ still pinned) if the warm
    bracket admits no feasible plan.  The returned plan records provenance:
    ``plan_epoch = prev + 1``, ``provenance = "replan:<reason>"``.
    """
    P = P or LengthDistribution()
    cfg = cfg or SchedulerConfig()
    if cost_provider is not None:
        cfg = replace(cfg, cost_provider=cost_provider)
    t0 = time.perf_counter()
    delta = prev_plan.delta

    best, iters = _gamma_bisection(
        cluster, cfg,
        lambda part: _evaluate_allocation(spec, cluster, part, P, cfg, delta),
        q=max(0.0, prev_plan.gamma - gamma_halfwidth),
        r=min(1.0, prev_plan.gamma + gamma_halfwidth),
        max_iters=max(4, cfg.max_iters // 4))

    if best is None:
        # warm bracket infeasible (e.g. survivors can't host the model at the
        # old γ): fall back to the full search, δ still pinned.
        full_cfg = replace(
            cfg, adapt_delta=False,
            staleness=replace(cfg.staleness, delta_init=delta))
        best = schedule_slice(spec, cluster, P, full_cfg, job=prev_plan.job)
    else:
        best.iterations = iters

    best.job = prev_plan.job
    best.plan_epoch = prev_plan.plan_epoch + 1
    best.parent_epoch = prev_plan.plan_epoch
    best.provenance = f"replan:{reason}"
    best.wall_time_s = time.perf_counter() - t0
    return best


# ------------------------------------------------------ Table 5 baselines
def schedule_without_search(
    spec: ModelSpec, cluster: Cluster,
    P: Optional[LengthDistribution] = None,
    cfg: Optional[SchedulerConfig] = None,
) -> ScheduledPlan:
    """'Ours (w/o Search)': replace the constrained search + reduced MILP with
    exhaustive plan enumeration (paper-literal Eq. 2 bisection + exhaustive σ)."""
    P = P or LengthDistribution()
    cfg = cfg or SchedulerConfig()
    cfg = replace(cfg, milp_bisection=True)
    t0 = time.perf_counter()
    delta = cfg.staleness.delta0()

    def evaluate(part: PartitionResult) -> Optional[ScheduledPlan]:
        sigma, tcost = exhaustive_search(
            spec, cluster, part.train_devices,
            tokens_per_step=cfg.tokens_per_step, seq_len=cfg.seq_len,
            cost_provider=cfg.cost_provider)
        if sigma is None:
            return None
        rollouts = delta * cfg.tokens_per_step / max(P.mean(), 1.0)
        milp_res = solve_rollout_milp_bisection(
            spec, part.infer_devices, P, total_rollouts=rollouts,
            cost_provider=cfg.cost_provider, env=cfg.env)
        tau = milp_res.plan
        if not tau.assignments:
            return None
        c_update = weight_sync_cost(spec, cluster, part.train_devices,
                                    part.infer_devices)
        c_env = cfg.env.stage_time(rollouts) if cfg.env is not None else 0.0
        return ScheduledPlan(
            train_devices=[d.index for d in part.train_devices],
            infer_devices=[d.index for d in part.infer_devices],
            train_plan=sigma, rollout_plan=tau,
            cost_train=delta * tcost.total,
            cost_infer=(tau.makespan + cfg.reward_cost_s * delta
                        + c_update * delta + c_env),
            cost_update=c_update * delta, cost_reward=cfg.reward_cost_s * delta,
            cost_env=c_env,
            delta=delta, gamma=part.gamma_actual)

    best, _ = _gamma_bisection(cluster, cfg, evaluate)
    if best is None:
        raise RuntimeError("no feasible plan (w/o search baseline)")
    best.wall_time_s = time.perf_counter() - t0
    return best


def schedule_without_repartition(
    spec: ModelSpec, cluster: Cluster,
    P: Optional[LengthDistribution] = None,
    cfg: Optional[SchedulerConfig] = None,
    node_limit: int = 16,
) -> ScheduledPlan:
    """'Ours (w/o Repartition)': replace graph partition with exhaustive subset
    enumeration over nodes (bounded by ``node_limit`` to stay runnable)."""
    P = P or LengthDistribution()
    cfg = cfg or SchedulerConfig()
    t0 = time.perf_counter()
    n_nodes = len({d.node for d in cluster.devices})
    if n_nodes > node_limit:
        raise RuntimeError(f"exhaustive repartition over {n_nodes} nodes "
                           "is intractable (that is the point of Table 5)")
    delta = cfg.staleness.delta0()
    best: Optional[ScheduledPlan] = None
    # enumerate every γ-unconstrained node bipartition and price it fully
    from .graph_partition import _group_nodes  # reuse node grouping
    groups = _group_nodes(cluster)
    nodes = [n for t in sorted(groups) for n in groups[t]]
    for mask in range(1, (1 << len(nodes)) - 1):
        tr: List[Device] = []
        inf: List[Device] = []
        for i, node in enumerate(nodes):
            (tr if (mask >> i) & 1 else inf).extend(node)
        part = PartitionResult(tr, inf, 0.0, compute_fraction(cluster, tr),
                               "exhaustive")
        plan = _evaluate_allocation(spec, cluster, part, P, cfg, delta)
        if plan is not None and (best is None or plan.objective < best.objective):
            best = plan
    if best is None:
        raise RuntimeError("no feasible plan (w/o repartition baseline)")
    best.wall_time_s = time.perf_counter() - t0
    return best


def schedule_uniform(
    spec: ModelSpec, cluster: Cluster,
    P: Optional[LengthDistribution] = None,
    cfg: Optional[SchedulerConfig] = None,
) -> ScheduledPlan:
    """Table 3 'AReaL (u)' baseline: uniform (50/50 nodes per type) allocation,
    no repartition optimization; search phase still picks σ, τ."""
    P = P or LengthDistribution()
    cfg = cfg or SchedulerConfig()
    from .graph_partition import _group_nodes
    groups = _group_nodes(cluster)
    tr: List[Device] = []
    inf: List[Device] = []
    for t in sorted(groups):
        nl = groups[t]
        half = len(nl) // 2
        for i, node in enumerate(nl):
            (tr if i < half else inf).extend(node)
    if not tr or not inf:
        # single-node-per-type degenerate case: split devices instead
        devs = list(cluster.devices)
        tr, inf = devs[: len(devs) // 2], devs[len(devs) // 2:]
    part = PartitionResult(tr, inf, 0.0, compute_fraction(cluster, tr), "uniform")
    delta = cfg.staleness.delta0()
    plan = _evaluate_allocation(spec, cluster, part, P, cfg, delta)
    if plan is None:
        raise RuntimeError("uniform allocation infeasible")
    return plan
