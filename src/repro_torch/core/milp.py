"""§4.2.2 — MILP for the rollout-generation plan τ, the port's copy of
``repro.core.milp``.

Decision variables (paper Eq. 2):
  y_ψ ∈ Z≥0   number of replicas of configuration ψ
  x_ψ ∈ [0,B] rollouts assigned to configuration ψ
  Θ ≥ 0       makespan over the δ(η)-step window

  min Θ   s.t.  Σx_ψ = B,  x_ψ·len ≤ Θ·y_ψ·h_ψ,  Σ_ψ v_ψ[t]·y_ψ ≤ i_t ∀t.

The Θ·y product makes Eq. 2 bilinear; we solve it two ways:

  * ``solve_rollout_milp`` (fast path): observe that for fixed y the optimal x
    is proportional to capacity, so min Θ = B·len / max Σ y_ψ h_ψ — an integer
    program solved exactly with scipy's HiGHS MILP (pure-python greedy
    fallback included).
  * ``solve_rollout_milp_bisection`` (paper-literal): bisect Θ, each iterate a
    feasibility MILP with linear constraints — used by the Table 5 benchmark
    to represent the naive formulation.

Per the paper, TP inside a replica is confined to one machine; reward cost is a
profiled constant; output lengths come from the profiled distribution P.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import Cluster, Device, PROFILES
from .cost_model import (CostProvider, EnvCostModel, LengthDistribution,
                         ReplicaConfig, ReplicaCost, replica_throughput)
from .model_spec import ModelSpec
from .plan import RolloutAssignment, RolloutPlan

try:
    from scipy.optimize import LinearConstraint, Bounds, milp
    _HAVE_SCIPY = True
except Exception:                                        # pragma: no cover
    _HAVE_SCIPY = False


# ------------------------------------------------------------- Ψ enumeration
def slice_node_widths(d_infer: Sequence[Device]) -> Dict[str, int]:
    """Per-type max devices co-located on one machine *within a slice*.

    Multi-job slices and post-failure survivor sets can own a machine only
    partially; TP is confined to one machine, so Ψ must be enumerated
    against what the slice actually holds per node, not the profile's
    nominal devices_per_node.
    """
    per_node: Dict[Tuple[str, int], int] = {}
    for d in d_infer:
        key = (d.type_name, d.node)
        per_node[key] = per_node.get(key, 0) + 1
    widths: Dict[str, int] = {}
    for (tname, _), c in per_node.items():
        widths[tname] = max(widths.get(tname, 0), c)
    return widths


def enumerate_replica_configs(
    spec: ModelSpec,
    type_counts: Dict[str, int],
    P: LengthDistribution,
    *,
    max_pp: int = 2,
    node_widths: Optional[Dict[str, int]] = None,
    cost_provider: Optional[CostProvider] = None,
    env: Optional[EnvCostModel] = None,
) -> List[Tuple[ReplicaConfig, ReplicaCost]]:
    """Build Ψ: feasible replica configs with their profiled throughput h_ψ.

    ``node_widths`` restricts TP degrees to what a single machine of the
    slice can host (see ``slice_node_widths``); without it the nominal
    ``devices_per_node`` is used (full-machine slices).

    ``env`` (multi-turn agentic workloads) deflates each h_ψ by the
    replica's env-stall utilization — a *per-config* factor, since faster
    replicas idle a larger fraction of wall time on the same env call, so
    env latency reshuffles which device types the MILP prefers.  None →
    h_ψ untouched (bit-identical Ψ).
    """
    out: List[Tuple[ReplicaConfig, ReplicaCost]] = []
    for tname, count in sorted(type_counts.items()):
        prof = PROFILES[tname]
        width = prof.devices_per_node
        if node_widths is not None:
            width = min(width, node_widths.get(tname, width))
        tp_opts = [t for t in (1, 2, 4, 8) if t <= width]
        for tp in tp_opts:
            for pp in range(1, max_pp + 1):
                cfg = ReplicaConfig(tname, (tp,) * pp)
                if cfg.n_devices > count:
                    continue
                rc = replica_throughput(spec, cfg, P,
                                        cost_provider=cost_provider)
                if env is not None and rc.feasible:
                    rc = dataclasses.replace(
                        rc, tokens_per_sec=rc.tokens_per_sec
                        * env.replica_util(rc, P))
                if rc.feasible and rc.tokens_per_sec > 0:
                    out.append((cfg, rc))
    return out


# ------------------------------------------------------------------ solvers
@dataclass
class MILPResult:
    plan: RolloutPlan
    solver: str
    optimal: bool


def _greedy_counts(configs: Sequence[Tuple[ReplicaConfig, ReplicaCost]],
                   type_counts: Dict[str, int]) -> List[int]:
    """Pure-python fallback: repeatedly add the replica with the best
    throughput-per-device until no device budget remains."""
    remaining = dict(type_counts)
    counts = [0] * len(configs)
    ranked = sorted(
        range(len(configs)),
        key=lambda i: configs[i][1].tokens_per_sec / configs[i][0].n_devices,
        reverse=True)
    progress = True
    while progress:
        progress = False
        for i in ranked:
            cfg, _ = configs[i]
            if remaining.get(cfg.profile_name, 0) >= cfg.n_devices:
                remaining[cfg.profile_name] -= cfg.n_devices
                counts[i] += 1
                progress = True
    return counts


def _max_throughput_counts(
    configs: Sequence[Tuple[ReplicaConfig, ReplicaCost]],
    type_counts: Dict[str, int],
) -> Tuple[List[int], str, bool]:
    """maximize Σ y_ψ·h_ψ  s.t.  Σ v_ψ[t]·y_ψ ≤ i_t — exact via HiGHS."""
    n = len(configs)
    if n == 0:
        return [], "none", True
    types = sorted(type_counts)
    if _HAVE_SCIPY:
        c = -np.array([rc.tokens_per_sec for _, rc in configs])
        A = np.zeros((len(types), n))
        for j, (cfg, _) in enumerate(configs):
            A[types.index(cfg.profile_name), j] = cfg.n_devices
        ub = np.array([type_counts[t] for t in types], dtype=float)
        cons = LinearConstraint(A, lb=np.zeros(len(types)), ub=ub)
        y_ub = np.array([type_counts[cfg.profile_name] // cfg.n_devices
                         for cfg, _ in configs], dtype=float)
        res = milp(c=c, constraints=cons, integrality=np.ones(n),
                   bounds=Bounds(lb=np.zeros(n), ub=y_ub))
        if res.success:
            return [int(round(v)) for v in res.x], "scipy-highs", True
    return _greedy_counts(configs, type_counts), "greedy", False


def solve_rollout_milp(
    spec: ModelSpec,
    d_infer: Sequence[Device],
    P: LengthDistribution,
    *,
    total_rollouts: float,
    max_pp: int = 2,
    cost_provider: Optional[CostProvider] = None,
    env: Optional[EnvCostModel] = None,
) -> MILPResult:
    """Fast path: exact reduction of Eq. 2 (see module docstring)."""
    type_counts: Dict[str, int] = {}
    for d in d_infer:
        type_counts[d.type_name] = type_counts.get(d.type_name, 0) + 1
    configs = enumerate_replica_configs(
        spec, type_counts, P, max_pp=max_pp,
        node_widths=slice_node_widths(d_infer),
        cost_provider=cost_provider, env=env)
    counts, solver, optimal = _max_throughput_counts(configs, type_counts)

    assignments: List[RolloutAssignment] = []
    total_tps = 0.0
    for (cfg, rc), y in zip(configs, counts):
        if y > 0:
            total_tps += y * rc.tokens_per_sec
    len_mean = P.mean()
    makespan = (total_rollouts * len_mean / total_tps) if total_tps > 0 else math.inf
    for (cfg, rc), y in zip(configs, counts):
        if y <= 0:
            continue
        x = total_rollouts * (y * rc.tokens_per_sec) / total_tps if total_tps else 0.0
        assignments.append(RolloutAssignment(config=cfg, count=y, workload=x, cost=rc))
    plan = RolloutPlan(assignments=tuple(assignments), makespan=makespan,
                       total_rollouts=total_rollouts)
    return MILPResult(plan=plan, solver=solver, optimal=optimal)


def solve_rollout_milp_bisection(
    spec: ModelSpec,
    d_infer: Sequence[Device],
    P: LengthDistribution,
    *,
    total_rollouts: float,
    max_pp: int = 2,
    tol: float = 1e-3,
    max_iters: int = 40,
    cost_provider: Optional[CostProvider] = None,
    env: Optional[EnvCostModel] = None,
) -> MILPResult:
    """Paper-literal Eq. 2 via Θ-bisection: each iterate solves the linear
    feasibility MILP  ∃y,x: Σx=B, x_ψ·len ≤ Θ·y_ψ·h_ψ, Σ v·y ≤ i."""
    type_counts: Dict[str, int] = {}
    for d in d_infer:
        type_counts[d.type_name] = type_counts.get(d.type_name, 0) + 1
    configs = enumerate_replica_configs(
        spec, type_counts, P, max_pp=max_pp,
        node_widths=slice_node_widths(d_infer),
        cost_provider=cost_provider, env=env)
    if not configs:
        empty = RolloutPlan(assignments=(), makespan=math.inf,
                            total_rollouts=total_rollouts)
        return MILPResult(plan=empty, solver="none", optimal=False)

    len_mean = P.mean()

    def feasible(theta: float) -> Optional[List[int]]:
        # capacity at makespan theta: each replica of ψ finishes
        # theta·h_ψ/len rollouts; need Σ y·theta·h/len ≥ B under budgets —
        # max-throughput IP answers this.
        counts, _, _ = _max_throughput_counts(configs, type_counts)
        cap = sum(y * rc.tokens_per_sec for (cfg, rc), y in zip(configs, counts))
        return counts if theta * cap / len_mean >= total_rollouts else None

    counts_star, solver, optimal = _max_throughput_counts(configs, type_counts)
    cap = sum(y * rc.tokens_per_sec for (_, rc), y in zip(configs, counts_star))
    if cap <= 0:
        empty = RolloutPlan(assignments=(), makespan=math.inf,
                            total_rollouts=total_rollouts)
        return MILPResult(plan=empty, solver=solver, optimal=False)
    lo, hi = 0.0, 2.0 * total_rollouts * len_mean / cap
    best = None
    for _ in range(max_iters):
        mid = (lo + hi) / 2.0
        c = feasible(mid)
        if c is not None:
            best, hi = (mid, c), mid
        else:
            lo = mid
        if hi - lo < tol * max(hi, 1.0):
            break
    theta, counts = best if best else (hi, counts_star)
    total_tps = sum(y * rc.tokens_per_sec for (_, rc), y in zip(configs, counts))
    assignments = []
    for (cfg, rc), y in zip(configs, counts):
        if y <= 0:
            continue
        x = total_rollouts * (y * rc.tokens_per_sec) / total_tps if total_tps else 0.0
        assignments.append(RolloutAssignment(config=cfg, count=y, workload=x, cost=rc))
    plan = RolloutPlan(assignments=tuple(assignments), makespan=theta,
                       total_rollouts=total_rollouts)
    return MILPResult(plan=plan, solver=solver + "+bisect", optimal=optimal)
