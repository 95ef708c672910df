"""Scheduled-plan dataclasses — the scheduler's output (§4.1), the port's
copy of ``repro.core.plan``.

A ``ScheduledPlan`` is the full answer to Eq. (1): the device bipartition
(D_T, D_I), the training plan σ, the rollout plan τ (replica configs with
counts + workload split), and the cost estimates that produced it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .cluster import Cluster, Device
from .cost_model import ReplicaConfig, ReplicaCost, TrainCost, TrainPlan


@dataclass(frozen=True)
class RolloutAssignment:
    """One row of τ: a replica configuration, its count y_ψ, and its share of
    the rollout workload x_ψ (in rollouts per scheduling window)."""

    config: ReplicaConfig
    count: int                 # y_ψ
    workload: float            # x_ψ
    cost: ReplicaCost          # includes h_ψ = tokens_per_sec

    @property
    def total_tokens_per_sec(self) -> float:
        return self.count * self.cost.tokens_per_sec


@dataclass(frozen=True)
class RolloutPlan:
    """τ — the rollout-generation execution plan (§4.2.2)."""

    assignments: Tuple[RolloutAssignment, ...]
    makespan: float            # Θ for the window's B rollouts
    total_rollouts: float      # B

    @property
    def n_devices(self) -> int:
        return sum(a.config.n_devices * a.count for a in self.assignments)

    @property
    def tokens_per_sec(self) -> float:
        return sum(a.total_tokens_per_sec for a in self.assignments)

    def describe(self) -> str:
        rows = [f"{a.count}x{a.config.describe()}(h={a.cost.tokens_per_sec:.0f}t/s,x={a.workload:.0f})"
                for a in self.assignments]
        return " + ".join(rows) if rows else "<empty>"


@dataclass
class ScheduledPlan:
    """(σ*, τ*, D_T*, D_I*) plus the costs that justified them."""

    train_devices: List[int]            # device indices of D_T
    infer_devices: List[int]            # device indices of D_I
    train_plan: TrainPlan
    rollout_plan: RolloutPlan
    cost_train: float                   # C_T over the δ(η) window, seconds
    cost_infer: float                   # C_I  (rollout + reward + update)
    cost_update: float                  # weight-sync component of C_I
    cost_reward: float
    delta: int                          # δ(η) window used
    gamma: float                        # compute fraction given to training
    # env/tool-pool component of C_I (the paper's third stage; 0.0 unless
    # the SchedulerConfig carries an EnvCostModel — defaults keep every
    # existing construction site and signature untouched)
    cost_env: float = 0.0
    iterations: int = 0                 # scheduler iterations to converge
    wall_time_s: float = 0.0            # scheduler runtime
    # --- provenance: who produced this plan and where it sits in the elastic
    # replan chain.  Epoch 0 is the initial offline plan; every runtime
    # replan (failure / sustained straggler) bumps the epoch so throughput
    # can be attributed to plan generations.
    plan_epoch: int = 0
    parent_epoch: Optional[int] = None  # epoch this plan was derived from
    provenance: str = "initial"         # "initial" | "replan:<reason>"
    # --- multi-job: which job of the pool this plan serves.  Single-job
    # schedules keep the default; the pool arbitration (core/pool.py) stamps
    # the JobSpec name so ownership/handoff provenance is self-describing.
    job: str = "job0"

    @property
    def objective(self) -> float:
        """max{C_T, C_I} — Eq. (1)."""
        return max(self.cost_train, self.cost_infer)

    def signature(self) -> Tuple:
        """Structural fingerprint of the decision (device sets, σ, τ, δ, γ).

        Excludes wall_time_s/iterations so two runs of the scheduler on the
        same inputs can be compared for *decision* equality — the
        determinism contract the warm-started ``reschedule`` relies on.
        """
        return (
            tuple(self.train_devices),
            tuple(self.infer_devices),
            tuple(self.train_plan.stages),
            tuple((a.config, a.count, round(a.workload, 6))
                  for a in self.rollout_plan.assignments),
            self.delta,
            round(self.gamma, 9),
        )

    def throughput_tokens_per_sec(self, tokens_per_step: float) -> float:
        """End-to-end RL training throughput: tokens consumed per wall second,
        over the δ-step window (the async pipeline runs at the max-stage rate)."""
        return self.delta * tokens_per_step / max(self.objective, 1e-12)

    def describe(self) -> str:
        return (
            f"[{self.job} epoch {self.plan_epoch}: {self.provenance}]  "
            f"D_T={len(self.train_devices)}dev  D_I={len(self.infer_devices)}dev  "
            f"γ={self.gamma:.3f}\n  σ: {self.train_plan.describe()}\n"
            f"  τ: {self.rollout_plan.describe()}\n"
            f"  C_T={self.cost_train:.2f}s  C_I={self.cost_infer:.2f}s "
            f"(update={self.cost_update:.2f}s reward={self.cost_reward:.2f}s"
            + (f" env={self.cost_env:.2f}s" if self.cost_env else "")
            + f")  δ={self.delta}"
        )
