"""Elastic replanning bridge between the simulator and the scheduler (the
port's copy of ``repro.sim.replan``).

The discrete-event simulator executes a ``ScheduledPlan``; the two-phase
scheduler produces one.  ``ElasticReplanner`` closes the loop: when the
runtime loses capacity (replica failure, sustained straggler) it

  1. maps the affected flattened replica indices back to the physical
     devices they occupy (the MILP's τ assigns replica configs to typed
     device pools — the mapping below mirrors the simulator's flattening),
  2. snapshots the surviving devices into a reduced ``Cluster`` (node ids
     preserved, so the graph partition stays node-granular), and
  3. re-runs the repartition phase via ``core.scheduler.reschedule`` —
     warm-started from the previous plan's γ and δ(η).

Device exclusions are cumulative across plan epochs: a device lost in
epoch 1 never reappears in epoch 2's cluster.

The replan cost charged to simulated time is a *fixed* ``replan_latency_s``
(covering scheduler runtime + engine restart + weight reload) rather than
the host's measured scheduler wall time, so simulation results stay
deterministic and machine-independent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.cluster import Cluster, Device
from repro_torch.core.cost_model import LengthDistribution
from repro_torch.core.model_spec import ModelSpec
from repro_torch.core.plan import ScheduledPlan
from repro_torch.core.pool import JobSpec, PoolConfig, PoolPlan, replan_pool
from repro_torch.core.scheduler import SchedulerConfig, reschedule


def replica_device_map(infer_devices: Sequence[Device],
                       plan: ScheduledPlan) -> List[List[Device]]:
    """Devices occupied by each flattened replica of ``plan``.

    Mirrors the simulator's flattening (assignments in order, ``count``
    replicas each); replica k of a ψ-assignment takes the next
    ``n_devices`` unclaimed D_I devices of ψ's profile type.  Shared by the
    single-job ``ElasticReplanner`` and the multi-job ``PoolReplanner``.
    """
    pools: Dict[str, List[Device]] = {}
    for d in infer_devices:
        pools.setdefault(d.type_name, []).append(d)
    out: List[List[Device]] = []
    for a in plan.rollout_plan.assignments:
        pool = pools.get(a.config.profile_name, [])
        for _ in range(a.count):
            take, pool = pool[: a.config.n_devices], \
                pool[a.config.n_devices:]
            out.append(take)
        pools[a.config.profile_name] = pool
    return out


@dataclass
class ElasticConfig:
    """Policy knobs for runtime replanning."""

    replan_on_failure: bool = True         # permanent failures trigger replan
    straggler_threshold: float = 0.5       # cumulative rate factor ≤ this
    #                                        counts as a *sustained* straggler
    replan_latency_s: float = 5.0          # simulated drain+swap latency
    min_interval_s: float = 0.0            # debounce between committed swaps


class ElasticReplanner:
    """Holds the planning inputs the simulator does not know about."""

    def __init__(self, spec: ModelSpec, cluster: Cluster,
                 P: Optional[LengthDistribution] = None,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 elastic: Optional[ElasticConfig] = None):
        self.spec = spec
        self.cluster = cluster
        self.P = P or LengthDistribution()
        self.sched_cfg = sched_cfg or SchedulerConfig()
        self.elastic = elastic or ElasticConfig()
        self.excluded: Set[int] = set()    # device indices lost for good

    # ------------------------------------------------------------- mapping
    def replica_devices(self, plan: ScheduledPlan) -> List[List[Device]]:
        """Devices occupied by each flattened replica of ``plan``."""
        return replica_device_map(self.cluster.subset(plan.infer_devices),
                                  plan)

    # ------------------------------------------------------------ survivors
    def exclude_replicas(self, plan: ScheduledPlan,
                         replica_idxs: Sequence[int]) -> None:
        """Permanently remove the devices behind these replicas."""
        rmap = self.replica_devices(plan)
        for i in replica_idxs:
            if 0 <= i < len(rmap):
                self.excluded.update(d.index for d in rmap[i])

    def surviving_cluster(self) -> Cluster:
        survivors = [d for d in self.cluster.devices
                     if d.index not in self.excluded]
        return Cluster(devices=survivors,
                       cross_type_bw=self.cluster.cross_type_bw)

    # --------------------------------------------------------------- replan
    def replan(self, prev_plan: ScheduledPlan,
               reason: str = "failure") -> Optional[ScheduledPlan]:
        """Re-run the repartition phase over the survivors.

        Returns None when no feasible plan exists (e.g. too few devices
        left to host the model) — the caller keeps running the old plan
        minus the dead replicas.
        """
        cluster = self.surviving_cluster()
        if len(cluster) < 2:
            return None
        try:
            return reschedule(self.spec, cluster, prev_plan,
                              self.P, self.sched_cfg, reason=reason)
        except RuntimeError:
            return None


class PoolReplanner:
    """Multi-job analogue of ``ElasticReplanner``: when a failure shrinks a
    job's slice, re-arbitrate the *whole pool* over the survivors
    (``core.pool.replan_pool``) — the new ``PoolPlan`` may hand surviving
    ICI domains between jobs, which the simulator commits through the same
    drain/commit path as a single-job swap.
    """

    def __init__(self, cluster: Cluster,
                 pool_cfg: Optional[PoolConfig] = None,
                 elastic: Optional["ElasticConfig"] = None):
        self.cluster = cluster
        self.pool_cfg = pool_cfg or PoolConfig()
        self.elastic = elastic or ElasticConfig()
        self.excluded: Set[int] = set()    # device indices lost for good

    def replica_devices(self, plan: ScheduledPlan) -> List[List[Device]]:
        return replica_device_map(self.cluster.subset(plan.infer_devices),
                                  plan)

    def exclude_replicas(self, plan: ScheduledPlan,
                         replica_idxs: Sequence[int]) -> List[int]:
        """Permanently remove the devices behind these replicas; returns the
        newly-dead device indices (for the simulator's ledger)."""
        rmap = self.replica_devices(plan)
        dead: List[int] = []
        for i in replica_idxs:
            if 0 <= i < len(rmap):
                for d in rmap[i]:
                    if d.index not in self.excluded:
                        self.excluded.add(d.index)
                        dead.append(d.index)
        return dead

    def surviving_cluster(self) -> Cluster:
        survivors = [d for d in self.cluster.devices
                     if d.index not in self.excluded]
        return Cluster(devices=survivors,
                       cross_type_bw=self.cluster.cross_type_bw)

    def replan(self, prev: PoolPlan, reason: str = "failure",
               frozen: Sequence[str] = (),
               departed: Sequence[str] = (),
               arrivals: Sequence["JobSpec"] = ()) -> Optional[PoolPlan]:
        """Re-arbitrate over the survivors; None when no feasible pool plan
        exists (every job keeps its old plan minus the dead replicas).
        ``frozen`` jobs (finished in the runtime) keep their slices and
        never receive handed-off devices; ``departed`` jobs leave the pool
        and their slices are reclaimed; ``arrivals`` are seeded from the
        donors' surplus (an unaffordable arrival is shed into
        ``PoolPlan.infeasible`` — partial mode — and stays queued)."""
        cluster = self.surviving_cluster()
        if len(cluster) < 2:
            return None
        try:
            return replan_pool(prev, cluster, self.pool_cfg, reason=reason,
                               frozen=frozen, departed=departed,
                               arrivals=arrivals,
                               allow_partial=bool(arrivals))
        except (RuntimeError, ValueError):
            return None
