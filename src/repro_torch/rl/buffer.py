"""Staleness-bounded producer-consumer rollout buffer (AReaL semantics),
the port of ``repro.rl.buffer`` (``Rollout`` and ``RolloutBuffer``; the
multi-job ``JobBuffers`` comes with the multi-job slice).

Rollout workers push completed trajectories tagged with the weight version
that generated them; the trainer pops batches subject to the admission
rule ``version_now - version_rollout <= eta``.  Capacity control -- at
most (eta+1)*B rollouts in flight -- *guarantees* the bound without
discarding work (``core/staleness.py``, shared bookkeeping).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.staleness import StalenessConfig, StalenessController


@dataclass
class Rollout:
    """One completed trajectory."""
    prompt_ids: List[int]
    completion_ids: List[int]
    behavior_logp: np.ndarray          # per completion token
    version: int                       # weight version that generated it
    group_id: int                      # GRPO group (same prompt)
    reward: float = 0.0
    task: Any = None
    plan_epoch: int = 0                # elastic plan generation that ran it

    @property
    def length(self) -> int:
        return len(self.prompt_ids) + len(self.completion_ids)


class RolloutBuffer:
    def __init__(self, config: Optional[StalenessConfig] = None,
                 metrics=None):
        self.config = config or StalenessConfig()
        self.ctl = StalenessController(self.config)
        self._items: List[Rollout] = []
        self.dropped = 0
        # default-off observability (obs.metrics.MetricsRegistry): None ->
        # every hook below is skipped, behavior bit-identical
        self.metrics = metrics
        if self.metrics is not None:
            # publish the bounds once so registry consumers (the health
            # monitor's staleness-burn and depth detectors) can judge
            # the histogram/gauge values against them
            self.metrics.gauge("buffer/eta").set(self.config.eta)
            self.metrics.gauge("buffer/capacity").set(self.ctl.capacity)

    # ------------------------------------------------------------- producer
    def can_launch(self, n: int = 1) -> bool:
        return self.ctl.can_launch(n)

    def launch(self, n: int = 1) -> None:
        self.ctl.launch(n)

    def push(self, rollout: Rollout) -> None:
        """Completed generation enters the buffer (still 'in flight' for
        capacity purposes until consumed)."""
        rollout.plan_epoch = self.ctl.plan_epoch
        self._items.append(rollout)
        if self.metrics is not None:
            self.metrics.counter("buffer/pushed").inc()
            self.metrics.gauge("buffer/depth").set(len(self._items))

    # ------------------------------------------------------------- elastic
    def on_plan_swap(self) -> int:
        """An elastic replan hot-swapped the execution plan.

        Buffered and in-flight rollouts from the previous epoch stay valid:
        their version tags are unchanged, so the η admission rule keeps
        holding across the swap (the capacity (η+1)·B depends only on η and
        B, which a swap never changes mid-run).  Returns the new epoch.
        """
        return self.ctl.record_plan_swap()

    @property
    def plan_epoch(self) -> int:
        return self.ctl.plan_epoch

    # ------------------------------------------------------------- trainer
    def bump_version(self) -> int:
        v = self.ctl.bump_version()
        # evict over-stale rollouts (rare under capacity control)
        fresh = []
        for r in self._items:
            if self.ctl.admissible(r.version):
                fresh.append(r)
            else:
                self.ctl.drop(1)
                self.dropped += 1
                if self.metrics is not None:
                    self.metrics.counter("buffer/dropped").inc()
        self._items = fresh
        return v

    def ready(self, n: int) -> bool:
        return len(self._items) >= n

    def pop_batch(self, n: int) -> List[Rollout]:
        """Oldest-first pop of n admissible rollouts."""
        if not self.ready(n):
            raise ValueError(f"pop_batch({n}) with {len(self._items)} "
                             "buffered")
        batch = self._items[:n]
        self._items = self._items[n:]
        self.ctl.consume([r.version for r in batch])
        if self.metrics is not None:
            # staleness distribution per consumed rollout, keyed at the
            # moment of admission (version_now − version_rollout ≤ η)
            hist = self.metrics.histogram("buffer/staleness")
            for r in batch:
                hist.observe(self.ctl.version - r.version)
            self.metrics.counter("buffer/consumed").inc(len(batch))
            self.metrics.gauge("buffer/depth").set(len(self._items))
        return batch

    def __len__(self) -> int:
        return len(self._items)

    @property
    def version(self) -> int:
        return self.ctl.version

    def stats(self) -> Dict[str, float]:
        return {
            "size": len(self._items),
            "in_flight": self.ctl.in_flight,
            "mean_staleness": self.ctl.mean_staleness(),
            "max_staleness": self.ctl.max_staleness(),
            "dropped": self.dropped,
            "plan_epoch": self.ctl.plan_epoch,
            "plan_swaps": len(self.ctl.swap_history()),
        }
