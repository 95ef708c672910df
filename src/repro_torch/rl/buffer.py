"""Staleness-bounded producer-consumer rollout buffer (AReaL semantics),
the port of ``repro.rl.buffer`` (``Rollout``, ``RolloutBuffer`` and the
multi-job ``JobBuffers``).

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


class JobBuffers:
    """Per-job rollout buffers over one shared pool (multi-job runtime).

    Each job owns an independent ``RolloutBuffer`` — its own weight-version
    stream, η_j budget, and capacity (η_j+1)·B_j.  A cross-job device
    handoff (core/pool.py arbitration) re-homes *hardware*, never data:
    both jobs see a plan-swap epoch bump and both buffers keep their
    contents and version streams, so each η_j admission rule is unaffected.
    """

    def __init__(self):
        self._bufs: Dict[str, RolloutBuffer] = {}

    def add_job(self, name: str,
                config: Optional[StalenessConfig] = None) -> RolloutBuffer:
        if name in self._bufs:
            raise ValueError(f"job {name!r} already has a buffer")
        buf = RolloutBuffer(config)
        self._bufs[name] = buf
        return buf

    def __getitem__(self, name: str) -> RolloutBuffer:
        return self._bufs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._bufs

    def jobs(self) -> List[str]:
        return sorted(self._bufs)

    def remove_job(self, name: str, *, force: bool = False) -> Dict[str, float]:
        """Reclaim a departed job's buffer (completion/rejection).

        A clean departure has nothing in flight — the job drained before
        its slice was reclaimed.  ``force=True`` (preemption/abort) drops
        whatever is still generating or buffered; the dropped count lands
        in the returned final stats so no rollout silently vanishes from
        the ledger.  Returns the buffer's final ``stats()`` snapshot.
        """
        if name not in self._bufs:
            raise KeyError(f"job {name!r} has no buffer")
        buf = self._bufs[name]
        if buf.ctl.in_flight and not force:
            raise RuntimeError(
                f"job {name!r} still has {buf.ctl.in_flight} rollouts in "
                f"flight; drain first or remove_job(force=True)")
        if buf.ctl.in_flight:
            buf.dropped += buf.ctl.in_flight   # buffered + still generating
            buf.ctl.drop(buf.ctl.in_flight)
            buf._items = []
        final = buf.stats()
        del self._bufs[name]
        return final

    def on_device_handoff(self, from_job: str, to_job: str) -> Dict[str, int]:
        """Devices moved between jobs: both plans swapped, both buffers
        bump their plan epoch; returns {job: new_epoch}."""
        return {from_job: self._bufs[from_job].on_plan_swap(),
                to_job: self._bufs[to_job].on_plan_swap()}

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {n: b.stats() for n, b in self._bufs.items()}
