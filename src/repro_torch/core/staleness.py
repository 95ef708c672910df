"""Bounded-staleness control for asynchronous RL (AReaL semantics), the
port's copy of ``repro.core.staleness`` (``StalenessConfig``,
``StalenessController`` and the scheduler's ``adaptive_delta``; the
multi-job registry comes with the slice that uses it).

The trainer holds weight version v.  Every rollout records the version(s)
that generated it.  The controller enforces:

  * admission  -- a rollout may enter a training batch only if
                  v_now - v_rollout <= eta  (data staleness bound);
  * capacity   -- at most (eta + 1) * B rollouts may be in flight
                  (generating or buffered), where B is rollouts consumed
                  per step: this *guarantees* the bound without
                  discarding work;
  * delta(eta) -- the scheduling window of the scheduler (section 4.1).

Pure bookkeeping: no torch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StalenessConfig:
    eta: int = 4                   # max allowed version lag
    rollouts_per_step: int = 256   # B: rollouts consumed per training step
    delta_init: Optional[int] = None   # initial δ(η); default max(1, η)
    delta_max: int = 64

    def delta0(self) -> int:
        return self.delta_init if self.delta_init is not None else max(1, self.eta)


@dataclass
class StalenessController:
    config: StalenessConfig
    version: int = 0                       # current trainer weight version
    in_flight: int = 0                     # rollouts generating or buffered
    plan_epoch: int = 0                    # elastic replan generation
    _staleness_hist: List[int] = field(default_factory=list)
    _swap_log: List[tuple] = field(default_factory=list)  # (epoch, version)

    # ---------------------------------------------------------------- queries
    @property
    def capacity(self) -> int:
        """Max concurrent rollouts: (η+1)·B."""
        return (self.config.eta + 1) * self.config.rollouts_per_step

    def can_launch(self, n: int = 1) -> bool:
        return self.in_flight + n <= self.capacity

    def admissible(self, rollout_version: int) -> bool:
        return self.version - rollout_version <= self.config.eta

    # ------------------------------------------------------------ transitions
    def launch(self, n: int = 1) -> None:
        if not self.can_launch(n):
            raise RuntimeError(
                f"staleness capacity exceeded: {self.in_flight}+{n} > {self.capacity}")
        self.in_flight += n

    def complete(self, n: int = 1) -> None:
        # generation finished; rollout stays in flight (buffered) until consumed
        pass

    def consume(self, rollout_versions: List[int]) -> None:
        """Trainer consumed a batch; record staleness, free capacity."""
        for v in rollout_versions:
            s = self.version - v
            if s > self.config.eta:
                raise RuntimeError(f"stale rollout consumed: lag {s} > η={self.config.eta}")
            self._staleness_hist.append(s)
        self.in_flight -= len(rollout_versions)
        if self.in_flight < 0:
            raise RuntimeError("consumed more rollouts than launched")

    def drop(self, n: int = 1) -> None:
        """Rollouts evicted as over-stale (should be rare under capacity ctl)."""
        self.in_flight -= n
        if self.in_flight < 0:
            raise RuntimeError("dropped more rollouts than launched")

    def bump_version(self) -> int:
        self.version += 1
        return self.version

    def record_plan_swap(self) -> int:
        """An elastic replan swapped the execution plan under this stream.

        A swap changes *where* rollouts run, never the weight-version
        stream: ``version``, ``in_flight``, and the η admission rule carry
        over unchanged — that is what preserves the staleness bound across
        the swap.  We only bump the plan epoch and log the (epoch, version)
        pair so consumed batches can be attributed to plan generations.
        """
        self.plan_epoch += 1
        self._swap_log.append((self.plan_epoch, self.version))
        return self.plan_epoch

    # ------------------------------------------------------------------ stats
    def mean_staleness(self) -> float:
        h = self._staleness_hist
        return sum(h) / len(h) if h else 0.0

    def max_staleness(self) -> int:
        return max(self._staleness_hist) if self._staleness_hist else 0

    def swap_history(self) -> List[tuple]:
        """[(plan_epoch, version_at_swap), ...] — provenance of replans."""
        return list(self._swap_log)


def adaptive_delta(run_window, config: StalenessConfig,
                   rel_tol: float = 0.05) -> int:
    """§4.2.2 'Optimize across different δ(η) values': start from δ0 and double
    until the resulting plan's *per-step* cost stabilizes.

    ``run_window(delta) -> float`` returns the δ-step objective max{C_T,C_I};
    we normalize per step and stop when successive values agree within rel_tol.
    """
    delta = config.delta0()
    prev = run_window(delta) / delta
    while delta * 2 <= config.delta_max:
        nxt = run_window(delta * 2) / (delta * 2)
        if abs(nxt - prev) <= rel_tol * max(abs(prev), 1e-12):
            break
        delta *= 2
        prev = nxt
    return delta
