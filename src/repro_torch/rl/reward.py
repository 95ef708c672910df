"""Reward stage: rule-based math verification (paper's setting), the port
of ``repro.rl.reward``.

The scheduler treats reward latency as a profiled constant (§4.2.2); the
runtime implements it as host-side exact-match verification: pure CPU
work (sandbox/rule-based in the paper) that runs while the accelerators
generate/train.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.data.tasks import MathTaskGenerator
from .buffer import Rollout


@dataclass
class RewardStats:
    n: int = 0
    total: float = 0.0
    wall_s: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class RuleBasedReward:
    """Exact-match math verification; profiles its own constant cost."""

    def __init__(self, gen: MathTaskGenerator, shaped: bool = False):
        self.gen = gen
        self.shaped = shaped
        self.stats = RewardStats()

    def score(self, rollout: Rollout) -> float:
        t0 = time.perf_counter()
        r = self.gen.reward(rollout.task, rollout.completion_ids,
                            shaped=self.shaped)
        self.stats.n += 1
        self.stats.total += r
        self.stats.wall_s += time.perf_counter() - t0
        return r

    def score_batch(self, rollouts: Sequence[Rollout]) -> List[float]:
        out = []
        for ro in rollouts:
            r = self.score(ro)
            ro.reward = r
            out.append(r)
        return out

    def profiled_cost_s(self) -> float:
        """Mean seconds per verification — feeds C_Reward in the scheduler."""
        return self.stats.wall_s / self.stats.n if self.stats.n else 1e-4
