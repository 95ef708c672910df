"""Environment cost model: the ``EnvCostModel`` of
``repro.core.cost_model``, as far as the simulated tool pool
(``rl.agentic.SimToolEnv``) uses it.

The env/tool pool is the paper's third pipeline stage: ``workers``
concurrent workers with a lognormal per-call latency (``mean_s``, ``cv``).
An episode of ``turns`` turns makes ``turns - 1`` env calls; ``overlap``
is the fraction of each call hidden by continuing other work.  The same
seed gives the same gaps as the reference.  The scheduler's terms
(``calls_per_episode``, ``episode_gap_s``, ``stage_time`` and
``replica_util``, which needs ``ReplicaCost`` and ``LengthDistribution``)
come with the copy of the rest of ``core/``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class EnvCostModel:
    """Reward/environment computation priced as the third stage."""

    mean_s: float = 0.1            # mean env/tool latency per call
    cv: float = 0.5                # latency coefficient of variation
    turns: float = 1.0             # turns per episode (1 → no env stage)
    workers: int = 64              # concurrent env workers in the pool
    overlap: float = 0.0           # fraction of latency hidden by overlap
    device_type: str = "ENVPOOL"   # label in plans/reports

    def lognorm_params(self) -> Tuple[float, float]:
        sigma2 = math.log(1.0 + self.cv**2)
        mu = math.log(max(self.mean_s, 1e-9)) - sigma2 / 2.0
        return mu, math.sqrt(sigma2)

    def sample_gaps(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Un-overlapped per-call env latencies for ``n`` calls."""
        if n <= 0:
            return np.zeros(0)
        mu, s = self.lognorm_params()
        return rng.lognormal(mu, s, size=n) * (1.0 - self.overlap)
