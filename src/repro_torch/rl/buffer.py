"""Rollout record (the ``Rollout`` dataclass of ``repro.rl.buffer``).

The staleness-bounded ``RolloutBuffer`` comes with the trainer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np


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
