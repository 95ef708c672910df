"""Agentic multi-turn rollouts: a simulated env/tool pool + episode driver.

The port of ``repro.rl.agentic``, over the port's ``serve.PagedEngine``
and its own copy of ``EnvCostModel`` (``core.cost_model``).  The same
seed gives the same observations and the same latency draws as the
reference.

The paper's workload is single-turn GRPO; agentic RL adds a third stage to
the pipeline — between assistant turns the episode leaves the GPU and
waits on an env/tool call (search, code execution, game step).  Two things
change for the scheduler:

  * **Latency** — every inter-turn gap is wall time a decode slot holds
    pages but generates nothing.  ``EnvConfig.cost_model()`` exports the
    pool's latency distribution as a ``core.cost_model.EnvCostModel`` so
    ``schedule``/``schedule_pool`` price it (deflated per-config h_ψ +
    a C_I env term) and the simulator samples it (``SimConfig.env``).
  * **Prefix reuse** — turn k's prompt is turn k−1's full history plus a
    small tool-observation delta.  With ``ServeConfig.radix`` on, the
    engine's cross-request radix cache serves the history from cached
    pages and prefills only the delta; the measured hit rate flows back
    through ``EngineReport.g_eff`` into replica pricing.

``SimToolEnv`` is deliberately *deterministic in tokens*: the observation
is a pure function of the conversation history, so a cold-cache and a
warm-cache engine replay token-identical episodes (the fig12 identity
gate).  Latency is stochastic but only *accounted* (simulated seconds,
never slept) — this is a single-host reproduction of the pool, not a real
tool sandbox.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import EnvCostModel
from repro_torch.data.tasks import MathTask, Tokenizer
from .buffer import Rollout


@dataclass
class EnvConfig:
    """Simulated env/tool pool: shape of the third pipeline stage."""

    turns: int = 2                 # assistant turns per episode
    tool_tokens: int = 12          # observation tokens injected per gap
    mean_s: float = 0.05           # mean tool-call latency (simulated)
    cv: float = 0.5                # latency coefficient of variation
    workers: int = 64              # concurrent env workers in the pool
    overlap: float = 0.0           # fraction hidden by pipelined decode
    max_new_per_turn: Optional[int] = None   # None → engine default
    seed: int = 0

    def cost_model(self) -> EnvCostModel:
        """Export the pool as the scheduler/simulator cost model."""
        return EnvCostModel(mean_s=self.mean_s, cv=self.cv,
                            turns=float(self.turns), workers=self.workers,
                            overlap=self.overlap)


class SimToolEnv:
    """Deterministic-token, stochastic-latency simulated tool pool.

    ``observe(history)`` derives the observation from a rolling hash of
    the history tokens — same history, same observation, regardless of
    which engine (or cache state) produced it.  ``latency()`` draws from
    the config's lognormal and accrues ``total_wait_s``; nothing sleeps.
    """

    def __init__(self, cfg: Optional[EnvConfig] = None):
        self.cfg = cfg or EnvConfig()
        self._lat_rng = np.random.default_rng(self.cfg.seed)
        self._env = self.cfg.cost_model()
        self.calls = 0
        self.total_wait_s = 0.0

    def observe(self, history: Sequence[int]) -> List[int]:
        """Tool observation for this conversation state (pure function)."""
        h = (self.cfg.seed * 2654435761 + 97531) & 0xFFFFFFFFFFFFFFFF
        for t in history:
            h = (h * 1000003 + t + 1) & 0xFFFFFFFFFFFFFFFF
        rng = np.random.default_rng(h)
        toks = rng.integers(Tokenizer.OFFSET, Tokenizer.OFFSET + 256,
                            size=self.cfg.tool_tokens)
        return [int(x) for x in toks]

    def latency(self) -> float:
        """One tool call's simulated wall time (accrued, not slept)."""
        self.calls += 1
        dt = float(self._env.sample_gaps(self._lat_rng, 1)[0])
        self.total_wait_s += dt
        return dt


@dataclass
class Episode:
    """One multi-turn conversation: per-turn rollouts + env accounting."""

    turns: List[Rollout] = field(default_factory=list)
    env_wait_s: float = 0.0

    @property
    def final(self) -> Rollout:
        return self.turns[-1]

    @property
    def history(self) -> List[int]:
        r = self.final
        return list(r.prompt_ids) + list(r.completion_ids)

    @property
    def total_tokens(self) -> int:
        return len(self.history)


class MultiTurnDriver:
    """Batched episode driver over a ``serve.PagedEngine``.

    Turn 1 is a plain batch submission; every later turn calls
    ``engine.resume(prev, observation)`` so admission can serve the
    history from the radix tree and prefill only the observation delta.
    All episodes advance turn-by-turn in lockstep — the batched shape is
    what makes cross-episode page sharing visible to the engine.
    """

    def __init__(self, engine, env: Optional[SimToolEnv] = None):
        self.engine = engine
        self.env = env or SimToolEnv()

    def run(self, tasks: Sequence[MathTask], *,
            group_ids: Optional[Sequence[int]] = None,
            temperature: Optional[float] = None,
            top_p: Optional[float] = None,
            greedy: Optional[bool] = None,
            ) -> Tuple[List[Episode], Dict]:
        """Run one episode per task; returns (episodes, engine+env metrics).

        Turn matching is by submission order: the engine packages finished
        requests sorted by submission index, and each turn submits every
        episode exactly once in episode order.
        """
        eng = self.engine
        cfg = self.env.cfg
        n = len(tasks)
        gids = list(group_ids) if group_ids is not None else list(range(n))
        mnew = (None if cfg.max_new_per_turn is None
                else [cfg.max_new_per_turn] * n)
        st0 = _stats_snapshot(eng)

        n0 = eng.stats.completed
        eng.submit(tasks, group_ids=gids, max_new_per_task=mnew,
                   temperature=temperature, top_p=top_p, greedy=greedy)
        eng.drain()
        first, _ = eng.collect(n0)
        episodes = [Episode(turns=[r]) for r in first]

        for _turn in range(1, cfg.turns):
            n0 = eng.stats.completed
            for ep in episodes:
                obs = self.env.observe(ep.history)
                ep.env_wait_s += self.env.latency()
                eng.resume(ep.final, obs,
                           max_new=cfg.max_new_per_turn,
                           temperature=temperature, top_p=top_p,
                           greedy=greedy)
            eng.drain()
            nxt, _ = eng.collect(n0)
            assert len(nxt) == len(episodes)
            for ep, r in zip(episodes, nxt):
                ep.turns.append(r)

        metrics = _stats_delta(eng, st0)
        metrics.update(
            episodes=n, turns=cfg.turns,
            env_calls=self.env.calls,
            env_wait_s=round(self.env.total_wait_s, 6),
            turn_gap_s=(self.env.total_wait_s / self.env.calls
                        if self.env.calls else 0.0),
        )
        return episodes, metrics


# --------------------------------------------------------------- accounting
_DELTA_FIELDS = ("prefill_tokens", "prefill_tokens_shared",
                 "radix_hit_tokens", "tokens_generated", "forks",
                 "cow_copies", "preemptions", "completed")


def _stats_snapshot(eng) -> Dict[str, int]:
    return {f: getattr(eng.stats, f) for f in _DELTA_FIELDS}


def _stats_delta(eng, st0: Dict[str, int]) -> Dict:
    d = {f: getattr(eng.stats, f) - st0[f] for f in _DELTA_FIELDS}
    logical = d["prefill_tokens"] + d["prefill_tokens_shared"]
    d["prefix_hit_rate"] = (d["prefill_tokens_shared"] / logical
                            if logical else 0.0)
    d["radix_hit_rate"] = (d["radix_hit_tokens"] / logical
                           if logical else 0.0)
    d["g_eff"] = (logical / d["prefill_tokens"]
                  if d["prefill_tokens"] else 1.0)
    return d
