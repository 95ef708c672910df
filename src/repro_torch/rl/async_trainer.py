"""The asynchronous GRPO driver (AReaL architecture, logical asynchrony),
the port of ``repro.rl.async_trainer``.

Producer: a rollout engine generates GRPO groups (G completions per
prompt) under the buffer's capacity control.  Consumer: the trainer pops
admissible batches, computes group advantages, runs the GRPO policy update
(forward and backward through the hand-written kernels, AdamW in place)
and publishes new weights.  On one host the interleaving is logical:
rollouts carry real weight versions, the buffer enforces the staleness
bound eta exactly, and generation is interruptible mid-sequence (weight
swap at segment boundaries).

``engine="static"`` (``RolloutEngine``) serves every ported family;
``engine="paged"`` (``serve.PagedEngine``, one prefill per GRPO group) and
``agentic`` multi-turn episodes serve the dense family.  The trainer's
parameters are its own trainable copy on ``device``; engines fetch frozen
copies from the ``WeightStore``.  The ``trace`` / ``metrics`` /
``monitor`` hooks are duck-typed like the reference's ``repro.obs``
objects; ``None`` skips every hook.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.staleness import StalenessConfig
from repro_torch.data.tasks import MathTaskGenerator, Tokenizer
from repro_torch.device import resolve_device
from repro_torch.models.api import ModelConfig, get_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from .agentic import EnvConfig, MultiTurnDriver, SimToolEnv
from .buffer import Rollout, RolloutBuffer
from .grpo import group_advantages, make_train_step
from .reward import RuleBasedReward
from .rollout import GenConfig, RolloutEngine
from .weight_sync import WeightStore


@dataclass
class TrainerConfig:
    group_size: int = 4                  # GRPO completions per prompt
    prompts_per_step: int = 4            # prompts consumed per train step
    seq_len: int = 160                   # packed train sequence length
    total_steps: int = 20
    publish_every: int = 1               # weight publish cadence (steps)
    # "static" -> right-padded RolloutEngine (every family); "paged" -> the
    # continuous-batching serve.PagedEngine, which prefills each GRPO
    # group's prompt once and COW-forks the G-1 siblings (dense family)
    engine: str = "static"
    staleness: StalenessConfig = field(default_factory=lambda:
                                       StalenessConfig(eta=2,
                                                       rollouts_per_step=16))
    opt: AdamWConfig = field(default_factory=lambda: AdamWConfig(lr=3e-5))
    seed: int = 0
    # multi-turn agentic episodes (requires engine="paged"): training
    # consumes the final turn of each episode.  None = single-turn.
    agentic: Optional[EnvConfig] = None
    trace: Optional[Any] = None          # tracer (now/span/instant/...)
    metrics: Optional[Any] = None        # obs.metrics.MetricsRegistry
    monitor: Optional[Any] = None        # health monitor (on_stall/...)


def _batch_from_rollouts(rollouts: List[Rollout], seq_len: int, vocab: int,
                         device=None) -> Dict[str, torch.Tensor]:
    """Pad/truncate rollouts into fixed [B, S] training tensors."""
    B = len(rollouts)
    tokens = np.full((B, seq_len), Tokenizer.PAD, np.int64)
    mask = np.zeros((B, seq_len), np.float32)
    blogp = np.zeros((B, seq_len), np.float32)
    rewards = np.array([r.reward for r in rollouts], np.float64)
    groups = np.array([r.group_id for r in rollouts])
    adv = group_advantages(rewards, groups)
    for i, r in enumerate(rollouts):
        ids = (r.prompt_ids + r.completion_ids)[:seq_len]
        tokens[i, :len(ids)] = ids
        p = len(r.prompt_ids)
        comp_end = min(len(ids), seq_len)
        mask[i, p:comp_end] = 1.0
        lp = r.behavior_logp[:max(0, comp_end - p)]
        blogp[i, p:p + len(lp)] = lp
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in (
        ("tokens", tokens), ("loss_mask", mask), ("behavior_logp", blogp),
        ("advantages", adv))}


class AsyncGRPOTrainer:
    """End-to-end async RL on one host: real model, real updates."""

    def __init__(self, cfg: ModelConfig,
                 tc: Optional[TrainerConfig] = None, device=None):
        tc = tc if tc is not None else TrainerConfig()
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        # autograd needs normal tensors: never build these in inference mode
        with torch.inference_mode(False):
            self.params = self.model.init(tc.seed, cfg, self.device)
            self.params.requires_grad_(True)
            self.opt_state = adamw_init(self.params, tc.opt)
        self.train_step = make_train_step(cfg, tc.opt)
        self.store = WeightStore()
        self.store.publish(self.params)
        self.buffer = RolloutBuffer(tc.staleness, metrics=tc.metrics)
        # version counters must agree: store starts at 1 (initial publish)
        self.buffer.ctl.version = self.store.version
        self.tasks = MathTaskGenerator(seed=tc.seed)
        self.rewarder = RuleBasedReward(self.tasks, shaped=True)
        gen = GenConfig(max_new_tokens=48, segment=12)
        self.driver: Optional[MultiTurnDriver] = None
        if tc.agentic is not None and tc.engine != "paged":
            raise ValueError("TrainerConfig.agentic requires engine='paged' "
                             "(multi-turn resume needs the radix cache)")
        if tc.engine == "paged":
            from repro_torch.serve import PagedEngine, ServeConfig
            # agentic episodes grow: history accumulates max_new + the tool
            # observation per extra turn on top of the single-turn budget
            extra = 0
            if tc.agentic is not None:
                per_turn = (tc.agentic.max_new_per_turn
                            or gen.max_new_tokens) + tc.agentic.tool_tokens
                extra = (tc.agentic.turns - 1) * per_turn
            self.engine = PagedEngine(
                cfg, self.store, gen,
                ServeConfig(max_slots=tc.group_size * tc.prompts_per_step,
                            max_len=tc.seq_len + gen.max_new_tokens + extra,
                            radix=tc.agentic is not None),
                rng_seed=tc.seed + 1, tracer=tc.trace, device=self.device)
            if tc.agentic is not None:
                self.driver = MultiTurnDriver(self.engine,
                                              SimToolEnv(tc.agentic))
        elif tc.engine == "static":
            self.engine = RolloutEngine(cfg, self.store, gen,
                                        rng_seed=tc.seed + 1,
                                        device=self.device)
        else:
            raise ValueError(f"unknown engine {tc.engine!r} "
                             f"(expected 'static' or 'paged')")
        self._group_counter = 0
        self.history: List[Dict] = []
        self._last_poll = 0.0
        if tc.monitor is not None and tc.trace is not None:
            # stream the trainer/engine stage spans into the monitor
            tc.trace.add_sink(tc.monitor.on_trace_event)

    # ------------------------------------------------------------- producer
    def produce(self) -> Dict:
        """Generate one GRPO group-batch if capacity allows."""
        G = self.tc.group_size
        n_prompts = self.tc.prompts_per_step
        n = G * n_prompts
        tr = self.tc.trace
        if not self.buffer.can_launch(n):
            if tr is not None:
                tr.instant("stage", "generation", "stall_capacity", tr.now(),
                           in_flight=self.buffer.ctl.in_flight)
            mon = self.tc.monitor
            if mon is not None:
                mon.on_stall("trainer", mon.now(), "capacity")
            return {"launched": 0}
        self.buffer.launch(n)
        t0 = tr.now() if tr is not None else 0.0
        prompts = self.tasks.batch(n_prompts)
        gids = list(range(self._group_counter,
                          self._group_counter + n_prompts))
        self._group_counter += n_prompts
        if self.driver is not None:
            episodes, metrics = self.driver.run(
                [p for p in prompts for _ in range(G)],
                group_ids=[g for g in gids for _ in range(G)])
            rollouts = [e.final for e in episodes]
        else:
            rollouts, metrics = self.engine.generate_groups(prompts, G,
                                                            group_ids=gids)
        self.rewarder.score_batch(rollouts)
        for r in rollouts:
            self.buffer.push(r)
        if tr is not None:
            tr.span("stage", "generation", "produce", t0, tr.now() - t0,
                    rollouts=n, version=self.store.version)
        return {"launched": n, **metrics}

    # ------------------------------------------------------------- consumer
    def train_one(self) -> Optional[Dict]:
        need = self.tc.group_size * self.tc.prompts_per_step
        mon = self.tc.monitor
        if not self.buffer.ready(need):
            if mon is not None:
                mon.on_stall("trainer", mon.now(), "data")
            return None
        batch_rollouts = self.buffer.pop_batch(need)
        if mon is not None:
            now = mon.now()
            version = self.buffer.version
            eta = self.tc.staleness.eta
            for r in batch_rollouts:
                mon.on_staleness("trainer", now, version - r.version, eta)
            mon.on_buffer("trainer", now, len(self.buffer),
                          self.buffer.ctl.capacity)
        tr = self.tc.trace
        t0 = tr.now() if tr is not None else 0.0
        batch = _batch_from_rollouts(batch_rollouts, self.tc.seq_len,
                                     self.cfg.vocab, self.device)
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, batch)
        out = {k: float(v) for k, v in metrics.items()}   # waits for the step
        if tr is not None:
            tokens = sum(r.length for r in batch_rollouts)
            tr.span("stage", "train", "train_step", t0, tr.now() - t0,
                    tokens=tokens, rollouts=need,
                    version=self.store.version)
        return out

    def publish(self) -> int:
        """Publish the trainer's weights and advance the buffer's version
        (evicting rollouts past the bound)."""
        version = self.store.publish(self.params)
        self.buffer.bump_version()
        if self.tc.trace is not None:
            self.tc.trace.instant("stage", "sync", "publish",
                                  self.tc.trace.now(), version=version)
        return version

    # ----------------------------------------------------------------- loop
    def run(self, steps: Optional[int] = None, log_every: int = 5,
            verbose: bool = True) -> List[Dict]:
        steps = steps or self.tc.total_steps
        mon = self.tc.monitor
        step = 0
        while step < steps:
            self.produce()
            m = self.train_one()
            if mon is not None:
                now = mon.now()
                if now - self._last_poll >= mon.cfg.poll_interval_s:
                    self._last_poll = now
                    mon.poll(now)
            if m is None:
                continue
            step += 1
            if step % self.tc.publish_every == 0:
                self.publish()
            m.update(self.buffer.stats())
            m["step"] = step
            m["mean_reward"] = self.rewarder.stats.mean
            self.history.append(m)
            if verbose and step % log_every == 0:
                print(f"[step {step:4d}] loss={m['loss']:.4f} "
                      f"reward={m['mean_reward']:.3f} "
                      f"staleness={m['mean_staleness']:.2f} "
                      f"buffer={m['size']}")
        return self.history
