"""Rollout generation engine: prefill + KV-cache decode, interruptible.

The port of ``repro.rl.rollout``.  AReaL semantics: generation proceeds in
*segments*; at a segment boundary the engine checks the weight store and,
if a newer version exists, swaps weights mid-sequence.  A rollout records
the OLDEST version that contributed to it (conservative staleness).

Static-shape batch: prompts are left-padded with PAD to a common length
(the PAD positions are attended, as in the reference); finished rows keep
decoding (masked out on extraction).  Every call to ``prefill`` launches
the flash kernel once per layer, every decode step the flash-decode
kernel once per layer (on a CUDA device).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.data.tasks import MathTask, Tokenizer
from repro_torch.device import resolve_device
from repro_torch.models.api import ModelConfig, get_model
from .buffer import Rollout
from .weight_sync import WeightStore


@dataclass
class GenConfig:
    max_new_tokens: int = 64
    segment: int = 16              # tokens between weight-update checks
    temperature: float = 1.0
    top_p: float = 1.0             # nucleus cutoff (paged engine; 1 = off)
    greedy: bool = False
    eos_id: int = Tokenizer.EOS


class RolloutEngine:
    def __init__(self, cfg: ModelConfig, store: WeightStore,
                 gen: Optional[GenConfig] = None, rng_seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.store = store
        self.gen = gen if gen is not None else GenConfig()
        self.model = get_model(cfg)
        self.device = resolve_device(device)
        self._rng = torch.Generator(device=self.device).manual_seed(rng_seed)

    # ------------------------------------------------------------ internals
    def _fetch(self):
        """Newest version, moved to the engine's device once per fetch."""
        tree, version = self.store.fetch(dtype=self.cfg.tdtype)
        return params_from_jax(tree, self.device), version

    def _pick(self, logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(next token, its log-prob) from padded-vocab logits."""
        # the padded vocab columns of lm_head are random, not zero: slice
        logits = logits[..., :self.cfg.vocab].float()
        if self.gen.greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / self.gen.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._rng)[:, 0]
        logp = torch.log_softmax(logits, dim=-1)
        chosen = torch.gather(logp, -1, nxt[:, None])[:, 0]
        return nxt.to(torch.int32), chosen

    # -------------------------------------------------------------- generate
    def generate_groups(self, tasks: Sequence[MathTask], group_size: int, *,
                        group_ids: Optional[Sequence[int]] = None,
                        ) -> Tuple[List[Rollout], Dict]:
        """GRPO frontend: ``group_size`` completions per task, replicated
        into one padded batch (the static engine shares no KV).  Rollouts
        come back task-major with the requested group ids."""
        expanded = [t for t in tasks for _ in range(group_size)]
        rollouts, metrics = self.generate(expanded)
        for j, r in enumerate(rollouts):
            r.group_id = (j // group_size if group_ids is None
                          else int(group_ids[j // group_size]))
        return rollouts, metrics

    @torch.inference_mode()
    def generate(self, tasks: Sequence[MathTask], *,
                 group_offset: int = 0) -> Tuple[List[Rollout], Dict]:
        """Generate one completion per task.  Returns rollouts + engine
        metrics, including host-clock seconds of the first fetch, the
        prefill (to the first token on the host) and the decode loop."""
        t0 = time.perf_counter()
        params, version = self._fetch()
        versions_used = {version}
        B = len(tasks)
        prompts = [t.prompt_ids for t in tasks]
        plen = max(len(p) for p in prompts)
        padded = np.full((B, plen), Tokenizer.PAD, np.int64)
        for i, p in enumerate(prompts):
            padded[i, plen - len(p):] = p        # right-aligned
        max_len = plen + self.gen.max_new_tokens

        t1 = time.perf_counter()
        logits, cache = self.model.prefill(
            params, self.cfg, torch.from_numpy(padded).to(self.device),
            max_len=max_len)
        token, first_logp = self._pick(logits)

        out_tokens = [token.cpu().numpy()]
        out_logps = [first_logp.cpu().numpy()]
        done = out_tokens[0] == self.gen.eos_id
        swaps = 0

        t2 = time.perf_counter()
        t = 1
        while t < self.gen.max_new_tokens and not done.all():
            # interruption point: segment boundary -> adopt fresh weights
            if t % self.gen.segment == 0 and self.store.version > version:
                params, version = self._fetch()
                versions_used.add(version)
                swaps += 1
            pos = torch.full((B,), plen + t - 1, dtype=torch.int32,
                             device=self.device)
            logits, cache = self.model.decode_step(params, self.cfg, cache,
                                                   token, pos)
            token, logp = self._pick(logits)
            out_tokens.append(token.cpu().numpy())
            out_logps.append(logp.cpu().numpy())
            done |= out_tokens[-1] == self.gen.eos_id
            t += 1
        t3 = time.perf_counter()

        toks = np.stack(out_tokens, 1)           # [B, T]
        logps = np.stack(out_logps, 1)
        rollouts = []
        oldest = min(versions_used)
        for i, task in enumerate(tasks):
            row = toks[i]
            stop = np.where(row == self.gen.eos_id)[0]
            end = int(stop[0]) + 1 if len(stop) else len(row)
            rollouts.append(Rollout(
                prompt_ids=list(prompts[i]),
                completion_ids=[int(x) for x in row[:end]],
                behavior_logp=logps[i, :end].astype(np.float32),
                version=oldest,                    # conservative staleness
                group_id=group_offset + i,
                task=task,
            ))
        metrics = {"weight_swaps": swaps, "versions": sorted(versions_used),
                   "mean_len": float(np.mean([len(r.completion_ids)
                                              for r in rollouts])),
                   # every decode step runs ALL B rows, finished or not
                   "decode_steps": t - 1,
                   "decode_slot_steps": (t - 1) * B,
                   "fetch_s": t1 - t0, "prefill_s": t2 - t1,
                   "decode_s": t3 - t2}
        return rollouts, metrics
