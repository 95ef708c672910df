"""GRPO with AReaL's decoupled (behavior vs proximal) objective, the port
of ``repro.rl.grpo``.

Pieces:
  * ``group_advantages`` -- GRPO group-relative advantage normalisation
                            (numpy, the trainer's host data path).
  * ``grpo_loss``        -- clipped policy-gradient loss with the
                            decoupled importance weight for stale rollouts
                            and the k3 KL term.
  * ``make_train_step``  -- the GRPO policy update: forward, backward
                            (autograd through the hand-written kernels'
                            recompute backwards) and AdamW, in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.api import ModelConfig, get_model
from repro_torch.parallel import local as _local
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     named_leaves)

Tensor = torch.Tensor


# ------------------------------------------------------------ advantages
def group_advantages(rewards: np.ndarray, group_ids: np.ndarray,
                     eps: float = 1e-6) -> np.ndarray:
    """advantage = (r - mean_group) / (std_group + eps); rewards [N],
    group_ids [N] (same id = the same prompt's rollout group)."""
    adv = np.zeros_like(rewards, dtype=np.float64)
    for g in np.unique(group_ids):
        m = group_ids == g
        r = rewards[m]
        adv[m] = (r - r.mean()) / (r.std() + eps)
    return adv.astype(np.float32)


# ------------------------------------------------------------------- loss
def token_logp_from_logits(logits: Tensor, targets: Tensor) -> Tensor:
    """log p(target) per position, float32.  logits [B,S,V], targets [B,S].
    Sharded logits take the vocab-parallel form (``parallel.local``)."""
    if _local.is_dt(logits):
        return _local.vocab_logp(logits, targets)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return tgt - lse


def grpo_loss(
    logits: Tensor,             # [B, S, V] (next-token logits at each pos)
    tokens: Tensor,             # [B, S]
    behavior_logp: Tensor,      # [B, S] logp under the rollout policy
    advantages: Tensor,         # [B]
    loss_mask: Tensor,          # [B, S] 1.0 on response tokens (targets)
    *,
    clip_eps: float = 0.2,
    prox_logp: Optional[Tensor] = None,      # decoupled objective (AReaL)
    kl_coef: float = 0.0,
    ref_logp: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Clipped GRPO objective.  Position t predicts token t+1; the mask
    (aligned with targets) selects response tokens."""
    targets = tokens[:, 1:]
    mask = loss_mask[:, 1:].float()
    logp = token_logp_from_logits(logits[:, :-1], targets)      # [B, S-1]
    b_logp = behavior_logp[:, 1:]
    adv = advantages[:, None].float()

    if prox_logp is not None:
        # AReaL decoupled PPO: ratio against the proximal policy; the
        # stale behaviour gap enters as a stop-gradient importance weight
        p_logp = prox_logp[:, 1:]
        ratio = torch.exp(logp - p_logp)
        iw = torch.clamp(torch.exp(p_logp - b_logp), 0.0, 2.0).detach()
    else:
        ratio = torch.exp(logp - b_logp)
        iw = 1.0

    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    pg = -torch.minimum(unclipped, clipped) * iw

    if kl_coef > 0.0 and ref_logp is not None:
        # k3 estimator (non-negative, unbiased)
        r = ref_logp[:, 1:] - logp
        pg = pg + kl_coef * (torch.exp(r) - r - 1.0)

    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(pg * mask) / denom
    metrics = {
        "loss": loss,
        "mean_ratio": torch.sum(ratio * mask) / denom,
        "clip_frac": torch.sum((torch.abs(ratio - 1.0) > clip_eps) * mask)
        / denom,
        "entropy_proxy": -torch.sum(logp * mask) / denom,
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


# -------------------------------------------------------------- train step
def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    *, clip_eps: float = 0.2,
                    decoupled: bool = False) -> Callable:
    """Build the GRPO policy-update step:

        train_step(params, opt_state, batch) -> (params, opt_state, metrics)

    ``params`` is a trainable ``Params`` (``requires_grad``), updated in
    place with ``opt_state``; ``batch`` holds tokens / loss_mask /
    advantages / behavior_logp tensors on the params' device (+ frames /
    patches for the stub-frontend archs, + prox_logp when decoupled).
    Metrics are 0-dim tensors with the reference's names."""
    model = get_model(cfg)

    def loss_fn(params, batch):
        if cfg.loss_chunk and cfg.family in ("dense", "vlm"):
            return _chunked_grpo_loss(model, params, cfg, batch, clip_eps)
        logits = model.forward(
            params, cfg, batch["tokens"],
            frames=batch.get("frames"), patches=batch.get("patches"))
        return grpo_loss(
            logits, batch["tokens"], batch["behavior_logp"],
            batch["advantages"], batch["loss_mask"], clip_eps=clip_eps,
            prox_logp=batch.get("prox_logp") if decoupled else None,
            kl_coef=0.0)

    def train_step(params, opt_state, batch):
        leaves = [p for _, p in named_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics.update(adamw_update(grads, opt_state, params, opt_cfg))
        return params, opt_state, metrics

    return train_step


def _chunked_grpo_loss(model, params, cfg: ModelConfig, batch: Dict,
                       clip_eps: float):
    """Sequence-chunked unembed + loss: never materialises the full
    [B, S, V] logits.  Each chunk is recomputed in the backward
    (``torch.utils.checkpoint``) instead of saving its logits."""
    h = model.forward(params, cfg, batch["tokens"],
                      frames=batch.get("frames"),
                      patches=batch.get("patches"), return_hidden=True)
    B, S = batch["tokens"].shape
    n = max(1, S // cfg.loss_chunk)
    targets = torch.roll(batch["tokens"], -1, dims=1)      # t predicts t+1
    mask = torch.roll(batch["loss_mask"].float(), -1, dims=1)
    mask[:, -1] = 0.0
    blogp = torch.roll(batch["behavior_logp"], -1, dims=1)
    adv = batch["advantages"][:, None].float()

    def chunk(hc, tc, mc, bc):
        logits = model.unembed(params, cfg, hc).float()
        lp = token_logp_from_logits(logits, tc)
        ratio = torch.exp(lp - bc)
        unc = ratio * adv
        cl = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
        pg = -torch.minimum(unc, cl)
        return torch.sum(pg * mc), torch.sum(mc)

    def split(x):
        return x.reshape(B, n, S // n, *x.shape[2:]).transpose(0, 1)

    args = [split(x) for x in (h, targets, mask, blogp)]
    num, den = 0.0, 0.0
    for i in range(n):
        a, b = checkpoint(chunk, *(x[i] for x in args), use_reentrant=False)
        num, den = num + a, den + b
    loss = num / torch.clamp(den, min=1.0)
    one = torch.ones((), device=h.device)
    return loss, {"loss": loss.detach(), "mean_ratio": one,
                  "clip_frac": 0.0 * one, "entropy_proxy": 0.0 * one}


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, cache, token, pos) -> (logits, cache) — one decode
    token for the whole batch (what decode_* shapes run)."""
    model = get_model(cfg)

    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cfg, cache, token, pos)

    return serve_step


def make_prefill(cfg: ModelConfig, max_len: int) -> Callable:
    model = get_model(cfg)

    def prefill_fn(params, tokens, **extras):
        return model.prefill(params, cfg, tokens, max_len=max_len, **extras)

    return prefill_fn
