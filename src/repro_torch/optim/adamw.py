"""AdamW with global-norm clipping and LR schedules, the port of
``repro.optim.adamw``.

State per parameter: ``m`` and ``v`` in float32 (``state_dtype``) and one
step count.  Params may be bfloat16: the update is computed in float32 and
cast back.  Where the reference returns new trees, the port updates the
parameter tensors and the moments in place under ``no_grad`` (one set of
weights and moments on the card, not two) and returns the metrics.

Trees are ``Params`` modules or nested dicts of tensors; the state keeps
one entry per leaf, keyed by its dotted name (``layers.attn.wq``).  As in
the reference, weight decay applies to leaves of two or more dimensions,
which for stacked layers includes the ``[L, d]`` norm scales.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Tensor]]:
    """(dotted name, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters(prefix=prefix.rstrip("."))
        return
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
        return
    yield prefix.rstrip("."), tree


def adamw_init(params: Any, cfg: AdamWConfig = AdamWConfig()) -> Dict:
    dt = getattr(torch, cfg.state_dtype)
    leaves = list(named_leaves(params))
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in leaves},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in leaves},
        "count": 0,
    }


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def adamw_update(grads: Sequence[Tensor], state: Dict, params: Any,
                 cfg: AdamWConfig = AdamWConfig(),
                 lr_scale: float = 1.0) -> Dict[str, Tensor]:
    """One AdamW step: ``params`` and ``state`` are updated in place.
    ``grads`` follow the order of ``named_leaves(params)``.  Returns
    ``{"grad_norm": ...}``."""
    leaves = list(named_leaves(params))
    if len(grads) != len(leaves):
        raise ValueError(f"adamw_update: {len(grads)} grads for "
                         f"{len(leaves)} params")
    state["count"] += 1
    count = np.float32(state["count"])
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    # bias corrections in float32, as the reference computes them
    b1c = float(np.float32(1.0) - np.float32(cfg.b1) ** count)
    b2c = float(np.float32(1.0) - np.float32(cfg.b2) ** count)
    lr = cfg.lr * lr_scale
    for (name, p), g in zip(leaves, grads):
        m, v = state["m"][name], state["v"][name]
        gf = g.float() * clip
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * gf * gf)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        if cfg.weight_decay > 0 and p.dim() >= 2:     # decay matrices only
            step = step + cfg.weight_decay * pf
        p.copy_(pf - lr * step)
    return {"grad_norm": gnorm}


# ------------------------------------------------------------------ schedules
def cosine_schedule(step: int, *, warmup: int, total: int,
                    min_frac: float = 0.1) -> float:
    s = float(step)
    warm = min(s / max(warmup, 1), 1.0)
    prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog))
    return warm * cos


def linear_schedule(step: int, *, warmup: int, total: int) -> float:
    s = float(step)
    warm = min(s / max(warmup, 1), 1.0)
    return warm * min(max(1.0 - (s - warmup) / max(total - warmup, 1), 0.0),
                      1.0)
