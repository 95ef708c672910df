"""Plain PyTorch oracle for flash attention (causal / SWA / GQA), the port
of ``repro/kernels/flash_attention/ref.py``.

Materializes the full score matrix in fp32.  Positions are absolute;
empty/padded KV slots carry position < 0 and are never attended; rows with
no valid key give 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,             # [B, Sq, H, D]
    k: torch.Tensor,             # [B, Sk, Hkv, D]
    v: torch.Tensor,             # [B, Sk, Hkv, D]
    *,
    q_positions: torch.Tensor,   # [B, Sq]
    k_positions: torch.Tensor,   # [B, Sk]
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float()) * scale

    qp = q_positions[:, :, None]
    kp = k_positions[:, None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    s = torch.where(ok[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    any_ok = torch.any(ok, dim=-1)[:, :, None, None, None]
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    o = torch.where(any_ok, o, torch.zeros_like(o))
    return o.reshape(B, Sq, H, D).to(q.dtype)
