"""Plain PyTorch oracle for flash decode (one query token over a KV cache),
the port of ``repro/kernels/decode_attention/ref.py``."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,         # [B, H, D]       one new token per row
    k: torch.Tensor,         # [B, C, Hkv, D]  cache
    v: torch.Tensor,         # [B, C, Hkv, D]
    q_pos: torch.Tensor,     # [B]  absolute position of the query token
    k_pos: torch.Tensor,     # [B, C] absolute positions (-2^30 = empty slot)
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, H, D = q.shape
    _, C, Hkv, _ = k.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bchd->bhgc", qf, k.float()) * scale

    ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos > (q_pos[:, None] - window))
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    any_ok = torch.any(ok, dim=-1)[:, None, None, None]
    o = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    o = torch.where(any_ok, o, torch.zeros_like(o))
    return o.reshape(B, H, D).to(q.dtype)
