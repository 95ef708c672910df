"""Plain PyTorch oracle for paged decode attention, the port of
``repro/kernels/paged_attention/ref.py``.

One query token per sequence attends over a *paged* KV cache: fixed-size
pages live in a global pool ``[P, page, Hkv, D]``; each sequence owns an
ordered list of page ids (its block table).  Logical slot ``i`` of a
sequence is ``pool[table[i // page], i % page]`` and holds the token at
absolute position ``i``; only the first ``length`` slots are valid.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(
    q: torch.Tensor,             # [B, H, D] one new token per sequence
    k_pages: torch.Tensor,       # [P, page, Hkv, D] global page pool
    v_pages: torch.Tensor,       # [P, page, Hkv, D]
    block_tables: torch.Tensor,  # [B, maxp] int page ids, row-major order
    lengths: torch.Tensor,       # [B] int valid context incl. the query
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    C = maxp * page
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    idx = block_tables.long()
    kd = k_pages[idx].reshape(B, C, Hkv, D).float()
    vd = v_pages[idx].reshape(B, C, Hkv, D).float()
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bchd->bhgc", qf, kd) * scale

    pos = torch.arange(C, device=q.device)[None, :]          # logical slot
    length = lengths.long()[:, None]
    ok = pos < length
    if window is not None:
        ok = ok & (pos > (length - 1) - window)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    any_ok = torch.any(ok, dim=-1)[:, None, None, None]
    o = torch.einsum("bhgc,bchd->bhgd", p, vd)
    o = torch.where(any_ok, o, torch.zeros_like(o))
    return o.reshape(B, H, D).to(q.dtype)
