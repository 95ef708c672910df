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


def paged_decode_attention_split_ref(
    q: torch.Tensor,             # [B, H, D]
    k_pages: torch.Tensor,       # [P, page, Hkv, D]
    v_pages: torch.Tensor,       # [P, page, Hkv, D]
    block_tables: torch.Tensor,  # [B, maxp] int page ids
    lengths: torch.Tensor,       # [B] int
    n_split: int,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    tile: int = 1,
) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch.  Row b's run is the
    slots the mask can reach, ``[lo, end)`` with ``lo = max(0, len -
    window)`` and ``end = min(len, maxp * page)``; its ``ceil((end - lo) /
    tile)`` tiles are cut into ``n_split`` contiguous runs (split s takes
    tiles ``s * n // n_split`` up to ``(s + 1) * n // n_split``, so a short
    row leaves some splits empty); each split keeps fp32 ``(acc, m, l)``
    (m = NEG_INF, l = 0 where it attends nothing), then the splits merge
    with weights ``exp(m_s - M)``, and a row that attends nothing gives 0.
    Table ids are clamped into ``[0, P-1]`` as the kernel clamps them."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    G = H // Hkv
    reach = maxp * page if window is None else min(maxp * page, window)
    if not 1 <= n_split <= max(1, -(-reach // tile)):
        raise ValueError(f"n_split={n_split} with {reach} reachable slots "
                         f"in tiles of {tile}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tables = torch.clamp(block_tables.long(), 0, P - 1)
    out = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        length = int(lengths[b])
        end = min(length, maxp * page)
        lo = 0 if window is None else max(0, length - window)
        n = max(0, end - lo)
        slots = torch.arange(lo, lo + n, device=q.device)
        pid = tables[b, slots // page]
        kb = k_pages[pid, slots % page].float()              # [n, Hkv, D]
        vb = v_pages[pid, slots % page].float()
        qb = q[b].float().reshape(Hkv, G, D)
        s = torch.einsum("hgd,chd->hgc", qb, kb) * scale
        n_tiles = -(-n // tile)
        parts = []
        for i in range(n_split):
            a = min(n, i * n_tiles // n_split * tile)
            z = min(n, (i + 1) * n_tiles // n_split * tile)
            si = s[..., a:z]
            m = (si.max(dim=-1).values if z > a
                 else torch.full((Hkv, G), NEG_INF, device=q.device))
            p = torch.exp(si - m[..., None])
            acc = torch.einsum("hgc,chd->hgd", p, vb[a:z])
            parts.append((acc, m, p.sum(dim=-1)))
        M = torch.stack([m for _, m, _ in parts]).max(dim=0).values
        acc = sum(a * torch.exp(m - M)[..., None] for a, m, _ in parts)
        den = sum(l * torch.exp(m - M) for _, m, l in parts)
        out[b] = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)
