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
    return_lse: bool = False,
):
    """``[B, H, D]``; with ``return_lse`` also each head's log-sum-exp of
    its scaled scores over the attended slots, float32 ``[B, H]``
    (``NEG_INF`` where none): the kernel's ``lse`` output."""
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
    o = o.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(any_ok[..., 0], torch.logsumexp(s, dim=-1),
                      torch.full_like(s[..., 0], NEG_INF))
    return o, lse.reshape(B, H)


def decode_scores_ref(
    q: torch.Tensor,         # [B, H, Dl]       a slice of each head's dims
    k: torch.Tensor,         # [B, C, Hkv, Dl]  the same slice of the cache
    *,
    scale: float,
) -> torch.Tensor:
    """Pass 1 of the decode over a head-dim slice: the partial scaled
    scores ``scale * q . k`` over the slice, float32 ``[B, H, C]``, no
    mask (the slices' scores are summed before it)."""
    B, H, D = q.shape
    _, C, Hkv, _ = k.shape
    s = torch.einsum("bhgd,bchd->bhgc", q.float().reshape(B, Hkv, H // Hkv, D),
                     k.float()) * scale
    return s.reshape(B, H, C)


def decode_softmax_pv_ref(
    s: torch.Tensor,         # [B, H, C] float32, summed over the slices
    v: torch.Tensor,         # [B, C, Hkv, Dl]
    q_pos: torch.Tensor,     # [B]
    k_pos: torch.Tensor,     # [B, C]
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Pass 2 of the decode over a head-dim slice: the masks of
    ``decode_attention_ref`` on the whole scores, the softmax and p . v on
    the local slice of V; ``[B, H, Dl]`` in v's dtype, 0 for a head that
    attends no slot."""
    B, H, C = s.shape
    _, _, Hkv, D = v.shape
    s = s.reshape(B, Hkv, H // Hkv, C)
    ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos > (q_pos[:, None] - window))
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    o = torch.where(torch.any(ok, dim=-1)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(B, H, D).to(v.dtype)


def merge_lse(o: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
    """Merge decode outputs over disjoint runs of the same cache rows: ``o``
    [..., B, H, D] normalised over its own run, ``lse`` [..., B, H] its
    log-sum-exp; ``reduce(x, op)`` (op "max" or "sum") reduces over the
    runs, which are a leading dim here or the ranks of a process group.  A
    head no run attended gives 0, as the kernel does."""
    m = reduce(lse, "max")
    w = torch.exp(lse - m)
    num = reduce(o.float() * w[..., None], "sum")
    den = reduce(w, "sum")
    return (num / den[..., None]).to(o.dtype)


def decode_attention_split_ref(
    q: torch.Tensor,         # [B, H, D]
    k: torch.Tensor,         # [B, C, Hkv, D]
    v: torch.Tensor,         # [B, C, Hkv, D]
    q_pos: torch.Tensor,     # [B]
    k_pos: torch.Tensor,     # [B, C]
    n_split: int,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    tile: int = 1,
) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch: the cache's
    ``ceil(C / tile)`` tiles are cut into ``n_split`` contiguous runs
    (split s takes tiles ``s * n // n_split`` up to ``(s + 1) * n //
    n_split``); each split keeps fp32 ``(acc, m, l)`` over its attended
    slots (m = NEG_INF, l = 0 where it attends none), then the splits merge
    with weights ``exp(m_s - M)``, and a head that attended nothing gives
    0."""
    B, H, D = q.shape
    _, C, Hkv, _ = k.shape
    G = H // Hkv
    n_tiles = -(-C // tile)
    if not 1 <= n_split <= n_tiles:
        raise ValueError(f"n_split={n_split} with {n_tiles} tiles")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bchd->bhgc", qf, k.float()) * scale
    ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos > (q_pos[:, None] - window))
    ok = ok[:, None, None, :]
    vf = v.float()
    parts = []
    for i in range(n_split):
        lo = min(C, i * n_tiles // n_split * tile)
        hi = min(C, (i + 1) * n_tiles // n_split * tile)
        si = torch.where(ok[..., lo:hi], s[..., lo:hi],
                         torch.full_like(s[..., lo:hi], NEG_INF))
        m = si.max(dim=-1).values                        # [B, Hkv, G]
        p = torch.where(ok[..., lo:hi], torch.exp(si - m[..., None]),
                        torch.zeros_like(si))
        acc = torch.einsum("bhgc,bchd->bhgd", p, vf[:, lo:hi])
        parts.append((acc, m, p.sum(dim=-1)))
    M = torch.stack([m for _, m, _ in parts]).max(dim=0).values
    acc = sum(a * torch.exp(m - M)[..., None] for a, m, _ in parts)
    den = sum(l * torch.exp(m - M) for _, m, l in parts)
    o = acc / torch.clamp(den, min=1e-30)[..., None]
    return o.reshape(B, H, D).to(q.dtype)
