"""Paged forward passes for the dense-transformer family.

The port of ``repro.serve.model``: the same blocks, RoPE and masked
attention as ``models/transformer.py``, reading and writing the **paged**
cache.  Per step, new K/V land at logical slot ``pos`` -> physical
``(table[pos // page], pos % page)``, written in place into the pools
(``index_put_``; the reference's functional ``.at[].set``).  Decode
attention runs through ``kernels.paged_attention`` on every layer: the
hand-written kernel on a CUDA tensor, its plain version on the CPU.

Prefill is *chunked* (one sequence, ``chunk`` tokens per call): the chunk
writes its K/V into the pages first, then attends over the gathered table
with position masks (``_gather_attention``), which makes intra-chunk
causality and attention to earlier chunks one code path.  Its positions
start at ``p0`` and unwritten slots carry position -2^30, so it takes the
plain masked ``blocks.attention`` on every device, never the flash kernel
(which assumes positions ``0..S-1``), as the reference does.  The final
(ragged) chunk is right-padded; pad writes land at logical slots the
sequence will overwrite at exactly those positions later, or in the null
page when they run past the table, and every read masks by current
length, so they are unobservable.

Both functions return ``(logits, k_pages, v_pages)`` so the engine reads
as the reference's does; the pools are updated in place and returned.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models import blocks
from repro_torch.models.api import ModelConfig
from repro_torch.models.params import Params, layer_views
from repro_torch.models.transformer import (EMPTY_POS, _ffn_block, _qkv,
                                            embed_inputs, unembed)

Tensor = torch.Tensor


def _gather_attention(q: Tensor, kp: Tensor, vp: Tensor, table: Tensor,
                      q_positions: Tensor, written: int,
                      cfg: ModelConfig) -> Tensor:
    """Densify the pool rows named by ``table`` [B, maxp] and run the
    shared masked attention.  ``written`` = logical slots written so far;
    slots beyond it hold stale pool data and are masked out."""
    B = q.shape[0]
    page = kp.shape[1]
    C = table.shape[1] * page
    idx = table.long()
    kd = kp[idx].reshape(B, C, *kp.shape[2:])
    vd = vp[idx].reshape(B, C, *vp.shape[2:])
    slot = torch.arange(C, dtype=torch.int32, device=q.device).expand(B, C)
    k_pos = torch.where(slot < written, slot,
                        torch.full_like(slot, EMPTY_POS))
    return blocks.attention(q, kd, vd, q_positions=q_positions,
                            k_positions=k_pos, causal=True,
                            window=cfg.attn_window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)


def paged_decode_step(params: Params, cfg: ModelConfig, k_pages: Tensor,
                      v_pages: Tensor, block_tables: Tensor, token: Tensor,
                      pos: Tensor, active: Tensor,
                      max_len: Optional[int] = None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """One decode token for every slot: token [S], pos [S], active [S]
    (int32) -> (logits [S, padded_vocab], k_pages, v_pages).

    ``max_len``, a host integer (the engine's largest ``pos`` + 1), is
    handed to every layer's ``paged_decode_attention``, whose split count
    then runs over the longest row instead of the table's width; it never
    changes the result.

    ``block_tables`` is the FULL int32 device table (the engine keeps a
    cached copy and re-uploads it only when the allocator dirtied it);
    ``active`` masks the slots decoding this step.  Inactive slots ride
    along with pos=0 and their table row zeroed *here* — writes land in
    the null page and their logits are garbage the engine discards — so
    the cached table never needs per-step editing on the host.
    """
    S = token.shape[0]
    page = k_pages.shape[2]
    tables = torch.where(active[:, None] > 0, block_tables,
                         torch.zeros_like(block_tables))
    h = embed_inputs(params, cfg, token[:, None])                 # [S,1,d]
    positions = pos[:, None]
    rows = torch.arange(S, device=pos.device)
    page_of = tables[rows, (pos // page).long()].long()           # [S]
    off = (pos % page).long()
    lengths = pos + 1
    for i, lp in enumerate(layer_views(params)):
        q, k, v = _qkv(h, lp, positions, cfg)
        kp, vp = k_pages[i], v_pages[i]                 # [P, page, Hkv, D]
        kp.index_put_((page_of, off), k[:, 0].to(kp.dtype))
        vp.index_put_((page_of, off), v[:, 0].to(vp.dtype))
        o = paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                   window=cfg.attn_window,
                                   max_len=max_len)[:, None]
        h = h + blocks.out_project(o, lp["attn"])
        h = _ffn_block(h, lp, cfg)
    logits = unembed(params, cfg, h[:, 0])
    return logits, k_pages, v_pages


def paged_prefill_chunk(params: Params, cfg: ModelConfig, k_pages: Tensor,
                        v_pages: Tensor, table_row: Tensor, tokens: Tensor,
                        p0: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Process ``tokens`` [chunk] of one sequence starting at absolute
    position ``p0``: (logits [chunk, padded_vocab], k_pages, v_pages).

    Writes the chunk's K/V into the pages, then attends over the whole
    gathered table — earlier chunks and intra-chunk causality fall out of
    the position masks.  The caller reads the logits row of the last
    *valid* token when the chunk completes the prompt.
    """
    (C,) = tokens.shape
    page = k_pages.shape[2]
    maxp = table_row.shape[0]
    h = embed_inputs(params, cfg, tokens[None])                   # [1,C,d]
    positions = (p0 + torch.arange(C, dtype=torch.int32,
                                   device=tokens.device))[None]   # [1,C]
    pidx = (positions[0] // page).long()
    # pad rows can run past the table (p0 + C > maxp·page near max_len);
    # an unclamped gather would alias them onto the LAST real page and the
    # scatter would corrupt valid prompt K/V — route them to the null page
    page_of = torch.where(pidx < maxp,
                          table_row[torch.clamp(pidx, max=maxp - 1)].long(),
                          torch.zeros_like(pidx))                 # [C]
    off = (positions[0] % page).long()
    table = table_row[None]
    for i, lp in enumerate(layer_views(params)):
        q, k, v = _qkv(h, lp, positions, cfg)
        kp, vp = k_pages[i], v_pages[i]
        kp.index_put_((page_of, off), k[0].to(kp.dtype))
        vp.index_put_((page_of, off), v[0].to(vp.dtype))
        o = _gather_attention(q, kp, vp, table, positions, p0 + C, cfg)
        h = h + blocks.out_project(o, lp["attn"])
        h = _ffn_block(h, lp, cfg)
    logits = unembed(params, cfg, h[0])
    return logits, k_pages, v_pages
