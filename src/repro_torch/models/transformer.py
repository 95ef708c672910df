"""Dense decoder-only transformer (qwen / llama family).

The port of ``repro.models.transformer`` for ``family="dense"``: stacked
layers walked by a Python loop, a preallocated ``[L, B, C, Hkv, D]`` KV
cache written in place, and attention through the hand-written kernels on
a CUDA tensor (flash prefill: one launch per layer per prefill; flash
decode: one launch per layer per decode step).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from . import blocks
from .api import ModelConfig
from .params import Params, layer_views

Tensor = torch.Tensor
EMPTY_POS = -(2 ** 30)            # k_pos of an empty cache slot


# ---------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(f"mlp_kind {cfg.mlp_kind!r} (ROADMAP M8)")
    dt, dev = cfg.tdtype, gen.device
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": blocks.init_attn_params(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, dt,
                                        bias=cfg.qkv_bias),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "ffn": blocks.init_swiglu_params(gen, cfg.d_model, cfg.d_ff, dt),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init(seed: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random-init parameters with the reference's names and shapes.  The
    draws come from a ``torch.Generator`` on ``device``; they are not the
    JAX draws (tests carry JAX params over with ``params_from_jax``)."""
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dt, dev = cfg.tdtype, gen.device
    params = {
        "embed": blocks.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "layers": _stack([_init_layer(gen, cfg) for _ in range(cfg.n_layers)]),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = blocks.dense_init(gen, cfg.d_model,
                                              cfg.padded_vocab, dt)
    return Params(params)


# ------------------------------------------------------------------- forward
def _ffn_block(h: Tensor, lp: Dict, cfg: ModelConfig) -> Tensor:
    x = blocks.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + blocks.swiglu(x, lp["ffn"])


def _qkv(h: Tensor, lp: Dict, positions: Tensor, cfg: ModelConfig):
    x = blocks.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = blocks.qkv_project(x, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd)
    q = blocks.apply_rope(q, positions, cfg.rope_theta)
    k = blocks.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _prompt_layer(h: Tensor, lp: Dict, positions: Tensor, cfg: ModelConfig):
    q, k, v = _qkv(h, lp, positions, cfg)
    o = blocks.attention(q, k, v, q_positions=positions,
                         k_positions=positions, causal=True,
                         window=cfg.attn_window, q_chunk=cfg.q_chunk,
                         kv_chunk=cfg.kv_chunk, contiguous_positions=True)
    h = h + blocks.out_project(o, lp["attn"])
    return _ffn_block(h, lp, cfg), k, v


def embed_inputs(params: Params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return F.embedding(tokens, params["embed"])


def unembed(params: Params, cfg: ModelConfig, h: Tensor) -> Tensor:
    h = blocks.rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return h @ table


def _positions(B: int, S: int, device) -> Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(params: Params, cfg: ModelConfig, tokens: Tensor,
            return_hidden: bool = False) -> Tensor:
    """Training forward: tokens [B,S] -> logits [B,S,padded_vocab] (or the
    pre-unembed hidden states with ``return_hidden``).  ``cfg.remat``
    recomputes each layer in the backward (``torch.utils.checkpoint``)."""
    B, S = tokens.shape
    h = embed_inputs(params, cfg, tokens)
    positions = _positions(B, S, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params):
        if remat:        # recompute the layer in the backward
            h = checkpoint(lambda x, lp=lp: _prompt_layer(
                x, lp, positions, cfg)[0], h, use_reentrant=False)
        else:
            h, _, _ = _prompt_layer(h, lp, positions, cfg)
    if return_hidden:
        return h
    return unembed(params, cfg, h)


# -------------------------------------------------------------------- decode
def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Linear cache for full attention; ring buffer of W for SWA."""
    if cfg.attn_window is not None:
        return min(cfg.attn_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, *, batch: int, max_len: int,
               device=None) -> Dict[str, Tensor]:
    C = cache_len(cfg, max_len)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
        # absolute position held in each slot; -2^30 = empty (always masked)
        "k_pos": torch.full((batch, C), EMPTY_POS, dtype=torch.int32,
                            device=dev),
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Tensor],
                token: Tensor, pos: Tensor) -> Tuple[Tensor, Dict]:
    """One decode step: token [B], pos [B] -> (logits [B, padded_vocab],
    cache).  Write-then-attend; the cache is updated in place and returned.

    Works for both full attention (slot = min(pos, C-1)) and SWA (ring slot
    = pos % W).
    """
    B = token.shape[0]
    C = cache["k"].shape[2]
    pos = pos.to(torch.int32)
    ring = cfg.attn_window is not None
    slot = (pos % C) if ring else torch.clamp(pos, max=C - 1)
    # row-major [B, C] flat index of each row's write slot
    flat = torch.arange(B, device=pos.device) * C + slot.long()
    cache["k_pos"].view(-1).index_copy_(0, flat, pos)
    h = embed_inputs(params, cfg, token[:, None])             # [B,1,D]
    positions = pos[:, None]                                  # [B,1]
    Hkv, D = cfg.n_kv_heads, cfg.hd
    for i, lp in enumerate(layer_views(params)):
        q, k, v = _qkv(h, lp, positions, cfg)
        ck, cv = cache["k"][i], cache["v"][i]                 # [B,C,Hkv,D]
        ck.view(B * C, Hkv, D).index_copy_(0, flat, k[:, 0].to(ck.dtype))
        cv.view(B * C, Hkv, D).index_copy_(0, flat, v[:, 0].to(cv.dtype))
        o = decode_attention(q[:, 0], ck, cv, pos, cache["k_pos"],
                             window=cfg.attn_window)[:, None]
        h = h + blocks.out_project(o, lp["attn"])
        h = _ffn_block(h, lp, cfg)
    logits = unembed(params, cfg, h[:, 0])
    return logits, cache


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor, *,
            max_len: int) -> Tuple[Tensor, Dict]:
    """Process the prompt, return (last-position logits, filled cache).

    All rows share prompt length = tokens.shape[1] (the engine pads
    prompts).  Each layer's K/V go straight into the preallocated cache.
    """
    B, S = tokens.shape
    C = cache_len(cfg, max_len)
    cache = init_cache(cfg, batch=B, max_len=max_len, device=tokens.device)
    h = embed_inputs(params, cfg, tokens)
    positions = _positions(B, S, tokens.device)
    if S <= C:
        slots = torch.arange(S, device=tokens.device)
        keep = slice(0, S)
    else:
        # SWA ring: keep the last C positions, placed at their ring slots.
        slots = torch.arange(S - C, S, device=tokens.device) % C
        keep = slice(S - C, S)
    for i, lp in enumerate(layer_views(params)):
        h, k, v = _prompt_layer(h, lp, positions, cfg)
        cache["k"][i].index_copy_(1, slots, k[:, keep].to(cache["k"].dtype))
        cache["v"][i].index_copy_(1, slots, v[:, keep].to(cache["v"].dtype))
    cache["k_pos"].index_copy_(1, slots, positions[:, keep].contiguous())
    logits = unembed(params, cfg, h[:, -1])
    return logits, cache
