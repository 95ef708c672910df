"""Dense decoder-only transformer (llama / qwen / starcoder2 family) and
the VLM stub.

The port of ``repro.models.transformer``: h2o-danube (SWA), starcoder2
(GELU MLP), yi, qwen2.5 (QKV bias, tied embeddings), the paper's
qwen-distill models, and internvl2 (``family="vlm"``: the ViT frontend is
stubbed, ``patches`` arrive as precomputed patch embeddings and replace
the first ``encoder_seq`` token positions).  Stacked layers walked by a
Python loop, a preallocated ``[L, B, C, Hkv, D]`` KV cache written in
place (a ring of W slots under SWA), and attention through the
hand-written kernels on a CUDA tensor: the flash kernel (K1) once per
layer per prefill or training forward, flash decode (K3) once per layer
per decode step.  ``models.moe`` reuses these passes with its routed FFN
(the ``ffn`` argument of ``forward``, ``prefill`` and ``decode_step``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.parallel import local as _local
from . import blocks
from .api import ModelConfig
from .params import Params, layer_views

Tensor = torch.Tensor
EMPTY_POS = blocks.EMPTY_POS


# ---------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    dt, dev = cfg.tdtype, gen.device
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "attn": blocks.init_attn_params(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, dt,
                                        bias=cfg.qkv_bias),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "ffn": (blocks.init_gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, dt)
                if cfg.mlp_kind == "gelu"
                else blocks.init_swiglu_params(gen, cfg.d_model, cfg.d_ff,
                                               dt)),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: ``init`` then builds
    every tensor on meta, where the draws it is passed to are no-ops."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(seed: Union[int, torch.Generator],
              device=None) -> torch.Generator:
    """The init generator on ``device``.  On ``"meta"`` it builds the
    parameter tree's shapes and dtypes and draws nothing."""
    if isinstance(seed, torch.Generator):
        return seed
    dev = resolve_device(device)
    if dev.type == "meta":
        return _MetaGenerator("cpu").manual_seed(seed)
    return torch.Generator(device=dev).manual_seed(seed)


def init_lm(gen: torch.Generator, cfg: ModelConfig, init_layer) -> Dict:
    """Embedding, ``init_layer`` stacked over ``cfg.n_layers``, final norm
    and (untied) ``lm_head``: the tree every decoder family shares."""
    dt, dev = cfg.tdtype, gen.device
    params = {
        "embed": blocks.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "layers": _stack([init_layer(gen, cfg) for _ in range(cfg.n_layers)]),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = blocks.dense_init(gen, cfg.d_model,
                                              cfg.padded_vocab, dt)
    return params


def init(seed: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random-init parameters with the reference's names and shapes.  The
    draws come from a ``torch.Generator`` on ``device``; they are not the
    JAX draws (tests carry JAX params over with ``params_from_jax``)."""
    gen = generator(seed, device)
    params = init_lm(gen, cfg, _init_layer)
    if cfg.family == "vlm":
        params["patch_proj"] = blocks.dense_init(gen, cfg.enc_dim,
                                                 cfg.d_model, cfg.tdtype)
    return Params(params)


# ------------------------------------------------------------------- forward
def dense_ffn(x: Tensor, lp: Dict, cfg: ModelConfig) -> Tensor:
    """The dense FFN of normed x [B, S, d]: SwiGLU or the GELU MLP."""
    if cfg.mlp_kind == "gelu":
        return blocks.gelu_mlp(x, lp["ffn"])
    return blocks.swiglu(x, lp["ffn"])


FFN = Callable[[Tensor, Dict, ModelConfig], Tensor]


def _ffn_block(h: Tensor, lp: Dict, cfg: ModelConfig,
               ffn: FFN = dense_ffn) -> Tensor:
    """Residual FFN block: ``h + ffn(rms_norm(h))``."""
    return h + ffn(blocks.rms_norm(h, lp["ffn_norm"], cfg.norm_eps), lp, cfg)


def _qkv(h: Tensor, lp: Dict, positions: Tensor, cfg: ModelConfig):
    x = blocks.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = blocks.qkv_project(x, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd)
    q = blocks.apply_rope(q, positions, cfg.rope_theta)
    k = blocks.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _prompt_layer(h: Tensor, lp: Dict, positions: Tensor, cfg: ModelConfig,
                  ffn: FFN = dense_ffn):
    q, k, v = _qkv(h, lp, positions, cfg)
    o = blocks.attention(q, k, v, q_positions=positions,
                         k_positions=positions, causal=True,
                         window=cfg.attn_window, q_chunk=cfg.q_chunk,
                         kv_chunk=cfg.kv_chunk, contiguous_positions=True)
    h = h + blocks.out_project(o, lp["attn"])
    return _ffn_block(h, lp, cfg, ffn), k, v


def embed_inputs(params: Params, cfg: ModelConfig, tokens: Tensor,
                 patches: Optional[Tensor] = None) -> Tensor:
    h = _local.embed(tokens, params["embed"])
    if cfg.family == "vlm" and patches is not None:
        proj = patches.to(cfg.tdtype) @ params["patch_proj"]
        h = torch.cat([proj, h[:, patches.shape[1]:]], dim=1)
    return h


def unembed(params: Params, cfg: ModelConfig, h: Tensor) -> Tensor:
    h = blocks.rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return h @ table


def _positions(B: int, S: int, device) -> Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(params: Params, cfg: ModelConfig, tokens: Tensor,
            patches: Optional[Tensor] = None, return_hidden: bool = False,
            ffn: FFN = dense_ffn, **_) -> Tensor:
    """Training forward: tokens [B,S] (+ ``patches`` [B,P,enc_dim] for
    the VLM) -> logits [B,S,padded_vocab] (or the pre-unembed hidden
    states with ``return_hidden``).  ``cfg.remat`` recomputes each layer
    in the backward (``torch.utils.checkpoint``).  ``ffn``: each layer's
    FFN on its normed input (``models.moe`` passes its routed experts)."""
    B, S = tokens.shape
    h = embed_inputs(params, cfg, tokens, patches)
    positions = _positions(B, S, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params):
        if remat:        # recompute the layer in the backward
            h = checkpoint(lambda x, lp=lp: _prompt_layer(
                x, lp, positions, cfg, ffn)[0], h, use_reentrant=False)
        else:
            h, _, _ = _prompt_layer(h, lp, positions, cfg, ffn)
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
                token: Tensor, pos: Tensor, ffn: FFN = dense_ffn
                ) -> Tuple[Tensor, Dict]:
    """One decode step: token [B], pos [B] -> (logits [B, padded_vocab],
    cache).  Write-then-attend; the cache is updated in place and returned.
    ``ffn`` sees the step's B tokens as x [B, 1, d].

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
    _local.write_rows(cache["k_pos"], slot, pos, flat)
    h = embed_inputs(params, cfg, token[:, None])             # [B,1,D]
    positions = pos[:, None]                                  # [B,1]
    Hkv, D = cfg.n_kv_heads, cfg.hd
    for i, lp in enumerate(layer_views(params)):
        q, k, v = _qkv(h, lp, positions, cfg)
        ck, cv = cache["k"][i], cache["v"][i]                 # [B,C,Hkv,D]
        _local.write_rows(ck, slot, k[:, 0], flat)
        _local.write_rows(cv, slot, v[:, 0], flat)
        o = _local.decode_attention(q[:, 0], ck, cv, pos, cache["k_pos"],
                                    window=cfg.attn_window)[:, None]
        h = h + blocks.out_project(o, lp["attn"])
        h = _ffn_block(h, lp, cfg, ffn)
    logits = unembed(params, cfg, h[:, 0])
    return logits, cache


def ring_slots(S: int, C: int, device):
    """(cache slots, prompt positions kept) of an S-token prompt in a cache
    of C slots: all of it from slot 0 when it fits, else (SWA ring) the
    last C positions at their ring slots ``pos % C``."""
    if S <= C:
        return torch.arange(S, device=device), slice(0, S)
    return torch.arange(S - C, S, device=device) % C, slice(S - C, S)


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor, *,
            max_len: int, patches: Optional[Tensor] = None,
            ffn: FFN = dense_ffn, **_) -> Tuple[Tensor, Dict]:
    """Process the prompt, return (last-position logits, filled cache).

    All rows share prompt length = tokens.shape[1] (the engine pads
    prompts).  Each layer's K/V go straight into the preallocated cache.
    """
    B, S = tokens.shape
    C = cache_len(cfg, max_len)
    cache = _local.place_cache(
        init_cache(cfg, batch=B, max_len=max_len, device=tokens.device),
        cfg, tokens)
    h = embed_inputs(params, cfg, tokens, patches)
    positions = _positions(B, S, tokens.device)
    slots, keep = ring_slots(S, C, tokens.device)
    for i, lp in enumerate(layer_views(params)):
        h, k, v = _prompt_layer(h, lp, positions, cfg, ffn)
        _local.write_slots(cache["k"][i], slots, k[:, keep])
        _local.write_slots(cache["v"][i], slots, v[:, keep])
    _local.write_slots(cache["k_pos"], slots, positions[:, keep].contiguous())
    logits = unembed(params, cfg, h[:, -1])
    return logits, cache
