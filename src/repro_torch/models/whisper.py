"""Whisper-small backbone (encoder-decoder) [arXiv:2212.04356], audio
frontend stubbed.

The port of ``repro.models.whisper``.  The conv frontend is stubbed:
``frames`` arrive as precomputed frame embeddings [B, encoder_seq,
enc_dim].  The encoder is a bidirectional transformer over the frames;
the decoder is causal self-attention plus cross-attention to the encoder
output.  LayerNorm, tanh-GELU MLP and biases, sinusoidal positions, tied
embeddings.

Attention on a CUDA tensor (the reference never passes ``use_pallas``
here and runs the jnp attention of the same functions):

  * the flash kernel (K1) for every prompt-side call: each encoder layer
    (non-causal, Se x Se), each decoder layer's causal self-attention and
    its cross-attention (non-causal, Sq = S against Sk = Se): 3 launches
    per layer pair, 36 for whisper-small's prefill;
  * flash decode (K3) for every decode-side call: the self-attention over
    the linear cache, and the cross-attention over the precomputed
    encoder K/V with the query at position ``Se - 1`` against keys at
    ``0..Se-1``, so every frame is visible (the reference's
    ``causal=False``): 2 launches per layer per step, 24 for
    whisper-small.

``prefill`` asserts ``frames``, as the reference's does: its
``RolloutEngine`` and launchers pass none, so whisper is served by
calling ``prefill(frames=...)`` and ``decode_step`` directly.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.parallel import local as _local
from . import blocks, transformer
from .api import ModelConfig
from .params import Params, layer_views

Tensor = torch.Tensor


def sinusoid_rows(positions: Tensor, channels: int) -> Tensor:
    """Rows ``positions`` [...] of Whisper's sinusoidal position embedding,
    [..., channels] fp32.

    Computed in fp64 and rounded, so the CPU and the card give the same
    table.  The reference computes in fp32, where the angle at position
    p already carries up to p * 2^-24 of rounding (1e-4 at p = 1500), so
    the two agree to that, not to the last bit."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float64, device=positions.device))
    scaled = positions.to(torch.float64)[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1).float()


def sinusoids(length: int, channels: int, device=None) -> Tensor:
    """Whisper's sinusoidal position embedding [length, channels], fp32."""
    return sinusoid_rows(torch.arange(length, device=device), channels)


# ---------------------------------------------------------------------- init
def _init_self_layer(gen: torch.Generator, cfg: ModelConfig, cross: bool):
    dt, dev, d = cfg.tdtype, gen.device, cfg.d_model

    def ones():
        return torch.ones((d,), dtype=dt, device=dev)

    def zeros():
        return torch.zeros((d,), dtype=dt, device=dev)

    p = {
        "attn_norm_scale": ones(), "attn_norm_bias": zeros(),
        "attn": blocks.init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.hd, dt, bias=True),
        "ffn_norm_scale": ones(), "ffn_norm_bias": zeros(),
        "ffn": blocks.init_gelu_mlp_params(gen, d, cfg.d_ff, dt),
    }
    if cross:
        p["cross_norm_scale"], p["cross_norm_bias"] = ones(), zeros()
        p["cross"] = blocks.init_attn_params(gen, d, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.hd, dt,
                                             bias=True)
    return p


def init(seed: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random-init parameters with the reference's names and shapes."""
    gen = transformer.generator(seed, device)
    dt, dev, d = cfg.tdtype, gen.device, cfg.d_model
    return Params({
        "embed": blocks.embed_init(gen, cfg.padded_vocab, d, dt),
        "frame_proj": blocks.dense_init(gen, cfg.enc_dim, d, dt),
        "enc_layers": transformer._stack([
            _init_self_layer(gen, cfg, cross=False)
            for _ in range(cfg.n_encoder_layers)]),
        "enc_norm_scale": torch.ones((d,), dtype=dt, device=dev),
        "enc_norm_bias": torch.zeros((d,), dtype=dt, device=dev),
        "layers": transformer._stack([
            _init_self_layer(gen, cfg, cross=True)
            for _ in range(cfg.n_layers)]),
        "final_norm_scale": torch.ones((d,), dtype=dt, device=dev),
        "final_norm_bias": torch.zeros((d,), dtype=dt, device=dev),
    })


# ------------------------------------------------------------------- encoder
def _norm(h: Tensor, lp: Dict, name: str, cfg: ModelConfig) -> Tensor:
    return blocks.layer_norm(h, lp[f"{name}_scale"], lp[f"{name}_bias"],
                             cfg.norm_eps)


def _attend(q, k, v, causal: bool, cfg: ModelConfig) -> Tensor:
    """Prompt-side attention at contiguous positions (K1 on the card)."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    return blocks.attention(
        q, k, v, q_positions=transformer._positions(B, Sq, q.device),
        k_positions=transformer._positions(B, Sk, q.device), causal=causal,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        contiguous_positions=True)


def _mlp(h: Tensor, lp: Dict, cfg: ModelConfig) -> Tensor:
    return h + blocks.gelu_mlp(_norm(h, lp, "ffn_norm", cfg), lp["ffn"])


def _enc_layer(h: Tensor, lp: Dict, cfg: ModelConfig) -> Tensor:
    x = _norm(h, lp, "attn_norm", cfg)
    q, k, v = blocks.qkv_project(x, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd)
    h = h + blocks.out_project(_attend(q, k, v, False, cfg), lp["attn"])
    return _mlp(h, lp, cfg)


def encode(params: Params, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """frames [B, S_enc, enc_dim] -> encoder states [B, S_enc, d]."""
    Se = frames.shape[1]
    h = frames.to(cfg.tdtype) @ params["frame_proj"]
    h = h + sinusoids(Se, cfg.d_model, h.device).to(h.dtype)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params, "enc_layers"):
        if remat:
            h = checkpoint(_enc_layer, h, lp, cfg, use_reentrant=False)
        else:
            h = _enc_layer(h, lp, cfg)
    return _norm(h, params, "enc_norm", cfg)


# ------------------------------------------------------------------- decoder
def _cross_kv(lp: Dict, enc: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    k = enc @ lp["cross"]["wk"]
    v = enc @ lp["cross"]["wv"]
    if "bk" in lp["cross"]:
        k = k + lp["cross"]["bk"].to(k.dtype)
        v = v + lp["cross"]["bv"].to(v.dtype)
    return (_local.split_last(k, cfg.n_kv_heads, cfg.hd),
            _local.split_last(v, cfg.n_kv_heads, cfg.hd))


def _dec_layer(h: Tensor, lp: Dict, enc: Tensor, cfg: ModelConfig):
    """One decoder layer over the whole prompt: (h, k, v, cross k, cross
    v)."""
    x = _norm(h, lp, "attn_norm", cfg)
    q, k, v = blocks.qkv_project(x, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd)
    h = h + blocks.out_project(_attend(q, k, v, True, cfg), lp["attn"])
    x = _norm(h, lp, "cross_norm", cfg)
    qc, _, _ = blocks.qkv_project(x, lp["cross"], cfg.n_heads,
                                  cfg.n_kv_heads, cfg.hd)
    kc, vc = _cross_kv(lp, enc, cfg)
    h = h + blocks.out_project(_attend(qc, kc, vc, False, cfg), lp["cross"])
    return _mlp(h, lp, cfg), k, v, kc, vc


def _embed(params: Params, tokens: Tensor, table: Tensor) -> Tensor:
    """Token embeddings plus the rows of position table ``table``."""
    h = _local.embed(tokens, params["embed"])
    return h + table.to(h.dtype)


def _unembed(params: Params, cfg: ModelConfig, h: Tensor) -> Tensor:
    h = _norm(h, params, "final_norm", cfg)
    return h @ params["embed"].T


def forward(params: Params, cfg: ModelConfig, tokens: Tensor,
            frames: Optional[Tensor] = None, **_) -> Tensor:
    """Training forward: (tokens [B,S], frames [B,Se,enc_dim]) -> logits."""
    S = tokens.shape[1]
    if frames is None:             # the reference's assertion, kept under -O
        raise AssertionError("whisper forward requires frames")
    enc = encode(params, cfg, frames)
    h = _embed(params, tokens, sinusoids(S, cfg.d_model, tokens.device)[None])
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params):
        if remat:
            h = checkpoint(lambda x, lp=lp: _dec_layer(x, lp, enc, cfg)[0], h,
                           use_reentrant=False)
        else:
            h = _dec_layer(h, lp, enc, cfg)[0]
    return _unembed(params, cfg, h)


# -------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, *, batch: int, max_len: int,
               device=None) -> Dict[str, Tensor]:
    L, Se, dt = cfg.n_layers, cfg.encoder_seq, cfg.tdtype
    dev = resolve_device(device)
    kv = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
    xkv = (L, batch, Se, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev),
        "k_pos": torch.full((batch, max_len), transformer.EMPTY_POS,
                            dtype=torch.int32, device=dev),
        # the cross-attention K/V of each layer, filled at prefill
        "xk": torch.zeros(xkv, dtype=dt, device=dev),
        "xv": torch.zeros(xkv, dtype=dt, device=dev),
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Tensor],
                token: Tensor, pos: Tensor) -> Tuple[Tensor, Dict]:
    """One decode step: token [B], pos [B] -> (logits [B, padded_vocab],
    cache), the self-attention cache updated in place (slot ``min(pos,
    C-1)``).  Positions come from ``sinusoids(C, d)[pos]``, C the cache
    length, as in the reference (whose gather clamps ``pos`` to C - 1):
    only the B rows are computed."""
    B = token.shape[0]
    C = cache["k"].shape[2]
    Se = cache["xk"].shape[2]
    pos = pos.to(torch.int32)
    slot = torch.clamp(pos, max=C - 1)
    flat = torch.arange(B, device=pos.device) * C + slot.long()
    _local.write_rows(cache["k_pos"], slot, pos, flat)
    h = _embed(params, token[:, None].long(),
               sinusoid_rows(torch.clamp(pos, max=C - 1), cfg.d_model)[:, None])
    # cross-attention: every frame visible to a query at position Se - 1
    x_qpos = torch.full((B,), Se - 1, dtype=torch.int32, device=pos.device)
    x_kpos = torch.arange(Se, dtype=torch.int32,
                          device=pos.device).expand(B, Se).contiguous()
    Hkv, D = cfg.n_kv_heads, cfg.hd
    for i, lp in enumerate(layer_views(params)):
        x = _norm(h, lp, "attn_norm", cfg)
        q, k, v = blocks.qkv_project(x, lp["attn"], cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd)
        ck, cv = cache["k"][i], cache["v"][i]
        _local.write_rows(ck, slot, k[:, 0], flat)
        _local.write_rows(cv, slot, v[:, 0], flat)
        o = _local.decode_attention(q[:, 0], ck, cv, pos,
                                    cache["k_pos"])[:, None]
        h = h + blocks.out_project(o, lp["attn"])
        x = _norm(h, lp, "cross_norm", cfg)
        qc, _, _ = blocks.qkv_project(x, lp["cross"], cfg.n_heads,
                                      cfg.n_kv_heads, cfg.hd)
        oc = _local.decode_attention(qc[:, 0], cache["xk"][i],
                                     cache["xv"][i], x_qpos, x_kpos)[:, None]
        h = h + blocks.out_project(oc, lp["cross"])
        h = _mlp(h, lp, cfg)
    return _unembed(params, cfg, h[:, 0]), cache


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor, *,
            max_len: int, frames: Optional[Tensor] = None,
            **_) -> Tuple[Tensor, Dict]:
    """Encode ``frames`` and process the prompt: (last-position logits,
    cache with the prompt's self K/V and every layer's cross K/V)."""
    B, S = tokens.shape
    if frames is None:
        raise AssertionError("whisper prefill requires frames")
    enc = encode(params, cfg, frames)
    cache = _local.place_cache(
        init_cache(cfg, batch=B, max_len=max_len, device=tokens.device),
        cfg, tokens)
    h = _embed(params, tokens, sinusoids(S, cfg.d_model, tokens.device)[None])
    for i, lp in enumerate(layer_views(params)):
        h, k, v, kc, vc = _dec_layer(h, lp, enc, cfg)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["xk"][i] = kc
        cache["xv"][i] = vc
    cache["k_pos"][:, :S] = transformer._positions(B, S, tokens.device)
    return _unembed(params, cfg, h[:, -1]), cache
