"""Hymba: hybrid parallel attention + Mamba (SSM) heads [arXiv:2411.13676].

The port of ``repro.models.hymba``.  Each layer runs a sliding-window GQA
attention path and a selective diagonal SSM path (state ``ssm_state``) in
parallel on the same normalised input; the two outputs are each
RMS-normalised and averaged (the paper's fusion), then the SwiGLU FFN
follows.  Meta tokens are omitted, as in the reference.

Attention: on a CUDA tensor the flash kernel (K1, windowed, causal) once
per layer per prefill or training forward, and flash decode (K3) once per
layer per decode step over the ring cache of W slots (slot ``pos % W``).
The reference never passes ``use_pallas`` here and runs the jnp attention
of the same function.

SSM: the reference evaluates a chunk with ``lax.associative_scan``, which
has no torch counterpart and no kernel.  ``ssm_chunkwise`` runs the same
recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t`` step by step in
fp32 (no division by a cumulative product of the decays, which would
underflow over a chunk), holding one chunk's states at a time to form the
outputs.  Decode carries the ring KV and the state ``[L, B, d, N]``.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.parallel import local as _local
from . import blocks, transformer
from .api import ModelConfig
from .params import Params, layer_views

Tensor = torch.Tensor

SSM_CHUNK = 128


# ------------------------------------------------------------------ SSM core
def ssm_chunkwise(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                  D: Tensor, h0: Tensor, chunk: int = SSM_CHUNK
                  ) -> Tuple[Tensor, Tensor]:
    """Selective diagonal SSM over a sequence, fp32.

    x:  [B, S, d]   inputs (d = d_inner)
    dt: [B, S, d]   softplus'd timestep
    A:  [d, N]      negative decay rates (-exp(A_log))
    Bm: [B, S, N]   input projections
    Cm: [B, S, N]   output projections
    D:  [d]         skip
    h0: [B, d, N]   carried state
    Returns (y [B, S, d], h_final [B, d, N]).  ``chunk`` steps' states are
    held at once; the result does not depend on it.
    """
    S = x.shape[1]
    h, ys = h0, []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        a = torch.exp(dt[:, sl, :, None] * A)                     # [B,T,d,N]
        b = (dt[:, sl] * x[:, sl])[..., None] * Bm[:, sl, None, :]
        hs = []
        for t in range(a.shape[1]):
            h = torch.addcmul(b[:, t], a[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("btdn,btn->btd", torch.stack(hs, 1), Cm[:, sl])
                  + D * x[:, sl])
    return torch.cat(ys, 1), h


def ssm_step(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
             D: Tensor, h: Tensor) -> Tuple[Tensor, Tensor]:
    """One decode step: x/dt [B, d]; Bm/Cm [B, N]; h [B, d, N]."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * Bm[:, None, :]
    h_new = a * h + b
    y = torch.einsum("bdn,bn->bd", h_new, Cm) + D * x
    return y, h_new


# ---------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    dt_, dev = cfg.tdtype, gen.device
    d, N = cfg.d_model, cfg.ssm_state
    f32 = torch.float32
    return {
        "norm": torch.ones((d,), dtype=dt_, device=dev),
        "attn": blocks.init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.hd, dt_),
        "attn_out_norm": torch.ones((d,), dtype=dt_, device=dev),
        # SSM path
        "ssm_in": blocks.dense_init(gen, d, d, dt_),
        "w_dt": blocks.dense_init(gen, d, d, f32),
        "b_dt": torch.full((d,), -4.0, dtype=f32, device=dev),  # small dt
        "w_B": blocks.dense_init(gen, d, N, f32),
        "w_C": blocks.dense_init(gen, d, N, f32),
        # Mamba A init: -(1..N) per channel (S4D-real)
        "A_log": torch.log(torch.arange(1, N + 1, dtype=f32, device=dev)
                           ).expand(d, N).contiguous(),
        "Dskip": torch.ones((d,), dtype=f32, device=dev),
        "ssm_out": blocks.dense_init(gen, d, d, dt_),
        "ssm_out_norm": torch.ones((d,), dtype=dt_, device=dev),
        # FFN
        "ffn_norm": torch.ones((d,), dtype=dt_, device=dev),
        "ffn": blocks.init_swiglu_params(gen, d, cfg.d_ff, dt_),
    }


def init(seed: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random-init parameters with the reference's names and shapes."""
    gen = transformer.generator(seed, device)
    return Params(transformer.init_lm(gen, cfg, _init_layer))


# ------------------------------------------------------------------- layers
def _ssm_inputs(lp: Dict, x: Tensor):
    """x [B, S, d] normalised -> (xin, dt, A, Bm, Cm) in fp32."""
    xf = x.float()
    xin = (x @ lp["ssm_in"]).float()
    dt = F.softplus(xf @ lp["w_dt"] + lp["b_dt"])
    return xin, dt, -torch.exp(lp["A_log"]), xf @ lp["w_B"], xf @ lp["w_C"]


def _fuse(h: Tensor, lp: Dict, attn_y: Tensor, ssm_y: Tensor,
          cfg: ModelConfig) -> Tensor:
    """Normalised-mean fusion of the two paths, then the SwiGLU FFN."""
    fused = 0.5 * (blocks.rms_norm(attn_y, lp["attn_out_norm"], cfg.norm_eps)
                   + blocks.rms_norm(ssm_y, lp["ssm_out_norm"],
                                     cfg.norm_eps))
    h = h + fused
    x = blocks.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + blocks.swiglu(x, lp["ffn"])


def _prompt_layer(h: Tensor, lp: Dict, positions: Tensor, h0: Tensor,
                  cfg: ModelConfig):
    """One layer over a whole sequence from SSM state ``h0``: (h, k, v,
    final SSM state)."""
    x = blocks.rms_norm(h, lp["norm"], cfg.norm_eps)
    q, k, v = blocks.qkv_project(x, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd)
    q = blocks.apply_rope(q, positions, cfg.rope_theta)
    k = blocks.apply_rope(k, positions, cfg.rope_theta)
    o = blocks.attention(q, k, v, q_positions=positions,
                         k_positions=positions, causal=True,
                         window=cfg.attn_window, q_chunk=cfg.q_chunk,
                         kv_chunk=cfg.kv_chunk, contiguous_positions=True)
    attn_y = blocks.out_project(o, lp["attn"])
    xin, dt, A, Bm, Cm = _ssm_inputs(lp, x)
    y, hs = _local.ssm(ssm_chunkwise, xin, dt, A, Bm, Cm, lp["Dskip"], h0)
    ssm_y = y.to(x.dtype) @ lp["ssm_out"]
    return _fuse(h, lp, attn_y, ssm_y, cfg), k, v, hs


def forward(params: Params, cfg: ModelConfig, tokens: Tensor,
            **_) -> Tensor:
    """Training forward: tokens [B, S] -> logits [B, S, padded_vocab]."""
    B, S = tokens.shape
    h = _local.embed(tokens, params["embed"])
    positions = transformer._positions(B, S, tokens.device)
    h0 = torch.zeros((B, cfg.d_model, cfg.ssm_state), dtype=torch.float32,
                     device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params):
        if remat:
            h = checkpoint(lambda x, lp=lp: _prompt_layer(
                x, lp, positions, h0, cfg)[0], h, use_reentrant=False)
        else:
            h = _prompt_layer(h, lp, positions, h0, cfg)[0]
    return transformer.unembed(params, cfg, h)


# -------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, *, batch: int, max_len: int,
               device=None) -> Dict[str, Tensor]:
    W = min(cfg.attn_window or max_len, max_len)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
        "k_pos": torch.full((batch, W), transformer.EMPTY_POS,
                            dtype=torch.int32, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.d_model, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Tensor],
                token: Tensor, pos: Tensor) -> Tuple[Tensor, Dict]:
    """One decode step: token [B], pos [B] -> (logits [B, padded_vocab],
    cache), the ring KV (slot ``pos % W``) and the SSM state updated in
    place."""
    B = token.shape[0]
    W = cache["k"].shape[2]
    pos = pos.to(torch.int32)
    slot = pos % W
    flat = torch.arange(B, device=pos.device) * W + slot.long()
    _local.write_rows(cache["k_pos"], slot, pos, flat)
    h = _local.embed(token[:, None].long(), params["embed"])     # [B,1,d]
    positions = pos[:, None]
    Hkv, D = cfg.n_kv_heads, cfg.hd
    for i, lp in enumerate(layer_views(params)):
        x = blocks.rms_norm(h, lp["norm"], cfg.norm_eps)
        q, k, v = blocks.qkv_project(x, lp["attn"], cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd)
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
        ck, cv = cache["k"][i], cache["v"][i]
        _local.write_rows(ck, slot, k[:, 0], flat)
        _local.write_rows(cv, slot, v[:, 0], flat)
        o = _local.decode_attention(q[:, 0], ck, cv, pos, cache["k_pos"],
                                    window=cfg.attn_window)[:, None]
        attn_y = blocks.out_project(o, lp["attn"])
        xin, dt, A, Bm, Cm = _ssm_inputs(lp, x)
        y, hs = _local.ssm(ssm_step, xin[:, 0], dt[:, 0], A, Bm[:, 0],
                           Cm[:, 0], lp["Dskip"], cache["ssm"][i])
        _local.copy_state(cache["ssm"][i], hs)
        ssm_y = (y.to(x.dtype) @ lp["ssm_out"])[:, None]
        h = _fuse(h, lp, attn_y, ssm_y, cfg)
    return transformer.unembed(params, cfg, h[:, 0]), cache


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor, *,
            max_len: int, **_) -> Tuple[Tensor, Dict]:
    """Process the prompt from the zero SSM state; return (last-position
    logits, cache): the last W positions' K/V at their ring slots and
    each layer's final SSM state."""
    B, S = tokens.shape
    cache = _local.place_cache(
        init_cache(cfg, batch=B, max_len=max_len, device=tokens.device),
        cfg, tokens)
    W = cache["k"].shape[2]
    h = _local.embed(tokens, params["embed"])
    positions = transformer._positions(B, S, tokens.device)
    slots, keep = transformer.ring_slots(S, W, tokens.device)
    for i, lp in enumerate(layer_views(params)):
        h, k, v, hs = _prompt_layer(h, lp, positions, cache["ssm"][i], cfg)
        _local.write_slots(cache["k"][i], slots, k[:, keep])
        _local.write_slots(cache["v"][i], slots, v[:, keep])
        _local.copy_state(cache["ssm"][i], hs)
    _local.write_slots(cache["k_pos"], slots, positions[:, keep].contiguous())
    return transformer.unembed(params, cfg, h[:, -1]), cache
