"""Mixture-of-Experts decoder (qwen3-moe 128e top-8, grok-1 8e top-2).

The port of ``repro.models.moe``: the dense transformer's layers with the
SwiGLU FFN replaced by GShard capacity-based routing.  Tokens are routed
in groups of ``cfg.moe_group`` (the last group zero-padded, and the pad
tokens route like any other); per group, each expert takes at most
``capacity = ceil(group * top_k * CAPACITY_FACTOR / E)`` token choices,
queued choice-major (every token's first choice before any token's
second), and the choices past capacity are dropped: a token whose choices
all drop passes through the residual unchanged.  The router and the
renormalised top-k gates are fp32, and so is the combine when
``cfg.moe_comb_f32``.  In decode the B tokens of a step are one group,
``capacity = ceil(B * top_k * CAPACITY_FACTOR / E)`` (1 at B = 8 for
qwen3-moe, so most choices drop).

The reference lowers dispatch and combine as one-hot einsums over
``[g, c, E, C]`` (a TPU lowering device); the port computes the same
function by index: each kept choice's token is gathered into its
``[E, G*C, d]`` slot, the expert GEMMs run batched over E
(``torch.bmm``), and the gate-weighted outputs are scatter-added back
(``index_add_``).  ``moe_fused_combine`` only reorders that contraction
in the reference (for a TP all-reduce); here it means the combine runs in
the activation dtype.

Attention is the dense transformer's (``transformer.forward``,
``prefill``, ``decode_step`` given this module's FFN): on a CUDA tensor
the flash kernel (K1) once per layer per prefill or training forward and
flash decode (K3) once per layer per decode step, where the reference,
which never passes ``use_pallas`` here, runs the jnp attention of the
same function.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from . import blocks, transformer
from .api import ModelConfig
from .params import Params

Tensor = torch.Tensor

CAPACITY_FACTOR = 1.25


# ---------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    dt, dev = cfg.tdtype, gen.device
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "attn_norm": torch.ones((d,), dtype=dt, device=dev),
        "attn": blocks.init_attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.hd, dt, bias=cfg.qkv_bias),
        "ffn_norm": torch.ones((d,), dtype=dt, device=dev),
        "router": blocks.dense_init(gen, d, E, torch.float32),
        "experts": {
            "w_gate": blocks.experts_init(gen, E, d, f, dt),
            "w_up": blocks.experts_init(gen, E, d, f, dt),
            "w_down": blocks.experts_init(gen, E, f, d, dt),
        },
    }


def init(seed: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random-init parameters with the reference's names and shapes
    (stacked ``[L, ...]`` layers, stacked ``[E, d, f]`` experts)."""
    gen = transformer.generator(seed, device)
    return Params(transformer.init_lm(gen, cfg, _init_layer))


# ------------------------------------------------------------------ routing
def route(x: Tensor, lp: Dict, cfg: ModelConfig, capacity: int
          ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """GShard routing of grouped tokens x [G, c, d]: per (group, choice,
    token) in choice-major order ``[G, k, c]``, the expert, the gate
    (renormalised over the top-k, fp32), the position in that expert's
    queue and whether it is kept (position < capacity)."""
    G, c, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ lp["router"].float()                    # [G, c, E]
    gates = torch.softmax(logits, dim=-1)
    # a stable sort: equal gates (the zero pad tokens' uniform ones) pick
    # the lower expert first, as lax.top_k does
    top_vals, top_idx = torch.sort(gates, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    expert = top_idx.transpose(1, 2)                             # [G, k, c]
    onehot = F.one_hot(expert.reshape(G, k * c), E)              # [G, kc, E]
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = (before * onehot).sum(-1).reshape(G, k, c)
    return expert, top_vals.transpose(1, 2), pos, pos < capacity


def _route_groups(x: Tensor, lp: Dict, cfg: ModelConfig,
                  capacity: int) -> Tensor:
    """x [G, c, d] -> y [G, c, d]: dispatch every kept choice to its
    expert slot, run the experts, combine with the gates."""
    G, c, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    expert, gate, pos, keep = route(x, lp, cfg, capacity)
    g_idx = torch.arange(G, device=x.device)[:, None, None].expand(G, k, c)
    t_idx = torch.arange(c, device=x.device)[None, None, :].expand(G, k, c)
    keep = keep.reshape(-1)
    token = (g_idx * c + t_idx).reshape(-1)[keep]                # [n_kept]
    # slot of each kept choice in the [E, G, C] expert buffer
    slot = ((expert * G + g_idx) * capacity + pos).reshape(-1)[keep]
    xe = x.new_zeros((E * G * capacity, d)).index_put(
        (slot,), x.reshape(G * c, d)[token])
    xe = xe.reshape(E, G * capacity, d)
    w = lp["experts"]
    h = (F.silu(torch.bmm(xe, w["w_gate"]).float()).to(x.dtype)
         * torch.bmm(xe, w["w_up"]))
    ye = torch.bmm(h, w["w_down"]).reshape(E * G * capacity, d)
    cdt = (torch.float32 if cfg.moe_comb_f32 and not cfg.moe_fused_combine
           else x.dtype)
    contrib = ye[slot].to(cdt) * gate.reshape(-1)[keep].to(cdt)[:, None]
    y = x.new_zeros((G * c, d), dtype=cdt).index_add(0, token, contrib)
    return y.to(x.dtype).reshape(G, c, d)


def _capacity(group: int, cfg: ModelConfig) -> int:
    return max(1, int(math.ceil(group * cfg.top_k * CAPACITY_FACTOR
                                / cfg.n_experts)))


def moe_ffn(x: Tensor, lp: Dict, cfg: ModelConfig) -> Tensor:
    """x [B, S, d] -> [B, S, d], routed in groups of ``cfg.moe_group``
    tokens (``min(moe_group, B*S)``; the last one zero-padded)."""
    B, S, d = x.shape
    n_tok = B * S
    group = min(cfg.moe_group, n_tok)
    pad = (-n_tok) % group
    xf = x.reshape(n_tok, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    G = xf.shape[0] // group
    y = _route_groups(xf.reshape(G, group, d), lp, cfg,
                      _capacity(group, cfg))
    return y.reshape(G * group, d)[:n_tok].reshape(B, S, d)


def decode_ffn(x: Tensor, lp: Dict, cfg: ModelConfig) -> Tensor:
    """One decode token per row, x [B, 1, d]: the B tokens are one group."""
    B = x.shape[0]
    return _route_groups(x[:, 0][None], lp, cfg,
                         _capacity(B, cfg))[0][:, None]


# ------------------------------------------------- forward / prefill / decode
def forward(params: Params, cfg: ModelConfig, tokens: Tensor, **kw) -> Tensor:
    return transformer.forward(params, cfg, tokens, ffn=moe_ffn, **kw)


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor,
            **kw) -> Tuple[Tensor, Dict]:
    return transformer.prefill(params, cfg, tokens, ffn=moe_ffn, **kw)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Tensor],
                token: Tensor, pos: Tensor) -> Tuple[Tensor, Dict]:
    return transformer.decode_step(params, cfg, cache, token, pos,
                                   ffn=decode_ffn)


init_cache = transformer.init_cache
cache_len = transformer.cache_len
unembed = transformer.unembed
