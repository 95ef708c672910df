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
function by index, in static shapes: each choice's token is gathered
into its ``[E, G*C, d]`` slot (a dropped choice into a discard slot past
the buffer), the expert GEMMs run batched over E (``torch.bmm``), and
the gate-weighted outputs are scatter-added back (``index_add_``; a
dropped choice adds a zero row).  On DTensors each rank
runs its own experts on its local rows and the ranks' outputs are summed
(``_sharded``).  ``moe_fused_combine`` only reorders that contraction
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
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.parallel import local as _local
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


def _route_groups(x: Tensor, lp: Dict, cfg: ModelConfig, capacity: int,
                  experts: Optional[Dict] = None, e_off: int = 0) -> Tensor:
    """x [G, c, d] -> y [G, c, d]: dispatch every kept choice to its
    expert slot, run the experts, combine with the gates.

    Static shapes throughout: every choice has a slot, a dropped one a
    discard row past the ``[E, G, C]`` input buffer, and it adds a zero
    row to the output.  ``experts`` (default ``lp``'s) may be
    the ``E_l`` experts ``e_off..e_off+E_l-1`` of a rank: choices of the
    others are dropped here, and the ranks' outputs sum to the whole."""
    G, c, d = x.shape
    k = cfg.top_k
    w = lp["experts"] if experts is None else experts
    E = w["w_gate"].shape[0]
    expert, gate, pos, keep = route(x, lp, cfg, capacity)
    expert = expert - e_off
    keep = keep & (expert >= 0) & (expert < E)
    g_idx = torch.arange(G, device=x.device)[:, None, None].expand(G, k, c)
    t_idx = torch.arange(c, device=x.device)[None, None, :].expand(G, k, c)
    token = (g_idx * c + t_idx).reshape(-1)                      # [G*k*c]
    # slot of each choice in the [E, G, C] expert buffer (+ the discard)
    n_slot = E * G * capacity
    slot = torch.where(keep, (expert * G + g_idx) * capacity + pos,
                       n_slot).reshape(-1)
    xe = x.new_zeros((n_slot + 1, d)).index_put(
        (slot,), x.reshape(G * c, d)[token])
    xe = xe[:n_slot].reshape(E, G * capacity, d)
    h = (F.silu(torch.bmm(xe, w["w_gate"]).float()).to(x.dtype)
         * torch.bmm(xe, w["w_up"]))
    ye = torch.bmm(h, w["w_down"]).reshape(n_slot, d)
    cdt = (torch.float32 if cfg.moe_comb_f32 and not cfg.moe_fused_combine
           else x.dtype)
    # a dropped choice reads some slot and adds a zero row; the slots it
    # reads are spread over the buffer, since the gather's backward
    # (a sorted scatter-add) runs the duplicates of one index serially
    keep = keep.reshape(-1)
    spread = torch.arange(slot.numel(), device=x.device) % n_slot
    contrib = (ye[torch.where(keep, slot, spread)].to(cdt)
               * gate.reshape(-1).to(cdt)[:, None])
    contrib = torch.where(keep[:, None], contrib, 0.0)
    y = x.new_zeros((G * c, d), dtype=cdt).index_add(0, token, contrib)
    return y.to(x.dtype).reshape(G, c, d)


def _capacity(group: int, cfg: ModelConfig) -> int:
    return max(1, int(math.ceil(group * cfg.top_k * CAPACITY_FACTOR
                                / cfg.n_experts)))


def moe_ffn(x: Tensor, lp: Dict, cfg: ModelConfig, experts=None,
            e_off: int = 0) -> Tensor:
    """x [B, S, d] -> [B, S, d], routed in groups of ``cfg.moe_group``
    tokens (``min(moe_group, B*S)``; the last one zero-padded)."""
    if _local.is_dt(x):
        return _sharded(moe_ffn, x, lp, cfg)
    B, S, d = x.shape
    n_tok = B * S
    group = min(cfg.moe_group, n_tok)
    pad = (-n_tok) % group
    xf = x.reshape(n_tok, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    G = xf.shape[0] // group
    y = _route_groups(xf.reshape(G, group, d), lp, cfg,
                      _capacity(group, cfg), experts, e_off)
    return y.reshape(G * group, d)[:n_tok].reshape(B, S, d)


def decode_ffn(x: Tensor, lp: Dict, cfg: ModelConfig, experts=None,
               e_off: int = 0) -> Tensor:
    """One decode token per row, x [B, 1, d]: the B tokens are one group."""
    if _local.is_dt(x):
        return _sharded(decode_ffn, x, lp, cfg)
    B = x.shape[0]
    return _route_groups(x[:, 0][None], lp, cfg, _capacity(B, cfg),
                         experts, e_off)[0][:, None]


def _sharded(ffn, x: Tensor, lp: Dict, cfg: ModelConfig) -> Tensor:
    """``ffn`` on DTensors, per rank (``parallel.local.local``): each rank
    routes its local rows (groups form within a data shard) over every
    expert and runs its own experts (``moe_shard="expert"``: E over
    "model") or its slice of every expert's FFN (``"ff"``: f over
    "model"); the ranks' partial outputs are summed over "model".
    Other splits of the expert weights (FSDP's) are gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    w = lp["experts"]
    keep_dim = {"w_gate": 0, "w_up": 0, "w_down": 0} \
        if cfg.moe_shard == "expert" else {"w_gate": 2, "w_up": 2,
                                           "w_down": 1}
    names = tuple(mesh.mesh_dim_names)
    mdl = names.index("model") if "model" in names else None

    def wpl(name):
        return tuple(p if (i == mdl and isinstance(p, Shard)
                           and p.dim == keep_dim[name]) else Replicate()
                     for i, p in enumerate(w[name].placements))

    rows = _local.dim_placements(mesh, {0: ("pod", "data")}, x.shape)
    split = mdl is not None and isinstance(wpl("w_gate")[mdl], Shard)
    out = tuple(Partial("sum") if split and i == mdl else p
                for i, p in enumerate(rows))
    ep = cfg.moe_shard == "expert"

    def body(x, router, wg, wu, wd):
        e_off = (_local._offset(mesh, [mdl], wg.shape[0])
                 if split and ep else 0)
        return ffn(x, {"router": router}, cfg,
                   {"w_gate": wg, "w_up": wu, "w_down": wd}, e_off)

    return _local.settle(_local.local(
        body, out, (rows, _local.replicate(mesh), wpl("w_gate"),
                    wpl("w_up"), wpl("w_down")),
        x, lp["router"], w["w_gate"], w["w_up"], w["w_down"]))


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
