"""xLSTM (mLSTM matrix-memory blocks): xlstm-1.3b [arXiv:2405.04517].

The port of ``repro.models.xlstm`` for ``family="ssm"``, as plain
functions over ``Params`` like ``transformer``.  The training forward and
the prefill run the stabilised chunkwise mLSTM through ``mlstm_scan``: on
a CUDA tensor that is the hand-written scan kernel, one launch per layer
(the prefill asks it for the final ``(C, n, m)`` carry too); on a CPU
tensor its plain chunkwise version.  Decode keeps the recurrent state per
sequence, ``C [L, B, H, D, D]``, ``n [L, B, H, D]``, ``m [L, B, H]``, and
updates it in place with plain torch ops (the reference has no kernel
there).

Block layout (about 5 d^2 params per layer): q, k, v d -> d per-head
projections; input/forget gates d -> 2H in float32 (``w_if`` / ``b_if``
are float32 even in a bfloat16 model); output gate d -> d; out proj
d -> d; RMSNorm pre-norm, residual.  ``cfg.remat`` recomputes each layer
in the backward (``torch.utils.checkpoint``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.ssm_scan.ops import mlstm_scan
from repro_torch.kernels.ssm_scan.ref import log_sigmoid
from repro_torch.parallel import local as _local
from . import blocks, transformer
from .api import ModelConfig
from .params import Params, layer_views

Tensor = torch.Tensor
CHUNK = 64      # mLSTM chunk length of the prefill (the reference's T_c)
State = Tuple[Tensor, Tensor, Tensor]


# --------------------------------------------------------------- mLSTM core
def mlstm_step(q: Tensor, k: Tensor, v: Tensor, ig: Tensor, fg: Tensor,
               state: State) -> Tuple[State, Tensor]:
    """One recurrent step (decode) for every (batch, head) row.  q/k/v
    [..., D]; ig/fg [...]; state (C [..., D, D], n [..., D], m [...]) in
    float32, updated in place and returned with h [..., D]."""
    D = q.shape[-1]
    C, n, m = state
    lf = log_sigmoid(fg.float())
    g = ig.float()
    m_new = torch.maximum(lf + m, g)
    f_sc = torch.exp(lf + m - m_new)
    i_sc = torch.exp(g - m_new)
    kf, vf = k.float(), v.float()
    qf = q.float() * (1.0 / math.sqrt(D))
    C.mul_(f_sc[..., None, None]).add_(
        i_sc[..., None, None] * (kf[..., :, None] * vf[..., None, :]))
    n.mul_(f_sc[..., None]).add_(i_sc[..., None] * kf)
    m.copy_(m_new)
    qn = torch.abs(torch.sum(qf * n, dim=-1))
    h = (qf[..., None, :] @ C)[..., 0, :] / torch.maximum(
        qn, torch.exp(-m_new))[..., None]
    return (C, n, m), h.to(q.dtype)


# ---------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    dt, dev = cfg.tdtype, gen.device
    d, H = cfg.d_model, cfg.n_heads
    return {
        "norm": torch.ones((d,), dtype=dt, device=dev),
        "wq": blocks.dense_init(gen, d, d, dt),
        "wk": blocks.dense_init(gen, d, d, dt),
        "wv": blocks.dense_init(gen, d, d, dt),
        "w_if": blocks.dense_init(gen, d, 2 * H, torch.float32),
        # forget-gate bias init positive -> long memory at init (xLSTM §4)
        "b_if": torch.cat([torch.zeros((H,), device=dev),
                           torch.full((H,), 3.0, device=dev)]),
        "w_gate": blocks.dense_init(gen, d, d, dt),
        "w_out": blocks.dense_init(gen, d, d, dt),
    }


def init(seed: Union[int, torch.Generator], cfg: ModelConfig,
         device=None) -> Params:
    """Random-init parameters with the reference's names and shapes (not
    its draws: tests carry JAX params over with ``params_from_jax``)."""
    gen = transformer.generator(seed, device)
    dt, dev = cfg.tdtype, gen.device
    layers = [_init_layer(gen, cfg) for _ in range(cfg.n_layers)]
    params = {
        "embed": blocks.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "layers": {k: torch.stack([lp[k] for lp in layers])
                   for k in layers[0]},
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = blocks.dense_init(gen, cfg.d_model,
                                              cfg.padded_vocab, dt)
    return Params(params)


# ------------------------------------------------------------------- forward
def _project(lp: Dict, x: Tensor, cfg: ModelConfig):
    H, D = cfg.n_heads, cfg.hd
    q = _local.split_last(x @ lp["wq"], H, D)
    k = _local.split_last(x @ lp["wk"], H, D)
    v = _local.split_last(x @ lp["wv"], H, D)
    gif = x.float() @ lp["w_if"] + lp["b_if"]
    ig, fg = torch.chunk(gif, 2, dim=-1)                   # [B, S, H] each
    return q, k, v, ig, fg


def _mix(lp: Dict, h: Tensor, x: Tensor, o: Tensor,
         cfg: ModelConfig) -> Tensor:
    """Output gate, out projection and residual around the mLSTM output
    ``o`` [B, S, H, D]."""
    o = _local.merge_last(o).to(x.dtype)
    gate = F.silu((x @ lp["w_gate"]).float()).to(x.dtype)
    return h + (o * gate) @ lp["w_out"]


def _layer_fwd(lp: Dict, h: Tensor, cfg: ModelConfig) -> Tensor:
    x = blocks.rms_norm(h, lp["norm"], cfg.norm_eps)
    q, k, v, ig, fg = _project(lp, x, cfg)
    # chunk=None -> the tuned table (kernels.tuning), 64 by default
    return _mix(lp, h, x, _local.scan(mlstm_scan, q, k, v, ig, fg), cfg)


def _unembed(params: Params, cfg: ModelConfig, h: Tensor) -> Tensor:
    h = blocks.rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ table


def forward(params: Params, cfg: ModelConfig, tokens: Tensor,
            **_) -> Tensor:
    """Training forward: tokens [B, S] -> logits [B, S, padded_vocab]."""
    h = _local.embed(tokens, params["embed"])
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params):
        if remat:
            h = checkpoint(_layer_fwd, lp, h, cfg, use_reentrant=False)
        else:
            h = _layer_fwd(lp, h, cfg)
    return _unembed(params, cfg, h)


# -------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, *, batch: int, max_len: int,
               device=None) -> Dict[str, Tensor]:
    H, D, L = cfg.n_heads, cfg.hd, cfg.n_layers
    dev = resolve_device(device)
    return {
        "C": torch.zeros((L, batch, H, D, D), dtype=torch.float32, device=dev),
        "n": torch.zeros((L, batch, H, D), dtype=torch.float32, device=dev),
        "m": torch.zeros((L, batch, H), dtype=torch.float32, device=dev),
    }


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Tensor],
                token: Tensor, pos: Tensor) -> Tuple[Tensor, Dict]:
    """One token per row: token [B] -> (logits [B, padded_vocab], cache),
    the recurrent state updated in place.  ``pos`` is unused (the state
    carries the history), as in the reference."""
    h = _local.embed(token[:, None].long(), params["embed"])    # [B, 1, d]
    for i, lp in enumerate(layer_views(params)):
        x = blocks.rms_norm(h, lp["norm"], cfg.norm_eps)
        q, k, v, ig, fg = _project(lp, x, cfg)
        state = (cache["C"][i], cache["n"][i], cache["m"][i])
        _, o = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
                          state)
        h = _mix(lp, h, x, o[:, None], cfg)
    return _unembed(params, cfg, h[:, 0]), cache


def prefill(params: Params, cfg: ModelConfig, tokens: Tensor, *,
            max_len: int, **_) -> Tuple[Tensor, Dict]:
    """Run the prompt through the recurrence from the zero state; return
    (last-position logits, the carried state).  Each layer is one scan
    over chunks of ``CHUNK`` (padded as the reference pads), which also
    returns the layer's final carry."""
    B, S = tokens.shape
    h = _local.embed(tokens, params["embed"])
    cache = _local.place_cache(
        init_cache(cfg, batch=B, max_len=max_len, device=tokens.device),
        cfg, tokens)
    for i, lp in enumerate(layer_views(params)):
        x = blocks.rms_norm(h, lp["norm"], cfg.norm_eps)
        q, k, v, ig, fg = _project(lp, x, cfg)
        o, (C, n, m) = _local.scan(
            lambda *a: mlstm_scan(*a, chunk=CHUNK, return_state=True),
            q, k, v, ig, fg, n_out=4)
        _local.copy_state(cache["C"][i], C)
        _local.copy_state(cache["n"][i], n)
        _local.copy_state(cache["m"][i], m)
        h = _mix(lp, h, x, o, cfg)
    return _unembed(params, cfg, h[:, -1]), cache
