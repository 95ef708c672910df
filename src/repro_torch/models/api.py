"""Model protocol: config dataclass + family dispatch.

A copy of the reference's ``ModelConfig`` (same fields, same derived
properties) so the port needs nothing from ``repro``.  ``tdtype`` maps the
``dtype`` string to a torch dtype; the scheduler's coarse ``spec`` is not
part of this slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    moe_shard: str = "expert"
    fsdp_params: bool = False
    shard_mode: str = "tp"
    seq_shard: bool = False
    loss_chunk: int = 0
    cache_shard: str = "hd"
    moe_group: int = 1024
    moe_comb_f32: bool = True
    moe_fused_combine: bool = False
    # --- SSM / hybrid
    ssm_state: int = 0
    attn_window: Optional[int] = None # SWA window; None = full attention
    # --- enc-dec / vlm stub frontends
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    encoder_dim: int = 0
    # --- details
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    norm_kind: str = "rms"            # "rms" | "layer"
    mlp_kind: str = "swiglu"          # "swiglu" | "gelu"
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"           # params/activations compute dtype
    remat: bool = True
    remat_policy: str = "full"
    use_pallas: bool = False          # ignored by the port (see blocks.attention)
    unroll_layers: bool = False
    q_chunk: int = 512
    kv_chunk: int = 1024

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad_to)

    @property
    def enc_dim(self) -> int:
        return self.encoder_dim or self.d_model

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.attn_window is not None


# ------------------------------------------------------------------ dispatch
def get_model(cfg: ModelConfig):
    """Return the family module implementing the model protocol.  The
    dense and ssm families are ported so far; the others come with their
    slices."""
    if cfg.family == "dense":
        from . import transformer
        return transformer
    if cfg.family == "ssm":
        from . import xlstm
        return xlstm
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP M8)")
