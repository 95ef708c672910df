"""Model protocol: config dataclass + family dispatch.

A copy of the reference's ``ModelConfig`` (same fields, same derived
properties) so the port needs nothing from ``repro``.  ``tdtype`` maps the
``dtype`` string to a torch dtype; ``spec`` is the scheduler's coarse
``ModelSpec``, field for field the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.core.model_spec import ModelSpec


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

    @property
    def spec(self) -> ModelSpec:
        """Coarse spec for the scheduler's analytic cost models."""
        return ModelSpec(
            name=self.name, family=self.family, n_layers=self.n_layers,
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_ff=self.d_ff, vocab=self.vocab,
            head_dim=self.head_dim, n_experts=self.n_experts,
            top_k=self.top_k, ssm_state=self.ssm_state,
            attn_window=self.attn_window,
            n_encoder_layers=self.n_encoder_layers,
            encoder_seq=self.encoder_seq,
            tie_embeddings=self.tie_embeddings,
            mlp_mats=2 if self.mlp_kind == "gelu" else 3,
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.attn_window is not None


# ------------------------------------------------------------------ dispatch
def get_model(cfg: ModelConfig):
    """Return the family module implementing the model protocol."""
    if cfg.family in ("dense", "vlm"):
        from . import transformer
        return transformer
    if cfg.family == "moe":
        from . import moe
        return moe
    if cfg.family == "ssm":
        from . import xlstm
        return xlstm
    if cfg.family == "hybrid":
        from . import hymba
        return hymba
    if cfg.family == "encdec":
        from . import whisper
        return whisper
    raise ValueError(f"unknown family {cfg.family!r}")


# --------------------------------------------------------------- input specs
# Shape-only stand-ins, the port's counterpart of ``jax.eval_shape``: meta
# tensors with the reference's keys, shapes and dtypes (no allocation).
_META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def train_input_specs(cfg: ModelConfig, *, batch: int, seq_len: int
                      ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for one GRPO train step.

    tokens/loss_mask cover the full packed sequence; ``advantages`` are
    per-sequence (GRPO group-normalized), ``behavior_logp`` per token from
    the rollout policy (staleness-decoupled objective).
    """
    f = cfg.tdtype
    specs = {
        "tokens": _meta((batch, seq_len), torch.int32),
        "loss_mask": _meta((batch, seq_len), f),
        "advantages": _meta((batch,), torch.float32),
        "behavior_logp": _meta((batch, seq_len), torch.float32),
    }
    if cfg.family == "encdec":
        specs["frames"] = _meta((batch, cfg.encoder_seq, cfg.enc_dim), f)
    if cfg.family == "vlm":
        specs["patches"] = _meta((batch, cfg.encoder_seq, cfg.enc_dim), f)
    return specs


def decode_input_specs(cfg: ModelConfig, *, batch: int, ctx_len: int
                       ) -> Dict[str, torch.Tensor]:
    """Stand-ins for one ``serve_step`` (one new token, KV cache of ctx_len)."""
    return {
        "token": _meta((batch,), torch.int32),
        "pos": _meta((batch,), torch.int32),
    }


def cache_specs(cfg: ModelConfig, *, batch: int, ctx_len: int
                ) -> Dict[str, torch.Tensor]:
    """The decode cache on the meta device (model-specific)."""
    return get_model(cfg).init_cache(cfg, batch=batch, max_len=ctx_len,
                                     device=_META)


def param_specs(cfg: ModelConfig):
    """The parameter tree (``Params``) on the meta device."""
    return get_model(cfg).init(0, cfg, device=_META)
