"""Architecture description consumed by the scheduler's cost models, the
port's copy of ``repro.core.model_spec``.

``ModelSpec`` is intentionally *coarser* than the real model configs in
``repro_torch.configs`` — it carries exactly the quantities the analytic
cost model needs (parameter counts, per-token FLOPs/bytes terms).  Every
config in ``repro_torch.configs`` exposes ``.spec`` returning one of these,
field for field the reference config's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    attn_window: Optional[int] = None   # SWA window; None = full attention
    # enc-dec
    n_encoder_layers: int = 0
    encoder_seq: int = 0                # stub-frontend sequence length (frames/patches)
    tie_embeddings: bool = False
    mlp_mats: int = 3                   # 3 = SwiGLU, 2 = GELU MLP

    # ---------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def ffn_params_per_layer(self, active_only: bool = False) -> float:
        """SwiGLU FFN params (3 mats).  For MoE: per activated path or total."""
        if self.d_ff == 0:
            return 0.0
        dense = self.mlp_mats * self.d_model * self.d_ff
        if self.n_experts > 0:
            mult = self.top_k if active_only else self.n_experts
            router = self.d_model * self.n_experts
            return dense * mult + router
        return dense

    def attn_params_per_layer(self) -> float:
        return (self.d_model * self.q_dim          # Wq
                + 2 * self.d_model * self.kv_dim   # Wk, Wv
                + self.q_dim * self.d_model)       # Wo

    def params(self, active_only: bool = False) -> float:
        """Total (or activated, for MoE) parameter count."""
        if self.family == "ssm":
            # mLSTM/sLSTM blocks: qkv-ish projections + gates; approximate with
            # 4*d^2 mixer + 2*d^2 gates per layer (matches xlstm-1.3b ~1.3e9).
            per_layer = 6 * self.d_model * self.d_model
            body = self.n_layers * per_layer
        else:
            per_layer = self.attn_params_per_layer() + self.ffn_params_per_layer(active_only)
            if self.family == "hybrid":
                # parallel SSM path alongside attention heads
                per_layer += 3 * self.d_model * self.d_model
            body = self.n_layers * per_layer
            if self.n_encoder_layers:
                enc_layer = (self.attn_params_per_layer()
                             + self.mlp_mats * self.d_model * self.d_ff)
                body += self.n_encoder_layers * enc_layer
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return body + embed

    # ------------------------------------------------------------- FLOP model
    def train_flops_per_token(self) -> float:
        """~6·N_active per token plus attention quadratic term is added by the
        cost model (it depends on sequence length)."""
        return 6.0 * self.params(active_only=True)

    def decode_flops_per_token(self) -> float:
        return 2.0 * self.params(active_only=True)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> float:
        """KV-cache bytes appended per generated token."""
        if self.family == "ssm":
            return 0.0
        return 2 * self.n_layers * self.kv_dim * dtype_bytes

    def state_bytes(self, dtype_bytes: int = 2) -> float:
        """Recurrent state bytes per sequence (SSM/hybrid)."""
        if self.family == "ssm":
            # mLSTM matrix state: heads × hd × hd
            return self.n_layers * self.n_heads * self.hd * self.hd * dtype_bytes
        if self.family == "hybrid":
            return self.n_layers * self.d_model * self.ssm_state * dtype_bytes
        return 0.0

    def weight_bytes(self, dtype_bytes: int = 2) -> float:
        return self.params() * dtype_bytes


# The paper's own evaluation models (DeepSeek-R1-Distill-Qwen 1.5B/7B/14B).
QWEN_DISTILL_1_5B = ModelSpec(
    name="qwen-distill-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128,
)
QWEN_DISTILL_7B = ModelSpec(
    name="qwen-distill-7b", family="dense", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128,
)
QWEN_DISTILL_14B = ModelSpec(
    name="qwen-distill-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064, head_dim=128,
)

PAPER_MODELS = {
    "1.5B": QWEN_DISTILL_1_5B,
    "7B": QWEN_DISTILL_7B,
    "14B": QWEN_DISTILL_14B,
}
