"""grok-1-314b [hf:xai-org/grok-1] — MoE 8 experts top-2, d_ff=32768.
8 experts do not divide a 16-way model axis, so expert weights shard on
d_ff instead (moe_shard="ffn" — Megatron-MoE TP)."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, top_k=2, moe_shard="ffn",
    fsdp_params=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, n_experts=4, top_k=2,
                          vocab=128, dtype="float32", remat=False)
