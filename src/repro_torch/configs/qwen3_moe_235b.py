"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B] — MoE 128 experts top-8,
per-expert d_ff=1536, GQA kv=4.  Experts sharded over the model axis (EP)."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, moe_shard="expert", rope_theta=1e6,
    fsdp_params=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=32, n_experts=8, top_k=2,
                          vocab=128, dtype="float32", remat=False)
