"""DeepSeek-R1-Distill-Qwen-1.5B — the paper's smallest evaluation model."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="qwen-distill-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128, qkv_bias=True, rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
                          head_dim=12, d_ff=128, vocab=128,
                          dtype="float32", remat=False)
