"""DeepSeek-R1-Distill-Qwen-7B — the paper's mid evaluation model."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="qwen-distill-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=56, n_heads=4, n_kv_heads=2,
                          head_dim=14, d_ff=160, vocab=128,
                          dtype="float32", remat=False)
