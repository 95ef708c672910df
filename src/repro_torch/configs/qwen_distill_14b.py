"""DeepSeek-R1-Distill-Qwen-14B — the paper's largest evaluation model."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="qwen-distill-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=80, n_heads=4, n_kv_heads=2,
                          head_dim=20, d_ff=224, vocab=128,
                          dtype="float32", remat=False)
