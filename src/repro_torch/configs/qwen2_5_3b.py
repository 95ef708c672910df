"""qwen2.5-3b [hf:Qwen/Qwen2.5-3B] — GQA kv=2, QKV bias, tied embeddings."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=192, vocab=128,
                          dtype="float32", remat=False)
