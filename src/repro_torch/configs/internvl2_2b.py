"""internvl2-2b [arXiv:2404.16821; hf] — InternViT frontend STUBBED to
precomputed patch embeddings [B, 256, 1024]; InternLM2-1.8B LM backbone."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128,
    encoder_seq=256, encoder_dim=1024, rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=192, vocab=128, encoder_seq=4,
                          encoder_dim=32, dtype="float32", remat=False)
