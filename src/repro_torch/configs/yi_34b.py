"""yi-34b [arXiv:2403.04652; hf] — llama-arch GQA kv=8."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128, rope_theta=5e6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=112, n_heads=7, n_kv_heads=1,
                          head_dim=16, d_ff=320, vocab=128,
                          dtype="float32", remat=False)
