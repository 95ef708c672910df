"""h2o-danube-1.8b [arXiv:2401.16818; hf] — llama+mistral mix, SWA(4096)."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, head_dim=80,
    attn_window=4096, rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                          head_dim=8, d_ff=160, vocab=128, attn_window=16,
                          dtype="float32", remat=False)
