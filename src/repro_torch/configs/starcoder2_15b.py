"""starcoder2-15b [arXiv:2402.19173; hf] — GQA kv=4, RoPE, full attention."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, head_dim=128, rope_theta=1e5,
    mlp_kind="gelu",   # starcoder2 uses a 2-matrix GELU MLP, not SwiGLU
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                          head_dim=16, d_ff=256, vocab=128,
                          dtype="float32", remat=False)
