"""xlstm-1.3b [arXiv:2405.04517] — mLSTM matrix-memory blocks, 4 heads.
No KV cache: decode state is O(1) in context."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=512,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                          head_dim=32, vocab=128,
                          dtype="float32", remat=False)
