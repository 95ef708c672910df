"""hymba-1.5b [arXiv:2411.13676; hf] — parallel attention + Mamba heads,
SWA(1024), ssm_state=16.  Meta tokens omitted (DESIGN.md §Arch-applicability).
Sub-quadratic decode state -> runs long_500k."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    ssm_state=16, attn_window=1024,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=40, n_heads=5, n_kv_heads=5,
                          head_dim=8, d_ff=96, vocab=128, ssm_state=4,
                          attn_window=16, dtype="float32", remat=False)
