"""whisper-small [arXiv:2212.04356] — enc-dec; conv frontend STUBBED to
precomputed frame embeddings (input_specs provides [B, 1500, 768])."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    n_encoder_layers=12, encoder_seq=1500, encoder_dim=768,
    norm_kind="layer", tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=48,
                          n_heads=4, n_kv_heads=4, head_dim=12, d_ff=96,
                          vocab=128, encoder_seq=20, encoder_dim=48,
                          dtype="float32", remat=False)
