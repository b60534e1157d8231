"""whisper-medium [audio]: enc-dec 24+24L d_model=1024 16H d_ff=4096
vocab=51865; conv frontend stubbed -- input_specs provides precomputed
1500-frame embeddings (arXiv:2212.04356)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    n_encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    mlp="gelu",
)
