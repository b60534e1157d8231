"""qwen2-vl-2b [vlm]: qwen2-1.5b backbone + M-RoPE; vision frontend is a stub
that supplies precomputed patch embeddings (arXiv:2409.12191)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_tokens=1024,
    rope_theta=1e6,
)
