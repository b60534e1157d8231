"""zamba2-2.7b [hybrid]: Mamba2 blocks + shared attention block (arXiv:2411.15242).

54 Mamba2 layers, d_model=2560, shared transformer block (32 MHA heads,
d_ff=10240) applied every 6 mamba layers with shared weights (per-application
LoRA adapters of the original are omitted -- see DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    rope_theta=10000.0,
)
