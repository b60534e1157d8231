"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H GQA(kv=4) d_ff=1536/expert,
128 experts top-8 (hf:Qwen/Qwen3-235B-A22B)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    moe_experts=128,
    moe_top_k=8,
    rope_theta=1e6,
)
