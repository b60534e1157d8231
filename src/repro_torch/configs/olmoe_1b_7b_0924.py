"""olmoe-1b-7b-0924 [moe]: the published OLMoE-1B-7B-0924 (arXiv:2409.02060,
huggingface.co/allenai/OLMoE-1B-7B-0924): 16L d_model=2048 16H of 128 (MHA),
QK-norm, 64 SwiGLU experts of 1,024, top-8 without renormalisation, dropless,
rope_theta 10,000, untied head over 50,304 rows; 6.92 B parameters, 1.3 B
active.  The port's own: the JAX reference has no counterpart (its
``olmoe-1b-7b`` has none of QK-norm, raw top-k weights or dropless routing,
and rope_theta 1e6), so ``ARCHS`` does not list it."""
from repro_torch.models.published import PublishedConfig

CONFIG = PublishedConfig(
    name="olmoe-1b-7b-0924",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    rope_theta=10000.0,
    norm_eps=1e-5,
    moe_experts=64,
    moe_top_k=8,
    qk_norm=True,
    norm_topk_prob=False,
    moe_dropless=True,
)
