"""Model/architecture configuration for the 10 assigned architectures.

A copy of ``repro.models.config``: the port imports nothing of the JAX
package, so it keeps its own copy of this pure-data module, field for field
and value for value (``tests/test_torch_package.py`` pins the two together).

Two execution knobs read differently in the port:

* ``attention_impl="flash_pallas"`` selects the hand-written Hopper
  flash-attention kernel (``repro_torch/kernels/csrc/flash_attention.cu``)
  in place of the Pallas TPU kernel; the literal keeps its name so configs
  stay interchangeable between the two packages.
* ``attention_block_q/k`` are TPU tile sizes.  The port's plain chunked
  attention honours ``attention_block_k``; the CUDA kernel picks its own
  tiles, because tiling does not change the function.

``ssm_chunk`` is the SSD scan's chunk length, as in the reference; on the
card the hand-written scan kernel (``repro_torch/kernels/csrc/ssd_scan.cu``)
takes 64 or 128, and it runs on every CUDA prefill of an ssm model (the
reference's model path runs the scan's XLA twin instead; there is no switch).

``remat`` chooses the training path's activation checkpointing per layer
(``transformer._maybe_remat``), as in the reference.  ``scan_layers`` and
``inner_unroll`` are JAX compilation knobs that the port's eager PyTorch
code has no use for; they are kept so that the configs compare equal.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- hybrid (zamba2-style): one shared attention+MLP block applied
    # after every `attn_every` mamba blocks (weights shared across uses) ---
    attn_every: int = 0

    # --- encoder-decoder (whisper-style) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # fixed frame count from the (stubbed) conv frontend

    # --- VLM (qwen2-vl-style) ---
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    vision_tokens: int = 0  # precomputed patch embeddings from the stub frontend

    # --- execution knobs (perf levers; see EXPERIMENTS.md §Perf) ---
    attention_impl: Literal["xla_chunked", "xla_full", "flash_pallas"] = "xla_chunked"
    attention_block_q: int = 512
    attention_block_k: int = 1024
    remat: Literal["none", "full", "dots"] = "full"
    scan_layers: bool = True
    #: fully unroll inner chunk loops (attention KV blocks, SSD chunks) --
    #: used by the dry-run cost probes so XLA cost analysis sees every trip
    inner_unroll: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---------------------------------------------------------- derived sizes
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k applies."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        mlp = d * f * (3 if self.mlp == "swiglu" else 2)
        moe_mlp = 3 * d * f * self.moe_experts + d * self.moe_experts
        ssm = 0
        if self.ssm_state:
            di, g, n, h = self.d_inner, 1, self.ssm_state, self.ssm_heads
            proj_out = 2 * di + 2 * g * n + h
            ssm = d * proj_out + self.ssm_conv * (di + 2 * g * n) + 3 * h + di + di * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        n = emb + 2 * d  # final norm(s)
        per_layer_norms = 2 * d
        if self.family == "moe":
            n += self.n_layers * (attn + moe_mlp + per_layer_norms)
        elif self.family == "ssm":
            n += self.n_layers * (ssm + d)
        elif self.family == "hybrid":
            n_shared_uses = self.n_layers // max(1, self.attn_every)
            n += self.n_layers * (ssm + d) + (attn + mlp + per_layer_norms)
            del n_shared_uses  # weights are shared; count once
        elif self.is_encoder_decoder:
            cross = d * n_q + 2 * d * n_kv + n_q * d
            n += self.n_encoder_layers * (attn + mlp + per_layer_norms)
            n += self.n_layers * (attn + cross + mlp + 3 * d)
            n += self.encoder_seq * 0
        else:
            n += self.n_layers * (attn + mlp + per_layer_norms)
        return int(n)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_moe = 3 * d * f * self.moe_experts
        active_moe = 3 * d * f * self.moe_top_k
        return int(self.param_count() - self.n_layers * (dense_moe - active_moe))


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k only for sub-quadratic archs (see DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2 * max(1, cfg.attn_every) if cfg.attn_every else 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        moe_experts=min(cfg.moe_experts, 8) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        mrope_sections=(4, 6, 6) if cfg.mrope else cfg.mrope_sections,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 64) if cfg.encoder_seq else 0,
        vision_tokens=min(cfg.vision_tokens, 16) if cfg.vision_tokens else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        attention_block_q=64,
        attention_block_k=64,
        remat="none",
    )
