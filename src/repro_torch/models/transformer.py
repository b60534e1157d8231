"""Model assembly, ported from ``repro.models.transformer`` (dense family).

Entry points:
  init_params(cfg, generator, device)   -> parameter dict
  forward(params, cfg, batch, cache)    -> (logits fp32, aux, new_cache)

Parameters are a plain dict shaped like the reference's pytree, except that
``layers`` is a list of per-layer dicts (the reference stacks them on a
leading axis and scans; the port loops).  Matmul weights and biases are held
in bf16 and norm scales in fp32 (see ``layers``).  ``weights.from_jax_params``
carries the reference's parameters across.

Only the dense family is ported; the other families raise
``NotImplementedError`` naming the family.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (only 'dense')")


# =================================================================== init
def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: torch.device | str | None = None
) -> Params:
    """Random parameters with the reference's shapes and scales (``init_params``).

    Dense weights are N(0, 1) / sqrt(fan_in) (``wo``: 1 / sqrt(H * Dh)), the
    embedding N(0, 1) * 0.02, biases zero and norm scales one, as in
    ``repro.models.transformer``.  The numbers come from ``generator``, which
    must live on ``device``, and differ from ``jax.random``'s for the same
    seed: to compare with the reference, carry its parameters across with
    ``repro_torch.weights.from_jax_params``.
    """
    _require_dense(cfg)
    dev = resolve_device(device)

    def normal(shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev) * scale
        return w.to(L.COMPUTE_DTYPE)

    def zeros(n):
        return torch.zeros((n,), dtype=L.COMPUTE_DTYPE, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    d, v, hd, f = cfg.d_model, cfg.vocab, cfg.head_dim, cfg.d_ff
    params: Params = {"embed": normal((v, d), scale=0.02), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v))
    layers = []
    for _ in range(cfg.n_layers):
        attn = {
            "wq": normal((d, cfg.n_heads * hd)),
            "wk": normal((d, cfg.n_kv_heads * hd)),
            "wv": normal((d, cfg.n_kv_heads * hd)),
            "wo": normal((cfg.n_heads * hd, d), scale=1.0 / np.sqrt(cfg.n_heads * hd)),
        }
        if cfg.qkv_bias:
            attn["bq"] = zeros(cfg.n_heads * hd)
            attn["bk"] = zeros(cfg.n_kv_heads * hd)
            attn["bv"] = zeros(cfg.n_kv_heads * hd)
        mlp = {"w_in": normal((d, f)), "w_out": normal((f, d))}
        if cfg.mlp == "swiglu":
            mlp["w_gate"] = normal((d, f))
        layers.append({"ln1": ones(d), "ln2": ones(d), "attn": attn, "mlp": mlp})
    params["layers"] = layers
    return params


# =================================================================== blocks
def _decoder_block(cfg: ModelConfig, x, p, positions, cache):
    """Pre-norm transformer block: self-attention + MLP."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, new_cache = A.self_attention(h, p["attn"], cfg, positions=positions, cache=cache)
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_block(h, p["mlp"], cfg.mlp), new_cache


# =================================================================== forward
def forward(params: Params, cfg: ModelConfig, batch: dict, cache: dict | None = None):
    """Returns (logits (B,S,V) fp32, aux scalar, new_cache).

    batch: {"tokens": (B, S) integer tensor}.  With a cache (``kvcache``),
    positions continue from ``cache["len"]`` and the cache is updated in
    place; the returned cache shares its tensors.
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(tokens, params["embed"])
    b, s = tokens.shape
    pos0 = cache["len"] if cache is not None else 0
    positions = (pos0 + torch.arange(s, device=tokens.device))[None, :].expand(b, s)
    for i, p in enumerate(params["layers"]):
        layer_cache = None
        if cache is not None:
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}
        x, _ = _decoder_block(cfg, x, p, positions, layer_cache)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "len": cache["len"] + s}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w_head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = L.lm_head(x, w_head)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux, new_cache
