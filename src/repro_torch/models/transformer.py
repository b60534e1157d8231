"""Model assembly, ported from ``repro.models.transformer`` (dense, moe and ssm families).

Entry points:
  init_params(cfg, generator, device)   -> parameter dict
  forward(params, cfg, batch, cache)    -> (logits fp32, aux, new_cache)

Parameters are a plain dict shaped like the reference's pytree, except that
``layers`` is a list of per-layer dicts (the reference stacks them on a
leading axis and scans; the port loops).  Matmul weights and biases are held
in bf16 and norm scales in fp32 (see ``layers``).  ``weights.from_jax_params``
carries the reference's parameters across.

The dense, moe (olmoe, qwen3-moe: a dense decoder whose MLP is the
capacity-routed ``moe.moe_block``) and ssm (mamba2) families are ported; the
other families raise ``NotImplementedError`` naming the family.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]
PORTED_FAMILIES = ("dense", "moe", "ssm")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (only {PORTED_FAMILIES})")


# =================================================================== init
def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: torch.device | str | None = None
) -> Params:
    """Random parameters with the reference's shapes and scales (``init_params``).

    Dense weights are N(0, 1) / sqrt(fan_in) (``wo``: 1 / sqrt(H * Dh)), the
    embedding N(0, 1) * 0.02, conv weights N(0, 1) * 0.5, biases zero and norm
    scales one; the experts' ``w_in`` and ``w_gate`` (E, D, F) N(0, 1) /
    sqrt(D) and ``w_out`` (E, F, D) N(0, 1) / sqrt(F); the SSM's ``dt_bias``
    is log(expm1(0.01)), ``a_log`` log(linspace(1, 16, H)) and ``d_skip`` one,
    as in ``repro.models.transformer``.  The numbers come from ``generator``, which
    must live on ``device``, and differ from ``jax.random``'s for the same
    seed: to compare with the reference, carry its parameters across with
    ``repro_torch.weights.from_jax_params``.
    """
    require_ported(cfg)
    dev = resolve_device(device)

    def normal(shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev) * scale
        return w.to(L.COMPUTE_DTYPE)

    def zeros(n):
        return torch.zeros((n,), dtype=L.COMPUTE_DTYPE, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def mamba():
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            "w_z": normal((d, di)),
            "w_x": normal((d, di)),
            "w_b": normal((d, n)),
            "w_c": normal((d, n)),
            "w_dt": normal((d, h)),
            "w_conv_x": normal((cfg.ssm_conv, di), scale=0.5),
            "b_conv_x": zeros(di),
            "w_conv_b": normal((cfg.ssm_conv, n), scale=0.5),
            "b_conv_b": zeros(n),
            "w_conv_c": normal((cfg.ssm_conv, n), scale=0.5),
            "b_conv_c": zeros(n),
            "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, **f32))),
            "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
            "d_skip": ones(h),
            "norm": ones(di),
            "w_out": normal((di, d)),
        }

    d, v, hd, f = cfg.d_model, cfg.vocab, cfg.head_dim, cfg.d_ff
    params: Params = {"embed": normal((v, d), scale=0.02), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v))
    if cfg.family == "ssm":
        params["layers"] = [{"ln": ones(d), "mamba": mamba()} for _ in range(cfg.n_layers)]
        return params
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
        layer = {"ln1": ones(d), "ln2": ones(d), "attn": attn}
        if cfg.family == "moe":
            e = cfg.moe_experts
            # a 3-D expert weight's fan-in is its second axis, not its first
            layer["moe"] = {
                "w_router": normal((d, e)),
                "w_in": normal((e, d, f), scale=1.0 / np.sqrt(d)),
                "w_gate": normal((e, d, f), scale=1.0 / np.sqrt(d)),
                "w_out": normal((e, f, d), scale=1.0 / np.sqrt(f)),
            }
        else:
            layer["mlp"] = {"w_in": normal((d, f)), "w_out": normal((f, d))}
            if cfg.mlp == "swiglu":
                layer["mlp"]["w_gate"] = normal((d, f))
        layers.append(layer)
    params["layers"] = layers
    return params


# =================================================================== blocks
def _decoder_block(cfg: ModelConfig, x, p, positions, cache):
    """Pre-norm transformer block: self-attention + MLP or MoE.

    Returns (x, aux, new_cache); aux is the MoE's load-balance loss, None for
    an MLP.
    """
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, new_cache = A.self_attention(h, p["attn"], cfg, positions=positions, cache=cache)
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        out, aux = M.moe_block(h, p["moe"], cfg)
        return x + out, aux, new_cache
    return x + L.mlp_block(h, p["mlp"], cfg.mlp), None, new_cache


def _mamba_layer(cfg: ModelConfig, x, p, cache):
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    out, new_cache = S.mamba_block(h, p["mamba"], cfg, cache)
    return x + out, new_cache


# =================================================================== forward
def forward(params: Params, cfg: ModelConfig, batch: dict, cache: dict | None = None):
    """Returns (logits (B,S,V) fp32, aux scalar, new_cache).

    aux is the sum of the layers' MoE load-balance losses, zero for the
    other families.

    batch: {"tokens": (B, S) integer tensor}.  With a cache (``kvcache``),
    positions continue from ``cache["len"]`` and the cache's buffers are
    updated in place; the returned cache shares them, with a new ``len``
    tensor (the input's ``len`` is left as it was).  With one token and a
    cache, nothing here reads a tensor's value on the host.
    """
    require_ported(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(tokens, params["embed"])
    b, s = tokens.shape
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.family == "ssm":
        for i, p in enumerate(params["layers"]):
            layer_cache = {k: cache[k][i] for k in S.CACHE_KEYS} if cache is not None else None
            x, layer_new = _mamba_layer(cfg, x, p, layer_cache)
            if cache is not None:
                for k in S.CACHE_KEYS:
                    cache[k][i].copy_(layer_new[k])
    else:
        pos0 = cache["len"] if cache is not None else 0
        positions = (pos0 + torch.arange(s, device=tokens.device))[None, :].expand(b, s)
        for i, p in enumerate(params["layers"]):
            layer_cache = None
            if cache is not None:
                layer_cache = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}
            x, layer_aux, _ = _decoder_block(cfg, x, p, positions, layer_cache)
            if layer_aux is not None:
                aux = aux + layer_aux
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "len": cache["len"] + s}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w_head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = L.lm_head(x, w_head)
    return logits, aux, new_cache
