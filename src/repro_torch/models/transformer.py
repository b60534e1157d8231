"""Model assembly for all six families, ported from ``repro.models.transformer``.

Entry points:
  init_params(cfg, generator, device)   -> parameter dict
  forward(params, cfg, batch, cache)    -> (logits fp32, aux, new_cache)

Parameters are a plain dict shaped like the reference's pytree, except that
``layers`` is a list of per-layer dicts (the reference stacks them on a
leading axis and scans; the port loops): for the hybrid family a list of
groups, each a list of ``attn_every`` mamba layers, beside the one
``shared`` decoder block; for the audio family ``enc_layers`` too.  Matmul
weights and biases are held in bf16 and norm scales in fp32 (see
``layers``).  ``weights.from_jax_params`` carries the reference's parameters
across.

Families: dense (qwen2, granite, internlm2), moe (olmoe, qwen3-moe: a dense
decoder whose MLP is the capacity-routed ``moe.moe_block``), ssm (mamba2),
hybrid (zamba2: groups of mamba layers, each followed by one shared
attention block), vlm (qwen2-vl: the dense decoder with M-RoPE and vision
embeddings in front of the text) and audio (whisper: an encoder over
precomputed frames and a decoder with cross-attention and sinusoidal
positions).
"""

from __future__ import annotations

import math
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
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


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

    def attn():
        p = {
            "wq": normal((d, cfg.n_heads * hd)),
            "wk": normal((d, cfg.n_kv_heads * hd)),
            "wv": normal((d, cfg.n_kv_heads * hd)),
            "wo": normal((cfg.n_heads * hd, d), scale=1.0 / np.sqrt(cfg.n_heads * hd)),
        }
        if cfg.qkv_bias:
            p["bq"] = zeros(cfg.n_heads * hd)
            p["bk"] = zeros(cfg.n_kv_heads * hd)
            p["bv"] = zeros(cfg.n_kv_heads * hd)
        return p

    def decoder_layer(cross: bool = False):
        layer = {"ln1": ones(d), "ln2": ones(d), "attn": attn()}
        if cross:
            layer["lnx"] = ones(d)
            layer["xattn"] = attn()
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
        return layer

    def mamba_layer():
        return {"ln": ones(d), "mamba": mamba()}

    d, v, hd, f = cfg.d_model, cfg.vocab, cfg.head_dim, cfg.d_ff
    params: Params = {"embed": normal((v, d), scale=0.02), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v))
    if cfg.family == "ssm":
        params["layers"] = [mamba_layer() for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        params["layers"] = [[mamba_layer() for _ in range(cfg.attn_every)] for _ in range(groups)]
        params["shared"] = decoder_layer()
    elif cfg.family == "audio":
        params["enc_layers"] = [decoder_layer() for _ in range(cfg.n_encoder_layers)]
        params["layers"] = [decoder_layer(cross=True) for _ in range(cfg.n_layers)]
        params["enc_norm"] = ones(d)
    else:
        params["layers"] = [decoder_layer() for _ in range(cfg.n_layers)]
    return params


# =================================================================== blocks
def _decoder_block(cfg: ModelConfig, x, p, positions, cache, enc_kv=None):
    """Pre-norm transformer block: self-attention [+ cross-attention] + MLP or MoE.

    Returns (x, aux, new_cache); aux is the MoE's load-balance loss, None for
    an MLP.
    """
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, new_cache = A.self_attention(
        h, p["attn"], cfg, positions=positions, cache=cache, use_rope=(cfg.family != "audio")
    )
    x = x + attn_out
    if enc_kv is not None:
        h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + A.cross_attention(h, p["xattn"], cfg, enc_kv)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        out, aux = M.moe_block(h, p["moe"], cfg)
        return x + out, aux, new_cache
    return x + L.mlp_block(h, p["mlp"], cfg.mlp), None, new_cache


def _mamba_layer(cfg: ModelConfig, x, p, cache):
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    out, new_cache = S.mamba_block(h, p["mamba"], cfg, cache)
    return x + out, new_cache


# =================================================================== stacks
def _mamba_stack(cfg: ModelConfig, x, layers: list, caches: dict | None, lead: tuple = ()):
    """Mamba layers in order; ``caches`` holds ``S.CACHE_KEYS`` buffers whose
    index ``(*lead, i)`` is layer i's, overwritten in place."""
    for i, p in enumerate(layers):
        layer_cache = {k: caches[k][(*lead, i)] for k in S.CACHE_KEYS} if caches is not None else None
        x, layer_new = _mamba_layer(cfg, x, p, layer_cache)
        if caches is not None:
            for k in S.CACHE_KEYS:
                caches[k][(*lead, i)].copy_(layer_new[k])
    return x


def _hybrid_stack(cfg: ModelConfig, x, params: Params, positions, caches: dict | None):
    """zamba2: groups of ``attn_every`` mamba layers, each followed by the one shared block.

    ``caches``: {"mamba": buffers (G, attn_every, ...), "attn": {"k", "v" (G, ...),
    "len" (G,)}} or None; group g's attention writes at its own ``len[g]``.
    Returns (x, aux); the buffers are updated in place.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g, group in enumerate(params["layers"]):
        x = _mamba_stack(cfg, x, group, caches["mamba"] if caches is not None else None, lead=(g,))
        attn_cache = None
        if caches is not None:
            ac = caches["attn"]
            attn_cache = {"k": ac["k"][g], "v": ac["v"][g], "len": ac["len"][g]}
        x, layer_aux, _ = _decoder_block(cfg, x, params["shared"], positions, attn_cache)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


# =================================================================== forward
def _sinusoid_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal embedding in fp32 for (B, S) positions, which may come from the device's ``len``."""
    half = d_model // 2
    inv = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=positions.device)
                    / (half - 1))
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(params: Params, cfg: ModelConfig, batch: dict, cache: dict | None):
    """Token (+ vision) embedding and positions: (B, S), or (3, B, S) for M-RoPE."""
    tokens = batch["tokens"]
    x = L.embed_tokens(tokens, params["embed"])
    if cfg.family == "vlm" and "vision_embeds" in batch:
        x = torch.cat([L.cast(batch["vision_embeds"]), x], dim=1)
    b, s = x.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        pos0 = cache["len"] if cache is not None else 0
        positions = (pos0 + torch.arange(s, device=x.device))[None, :].expand(b, s)
        if cfg.mrope:
            positions = positions[None].expand(3, b, s)
    if cfg.family == "audio":
        # whisper-style absolute positions on the decoder stream
        x = x + _sinusoid_at(positions, cfg.d_model).to(x.dtype)
    return x, positions


def _encode_audio(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed (stub conv-frontend) frames (B, S_enc, D).

    Its self-attention is non-causal, so it takes the chunked route, never the
    flash kernel, as in the reference.
    """
    x = L.cast(frames) + L.sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device).to(L.COMPUTE_DTYPE)
    positions = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    for p in params["enc_layers"]:
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn_out, _ = A.self_attention(h, p["attn"], cfg, positions=positions, causal=False, use_rope=False)
        x = x + attn_out
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp_block(h, p["mlp"], cfg.mlp)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(params: Params, cfg: ModelConfig, batch: dict, cache: dict | None = None):
    """Returns (logits (B,S,V) fp32, aux scalar, new_cache).

    aux is the sum of the layers' MoE load-balance losses, zero for the
    other families.

    batch: {"tokens": (B, S) integer tensor}, and optionally ``positions``
    ((B, S), or (3, B, S) for M-RoPE), for vlm ``vision_embeds`` (B, S_vis, D)
    put in front of the text, for audio ``frames`` (B, S_enc, D), which a
    cache holding ``enc_kv`` makes unnecessary.  With a cache (``kvcache``),
    positions continue from ``cache["len"]`` and the cache's buffers are
    updated in place; the returned cache shares them, with new ``len``
    tensors (the input's are left as they were) and, for audio, the
    encoder's K/V.  With one token and a cache, nothing here reads a
    tensor's value on the host.
    """
    require_ported(cfg)
    x, positions = _embed_inputs(params, cfg, batch, cache)
    s = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {**cache, "len": cache["len"] + s} if cache is not None else None
    if cfg.family == "ssm":
        x = _mamba_stack(cfg, x, params["layers"], cache)
    elif cfg.family == "hybrid":
        x, aux = _hybrid_stack(cfg, x, params, positions, cache)
        if cache is not None:
            new_cache["attn"] = {**cache["attn"], "len": cache["attn"]["len"] + s}
    else:
        enc_kv = None
        if cfg.family == "audio":
            if cache is not None and "enc_kv" in cache:
                enc_kv = cache["enc_kv"]
            else:
                enc_out = _encode_audio(params, cfg, batch["frames"])
                kvs = [A.encoder_kv(enc_out, p["xattn"], cfg) for p in params["layers"]]
                enc_kv = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
            if new_cache is not None:
                new_cache["enc_kv"] = enc_kv
        for i, p in enumerate(params["layers"]):
            layer_cache = None
            if cache is not None:
                layer_cache = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}
            ekv = (enc_kv[0][i], enc_kv[1][i]) if enc_kv is not None else None
            x, layer_aux, _ = _decoder_block(cfg, x, p, positions, layer_cache, ekv)
            if layer_aux is not None:
                aux = aux + layer_aux
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w_head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = L.lm_head(x, w_head)
    return logits, aux, new_cache
