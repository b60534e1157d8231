"""Decode-time caches of every family, ported from ``repro.models.kvcache``.

Each cache is a dict whose ``len``, the number of positions written, is a
0-d int32 tensor on the cache's device, as the reference's int32 array is
(on one device every layer has the same length).  A decode step reads it
only on the device, so a CUDA graph can capture the step and replay it while
``len`` advances in place (``train.steps.capture_serve_step``, through
``advance``).

* dense, moe and vlm: bf16 ``k`` and ``v`` of shape (L, B, S_max, KVH, D);
  ``self_attention`` updates them in place.
* ssm: fp32 conv buffers ``conv_x`` (L, B, K-1, d_inner), ``conv_b`` and
  ``conv_c`` (L, B, K-1, N), and the fp32 SSM ``state`` (L, B, H, P, N);
  ``transformer.forward`` overwrites each layer's slice in place.  Their size
  does not depend on S_max.
* hybrid (zamba2): ``mamba``, the ssm buffers with two leading axes (G,
  attn_every) for G = n_layers / attn_every groups, and ``attn``, the shared
  block's bf16 ``k`` and ``v`` (G, B, S_max, KVH, D) with one ``len`` per
  group, an int32 (G,) tensor whose entries are 0-d views, as the
  reference's (groups,) array.
* audio (whisper): the dense ``k`` and ``v`` of the decoder's self-attention
  and ``enc_kv``, the cross-attention's (K, V), each bf16 (L, B, S_enc, KVH,
  D).  The prefill computes ``enc_kv`` from the frames (``generate`` drops the
  zero one first, as the reference does) and the returned cache keeps it, so
  a captured decode step reads the same buffers on every replay.

The reference's ``init_cache(..., concrete=False)`` (shape stand-ins for
the dry run) is ``init_cache`` called under ``FakeTensorMode``; its leaves'
specs come from ``launch.shardings.cache_specs``.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

CACHE_DTYPE = torch.bfloat16


def _kv_heads_spec(cfg: ModelConfig, rules) -> str | None:
    """"tp" where the rules' tp size divides the kv heads, else None (no rules: None)."""
    if rules is None:
        return None
    return "tp" if cfg.n_kv_heads % rules.tp_size == 0 else None


def _zero_len(device, *shape: int) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device)


def _ssm_buffers(cfg: ModelConfig, lead: tuple, batch: int, device) -> dict:
    k1, f32 = cfg.ssm_conv - 1, torch.float32
    lead = (*lead, batch)
    return {
        "conv_x": torch.zeros((*lead, k1, cfg.d_inner), dtype=f32, device=device),
        "conv_b": torch.zeros((*lead, k1, cfg.ssm_state), dtype=f32, device=device),
        "conv_c": torch.zeros((*lead, k1, cfg.ssm_state), dtype=f32, device=device),
        "state": torch.zeros(
            (*lead, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), dtype=f32, device=device
        ),
    }


def _kv(lead: int, batch: int, max_len: int, cfg: ModelConfig, device) -> dict:
    shape = (lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str) -> dict:
    """Zero cache for ``batch`` sequences of up to ``max_len`` positions."""
    if cfg.family == "ssm":
        return {**_ssm_buffers(cfg, (cfg.n_layers,), batch, device), "len": _zero_len(device)}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        return {
            "mamba": _ssm_buffers(cfg, (groups, cfg.attn_every), batch, device),
            "attn": {**_kv(groups, batch, max_len, cfg, device), "len": _zero_len(device, groups)},
            "len": _zero_len(device),
        }
    if cfg.family == "audio":
        enc = _kv(cfg.n_layers, batch, cfg.encoder_seq or 1500, cfg, device)
        return {**_kv(cfg.n_layers, batch, max_len, cfg, device), "enc_kv": (enc["k"], enc["v"]),
                "len": _zero_len(device)}
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(cfg.family)
    return {**_kv(cfg.n_layers, batch, max_len, cfg, device), "len": _zero_len(device)}


def advance(cache: dict, n: int) -> None:
    """Advance every ``len`` of ``cache`` by ``n`` in place (the hybrid's per-group lengths too)."""
    cache["len"] += n
    if "attn" in cache:
        cache["attn"]["len"] += n
