"""Decode-time KV cache of the dense family, ported from ``repro.models.kvcache``.

The cache is a dict: bf16 ``k`` and ``v`` of shape (L, B, S_max, KVH, D) and
``len``, the number of positions written, as a Python int (the reference
keeps a per-layer int32 array; on one device every layer has the same
length, and a host int costs no device sync).  ``self_attention`` updates
the tensors in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

CACHE_DTYPE = torch.bfloat16


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str) -> dict:
    """Zero cache for ``batch`` sequences of up to ``max_len`` positions."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} caches are not ported yet")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "len": 0,
    }
