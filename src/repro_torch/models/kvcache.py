"""Decode-time caches of the dense, moe and ssm families, ported from ``repro.models.kvcache``.

Each cache is a flat dict whose ``len``, the number of positions written, is
a 0-d int32 tensor on the cache's device, as the reference's int32 array is
(on one device every layer has the same length).  A decode step reads it
only on the device, so a CUDA graph can capture the step and replay it while
``len`` advances in place (``train.steps.capture_serve_step``).

* dense and moe: bf16 ``k`` and ``v`` of shape (L, B, S_max, KVH, D);
  ``self_attention`` updates them in place.
* ssm: fp32 conv buffers ``conv_x`` (L, B, K-1, d_inner), ``conv_b`` and
  ``conv_c`` (L, B, K-1, N), and the fp32 SSM ``state`` (L, B, H, P, N);
  ``transformer.forward`` overwrites each layer's slice in place.  Their size
  does not depend on S_max.

The other families raise naming the family.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

CACHE_DTYPE = torch.bfloat16


def _zero_len(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str) -> dict:
    """Zero cache for ``batch`` sequences of up to ``max_len`` positions."""
    if cfg.family == "ssm":
        k1, f32 = cfg.ssm_conv - 1, torch.float32
        lead = (cfg.n_layers, batch)
        return {
            "conv_x": torch.zeros((*lead, k1, cfg.d_inner), dtype=f32, device=device),
            "conv_b": torch.zeros((*lead, k1, cfg.ssm_state), dtype=f32, device=device),
            "conv_c": torch.zeros((*lead, k1, cfg.ssm_state), dtype=f32, device=device),
            "state": torch.zeros(
                (*lead, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), dtype=f32, device=device
            ),
            "len": _zero_len(device),
        }
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} caches are not ported yet")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
        "len": _zero_len(device),
    }
