"""GQA attention, ported from ``repro.models.attention`` for one device.

``chunked_attention`` (``xla_chunked``) is the plain online-softmax twin of
the flash kernel, scanning KV blocks of ``attention_block_k`` keys;
``full_attention`` (``xla_full``, and every decode step) materialises the
scores.  ``attention_impl="flash_pallas"`` sends causal attention over more
than one query, the cached prefill, to the hand-written Hopper kernel
(``repro_torch.kernels.ops.flash_attention``).

On one device the reference's head policy is always ``"kv_sharded"``, so the
port has no head policy; the multi-chip cores (``_q_sharded_core``,
``decode_seq_sharded``) wait for the sharding slice.

The flash route passes the causal offset of a cached prefill to the kernel.
The reference drops it (``repro/models/attention.py:153-158``), which is
exact only at offset 0, the prefill that ``generate`` runs.

The KV cache is updated in place: ``self_attention`` writes the new keys and
values into the cache's tensors at device positions and returns a cache that
shares them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def qkv_proj(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x: (B, S, D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh)."""
    b, s, _ = x.shape
    q = L.dense(x, p["wq"], p.get("bq")).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.dense(x, p["wk"], p.get("bk")).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(x, p["wv"], p.get("bv")).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def out_proj(o: torch.Tensor, p: dict) -> torch.Tensor:
    b, s = o.shape[:2]
    return L.dense(o.reshape(b, s, -1), p["wo"])


# ---------------------------------------------------------------- cores
def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    q_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """Materialised-scores GQA attention.  q: (B,Sq,H,Dh), k/v: (B,Skv,KV,Dh).

    ``q_offset`` may be a 0-d device tensor (a decode step's cache length).
    """
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh)
    # fp32 products of the bf16 operands: the reference's preferred_element_type
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (dh**-0.5)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = torch.arange(skv, device=q.device)[None, :] <= qpos[:, None]  # (Sq, Skv)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: int = 0,
    block_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block_k`` keys (flash-style, plain)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = (q * (dh**-0.5)).reshape(b, sq, kvh, g, dh).float()
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, dh), dtype=torch.float32, device=q.device)
    for start in range(0, skv, block_k):
        kj = k[:, start : start + block_k]
        vj = v[:, start : start + block_k]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj.float())
        kpos = start + torch.arange(kj.shape[1], device=q.device)
        if causal:
            s = s.masked_fill(~(kpos[None, :] <= qpos[:, None]), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype).float(), vj.float())
        acc = acc * scale[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-37)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def attention_core(q, k, v, cfg: ModelConfig, *, causal: bool,
                   q_offset: int | torch.Tensor = 0) -> torch.Tensor:
    """The attention route, as the reference's ``_plain_core``.

    On one device the reference's ``attention_core`` always takes
    ``_plain_core`` (the ``kv_sharded`` policy), so the port has the one.
    A tensor ``q_offset`` (a decode step's cache length) reaches only
    ``full_attention``, where every single query goes; the other cores take
    a host int.
    """
    if cfg.attention_impl == "xla_full" or q.shape[1] == 1:
        return full_attention(q, k, v, causal=causal, q_offset=q_offset)
    if cfg.attention_impl == "flash_pallas" and causal:
        return kernel_ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return chunked_attention(
        q, k, v, causal=causal, q_offset=q_offset, block_k=cfg.attention_block_k
    )


# ---------------------------------------------------------------- blocks
def self_attention(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    cache: dict | None = None,
    use_rope: bool = True,
):
    """Self-attention with an optional KV cache, updated in place.

    cache: {"k": (B, S_max, KV, Dh), "v": ..., "len": 0-d int tensor} or None.
    Returns (out-projected output (B, S, D), new cache or None).
    """
    q, k, v = qkv_proj(x, p, cfg)
    if use_rope:
        if cfg.mrope:
            raise NotImplementedError("M-RoPE (family 'vlm') is not ported yet")
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is not None:
        ck, cv, idx = cache["k"], cache["v"], cache["len"]
        s = k.shape[1]
        if s > 1:
            # A cached prefill runs eager and once, and the flash kernel takes
            # its causal offset as a host int, so it reads the length here.  A
            # one-token decode step reads no tensor value on the host: a CUDA
            # graph captures it (``generate`` checks the cache's room first).
            idx = int(idx)
            if idx + s > ck.shape[1]:
                raise ValueError(f"cache of {ck.shape[1]} positions cannot take {s} more after {idx}")
        pos = idx + torch.arange(s, device=ck.device)
        ck.index_copy_(1, pos, k.to(ck.dtype))
        cv.index_copy_(1, pos, v.to(cv.dtype))
        new_cache = {"k": ck, "v": cv, "len": cache["len"] + s}
        # keys past the new length are masked by the causal offset
        o = attention_core(q, ck.to(q.dtype), cv.to(q.dtype), cfg, causal=True, q_offset=idx)
    else:
        o = attention_core(q, k, v, cfg, causal=causal, q_offset=0)
    return out_proj(o, p), new_cache
