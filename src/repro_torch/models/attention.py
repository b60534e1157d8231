"""GQA attention, ported from ``repro.models.attention`` for one device.

``chunked_attention`` (``xla_chunked``) is the plain online-softmax twin of
the flash kernel, scanning KV blocks of ``attention_block_k`` keys;
``full_attention`` (``xla_full``, and every decode step) materialises the
scores.  ``attention_impl="flash_pallas"`` sends causal attention over more
than one query, the cached prefill, to the hand-written Hopper kernel
(``repro_torch.kernels.ops.flash_attention``).  Non-causal attention (whisper's
encoder and every cross-attention) takes the chunked route, or ``full_attention``
for one query, as in the reference.

Head-sharding policy (``head_policy``), as the reference's, under sharding
rules on a multi-device mesh (``repro_torch.distributed``):

* "kv_sharded"  -- n_kv_heads % tp == 0: classic GQA tensor parallelism;
  the core runs per rank on its heads.
* "q_sharded"   -- n_heads % tp == 0 but kv heads are not divisible (MQA /
  narrow GQA): q heads shard over tp, k/v replicate; ``_q_sharded_core``
  gathers each local q head's kv partner so the grouped reshape never
  crosses shards.
* "replicated"  -- heads not divisible (or ``seq_parallel``): attention
  weights replicate; parallelism comes from batch (and, under
  ``seq_parallel``, each rank's own queries against all keys).

Every core runs through ``distributed.local_call`` (the reference's GSPMD
propagates through its cores; DTensor's cannot take the grouped 5-D
products).  Decode against a sequence-sharded cache (the policies other
than "kv_sharded") is ``decode_seq_sharded`` (flash-decode).  With no rules
or one device the policy is "kv_sharded" and every path is the
single-device one.

With ``qk_norm`` (a ``models.published.PublishedConfig``: OLMoE) an RMS norm
over the whole q width and the whole k width runs after the projections and
before RoPE, on every route, so the cache holds the normalised keys.

The flash route passes the causal offset of a cached prefill to the kernel.
The reference drops it (``repro/models/attention.py:153-158``), which is
exact only at offset 0, the prefill that ``generate`` runs.

The KV cache is updated in place: ``self_attention`` writes the new keys and
values into the cache's tensors at device positions and returns a cache that
shares them.
"""

from __future__ import annotations

import torch

from repro_torch import distributed as D
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def head_policy(cfg: ModelConfig) -> str:
    rules = D.active_rules()
    if rules is None or rules.tp_size == 1:
        return "kv_sharded"  # degenerate: everything divides 1
    if rules.seq_parallel:
        return "replicated"  # tokens shard over the model axis, heads don't
    tp = rules.tp_size
    if cfg.n_kv_heads % tp == 0:
        return "kv_sharded"
    if cfg.n_heads % tp == 0:
        return "q_sharded"
    return "replicated"


def _head_specs(cfg: ModelConfig) -> tuple[str | None, str | None]:
    policy = head_policy(cfg)
    q_spec = "tp" if policy in ("kv_sharded", "q_sharded") else None
    kv_spec = "tp" if policy == "kv_sharded" else None
    return q_spec, kv_spec


def _rope(q, k, positions, cfg: ModelConfig):
    if cfg.mrope and positions.ndim == 3:
        return (L.apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                L.apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return L.apply_rope(q, positions, cfg.rope_theta), L.apply_rope(k, positions, cfg.rope_theta)


def _project(x, wq, wk, wv, bq, bk, bv, positions, cfg: ModelConfig, q_norm=None, k_norm=None):
    """The projections, then with ``q_norm`` / ``k_norm`` (QK-norm) an RMS norm over the whole q
    and the whole k width, then the rotation."""
    b, s, _ = x.shape
    q, k = L.dense(x, wq, bq), L.dense(x, wk, bk)
    if q_norm is not None:
        q, k = L.rms_norm(q, q_norm, cfg.norm_eps), L.rms_norm(k, k_norm, cfg.norm_eps)
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = L.dense(x, wv, bv).reshape(b, s, -1, cfg.head_dim)
    if positions is not None:
        q, k = _rope(q, k, positions, cfg)
    return q, k, v


def qkv_proj(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor | None = None):
    """x: (B, S, D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh), rotated by ``positions`` when given.

    With ``cfg.qk_norm`` (``models.published``) q and k are normalised over
    their whole widths by ``p["q_norm"]`` and ``p["k_norm"]`` before the
    rotation, so the cache holds normalised keys.

    Under distributed rules the projections and the rotation run per rank on
    its heads (by the head policy), q on its tokens under ``seq_parallel``,
    where k/v are then gathered over the sequence.  QK-norm is not written
    for that path: its norm runs over every head.
    """
    rules = D.distributed_rules()
    w = [p["wq"], p["wk"], p["wv"], p.get("bq"), p.get("bk"), p.get("bv")]
    qk_norm = getattr(cfg, "qk_norm", False)
    if rules is None or not isinstance(x, D.DTensor):
        norms = (p["q_norm"], p["k_norm"]) if qk_norm else ()
        return _project(x, *w, positions, cfg, *norms)
    if qk_norm:
        raise NotImplementedError(f"{cfg.name}: QK-norm runs on one device; the sharded attention path "
                                  f"has no norm over the whole q and k widths")
    b, s, _ = x.shape
    q_spec, kv_spec = _head_specs(cfg)
    x_spec = D.sanitize_spec(rules, rules.spec("batch", "seq", None), x.shape)
    q_out = D.sanitize_spec(rules, rules.spec("batch", "seq", q_spec, None), (b, s, cfg.n_heads, cfg.head_dim))
    kv_out = D.sanitize_spec(rules, rules.spec("batch", "seq", kv_spec, None), (b, s, cfg.n_kv_heads, cfg.head_dim))
    qw, kw = rules.spec(None, q_spec), rules.spec(None, kv_spec)
    pos_spec = None
    if positions is not None:
        lead = (None,) if positions.ndim == 3 else ()
        pos_spec = D.sanitize_spec(rules, D.P(*lead, *x_spec[:2]), positions.shape)
    inputs = [(x, x_spec), (w[0], qw), (w[1], kw), (w[2], kw), (w[3], D.P(qw[1])), (w[4], D.P(kw[1])),
              (w[5], D.P(kw[1])), (positions, pos_spec)]
    q, k, v = D.local_call(lambda *a: _project(*a, cfg), inputs, [q_out, kv_out, kv_out])
    # seq-parallel: q stays token-sharded; k/v replicate over seq (all-gather)
    k = D.shard(k, "batch", None, kv_spec, None)
    v = D.shard(v, "batch", None, kv_spec, None)
    return q, k, v


def out_proj(o: torch.Tensor, p: dict) -> torch.Tensor:
    b, s = o.shape[:2]
    y = L.dense(o.reshape(b, s, -1), p["wo"])
    return D.shard(y, "batch", "seq", None)


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


def _plain_core(q, k, v, cfg: ModelConfig, *, causal: bool,
                q_offset: int | torch.Tensor = 0) -> torch.Tensor:
    """The attention route, as the reference's ``_plain_core``.

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


def _core_specs(cfg: ModelConfig, q, k):
    """(q spec, k/v spec) of the core's local call under the active rules."""
    rules = D.active_rules()
    policy = head_policy(cfg)
    q_spec = rules.spec("batch", "seq", "tp" if policy != "replicated" else None, None)
    kv_spec = rules.spec("batch", None, "tp" if policy == "kv_sharded" else None, None)
    return D.sanitize_spec(rules, q_spec, q.shape), D.sanitize_spec(rules, kv_spec, k.shape)


def _local_offset(q_offset, q_spec, sq_local: int):
    """The causal offset of this rank's queries: under ``seq_parallel`` a rank
    holds queries ``tp_index * Sq_local`` onward."""
    if q_spec[1] is None:
        return q_offset
    return q_offset + D.tp_index() * sq_local


def attention_core(q, k, v, cfg: ModelConfig, *, causal: bool,
                   q_offset: int | torch.Tensor = 0) -> torch.Tensor:
    """The reference's ``attention_core``: ``_q_sharded_core`` under the
    "q_sharded" policy (more than one query), else ``_plain_core``, per rank
    on its heads (and, under ``seq_parallel``, its queries) when the rules
    shard anything."""
    if D.distributed_rules() is None:
        return _plain_core(q, k, v, cfg, causal=causal, q_offset=q_offset)
    if head_policy(cfg) == "q_sharded" and q.shape[1] > 1:
        return _q_sharded_core(q, k, v, cfg, causal=causal, q_offset=q_offset)
    q_spec, kv_spec = _core_specs(cfg, q, k)

    def local_fn(q_l, k_l, v_l, off):
        off = _local_offset(off, q_spec, q_l.shape[1])
        return _plain_core(q_l, k_l, v_l, cfg, causal=causal, q_offset=off)

    off_spec = D.P() if isinstance(q_offset, torch.Tensor) else None
    return D.local_call(local_fn, [(q, q_spec), (k, kv_spec), (v, kv_spec), (q_offset, off_spec)], [q_spec])


def _q_sharded_core(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset=0) -> torch.Tensor:
    """Local core for MQA/narrow-GQA: q heads over tp, kv replicated.

    Each rank gathers the kv partner of its local q heads (so the grouped
    reshape happens on local tensors) and runs the plain core locally.
    """
    rules = D.active_rules()
    g = cfg.n_heads // cfg.n_kv_heads
    h_local = cfg.n_heads // rules.tp_size
    q_spec, kv_spec = _core_specs(cfg, q, k)

    def local_fn(q_l, k_l, v_l):
        heads = D.tp_index() * h_local + torch.arange(h_local, device=q_l.device)
        kv_idx = heads // g  # kv partner of each local q head
        k_g = k_l.index_select(2, kv_idx)  # (B,S,h_local,D)
        v_g = v_l.index_select(2, kv_idx)
        return _plain_core(q_l, k_g, v_g, cfg, causal=causal, q_offset=q_offset)

    return D.local_call(local_fn, [(q, q_spec), (k, kv_spec), (v, kv_spec)], [q_spec])


# ---------------------------------------------------------------- flash-decode
def decode_seq_sharded(q, cache_k, cache_v, k_new, v_new, idx, cfg: ModelConfig):
    """One decode step against a sequence-sharded KV cache (flash-decode).

    q (B,1,H,Dh) replicated over tp; cache_k/v (B,S_max,KVH,Dh) seq-sharded
    over tp, updated in place; idx the 0-d cache length.  The owning rank
    writes the new K/V at global position ``idx`` (every rank writes: the
    others write back the row they hold, so no rank reads ``idx`` on the
    host); every rank takes a partial softmax over its slice, and partials
    merge with the log-sum-exp combine: a max over tp, then two sums (a few
    KiB).  Returns (o (B,1,H,Dh) replicated over tp, cache_k, cache_v).
    """
    rules = D.active_rules()
    kvh = cfg.n_kv_heads
    g = cfg.n_heads // kvh
    scale = cfg.head_dim**-0.5
    rep = D.sanitize_spec(rules, rules.spec("batch", None, None, None), q.shape)
    seq = D.sanitize_spec(rules, rules.spec("batch", "tp", None, None), cache_k.shape)
    red = D.P(rep[0], None, None)  # (B, KVH, G): replicated over tp once combined
    s_spec = D.P(rep[0], None, None, seq[1])  # (B, KVH, G, S_local)

    def combined(op):
        """Placements of a per-rank partial over the sequence slices, still to combine by ``op`` over tp."""
        return D.with_partial(rules.mesh, red, 3, D.axes_of(seq[1]), op)

    def scores(q_l, ck, cv, k1, v1, idx_l):
        s_l = ck.shape[1]
        start = D.tp_index() * s_l if seq[1] is not None else 0
        local_idx = idx_l - start
        owned = (local_idx >= 0) & (local_idx < s_l)
        li = local_idx.clamp(0, s_l - 1).reshape(1).long()
        ck.index_copy_(1, li, torch.where(owned, k1.to(ck.dtype), ck.index_select(1, li)))
        cv.index_copy_(1, li, torch.where(owned, v1.to(cv.dtype), cv.index_select(1, li)))
        b = q_l.shape[0]
        qg = (q_l[:, 0] * scale).reshape(b, kvh, g, cfg.head_dim)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float())
        kpos = start + torch.arange(s_l, device=ck.device)
        s = s.masked_fill(~(kpos <= idx_l), NEG_INF)  # the current token included
        return s, s.amax(dim=-1)

    s, m_loc = D.local_call(scores, [(q, rep), (cache_k, seq), (cache_v, seq), (k_new, rep), (v_new, rep),
                                     (idx, D.P())], [s_spec, combined("max")])
    m_glob = D.constrain(m_loc, red)

    def partials(s_l, m, cv):
        p = torch.exp(s_l - m[..., None])
        return p.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd", p, cv.float())

    l_loc, o_loc = D.local_call(partials, [(s, s_spec), (m_glob, red), (cache_v, seq)],
                                [combined("sum"), combined("sum")])
    l_glob = D.constrain(l_loc, red)
    o_glob = D.constrain(o_loc, D.P(*red, None)) / torch.clamp(l_glob[..., None], min=1e-37)
    b = q.shape[0]
    o = o_glob.reshape(b, 1, cfg.n_heads, cfg.head_dim).to(q.dtype)
    return o, cache_k, cache_v


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
    q, k, v = qkv_proj(x, p, cfg, positions if use_rope else None)
    new_cache = None
    if cache is not None:
        ck, cv, idx = cache["k"], cache["v"], cache["len"]
        s = k.shape[1]
        if s == 1 and head_policy(cfg) != "kv_sharded":
            # flash-decode against a sequence-sharded cache (see module doc)
            o, ck, cv = decode_seq_sharded(q, ck, cv, k, v, idx, cfg)
            return out_proj(o, p), {"k": ck, "v": cv, "len": idx + 1}
        if s > 1:
            # A cached prefill runs eager and once, and the flash kernel takes
            # its causal offset as a host int, so it reads the length here.  A
            # one-token decode step reads no tensor value on the host: a CUDA
            # graph captures it (``generate`` checks the cache's room first).
            idx = int(idx)
            if idx + s > ck.shape[1]:
                raise ValueError(f"cache of {ck.shape[1]} positions cannot take {s} more after {idx}")
        _cache_write(ck, cv, k, v, idx, cfg)
        new_cache = {"k": ck, "v": cv, "len": cache["len"] + s}
        # keys past the new length are masked by the causal offset
        o = attention_core(q, ck.to(q.dtype), cv.to(q.dtype), cfg, causal=True, q_offset=idx)
    else:
        o = attention_core(q, k, v, cfg, causal=causal, q_offset=0)
    return out_proj(o, p), new_cache


def _cache_write(ck, cv, k, v, idx, cfg: ModelConfig) -> None:
    """Write k/v (B, S, KV, Dh) into the caches at positions ``idx`` onward, in
    place; per rank on its kv heads when the rules shard them, or on its
    slice of a sequence-sharded cache (a cached prefill, ``idx`` a host int)."""

    def write(ck, cv, k, v, idx):
        pos = idx + torch.arange(k.shape[1], device=ck.device)
        ck.index_copy_(1, pos, k.to(ck.dtype))
        cv.index_copy_(1, pos, v.to(cv.dtype))
        return ()

    rules = D.distributed_rules()
    if rules is None:
        write(ck, cv, k, v, idx)
        return
    if head_policy(cfg) == "kv_sharded":
        spec = D.sanitize_spec(rules, rules.spec("batch", None, "tp", None), ck.shape)
        idx_spec = D.P() if isinstance(idx, torch.Tensor) else None
        D.local_call(write, [(ck, spec), (cv, spec), (k, spec), (v, spec), (idx, idx_spec)], [])
        return
    seq = D.sanitize_spec(rules, rules.spec("batch", "tp", None, None), ck.shape)
    new = D.sanitize_spec(rules, rules.spec("batch", None, None, None), k.shape)

    def write_slice(ck, cv, k, v):
        s_l = ck.shape[1]
        start = D.tp_index() * s_l if seq[1] is not None else 0
        lo, hi = max(idx, start), min(idx + k.shape[1], start + s_l)
        if lo < hi:
            ck[:, lo - start:hi - start] = k[:, lo - idx:hi - idx].to(ck.dtype)
            cv[:, lo - start:hi - start] = v[:, lo - idx:hi - idx].to(cv.dtype)
        return ()

    D.local_call(write_slice, [(ck, seq), (cv, seq), (k, new), (v, new)], [])


def cross_attention(x: torch.Tensor, p: dict, cfg: ModelConfig, enc_kv: tuple[torch.Tensor, torch.Tensor]):
    """Whisper-style cross-attention; enc_kv precomputed (B, S_enc, KV, Dh) each.

    Non-causal, so never the flash kernel: the chunked route over the
    encoder's keys, or ``full_attention`` for a decode step's one query.
    """
    b, s, _ = x.shape
    h_spec, kv_spec = _head_specs(cfg)
    q = L.dense(x, p["wq"], p.get("bq")).reshape(b, s, cfg.n_heads, cfg.head_dim)
    q = D.shard(q, "batch", "seq", h_spec, None)
    k, v = enc_kv
    k = D.shard(k, "batch", None, kv_spec, None)
    v = D.shard(v, "batch", None, kv_spec, None)
    o = attention_core(q, k.to(q.dtype), v.to(q.dtype), cfg, causal=False)
    return out_proj(o, p)


def encoder_kv(enc_out: torch.Tensor, p: dict, cfg: ModelConfig):
    """Cross-attention K/V of one decoder layer from the encoder's output."""
    b, s, _ = enc_out.shape
    k = L.dense(enc_out, p["wk"], p.get("bk")).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(enc_out, p["wv"], p.get("bv")).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    _, kv_spec = _head_specs(cfg)
    return D.shard(k, "batch", None, kv_spec, None), D.shard(v, "batch", None, kv_spec, None)
