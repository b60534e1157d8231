"""Whole-model decomposition: ModelConfig x InputShape x mesh -> building blocks.

This is the bridge between the paper's methodology and the framework: any of
the 10 assigned architectures decomposes into per-device building-block
instances (attention block, MLP block, MoE block, SSD block, embed, LM head)
whose layer configurations live in the TPU-v5e platform's parameter spaces.
The PR-trained single-layer estimators then predict per-block times, combined
per Eq. 9-12 into a step-time estimate -- the LM-transformer analogue of the
paper's MobileNet/ResNet whole-DNN estimation.

Sharding-awareness: dims are *per-device* under the given (dp, tp) mesh
factors, and every block carries its collective payload so the Eq.-9 max rule
(compute/DMA/ICI overlap) applies on the sharded platform.
"""

from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.blocks import Block
from repro_torch.core.prs import Config
from repro_torch.models.config import InputShape, ModelConfig


def _head_policy(cfg: ModelConfig, tp: int) -> str:
    if tp == 1 or cfg.n_kv_heads % tp == 0:
        return "kv_sharded"
    if cfg.n_heads % tp == 0:
        return "q_sharded"
    return "replicated"


def _decompose_plan(
    cfg: ModelConfig,
    shape: InputShape,
    dp: int,
    tp: int,
    train_factor: float = 3.0,
):
    """Yield ``(kind, layers, collective_bytes, repeat)`` for one step's blocks.

    The single source of truth behind both :func:`decompose` (materialises
    :class:`Block` objects) and :func:`decompose_batch` (streams straight into
    a columnar :class:`~repro_torch.core.batch.BlockBatch`), so the two can never
    drift: same blocks, same order, same fields.
    """
    is_train = shape.kind == "train"
    is_decode = shape.kind == "decode"
    rep = train_factor if is_train else 1.0
    b_loc = max(1, shape.global_batch // dp)
    s = 1 if is_decode else shape.seq_len
    t_loc = b_loc * s
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.head_dim
    policy = _head_policy(cfg, tp)
    h_loc = cfg.n_heads // tp if policy in ("kv_sharded", "q_sharded") else cfg.n_heads
    kv_loc = cfg.n_kv_heads // tp if policy == "kv_sharded" else cfg.n_kv_heads
    kv_ratio = max(1, h_loc // max(1, kv_loc))

    coll_act = t_loc * d * 2.0  # one bf16 activation all-reduce payload

    def attn_block() -> tuple:
        layers: list[tuple[str, Config]] = [
            ("dense", {"tokens": t_loc, "d_in": d, "d_out": (h_loc + 2 * kv_loc) * hd}),
        ]
        if is_decode:
            layers.append(
                ("attention_decode", {"B": b_loc, "S_kv": shape.seq_len, "H": h_loc, "Dh": hd, "kv_ratio": kv_ratio})
            )
        else:
            layers.append(
                ("attention_prefill", {"B": b_loc, "S": s, "H": h_loc, "Dh": hd, "kv_ratio": kv_ratio})
            )
        layers.append(("dense", {"tokens": t_loc, "d_in": h_loc * hd, "d_out": d}))
        return ("attn", tuple(layers), coll_act)

    def mlp_block() -> tuple:
        f_loc = max(1, f // tp)
        n_in = 2 if cfg.mlp == "swiglu" else 1
        layers = [("dense", {"tokens": t_loc, "d_in": d, "d_out": f_loc})] * n_in
        layers.append(("dense", {"tokens": t_loc, "d_in": f_loc, "d_out": d}))
        return ("mlp", tuple(layers), coll_act)

    def moe_block() -> tuple:
        e_loc = max(1, cfg.moe_experts // tp)
        layers = [
            ("dense", {"tokens": t_loc, "d_in": d, "d_out": cfg.moe_experts}),  # router
            (
                "moe_gemm",
                {
                    "tokens": max(1, t_loc // tp),
                    "d_model": d,
                    "d_ff": f,
                    "E": e_loc,
                    "topk": cfg.moe_top_k,
                },
            ),
        ]
        return ("moe", tuple(layers), 2 * coll_act)

    def ssd_block() -> tuple:
        di_loc = max(1, cfg.d_inner // tp)
        h_ssm = max(1, cfg.ssm_heads // tp)
        layers = [
            ("dense", {"tokens": t_loc, "d_in": d, "d_out": 2 * di_loc + 2 * cfg.ssm_state + cfg.ssm_heads}),
            ("ssd_scan", {"B": b_loc, "S": s, "H": h_ssm, "P": cfg.ssm_headdim, "N": cfg.ssm_state}),
            ("dense", {"tokens": t_loc, "d_in": di_loc, "d_out": d}),
        ]
        return ("ssd", tuple(layers), coll_act)

    def body(plan: tuple, n: int) -> tuple:
        kind, layers, coll = plan
        return (kind, layers, coll, n * rep)

    # ---- embedding ----
    yield ("embed", (("embed", {"tokens": t_loc, "vocab": v, "d_model": d}),), 0.0, rep)

    # ---- body ----
    if cfg.family in ("dense", "vlm"):
        yield body(attn_block(), cfg.n_layers)
        yield body(mlp_block(), cfg.n_layers)
    elif cfg.family == "moe":
        yield body(attn_block(), cfg.n_layers)
        yield body(moe_block(), cfg.n_layers)
    elif cfg.family == "ssm":
        yield body(ssd_block(), cfg.n_layers)
    elif cfg.family == "hybrid":
        n_shared = cfg.n_layers // max(1, cfg.attn_every)
        yield body(ssd_block(), cfg.n_layers)
        yield body(attn_block(), n_shared)
        yield body(mlp_block(), n_shared)
    elif cfg.family == "audio":
        if not is_decode:
            enc_t = b_loc * cfg.encoder_seq
            enc_attn = (
                "attn",
                (
                    ("dense", {"tokens": enc_t, "d_in": d, "d_out": (h_loc + 2 * kv_loc) * hd}),
                    ("attention_prefill", {"B": b_loc, "S": cfg.encoder_seq, "H": h_loc, "Dh": hd, "kv_ratio": kv_ratio}),
                    ("dense", {"tokens": enc_t, "d_in": h_loc * hd, "d_out": d}),
                ),
                enc_t * d * 2.0,
            )
            enc_mlp = (
                "mlp",
                (
                    ("dense", {"tokens": enc_t, "d_in": d, "d_out": max(1, f // tp)}),
                    ("dense", {"tokens": enc_t, "d_in": max(1, f // tp), "d_out": d}),
                ),
                enc_t * d * 2.0,
            )
            yield body(enc_attn, cfg.n_encoder_layers)
            yield body(enc_mlp, cfg.n_encoder_layers)
        # decoder: self-attn + cross-attn + mlp
        cross = (
            "attn",
            (
                ("dense", {"tokens": t_loc, "d_in": d, "d_out": h_loc * hd}),
                ("attention_decode" if is_decode else "attention_prefill",
                 ({"B": b_loc, "S_kv": cfg.encoder_seq, "H": h_loc, "Dh": hd, "kv_ratio": kv_ratio}
                  if is_decode
                  else {"B": b_loc, "S": cfg.encoder_seq, "H": h_loc, "Dh": hd, "kv_ratio": kv_ratio})),
                ("dense", {"tokens": t_loc, "d_in": h_loc * hd, "d_out": d}),
            ),
            coll_act,
        )
        yield body(attn_block(), cfg.n_layers)
        yield body(cross, cfg.n_layers)
        yield body(mlp_block(), cfg.n_layers)
    else:
        raise ValueError(cfg.family)

    # ---- LM head ----
    yield (
        "mlp",
        (("dense", {"tokens": t_loc, "d_in": d, "d_out": max(1, v // tp)}),),
        0.0,
        rep,
    )


def decompose(
    cfg: ModelConfig,
    shape: InputShape,
    dp: int,
    tp: int,
    train_factor: float = 3.0,
) -> list[Block]:
    """Per-device building blocks of one step.  train_factor ~ (fwd+bwd)/fwd."""
    return [
        Block(kind=kind, layers=layers, collective_bytes=coll, repeat=repeat)
        for kind, layers, coll, repeat in _decompose_plan(cfg, shape, dp, tp, train_factor)
    ]


def decompose_batch(
    cfg: ModelConfig,
    shape: InputShape,
    dp: int,
    tp: int,
    train_factor: float = 3.0,
):
    """Columnar-native :func:`decompose`: the same plan streamed straight into
    a :class:`~repro_torch.core.batch.BlockBatch`, skipping the per-block ``Block``
    objects and the re-grouping pass of ``BlockBatch.from_blocks``.  Field-
    for-field identical to ``BlockBatch.from_blocks(decompose(...))``.
    """
    from repro_torch.core.batch import BlockBatchBuilder

    builder = BlockBatchBuilder()
    for kind, layers, coll, repeat in _decompose_plan(cfg, shape, dp, tp, train_factor):
        builder.add(kind, layers, collective_bytes=coll, repeat=repeat)
    return builder.build()


def simulate_network(platform, blocks: Sequence[Block]) -> float:
    """'Measure' the whole network on a simulated platform (Table-2 ground truth).

    The network is measured as one :class:`~repro_torch.core.batch.BlockBatch`
    through the platform's columnar block model (cache-partitioned and
    runtime-sharded under a ``CachedPlatform``); values are bitwise identical
    to the old per-block ``measure_block`` loop.
    """
    return simulate_networks(platform, [blocks])[0]


def simulate_networks(platform, networks: Sequence[Sequence[Block]]) -> list[float]:
    """Batched :func:`simulate_network` over many networks.

    All networks' blocks flatten into one block batch (one platform call, one
    cache partition; duplicate blocks across networks are measured once under
    a caching platform), then each network's Eq.-12 sum accumulates in block
    order — the same left fold as the scalar loop, so the result is bitwise
    identical for every network.
    """
    from repro_torch.core.blocks import measure_block_many

    networks = [list(net) for net in networks]
    flat = [b for net in networks for b in net]
    y = measure_block_many(platform, flat)
    times = y.tolist()
    out: list[float] = []
    i = 0
    for net in networks:
        t = 0.0
        for b in net:
            t += times[i] * b.repeat
            i += 1
        out.append(t)
    return out
