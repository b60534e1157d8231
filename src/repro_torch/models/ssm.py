"""Mamba2 block, ported from ``repro.models.ssm``.

Prefill: the chunked SSD scan through ``kernels.ops.ssd_scan``, so on a CUDA
tensor the hand-written Hopper kernel runs where the reference runs its XLA
twin ``ssd_chunked``; on a CPU tensor the wrapper runs the plain version.
Decode (one token with a cache): the O(1) conv-buffer and state update, in
plain PyTorch as in the reference.

Under sharding rules on a multi-device mesh the block runs as the
reference's annotations place it: z and x (the inner dim) shard over tp
with the heads when ``ssm_heads % tp == 0``, B, C and dt replicate; the
projections, convolutions, the scan (or the decode recurrence) and the
gate run per rank in one ``distributed.local_call`` (``_mixer``), then the
norm over the inner dim and the out-projection run on DTensors.  With no
rules, or one device, ``_mixer`` runs on the whole tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import distributed as D
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

CACHE_KEYS = ("conv_x", "conv_b", "conv_c", "state")


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: torch.Tensor | None = None):
    """Causal depthwise conv along seq.  x: (B,S,C); w: (K,C); b: (C,).

    With ``state`` (B, K-1, C) the last K-1 inputs of the previous step are
    prepended (decode).  The K shifted products are summed in x's dtype in
    the reference's order (``F.conv1d`` would accumulate in another order and
    type).  Returns (y, new_state).
    """
    k = w.shape[0]
    bsz, s, c = x.shape
    if state is None:
        pad = torch.zeros((bsz, k - 1, c), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i : i + s] * w[i]
    new_state = xp[:, s:] if k > 1 else torch.zeros_like(pad)
    return y + b, new_state


def ssd_chunked(
    xbar: torch.Tensor,
    log_da: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    chunk: int,
    state0: torch.Tensor | None = None,
):
    """Chunked SSD scan.  Returns (y (B,S,H,P), final_state (B,H,P,N) fp32).

    The reference rounds the intra-chunk weights to xbar's dtype (bf16 on the
    model path) before the second product; the card's bf16 kernel feeds them
    as a bf16 pair hi + lo, and rounds B * decay and each chunk's incoming
    state to bf16 as product operands (sums and the carried state stay
    fp32); the plain version keeps every operand in fp32.  They agree to the
    bf16 bar, not bit for bit.
    """
    return ops.ssd_scan(xbar, log_da, bmat, cmat, chunk=chunk, state0=state0)


def _decode_step(state0, log_da, bmat, xbar, cmat, dtype):
    """The O(1) decode recurrence over one token: -> (y (B,1,H,P), state)."""
    bsz, _, h, pd = xbar.shape
    da = torch.exp(log_da[:, 0])  # (B,H)
    upd = torch.einsum("bn,bhp->bhpn", bmat[:, 0].float(), xbar[:, 0].float())
    state = state0 * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cmat[:, 0].float())[:, None]
    return y.reshape(bsz, 1, h, pd).to(dtype), state


def _mixer(x, w_z, w_x, w_b, w_c, w_dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c,
           dt_bias, a_log, d_skip, conv_x, conv_b, conv_c, state0, cfg: ModelConfig):
    """The block up to its norm, on one rank's heads (all of them on one device):
    -> (y * silu(z) (B, S, H_local*P), new conv_x, conv_b, conv_c, state)."""
    bsz, s, _ = x.shape
    h, pd = dt_bias.shape[0], cfg.ssm_headdim
    z = L.dense(x, w_z)
    xs = L.dense(x, w_x)
    bmat = L.dense(x, w_b)
    cmat = L.dense(x, w_c)
    dt = L.dense(x, w_dt)

    xs, new_conv_x = depthwise_conv1d(xs, L.cast(w_conv_x), L.cast(b_conv_x), conv_x)
    bmat, new_conv_b = depthwise_conv1d(bmat, L.cast(w_conv_b), L.cast(b_conv_b), conv_b)
    cmat, new_conv_c = depthwise_conv1d(cmat, L.cast(w_conv_c), L.cast(b_conv_c), conv_c)
    xs = L.silu(xs)
    bmat = L.silu(bmat)
    cmat = L.silu(cmat)

    dt = F.softplus(dt.float() + dt_bias)  # (B,S,H) fp32
    a = -torch.exp(a_log)  # (H,) negative
    log_da = dt * a
    xhp = xs.reshape(bsz, s, h, pd)
    xbar = xhp * dt[..., None].to(xhp.dtype)  # bf16, as the reference keeps it

    if s == 1 and state0 is not None:
        y, new_state = _decode_step(state0, log_da, bmat, xbar, cmat, x.dtype)
    else:
        y, new_state = ssd_chunked(xbar, log_da, bmat, cmat, cfg.ssm_chunk, state0)

    y = y + xhp * d_skip.to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, h * pd)
    return y * L.silu(z), new_conv_x, new_conv_b, new_conv_c, new_state


_WEIGHTS = ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_conv_x", "b_conv_x", "w_conv_b", "b_conv_b",
            "w_conv_c", "b_conv_c", "dt_bias", "a_log", "d_skip")


def _mixer_specs(rules, cfg: ModelConfig, x) -> tuple[list, list]:
    """(input specs, output specs) of ``_mixer``'s local call: heads (and the
    inner dim with them) over tp where ``ssm_heads % tp == 0``, else
    replicated; B, C and the conv of their streams replicated."""
    head = rules.tp_axis if cfg.ssm_heads % rules.tp_size == 0 else None
    batch = D.sanitize_spec(rules, rules.spec("batch"), x.shape[:1])[0]
    weights = {"w_z": D.P(None, head), "w_x": D.P(None, head), "w_b": D.P(), "w_c": D.P(),
               "w_dt": D.P(None, head), "w_conv_x": D.P(None, head), "b_conv_x": D.P(head),
               "w_conv_b": D.P(), "b_conv_b": D.P(), "w_conv_c": D.P(), "b_conv_c": D.P(),
               "dt_bias": D.P(head), "a_log": D.P(head), "d_skip": D.P(head)}
    inner, rows = D.P(batch, None, head), D.P(batch, None, None)
    caches = [inner, rows, rows, D.P(batch, head, None, None)]
    ins = [D.P(batch, None, None)] + [weights[k] for k in _WEIGHTS] + caches
    return ins, [inner] + caches


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict | None = None):
    """Mamba2 block.  x: (B, S, D).  cache: this layer's ``CACHE_KEYS`` tensors.

    Returns (y (B,S,D), new_cache): fresh fp32 conv buffers and state, or None
    without a cache.  Under distributed rules ``_mixer`` runs per rank on its
    heads, then the norm over the inner dim and the out-projection (its
    partial sums over tp) run on DTensors, as the reference's annotations
    place them.
    """
    cs = cache if cache is not None else {}
    args = [x] + [p[k] for k in _WEIGHTS] + [cs.get(k) for k in CACHE_KEYS]
    rules = D.distributed_rules()
    if rules is None:
        y, *new = _mixer(*args, cfg=cfg)
    else:
        ins, outs = _mixer_specs(rules, cfg, x)
        y, *new = D.local_call(lambda *a: _mixer(*a, cfg=cfg), list(zip(args, ins)), outs)
        y = D.shard(y, "batch", None, "tp")
    y = L.rms_norm(y, p["norm"], cfg.norm_eps)
    out = D.shard(L.dense(y, p["w_out"]), "batch", None, None)
    new_cache = None
    if cache is not None:
        new_cache = dict(zip(CACHE_KEYS, (new[0].float(), new[1].float(), new[2].float(), new[3])))
    return out, new_cache
