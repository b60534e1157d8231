"""Mamba2 block, ported from ``repro.models.ssm``.

Prefill: the chunked SSD scan through ``kernels.ops.ssd_scan``, so on a CUDA
tensor the hand-written Hopper kernel runs where the reference runs its XLA
twin ``ssd_chunked``; on a CPU tensor the wrapper runs the plain version.
Decode (one token with a cache): the O(1) conv-buffer and state update, in
plain PyTorch as in the reference.

The reference's ``shard(...)`` annotations have no counterpart on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict | None = None):
    """Mamba2 block.  x: (B, S, D).  cache: this layer's ``CACHE_KEYS`` tensors.

    Returns (y (B,S,D), new_cache): fresh fp32 conv buffers and state, or None
    without a cache.
    """
    bsz, s, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_headdim
    z = L.dense(x, p["w_z"])
    xs = L.dense(x, p["w_x"])
    bmat = L.dense(x, p["w_b"])
    cmat = L.dense(x, p["w_c"])
    dt = L.dense(x, p["w_dt"])

    cs = cache if cache is not None else {}
    xs, new_conv_x = depthwise_conv1d(xs, L.cast(p["w_conv_x"]), L.cast(p["b_conv_x"]), cs.get("conv_x"))
    bmat, new_conv_b = depthwise_conv1d(bmat, L.cast(p["w_conv_b"]), L.cast(p["b_conv_b"]), cs.get("conv_b"))
    cmat, new_conv_c = depthwise_conv1d(cmat, L.cast(p["w_conv_c"]), L.cast(p["b_conv_c"]), cs.get("conv_c"))
    xs = L.silu(xs)
    bmat = L.silu(bmat)
    cmat = L.silu(cmat)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H) fp32
    a = -torch.exp(p["a_log"])  # (H,) negative
    log_da = dt * a
    xhp = xs.reshape(bsz, s, h, pd)
    xbar = xhp * dt[..., None].to(xhp.dtype)  # bf16, as the reference keeps it

    state0 = cache["state"] if cache is not None else None
    if s == 1 and cache is not None:
        da = torch.exp(log_da[:, 0])  # (B,H)
        upd = torch.einsum("bn,bhp->bhpn", bmat[:, 0].float(), xbar[:, 0].float())
        state = state0 * da[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, cmat[:, 0].float())[:, None]
        y = y.reshape(bsz, 1, h, pd).to(x.dtype)
        new_state = state
    else:
        y, new_state = ssd_chunked(xbar, log_da, bmat, cmat, cfg.ssm_chunk, state0)

    y = y + xhp * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, cfg.d_inner)
    y = L.rms_norm(y * L.silu(z), p["norm"], cfg.norm_eps)
    out = L.dense(y, p["w_out"])
    new_cache = None
    if cache is not None:
        new_cache = {
            "conv_x": new_conv_x.float(),
            "conv_b": new_conv_b.float(),
            "conv_c": new_conv_c.float(),
            "state": new_state,
        }
    return out, new_cache
