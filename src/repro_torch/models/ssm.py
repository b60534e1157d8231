"""Mamba2 block, ported from ``repro.models.ssm``.

Prefill: the chunked SSD scan through ``kernels.ops.ssd_scan``, so on a CUDA
tensor the hand-written Hopper kernel runs where the reference runs its XLA
twin ``ssd_chunked``; on a CPU tensor the wrapper runs the plain version.
Decode (one token with a cache): the O(1) conv-buffer and state update, in
plain PyTorch as in the reference.

The elementwise chain around the scan (the causal conv, silu, softplus and
xbar before it; the skip, the gate and the norm after it) runs through
``ops.ssm_conv_gate_in`` and ``ops.ssm_gate_norm`` wherever autograd would
not record it, which on a CUDA tensor are two fused kernels; where autograd
records (training, remat's recompute) it runs their plain versions
(``kernels.ref``), op by op, as before the kernels existed.

Under sharding rules on a multi-device mesh the block runs as the
reference's annotations place it: z and x (the inner dim) shard over tp
with the heads when ``ssm_heads % tp == 0``, B, C and dt replicate; the
projections, convolutions, the scan (or the decode recurrence) and the
gate run per rank in one ``distributed.local_call`` (``_mixer``), then the
norm over the inner dim and the out-projection run on DTensors.  With no
rules, or one device, ``_mixer`` runs on the whole tensors and takes the
norm too.
"""

from __future__ import annotations

import torch

from repro_torch import distributed as D
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

CACHE_KEYS = ("conv_x", "conv_b", "conv_c", "state")


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
           dt_bias, a_log, d_skip, conv_x, conv_b, conv_c, state0, cfg: ModelConfig, norm=None):
    """The block up to its norm, on one rank's heads (all of them on one device), and
    the norm too when its ``norm`` scale is given:
    -> (y * silu(z) (B, S, H_local*P), new conv_x, conv_b, conv_c, state)."""
    z = L.dense(x, w_z)
    xs = L.dense(x, w_x)
    bmat = L.dense(x, w_b)
    cmat = L.dense(x, w_c)
    dt = L.dense(x, w_dt)

    leaves = (x, w_z, w_x, w_b, w_c, w_dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c,
              dt_bias, a_log, d_skip, conv_x, conv_b, conv_c, state0, norm)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in leaves):
        gate_in, gate_norm = ref.ssm_conv_gate_in_ref, ref.ssm_gate_norm_ref
    else:
        gate_in, gate_norm = ops.ssm_conv_gate_in, ops.ssm_gate_norm
    xs, bmat, cmat, xbar, log_da, new_conv_x, new_conv_b, new_conv_c = gate_in(
        xs, bmat, cmat, dt, L.cast(w_conv_x), L.cast(b_conv_x), L.cast(w_conv_b), L.cast(b_conv_b),
        L.cast(w_conv_c), L.cast(b_conv_c), dt_bias, a_log, conv_x, conv_b, conv_c)

    if xs.shape[1] == 1 and state0 is not None:
        y, new_state = _decode_step(state0, log_da, bmat, xbar, cmat, x.dtype)
    else:
        y, new_state = ssd_chunked(xbar, log_da, bmat, cmat, cfg.ssm_chunk, state0)

    y = gate_norm(y, xs, z, d_skip, norm, cfg.norm_eps)
    return y, new_conv_x, new_conv_b, new_conv_c, new_state


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
    place them; without rules ``_mixer`` takes the norm too.
    """
    cs = cache if cache is not None else {}
    args = [x] + [p[k] for k in _WEIGHTS] + [cs.get(k) for k in CACHE_KEYS]
    rules = D.distributed_rules()
    if rules is None:
        y, *new = _mixer(*args, cfg=cfg, norm=p["norm"])
    else:
        ins, outs = _mixer_specs(rules, cfg, x)
        y, *new = D.local_call(lambda *a: _mixer(*a, cfg=cfg), list(zip(args, ins)), outs)
        y = L.rms_norm(D.shard(y, "batch", None, "tp"), p["norm"], cfg.norm_eps)
    out = D.shard(L.dense(y, p["w_out"]), "batch", None, None)
    new_cache = None
    if cache is not None:
        new_cache = dict(zip(CACHE_KEYS, (new[0].float(), new[1].float(), new[2].float(), new[3])))
    return out, new_cache
