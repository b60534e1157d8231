"""The ssm family of the plain reference: mamba2 (arXiv:2405.21060).

Each layer is x + out(RMSNorm(y * silu(z))) where [z, x, B, C, dt] are
projections of RMSNorm(x); x, B and C go through a causal depthwise
convolution (4 taps, with bias) and silu; dt = softplus(dt + dt_bias), A =
-exp(a_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
y_t = h_t C_t + D x_t, one group of B and C shared by every head.

The SSD here is the chunked form of the Mamba-2 paper's listing ("SSD
minimal"): diagonal blocks by a masked decay matrix, chunk states, a
recurrence over chunks, and the states' contribution to each output.  It
follows the paper, not the program's kernels or their plain versions.

A family's file gives ``layer_specs(m)``, the (path, shape, kind, scale) of
its layers' leaves in a fixed order (``perfbench.weights`` makes them), and
``layers(x, params, m, run, matmul)``, the residual stream through every
layer (``model.hidden_states`` calls it between the embedding and the final
norm; ``run(fn, x)`` applies one layer, recomputed in the backward pass when
training).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import fp32_matmul, linear, rms_norm, silu


#: the leaves that are neither normal, zeros nor ones: float32, from their shape (``weights.make``)
KINDS = {
    "dt_bias": lambda shape, **f32: torch.log(torch.expm1(torch.full(shape, 0.01, **f32))),
    "a_log": lambda shape, **f32: torch.log(torch.linspace(1.0, 16.0, shape[0], **f32)),
}


def _mamba_specs(m: dict, prefix: str) -> list:
    d, di, n = m["d_model"], m["ssm_expand"] * m["d_model"], m["ssm_state"]
    h, k = di // m["ssm_headdim"], m["ssm_conv"]
    mb = prefix + "mamba."
    return [
        (prefix + "ln", (d,), "ones", None),
        (mb + "w_z", (d, di), "normal", 1 / math.sqrt(d)),
        (mb + "w_x", (d, di), "normal", 1 / math.sqrt(d)),
        (mb + "w_b", (d, n), "normal", 1 / math.sqrt(d)),
        (mb + "w_c", (d, n), "normal", 1 / math.sqrt(d)),
        (mb + "w_dt", (d, h), "normal", 1 / math.sqrt(d)),
        (mb + "w_conv_x", (k, di), "normal", 0.5),
        (mb + "b_conv_x", (di,), "zeros", None),
        (mb + "w_conv_b", (k, n), "normal", 0.5),
        (mb + "b_conv_b", (n,), "zeros", None),
        (mb + "w_conv_c", (k, n), "normal", 0.5),
        (mb + "b_conv_c", (n,), "zeros", None),
        (mb + "dt_bias", (h,), "dt_bias", None),
        (mb + "a_log", (h,), "a_log", None),
        (mb + "d_skip", (h,), "ones", None),
        (mb + "norm", (di,), "ones", None),
        (mb + "w_out", (di, d), "normal", 1 / math.sqrt(di)),
    ]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: y_t = b + sum_i w[i] x_{t - K + 1 + i}; x (B, S, C), w (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = b.float().expand_as(x).clone()
    for i in range(k):
        y = y + xp[:, i:i + s] * w[i].float()
    return y


def _segsum(a: torch.Tensor, stable: bool = False) -> torch.Tensor:
    """a (..., T) -> (..., T, T): the sum of a over (j, i] on and below the diagonal, -inf above it.

    ``stable`` sums each entry on its own (T x T memory per row) instead of
    differencing one cumulative sum, for long runs whose sums grow large.
    """
    t = a.shape[-1]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    if stable:
        strict = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), diagonal=-1)
        seg = torch.cumsum(a[..., None, :].expand(*a.shape, t).transpose(-1, -2).masked_fill(~strict, 0), dim=-2)
    else:
        cum = torch.cumsum(a, dim=-1)
        seg = cum[..., :, None] - cum[..., None, :]
    return seg.masked_fill(~mask, float("-inf"))


def ssd(x: torch.Tensor, log_a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD recurrence h_t = exp(log_a_t) h_{t-1} + x_t B_t^T, y_t = h_t C_t, from h_0 = 0.

    x (B, S, H, P) (already multiplied by dt), log_a (B, S, H), bmat / cmat
    (B, S, N), all float32; returns y (B, S, H, P).  The sequence is cut into
    chunks of ``chunk`` steps (a ragged end is padded with steps that keep the
    state and add nothing).
    """
    b, s, h, p = x.shape
    pad = (-s) % chunk
    if pad:
        x, log_a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(log_a, (0, 0, 0, pad))
        bmat, cmat = F.pad(bmat, (0, 0, 0, pad)), F.pad(cmat, (0, 0, 0, pad))
    c = (s + pad) // chunk
    x = x.reshape(b, c, chunk, h, p)
    a = log_a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (B, H, C, L)
    bm = bmat.reshape(b, c, chunk, -1)
    cm = cmat.reshape(b, c, chunk, -1)
    a_cum = torch.cumsum(a, dim=-1)
    # diagonal blocks: y = (C B^T o decay) x inside each chunk
    decay = torch.exp(_segsum(a))  # (B, H, C, L, L)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cm, bm, decay, x)
    # each chunk's state from its own steps, then the recurrence over chunks
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, H, C, L)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bm, decay_states, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)  # h_0 = 0
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0)), stable=True))  # (B, H, C+1, C+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]  # state entering each chunk
    # the entering state's part of each output
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cm, states, torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, c * chunk, h, p)[:, :s]


def mamba_layer(x: torch.Tensor, p: dict, m: dict, matmul=fp32_matmul) -> torch.Tensor:
    """x + mamba2 mixer of RMSNorm(x); x (B, S, D) float32."""
    mb = p["mamba"]
    b, s, _ = x.shape
    hd = m["ssm_headdim"]
    h_in = rms_norm(x, p["ln"], m["norm_eps"])
    z = linear(h_in, mb["w_z"], matmul)
    xs = silu(causal_conv(linear(h_in, mb["w_x"], matmul), mb["w_conv_x"], mb["b_conv_x"]))
    bm = silu(causal_conv(linear(h_in, mb["w_b"], matmul), mb["w_conv_b"], mb["b_conv_b"]))
    cm = silu(causal_conv(linear(h_in, mb["w_c"], matmul), mb["w_conv_c"], mb["b_conv_c"]))
    dt = F.softplus(linear(h_in, mb["w_dt"], matmul) + mb["dt_bias"].float())  # (B, S, H)
    a = -torch.exp(mb["a_log"].float())
    xh = xs.reshape(b, s, -1, hd)
    y = ssd(xh * dt[..., None], dt * a, bm, cm, m["ssm_chunk"]) + xh * mb["d_skip"].float()[:, None]
    y = y.reshape(b, s, -1) * silu(z)
    return x + linear(rms_norm(y, mb["norm"], m["norm_eps"]), mb["w_out"], matmul)


def layer_specs(m: dict) -> list:
    out = []
    for i in range(m["n_layers"]):
        out += _mamba_specs(m, f"layers.{i}.")
    return out


def layers(x: torch.Tensor, params: dict, m: dict, run, matmul=fp32_matmul) -> torch.Tensor:
    for p in params["layers"]:
        x = run(lambda x_, p_=p: mamba_layer(x_, p_, m, matmul), x)
    return x
