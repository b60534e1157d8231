"""Plain float32 reference of the benchmark's model: mamba2 (ssm).

Written from the model's published equations, in plain PyTorch, for the
comparison that decides a run's ``correct``.  It imports nothing of the
program (``repro_torch``) or of the JAX package and takes none of their
outputs but the ones it judges: it reads the parameter tree that
``perfbench.weights`` makes from the seed, and the sizes in
``perfbench/configs/<name>.json``.  Every operation is float32 with TF32 off
(``fp32_matmuls``), and a product may be swapped for a lower-precision one
(``matmul=``) to make the control that the comparison must fail.

The model, as the configuration states it (mamba2, arXiv:2405.21060):
embedding; per layer x + out(RMSNorm(y * silu(z))) where [z, x, B, C, dt]
are projections of RMSNorm(x); x, B and C go through a causal depthwise
convolution (4 taps, with bias) and silu; dt = softplus(dt + dt_bias), A =
-exp(a_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
y_t = h_t C_t + D x_t, one group of B and C shared by every head; final
RMSNorm and the head, tied to the embedding as published.  The residual
stream is float32, as published (the program keeps it in bfloat16, which
the configuration lists in ``reduced``).

The SSD here is the chunked form of the Mamba-2 paper's listing ("SSD
minimal"): diagonal blocks by a masked decay matrix, chunk states, a
recurrence over chunks, and the states' contribution to each output.  It
follows the paper, not the program's kernels or their plain versions.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def fp32_matmuls():
    """Float32 products in full float32: TF32 off for matmuls and cuDNN, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def linear(x: torch.Tensor, w: torch.Tensor, matmul=fp32_matmul) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32 (``matmul`` takes 2-d operands)."""
    lead = x.shape[:-1]
    return matmul(x.reshape(-1, x.shape[-1]), w.float()).reshape(*lead, w.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


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


def hidden_states(family: str, params: dict, m: dict, tokens: torch.Tensor, matmul=fp32_matmul,
                  remat: bool = False) -> torch.Tensor:
    """The final RMSNorm's output (B, S, D) for integer ``tokens`` (B, S).

    ``remat`` recomputes each layer in the backward pass (for training at
    full size), which changes memory, not values.
    """
    x = F.embedding(tokens, params["embed"].float())

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    if family == "ssm":
        for p in params["layers"]:
            x = run(lambda x_, p_=p: mamba_layer(x_, p_, m, matmul), x)
    else:
        raise ValueError(f"the reference has no family {family!r}")
    return rms_norm(x, params["final_norm"], m["norm_eps"])


def head_weight(params: dict, m: dict) -> torch.Tensor:
    return params["embed"].t() if m.get("tie_embeddings", False) else params["lm_head"]


def logits_at(family: str, params: dict, m: dict, tokens: torch.Tensor, positions: slice,
              matmul=fp32_matmul) -> torch.Tensor:
    """Float32 logits (B, len(positions), V) at ``positions`` of ``tokens`` (B, S)."""
    with torch.no_grad():
        x = hidden_states(family, params, m, tokens, matmul)[:, positions]
        return linear(x, head_weight(params, m), matmul)


def loss(family: str, params: dict, m: dict, tokens: torch.Tensor, labels: torch.Tensor,
         matmul=fp32_matmul, rows: slice | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy over every position of ``rows`` (default: all rows)."""
    if rows is not None:
        tokens, labels = tokens[rows], labels[rows]
    x = hidden_states(family, params, m, tokens, matmul, remat=True)
    logits = linear(x, head_weight(params, m), matmul)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
