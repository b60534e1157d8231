"""Shared neural-net layers, ported from ``repro.models.layers``.

Numerics follow the reference:

* matmuls take bf16 operands (``cast``) and accumulate in fp32; ``dense``
  returns bf16, ``lm_head`` returns fp32 logits;
* norms compute in fp32 and return the input dtype;
* the residual stream is bf16.

For serving the port holds matmul weights and biases in bf16: the reference
keeps fp32 parameters but casts them to bf16 at every call, so a bf16 copy
is exactly what each call sees.  Norm scales stay fp32, as the norms read
them in fp32.  For training every leaf stays fp32 (``param_dtype``) and each
use casts, as in the reference, so the optimizer updates fp32 masters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


# ------------------------------------------------------------------ dense
def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """bf16 ``x @ w (+ b)``: fp32 accumulation, one rounding to bf16."""
    y = torch.matmul(cast(x), cast(w))
    if b is not None:
        y = y + cast(b)
    return y


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """fp64 inverse frequencies, as the reference's numpy ``rope_freqs``.

    Computed on ``device``: a host-to-device copy here would synchronise the
    stream twice per layer.
    """
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device).float()  # (d/2,)
    angles = positions[..., None].float() * freqs  # (B, S, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, sections: tuple[int, int, int]
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): x (B, S, H, D); positions (3, B, S) for the (t, h, w) streams.

    The rotary half-dim is split into ``sections``; each section rotates by
    its own position stream, in fp32 as ``apply_rope``.  Text tokens have
    t == h == w, where M-RoPE is RoPE.  The streams are laid out per
    frequency by slicing, so no index table is copied to the device.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover the rotary half-dim {d // 2}")
    freqs = rope_freqs(d, theta, x.device).float()  # (d/2,)
    pos = positions.float()
    pos_per_freq = torch.cat(
        [pos[i, ..., None].expand(*pos.shape[1:], n) for i, n in enumerate(sections)], dim=-1
    )  # (B, S, d/2)
    angles = pos_per_freq * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, device: torch.device | str) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, (seq, d_model) fp32.

    Computed in fp64 and rounded once to fp32, as the reference's numpy
    version; on ``device``, so no table is copied to it.
    """
    half = d_model // 2
    pos = torch.arange(seq, dtype=torch.float64, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=device) / (half - 1))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float()


# ------------------------------------------------------------------ MLP
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s own steps, ``x * (1 / (1 + exp(-x)))``, each rounded to x's dtype.

    ``F.silu`` rounds once; on bf16 the two differ by one step in many
    elements, which the SSM's four silus a layer and the MoE's experts carry
    into the logits.
    """
    return x * (1 / (1 + torch.exp(-x)))


#: sqrt(2 / pi) in bf16, as ``jax.nn.gelu`` casts it to its input's dtype
_SQRT_2_OVER_PI_BF16 = float(torch.tensor(math.sqrt(2 / math.pi), dtype=torch.bfloat16))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``'s own steps on a bf16 ``x`` (``dense``'s output), each rounded to bf16.

    ``F.gelu`` rounds once; like ``silu``, the per-step roundings of the
    reference move whisper's outputs by a bf16 step in many elements.
    """
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI_BF16 * (x + 0.044715 * (x * (x * x)))))
    return x * cdf


def mlp_block(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """Gated (swiglu) or plain gelu MLP."""
    if kind == "swiglu":
        h = dense(x, p["w_in"]) * F.silu(dense(x, p["w_gate"]))
    else:
        h = gelu_tanh(dense(x, p["w_in"], p.get("b_in")))
    return dense(h, p["w_out"], p.get("b_out"))


# ------------------------------------------------------------------ embed / head
def embed_tokens(tokens: torch.Tensor, w_embed: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, cast(w_embed))


class _MatmulF32(torch.autograd.Function):
    """bf16 (M, K) x (K, N) -> fp32 on the card, with the reference's gradient.

    jax's transpose of ``einsum(bf16, bf16, preferred_element_type=float32)``
    takes the fp32 cotangent against the other operand widened to fp32, in an
    fp32 product, and rounds the result once to the operand's dtype (bf16).
    ``torch.mm(..., out_dtype=torch.float32)`` has no derivative, so the
    backward computes exactly that.
    """

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.mm(g, b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = torch.mm(a.float().t(), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) -> fp32 (M, N) from bf16 operands, as the reference's
    ``einsum(..., preferred_element_type=float32)``.

    A bf16-output matmul followed by ``.float()`` would round the result to
    bf16 and could flip a greedy argmax or a router's top-k at a near tie, so
    the fp32 result comes out of the product itself: cuBLAS's bf16 GEMM with
    an fp32 output on the card, and an fp32 product of the (exactly
    representable) bf16 values on the CPU, which has no such GEMM.  Under
    autograd on the card it runs through ``_MatmulF32``; on the CPU autograd
    of the fp32 product already computes the reference's gradient.
    """
    a, b = cast(a), cast(b)
    if a.is_cuda:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) bf16, w: (D, V) -> logits (B, S, V) fp32 (``matmul_f32``)."""
    b, s, d = x.shape
    return matmul_f32(x.reshape(b * s, d), w).reshape(b, s, -1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; logits fp32 (B, S, V), labels (B, S)."""
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - target)
