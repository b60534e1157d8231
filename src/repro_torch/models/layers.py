"""Shared neural-net layers, ported from ``repro.models.layers``.

Numerics follow the reference:

* matmuls take bf16 operands (``cast``) and accumulate in fp32; ``dense``
  returns bf16, ``lm_head`` returns fp32 logits;
* norms compute in fp32 and return the input dtype;
* the residual stream is bf16.

The port holds matmul weights and biases in bf16: the reference keeps fp32
parameters but casts them to bf16 at every call, so a bf16 copy is exactly
what each call sees.  Norm scales stay fp32, as the norms read them in fp32.
"""

from __future__ import annotations

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


# ------------------------------------------------------------------ MLP
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s own steps, ``x * (1 / (1 + exp(-x)))``, each rounded to x's dtype.

    ``F.silu`` rounds once; on bf16 the two differ by one step in many
    elements, which the SSM's four silus a layer and the MoE's experts carry
    into the logits.
    """
    return x * (1 / (1 + torch.exp(-x)))


def mlp_block(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """Gated (swiglu) or plain gelu MLP."""
    if kind == "swiglu":
        h = dense(x, p["w_in"]) * F.silu(dense(x, p["w_gate"]))
    else:
        h = F.gelu(dense(x, p["w_in"], p.get("b_in")), approximate="tanh")
    return dense(h, p["w_out"], p.get("b_out"))


# ------------------------------------------------------------------ embed / head
def embed_tokens(tokens: torch.Tensor, w_embed: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, cast(w_embed))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) -> fp32 (M, N) from bf16 operands, as the reference's
    ``einsum(..., preferred_element_type=float32)``.

    A bf16-output matmul followed by ``.float()`` would round the result to
    bf16 and could flip a greedy argmax or a router's top-k at a near tie, so
    the fp32 result comes out of the product itself: cuBLAS's bf16 GEMM with
    an fp32 output on the card, and an fp32 product of the (exactly
    representable) bf16 values on the CPU, which has no such GEMM.
    """
    a, b = cast(a), cast(b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) bf16, w: (D, V) -> logits (B, S, V) fp32 (``matmul_f32``)."""
    b, s, d = x.shape
    return matmul_f32(x.reshape(b * s, d), w).reshape(b, s, -1)
