"""Shared neural-net layers, ported from ``repro.models.layers``.

Numerics follow the reference:

* matmuls take bf16 operands (``cast``) and accumulate in fp32; ``dense``
  returns bf16, ``lm_head`` returns fp32 logits;
* norms compute in fp32 and return the input dtype;
* the residual stream is bf16.

Under sharding rules on a multi-device mesh (``repro_torch.distributed``)
the same functions take DTensors and run per rank through
``distributed.local_call``, placed as the reference's annotations
(``shard``) place them: the products (``local_product``: a weight sharded
over the dp axes, ``fsdp``, is gathered first, as FSDP does), the norms,
the whole MLP, the embedding, the head and the cross-entropy
(vocab-parallel).  Each rank's computation is the single-device one on its
shards, so the card's routes stay the card's; DTensor only moves data
between the regions (its own propagation cannot take the products whose
token dim is sharded under ``seq_parallel``).  With no rules, or one
device, nothing changes.

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

from repro_torch import distributed as D
from repro_torch.kernels import ref
from repro_torch.kernels.ref import silu  # noqa: F401  (the model's silu, ``L.silu``)

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if D.distributed_rules() is not None and isinstance(x, D.DTensor):
        return _local_rms_norm(x, scale, eps)
    return ref.rms_norm(x, scale, eps)


def _local_rms_norm(x, scale, eps: float):
    """``rms_norm`` per rank; over a last dim sharded over tp (the SSM's inner
    dim) the sum of squares is summed across the ranks first."""
    mesh = x.device_mesh
    spec = D.spec_of(x)
    rows = D.P(*spec[:-1], None)
    sq = D.local_call(lambda xl: xl.float().square().sum(dim=-1, keepdim=True), [(x, spec)],
                      [D.with_partial(mesh, rows, x.ndim, D.axes_of(spec[-1]))])
    sq = D.constrain(sq, rows)
    n = x.shape[-1]

    def norm(xl, s, sc):
        return (xl.float() * torch.rsqrt(s / n + eps) * sc.float()).to(xl.dtype)

    return D.local_call(norm, [(x, spec), (sq, rows), (scale, D.P(spec[-1]))], [spec])


# ------------------------------------------------------------------ dense
def _plain_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = torch.matmul(cast(x), cast(w))
    if b is not None:
        y = y + cast(b)
    return y


def local_product(x: torch.Tensor, w: torch.Tensor, fn=None) -> torch.Tensor:
    """``fn(x_local, w_local)`` (default the bf16 product) per rank, as GSPMD
    would place ``x @ w``: x keeps its batch and token sharding, w gives up
    any dp sharding (fsdp: gathered), its contraction dim's tp sharding
    shards x's last dim too and leaves a partial sum over tp, its output
    dim's tp sharding shards the result's."""
    rules = D.distributed_rules()
    x = D.replicate(x, rules.mesh)
    w = D.replicate(w, rules.mesh)
    xs, ws = D.spec_of(x), D.spec_of(w)
    used = {a for e in xs[:-1] for a in D.axes_of(e)}

    def keep(entry):
        kept = tuple(a for a in D.axes_of(entry) if a not in rules.dp_axes and a not in used)
        return None if not kept else kept[0] if len(kept) == 1 else kept

    k_axis, n_axis = keep(ws[0]), keep(ws[1])
    x_spec, w_spec = D.P(*xs[:-1], k_axis), D.P(k_axis, n_axis)
    out = D.with_partial(rules.mesh, D.P(*xs[:-1], n_axis), x.ndim, D.axes_of(k_axis))
    fn = fn or (lambda xl, wl: torch.matmul(cast(xl), cast(wl)))
    return D.local_call(fn, [(x, x_spec), (w, w_spec)], [out])


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """bf16 ``x @ w (+ b)``: fp32 accumulation, one rounding to bf16."""
    if D.distributed_rules() is None or not isinstance(x, D.DTensor):
        return _plain_dense(x, w, b)
    y = local_product(x, w)
    if b is not None:
        y = D.constrain(y, D.spec_of(y)) + cast(b)  # a partial sum is taken before the bias
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
#: sqrt(2 / pi) in bf16, as ``jax.nn.gelu`` casts it to its input's dtype
_SQRT_2_OVER_PI_BF16 = float(torch.tensor(math.sqrt(2 / math.pi), dtype=torch.bfloat16))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``'s own steps on a bf16 ``x`` (``dense``'s output), each rounded to bf16.

    ``F.gelu`` rounds once; like ``silu``, the per-step roundings of the
    reference move whisper's outputs by a bf16 step in many elements.
    """
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI_BF16 * (x + 0.044715 * (x * (x * x)))))
    return x * cdf


def _mlp(x, w_in, w_gate, b_in, w_out, kind: str):
    """The MLP without its output bias: (B, S, D) -> (B, S, D) bf16."""
    if kind == "swiglu":
        h = _plain_dense(x, w_in) * F.silu(_plain_dense(x, w_gate))
    else:
        h = gelu_tanh(_plain_dense(x, w_in, b_in))
    return torch.matmul(cast(h), cast(w_out))


def mlp_block(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """Gated (swiglu) or plain gelu MLP.

    Under distributed rules it runs per rank (the hidden dim over tp, the
    reference's ``shard(h, "batch", "seq", "tp")``), its output a partial sum
    over tp taken by ``shard(y, "batch", "seq", None)`` before the bias.
    """
    weights = (p["w_in"], p.get("w_gate"), p.get("b_in"), p["w_out"])
    rules = D.distributed_rules()
    if rules is None or not isinstance(x, D.DTensor):
        y = _mlp(x, *weights, kind=kind)
    else:
        x_spec = D.sanitize_spec(rules, rules.spec("batch", "seq", None), x.shape)
        col, row = rules.spec(None, "tp"), rules.spec("tp", None)
        specs = (col, col, D.P(col[1]), row)
        out = D.with_partial(rules.mesh, x_spec, 3, D.axes_of(row[0]))
        y = D.local_call(lambda *a: _mlp(*a, kind=kind), [(x, x_spec), *zip(weights, specs)], [out])
        y = D.shard(y, "batch", "seq", None)
    if p.get("b_out") is not None:
        y = y + cast(p["b_out"])
    return y


# ------------------------------------------------------------------ embed / head
def embed_tokens(tokens: torch.Tensor, w_embed: torch.Tensor) -> torch.Tensor:
    """Token lookup.  Under distributed rules, per rank: a vocabulary sharded
    over tp is looked up in the rank's slice (zero rows elsewhere) and summed
    over tp; a model dim sharded over tp is gathered."""
    rules = D.distributed_rules()
    if rules is None or not isinstance(w_embed, D.DTensor):
        return F.embedding(tokens, cast(w_embed))
    rows = D.sanitize_spec(rules, rules.spec("batch", "seq"), tokens.shape)
    ws = D.spec_of(w_embed)
    keep = [None if e is None or set(D.axes_of(e)) & set(rules.dp_axes) else e for e in ws]
    vocab, model = keep
    w_spec = D.P(vocab, model)

    def lookup(tok, w_l):
        if vocab is None:
            return F.embedding(tok, cast(w_l))
        v_l = w_l.shape[0]
        local = tok - D.tp_index() * v_l
        owned = (local >= 0) & (local < v_l)
        return F.embedding(local.clamp(0, v_l - 1), cast(w_l)) * owned[..., None]

    out = D.with_partial(rules.mesh, D.P(*rows, model), 3, D.axes_of(vocab))
    y = D.local_call(lookup, [(tokens, rows), (w_embed, w_spec)], [out])
    return D.shard(y, "batch", "seq", None)


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
    if D.distributed_rules() is None or not isinstance(x, D.DTensor):
        return matmul_f32(x.reshape(b * s, d), w).reshape(b, s, -1)

    def head(xl, wl):
        bl, sl, dl = xl.shape
        return matmul_f32(xl.reshape(bl * sl, dl), wl).reshape(bl, sl, -1)

    return D.shard(local_product(x, w, head), "batch", "seq", "tp")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; logits fp32 (B, S, V), labels (B, S).

    Logits sharded over the vocabulary (tp) take the vocab-parallel form: a
    max over tp, then per rank the sum of exponentials and the target logit
    where the label falls in its slice, both summed over tp.
    """
    if D.distributed_rules() is None or not isinstance(logits, D.DTensor):
        lse = torch.logsumexp(logits, dim=-1)
        target = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.mean(lse - target)
    rules = D.distributed_rules()
    spec = D.sanitize_spec(rules, rules.spec("batch", "seq", "tp"), logits.shape)
    rows = D.P(*spec[:2])
    sharded = spec[2] is not None

    def combined(op):
        return D.with_partial(rules.mesh, rows, 2, D.axes_of(spec[2]), op)

    def local_max(lg):
        return lg.detach().amax(dim=-1)

    m = D.constrain(D.local_call(local_max, [(logits, spec)], [combined("max")]), rows)

    def local_terms(lg, lab, m):
        v_l = lg.shape[-1]
        local = lab.long() - (D.tp_index() * v_l if sharded else 0)
        owned = (local >= 0) & (local < v_l)
        picked = torch.gather(lg, -1, local.clamp(0, v_l - 1)[..., None])[..., 0]
        return torch.exp(lg - m[..., None]).sum(dim=-1), torch.where(owned, picked, 0.0)

    sumexp, target = D.local_call(local_terms, [(logits, spec), (labels, rows), (m, rows)],
                                  [combined("sum"), combined("sum")])
    lse = torch.log(D.constrain(sumexp, rows)) + m
    return torch.mean(lse - D.constrain(target, rows))
