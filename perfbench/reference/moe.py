"""The moe family of the plain reference: OLMoE-1B-7B-0924 (arXiv:2409.02060).

Each layer, as transformers' ``models/olmoe/modeling_olmoe.py`` writes it
(``OlmoeAttention``, ``OlmoeSparseMoeBlock``, ``OlmoeDecoderLayer``):

    h = RMSNorm(x)
    q = RMSNorm_q(h Wq), k = RMSNorm_k(h Wk)   (each over its whole width, with ``qk_norm``)
    v = h Wv;  q, k rotated by RoPE (rotate-half, base ``rope_theta``)
    x = x + softmax(q k^T / sqrt(head_dim), causal) v Wo
    h = RMSNorm(x);  p = softmax(h W_router)
    x = x + sum over the token's top-k experts e of p_e * ((silu(h W_gate[e]) * (h W_in[e])) W_out[e])

with the top-k probabilities renormalised to sum to one only when
``norm_topk_prob`` is true (OLMoE's is false).  Every chosen expert runs on
its rows, one expert at a time: nothing is dropped, whatever the load.

Departures from ``modeling_olmoe.py``, none in the function:

* everything is float32 with TF32 off (``model.fp32_matmuls``), where the
  release runs bfloat16; a token's expert outputs add in expert order in
  float32 (the release's ``index_add_`` adds in bfloat16);
* the weights are the benchmark's, random from the seed (``perfbench.weights``),
  laid out (in, out) and the experts stacked (E, D, F) and (E, F, D), where
  ``nn.Linear`` keeps (out, in) per expert;
* the whole sequence runs at once, with no cache, no ``clip_qkv`` (the
  release's is null) and no dropout;
* the router's load-balancing loss, a training term, is not computed.

Attention's products (q k^T, the probabilities times v) are float32 ``matmul``s
that the fp8 control leaves as they are, as ``ssm.py`` leaves its scan; the
projections, the router and the experts take ``matmul``.
"""

from __future__ import annotations

import math

import torch

from .model import fp32_matmul, linear, rms_norm, silu

#: no leaf of this family is other than normal, zeros or ones (the q and k norm scales are ones)
KINDS: dict = {}


def _layer_specs(m: dict, prefix: str) -> list:
    d, f, e = m["d_model"], m["d_ff"], m["moe_experts"]
    hd = m["head_dim"]
    q_width, kv_width = m["n_heads"] * hd, m["n_kv_heads"] * hd
    at, mo = prefix + "attn.", prefix + "moe."
    specs = [
        (prefix + "ln1", (d,), "ones", None),
        (at + "wq", (d, q_width), "normal", 1 / math.sqrt(d)),
        (at + "wk", (d, kv_width), "normal", 1 / math.sqrt(d)),
        (at + "wv", (d, kv_width), "normal", 1 / math.sqrt(d)),
        (at + "wo", (q_width, d), "normal", 1 / math.sqrt(q_width)),
    ]
    if m.get("qk_norm", False):
        specs += [(at + "q_norm", (q_width,), "ones", None), (at + "k_norm", (kv_width,), "ones", None)]
    return specs + [
        (prefix + "ln2", (d,), "ones", None),
        (mo + "w_router", (d, e), "normal", 1 / math.sqrt(d)),
        (mo + "w_in", (e, d, f), "normal", 1 / math.sqrt(d)),
        (mo + "w_gate", (e, d, f), "normal", 1 / math.sqrt(d)),
        (mo + "w_out", (e, f, d), "normal", 1 / math.sqrt(f)),
    ]


def layer_specs(m: dict) -> list:
    out = []
    for i in range(m["n_layers"]):
        out += _layer_specs(m, f"layers.{i}.")
    return out


def rope_tables(s: int, head_dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (S, head_dim / 2) of positions 0 .. S-1, computed in float64."""
    inv = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim)
    ang = torch.arange(s, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE by rotate-half on x (B, H, S, hd): the first half of each head pairs with the second."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h: torch.Tensor, p: dict, m: dict, cos, sin, matmul=fp32_matmul) -> torch.Tensor:
    """Causal self-attention of RMSNorm'd h (B, S, D), out-projected."""
    b, s, _ = h.shape
    hd, nh, nkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    q, k, v = linear(h, p["wq"], matmul), linear(h, p["wk"], matmul), linear(h, p["wv"], matmul)
    if m.get("qk_norm", False):
        q, k = rms_norm(q, p["q_norm"], m["norm_eps"]), rms_norm(k, p["k_norm"], m["norm_eps"])
    q = rotate(q.view(b, s, nh, hd).transpose(1, 2), cos, sin)
    k = rotate(k.view(b, s, nkv, hd).transpose(1, 2), cos, sin).repeat_interleave(nh // nkv, dim=1)
    v = v.view(b, s, nkv, hd).transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    future = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    del scores
    o = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, nh * hd)
    return linear(o, p["wo"], matmul)


def experts(h: torch.Tensor, p: dict, m: dict, matmul=fp32_matmul) -> torch.Tensor:
    """The sparse-expert block on RMSNorm'd h (B, S, D): every chosen expert on its rows."""
    b, s, d = h.shape
    hf = h.reshape(b * s, d)
    probs = torch.softmax(linear(hf, p["w_router"], matmul), dim=-1)
    top_p, top_i = torch.topk(probs, m["moe_top_k"], dim=-1)
    if m.get("norm_topk_prob", True):
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(hf)
    for e in range(m["moe_experts"]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        he = hf[tok]
        ye = linear(silu(linear(he, p["w_gate"][e], matmul)) * linear(he, p["w_in"][e], matmul),
                    p["w_out"][e], matmul)
        out.index_add_(0, tok, ye * top_p[tok, slot, None])
    return out.view(b, s, d)


def decoder_layer(x: torch.Tensor, p: dict, m: dict, cos, sin, matmul=fp32_matmul) -> torch.Tensor:
    x = x + attention(rms_norm(x, p["ln1"], m["norm_eps"]), p["attn"], m, cos, sin, matmul)
    return x + experts(rms_norm(x, p["ln2"], m["norm_eps"]), p["moe"], m, matmul)


def layers(x: torch.Tensor, params: dict, m: dict, run, matmul=fp32_matmul) -> torch.Tensor:
    cos, sin = rope_tables(x.shape[1], m["head_dim"], m["rope_theta"], x.device)
    for p in params["layers"]:
        x = run(lambda x_, p_=p: decoder_layer(x_, p_, m, cos, sin, matmul), x)
    return x
