"""Mixture-of-Experts block (top-k routing, capacity-based), ported from ``repro.models.moe``.

The reference runs ``_local_moe`` under ``shard_map`` with the experts
sharded over the tp axis.  On one device there is one tp shard: every expert
is local (``tp_index`` 0, ``e_local = E``), and its ``psum`` and ``pmean``
are the identity, so the port is ``_local_moe`` without them.

Switch-style capacity dispatch, as in the reference:

* the router's logits are an fp32 product of bf16 operands; softmax and the
  top-k renormalisation are fp32 (``route``);
* the T·k entries are ordered token-major, then by rank within the token's
  top-k.  An entry's slot is its rank among the entries routed to its expert
  (a running count), and each expert holds C = max(ceil(T·k/E·cf), 8) slots.
  An entry past C goes to a scratch slot C and is dropped (``dispatch``);
* the expert products run batched over (E, C+1, D) bf16 buffers
  (``experts``); the scratch slot holds zeros, so its output is zero;
* each entry's output is gathered from its slot, weighted in bf16 by its
  renormalised probability (zero when dropped), summed per token in fp32 and
  rounded to bf16 once (``combine``);
* the load-balance aux loss E · Σ(density · mean_prob) takes its density
  from the top-1 choice.

The block synchronises with the host nowhere and every shape follows from
the input's shape and the config (no ``.item()``, ``nonzero`` or boolean-mask
indexing, no branch on a tensor's value), so a CUDA graph can capture it.
It runs on no hand-written kernel: the reference leaves the expert products,
gathers and scatters to XLA, and the port to PyTorch's own ops.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def capacity(tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: max(ceil(T·k/E·cf), 8), in the reference's float order."""
    return max(int(math.ceil(tokens * top_k / n_experts * capacity_factor)), 8)


def route(xf: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """xf (T, D) bf16 -> (top_p (T, k) fp32 renormalised, top_i (T, k) int64, aux fp32 scalar)."""
    n_exp = w_router.shape[1]
    probs = torch.softmax(L.matmul_f32(xf, w_router), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    experts = torch.arange(n_exp, device=xf.device)
    density = (top_i[:, :1] == experts).float().mean(dim=0)
    aux = n_exp * (density * probs.mean(dim=0)).sum()
    return top_p, top_i, aux


def dispatch(xf: torch.Tensor, top_i: torch.Tensor, n_exp: int, cap: int):
    """Gather the entries into their experts' slots.

    Returns buf (E, C+1, D) bf16, each entry's slot (T·k,) (C where dropped)
    and keep (T·k,) bool.  The reference scatter-adds the kept entries into
    a zero buffer; since kept slots are unique, the port records each slot's
    token (index T, a zero row, for an empty slot and for the scratch slot,
    where the dropped entries land) and gathers the buffer in one pass.
    """
    t, k = top_i.shape
    ent_e = top_i.reshape(-1)
    # running count per expert, as a scan along the entries (the last axis)
    onehot = (ent_e[None, :] == torch.arange(n_exp, device=xf.device)[:, None]).to(torch.int32)
    slot = onehot.cumsum(dim=1, dtype=torch.int32).gather(0, ent_e[None, :])[0].long() - 1
    keep = slot < cap
    slot = torch.where(keep, slot, cap)
    token = torch.arange(t * k, device=xf.device) // k
    src = torch.full((n_exp * (cap + 1),), t, dtype=torch.long, device=xf.device)
    src[ent_e * (cap + 1) + slot] = torch.where(keep, token, t)
    rows = torch.cat([L.cast(xf), xf.new_zeros((1, xf.shape[1]), dtype=L.COMPUTE_DTYPE)])
    return rows[src].view(n_exp, cap + 1, -1), slot, keep


def experts(buf: torch.Tensor, p: dict) -> torch.Tensor:
    """The swiglu experts over their slots: (E, C+1, D) bf16 -> (E, C+1, D) bf16.

    Three batched products with bf16 outputs (fp32 accumulation), and
    ``h * silu(g)`` in bf16 with ``jax.nn.silu``'s own rounding steps.
    """
    h = torch.bmm(buf, L.cast(p["w_in"]))
    g = torch.bmm(buf, L.cast(p["w_gate"]))
    return torch.bmm(h * L.silu(g), L.cast(p["w_out"]))


def combine(out: torch.Tensor, top_i: torch.Tensor, top_p: torch.Tensor,
            slot: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each token's k weighted expert outputs, summed in fp32: -> (T, D) bf16.

    A token owns k consecutive entries, so the reference's segment sum is a
    sum over k; ``index_add_`` would order it by its atomics.
    """
    t, k = top_i.shape
    w = torch.where(keep, top_p.reshape(-1), 0.0).to(L.COMPUTE_DTYPE)
    ent_out = out[top_i.reshape(-1), slot] * w[:, None]
    return ent_out.view(t, k, -1).sum(dim=1, dtype=torch.float32).to(L.COMPUTE_DTYPE)


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) bf16 -> (y (B, S, D), aux fp32 scalar)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_p, top_i, aux = route(xf, p["w_router"], cfg.moe_top_k)
    cap = capacity(b * s, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
    buf, slot, keep = dispatch(xf, top_i, cfg.moe_experts, cap)
    y = combine(experts(buf, p), top_i, top_p, slot, keep)
    return y.reshape(b, s, d).to(x.dtype), aux
