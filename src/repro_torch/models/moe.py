"""Mixture-of-Experts block (top-k routing, capacity-based), ported from ``repro.models.moe``.

The reference runs ``_local_moe`` under ``shard_map`` with the experts
sharded over the tp axis; the port runs ``local_moe`` through
``distributed.local_call`` the same way under sharding rules on a
multi-device mesh: tokens batch-sharded over dp and replicated over tp,
the router replicated, each rank's E/tp experts resident.  A rank routes
its tokens, keeps the entries whose expert it holds
(``ent_expert // e_local == tp_index``), fills C = max(ceil(T_local·k/E·cf),
8) slots per local expert, and its partial outputs and aux leave as
``Partial`` DTensors: the combine's sum over tp runs in bf16, and aux is
averaged over tp.  On one device there is one tp shard: every expert is
local (``tp_index`` 0, ``e_local = E``), and the sum and mean are the
identity -- the same operations as before the sharded path existed.

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
The capacity route runs on no hand-written kernel: the reference leaves the
expert products, gathers and scatters to XLA, and the port to PyTorch's own
ops.

A ``models.published.PublishedConfig`` may ask for the published model's
routing instead (OLMoE): ``norm_topk_prob`` false weights the experts by the
raw top-k probabilities, and ``moe_dropless`` computes every entry
(``dropless_moe``, one device only): the T·k entries are sorted by expert on
the device (stable, so token-major within an expert), each expert's rows
start at an offset that stays on the device, and the experts' products run
grouped over the sorted rows through the hand-written kernel
``kernels.ops.moe_grouped_mm`` (its plain version where autograd records);
each entry's output is weighted in bf16 by its probability and a token's k
outputs summed in fp32 and rounded to bf16 once, as the capacity route's
``combine``.  No host sync there either, so the decode step still captures.

The dropless route records the phases ``moe.route`` (router product,
softmax, top-k, the sort and the offsets) and ``moe.experts`` (the grouped
products and the combine), on the device's clock too when the call has more
than one position (a prefill; a decode step, eager or recorded into its
graph, records host time only), and counts its routed entries in
``moe.entries``; the capacity route records none of them.
"""

from __future__ import annotations

import math

import torch

from repro_torch import distributed as D
from repro_torch import phases
from repro_torch.kernels import ops
from repro_torch.kernels.ref import moe_grouped_mm_ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def capacity(tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: max(ceil(T·k/E·cf), 8), in the reference's float order."""
    return max(int(math.ceil(tokens * top_k / n_experts * capacity_factor)), 8)


def route(xf: torch.Tensor, w_router: torch.Tensor, top_k: int, renormalize: bool = True):
    """xf (T, D) bf16 -> (top_p (T, k) fp32, renormalised to sum to one unless ``renormalize`` is
    false, top_i (T, k) int64, aux fp32 scalar)."""
    n_exp = w_router.shape[1]
    probs = torch.softmax(L.matmul_f32(xf, w_router), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1, sorted=True)
    if renormalize:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    experts = torch.arange(n_exp, device=xf.device)
    density = (top_i[:, :1] == experts).float().mean(dim=0)
    aux = n_exp * (density * probs.mean(dim=0)).sum()
    return top_p, top_i, aux


def dispatch(xf: torch.Tensor, top_i: torch.Tensor, n_exp: int, cap: int, tp_index: int = 0,
             n_total: int | None = None):
    """Gather the entries routed to this rank's ``n_exp`` experts into their slots.

    ``top_i`` holds global expert ids among ``n_total`` (default ``n_exp``);
    the rank holds experts ``tp_index * n_exp`` onward (all of them on one
    device).  Returns buf (E_local, C+1, D) bf16, each entry's slot (T·k,)
    (C where dropped or not local) and keep (T·k,) bool.  The reference scatter-adds the kept entries into a zero buffer;
    since kept slots are unique, the port records each slot's token (index
    T, a zero row, for an empty slot and for the scratch slot, where the
    dropped and the other ranks' entries land) and gathers the buffer in one
    pass.
    """
    t, k = top_i.shape
    ent_e = top_i.reshape(-1)
    experts = torch.arange(n_exp, device=xf.device)[:, None]
    if n_total is None or n_total == n_exp:
        local_e, is_local = ent_e, None
        # running count per expert, as a scan along the entries (the last axis)
        onehot = (ent_e[None, :] == experts).to(torch.int32)
    else:
        is_local = (ent_e // n_exp) == tp_index
        local_e = ent_e % n_exp
        onehot = ((local_e[None, :] == experts) & is_local[None, :]).to(torch.int32)
    slot = onehot.cumsum(dim=1, dtype=torch.int32).gather(0, local_e[None, :])[0].long() - 1
    keep = slot < cap
    if is_local is not None:
        keep = keep & is_local
    slot = torch.where(keep, slot, cap)
    token = torch.arange(t * k, device=xf.device) // k
    src = torch.full((n_exp * (cap + 1),), t, dtype=torch.long, device=xf.device)
    src[local_e * (cap + 1) + slot] = torch.where(keep, token, t)
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
            slot: torch.Tensor, keep: torch.Tensor, n_total: int | None = None) -> torch.Tensor:
    """Each token's k weighted expert outputs, summed in fp32: -> (T, D) bf16.

    ``out`` holds this rank's E_local experts of ``n_total`` (default: all).
    A token owns k consecutive entries, so the reference's segment sum is a
    sum over k; ``index_add_`` would order it by its atomics.
    """
    t, k = top_i.shape
    ent_e = top_i.reshape(-1)
    if n_total is not None and n_total != out.shape[0]:
        ent_e = ent_e % out.shape[0]
    w = torch.where(keep, top_p.reshape(-1), 0.0).to(L.COMPUTE_DTYPE)
    ent_out = out[ent_e, slot] * w[:, None]
    return ent_out.view(t, k, -1).sum(dim=1, dtype=torch.float32).to(L.COMPUTE_DTYPE)


def local_moe(x: torch.Tensor, w_router: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
              w_out: torch.Tensor, cfg: ModelConfig, tp_index: int = 0):
    """The reference's ``_local_moe`` on one rank: x (B_local, S, D) bf16, the
    rank's experts (E_local, ...) -> (its partial y (B_local, S, D), aux).

    Summed over the tp ranks, the partial outputs make the block's output;
    aux is the same on every rank (routing is replicated over tp).
    """
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_p, top_i, aux = route(xf, w_router, cfg.moe_top_k, getattr(cfg, "norm_topk_prob", True))
    cap = capacity(b * s, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
    buf, slot, keep = dispatch(xf, top_i, w_in.shape[0], cap, tp_index, cfg.moe_experts)
    p = {"w_in": w_in, "w_gate": w_gate, "w_out": w_out}
    y = combine(experts(buf, p), top_i, top_p, slot, keep, cfg.moe_experts)
    return y.reshape(b, s, d).to(x.dtype), aux


def sort_entries(top_i: torch.Tensor, n_exp: int):
    """The T·k entries (token-major) sorted by expert, on the device: (src (T·k,) int32, each sorted
    row's token; dst (T·k,) int32, its entry; offsets (E+1,) int32, where each expert's rows start,
    the last T·k).  The sort is stable, so within an expert the rows stay token-major."""
    k = top_i.shape[1]
    sorted_e, order = torch.sort(top_i.reshape(-1), stable=True)
    offsets = torch.searchsorted(sorted_e, torch.arange(n_exp + 1, device=top_i.device))
    return (torch.div(order, k, rounding_mode="floor").to(torch.int32), order.to(torch.int32),
            offsets.to(torch.int32))


def combine_entries(y_ent: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Each token's k entry outputs (T·k, D) bf16, token-major, weighted in bf16 by their
    probabilities and summed in fp32: -> (T, D) bf16, as ``combine``."""
    t, k = top_p.shape
    w = top_p.to(L.COMPUTE_DTYPE)
    return (y_ent.view(t, k, -1) * w[..., None]).sum(dim=1, dtype=torch.float32).to(L.COMPUTE_DTYPE)


def dropless_moe(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x (B, S, D) bf16 -> (y (B, S, D), aux): every routed entry computed (see the module's note).

    The grouped products run in ``ops.moe_grouped_mm`` (on the card the
    hand-written kernel, on the CPU its plain version), or in its plain
    version, one product per expert in torch, where autograd records.
    """
    b, s, d = x.shape
    xf = L.cast(x.reshape(b * s, d))
    timed = x.device if s > 1 else None
    with phases.phase("moe.route", timed):
        top_p, top_i, aux = route(xf, p["w_router"], cfg.moe_top_k, getattr(cfg, "norm_topk_prob", True))
        src, dst, offsets = sort_entries(top_i, cfg.moe_experts)
    with phases.phase("moe.experts", timed):
        args = (xf, L.cast(p["w_in"]), L.cast(p["w_gate"]), L.cast(p["w_out"]), src, dst, offsets)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args[:4]):
            y_ent = moe_grouped_mm_ref(*args)
        else:
            y_ent = ops.moe_grouped_mm(*args)
        y = combine_entries(y_ent, top_p)
    phases.count("moe.entries", b * s * cfg.moe_top_k)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) bf16 -> (y (B, S, D), aux fp32 scalar).

    With ``cfg.moe_dropless``, ``dropless_moe`` on one device; under
    sharding rules that raises rather than fall back to capacity routing.
    Under sharding rules on a multi-device mesh, ``local_moe`` per rank with
    the experts over tp (the reference's ``shard_map``): its partial y leaves
    as a bf16 sum over tp still to take, aux as a mean over tp.
    """
    rules = D.distributed_rules()
    dropless = getattr(cfg, "moe_dropless", False)
    if dropless and rules is not None:
        raise NotImplementedError(f"{cfg.name}: dropless routing (moe_dropless) runs on one device; its "
                                  f"sharded path, experts over tp, is not written")
    if dropless:
        return dropless_moe(x, p, cfg)
    args = (p["w_router"], p["w_in"], p["w_gate"], p["w_out"])
    if rules is None:
        return local_moe(x, *args, cfg)
    batch = D.sanitize_spec(rules, rules.spec("batch", None, None), x.shape)
    experts_spec = D.P(rules.tp_axis, None, None)
    y_out = D.with_partial(rules.mesh, batch, 3, (rules.tp_axis,))
    # aux: the mean over tp (``pmean``); over dp each shard keeps the aux of its
    # own tokens, as the reference's replicated out_spec P() leaves it
    aux_out = D.with_partial(rules.mesh, D.P(), 0, (rules.tp_axis,), "avg")
    y, aux = D.local_call(
        lambda x, wr, wi, wg, wo: local_moe(x, wr, wi, wg, wo, cfg, D.tp_index()),
        [(x, batch), (args[0], D.P(None, None)), (args[1], experts_spec), (args[2], experts_spec),
         (args[3], experts_spec)], [y_out, aux_out])
    return D.shard(y, "batch", None, None), aux
