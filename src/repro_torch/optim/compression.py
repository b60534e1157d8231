"""Gradient compression for the data-parallel all-reduce, ported from
``repro.optim.compression``.

int8 quantisation with a per-tensor scale shared across the dp ranks:
gradients are quantised *before* the dp all-reduce and dequantised after,
cutting its bytes 4x against fp32.  The collectives are functional
collectives over the mesh's dp dims (a max for the scale, an int32 sum of
the int8 payloads), so a trace sees them at their local shapes.

The reference draws stochastic-rounding noise for a first quantisation, but
its result comes from a second one, ``round(g / scale)`` with the shared
scale, where the noise does not enter; the port computes that result and
needs no copy of jax's RNG.  It plugs into ``make_train_step``'s
``grad_transform`` hook; nothing calls it by default.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import ShardingRules, axis_names
from repro_torch.optim.adamw import tree_map


def _all_reduce(t: torch.Tensor, op: str, rules: ShardingRules) -> torch.Tensor:
    """``t`` reduced by ``op`` over every dp dim of the rules' mesh (sum and max compose dim by dim)."""
    import torch.distributed._functional_collectives as funcol

    names = axis_names(rules.mesh)
    for axis in rules.dp_axes:
        t = funcol.all_reduce(t, op, (rules.mesh, names.index(axis)))
    return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t


def compressed_psum_mean(grads: Any, rules: ShardingRules) -> Any:
    """Mean-reduce int8-compressed gradients over the dp axes.

    ``grads`` holds this rank's gradients (plain tensors, or DTensors whose
    local shards are taken), each rank's of the same shape -- the per-replica
    gradients of the reference's ``shard_map``.  Accumulation happens in
    int32 (a sum of int8 payloads cannot overflow for <= 2^23 replicas), then
    the mean is dequantised with the shared (max) scale.
    """

    def one(g):
        local = g.to_local() if hasattr(g, "to_local") else g
        gf = local.float()
        scale = _all_reduce(gf.abs().max() + 1e-12, "max", rules) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        total = _all_reduce(q.to(torch.int32), "sum", rules)
        return (total.float() / rules.dp_size) * scale

    return tree_map(one, grads)
