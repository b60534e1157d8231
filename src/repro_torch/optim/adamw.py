"""AdamW + cosine schedule + global-norm clipping, ported from ``repro.optim.adamw``.

Trees are the port's parameter trees: nested dicts and lists of tensors,
walked in the reference's leaf order (a dict's keys sorted, as
``jax.tree.leaves`` orders them).  ``step`` is a 0-d int32 tensor on the
parameters' device, and the learning rate, the bias corrections and the
clip scale are 0-d device tensors computed from it, so an update reads
nothing on the host.  Updates are functional, as in the reference: new
tensors, the inputs untouched.  The moments are fp32 whatever the
parameters' dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(skeleton: Any, leaves) -> Any:
    """A tree shaped like ``skeleton`` whose leaves are ``leaves``, in ``tree_leaves``' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(skeleton)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees of the same structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def clip_by_global_norm(grads: Any, max_norm: float):
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


def adamw_init(params: Any) -> dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    # like the parameter: a DTensor parameter's moments are DTensors of its placements
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}: 0-d fp32 tensors)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    flat = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))
    new_p, new_m, new_v = zip(*(upd(p, g, m, v) for p, g, m, v in flat))
    new_state = {"m": tree_unflatten(state["m"], new_m), "v": tree_unflatten(state["v"], new_v), "step": step}
    return tree_unflatten(params, new_p), new_state, {"grad_norm": gnorm, "lr": lr}
