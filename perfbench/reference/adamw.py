"""Plain AdamW with global-norm clipping and a cosine schedule, as the configuration states it.

Decoupled weight decay on every leaf (Loshchilov and Hutter, arXiv:1711.05101),
bias-corrected moments, the gradients clipped to a global L2 norm first, and
the learning rate lr * min(t / warmup, 1) * (f + (1 - f) (1 + cos(pi u)) / 2)
at step t, u = clamp((t - warmup) / (total - warmup), 0, 1), f = min_lr_frac.
Float32 throughout.  Trees are ``{path: tensor}`` dicts.
"""

from __future__ import annotations

import math

import torch


def clipped(grads: dict, max_norm: float, norm: float | None = None) -> dict:
    """The gradients scaled to a global L2 norm of at most ``max_norm``; ``norm`` is that of every
    leaf's gradient where ``grads`` hold some of the leaves only (by default, ``grads``'s own)."""
    if norm is None:
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).item()
    scale = min(1.0, max_norm / max(norm, 1e-9))
    return {k: g * scale for k, g in grads.items()}


def learning_rate(h: dict, step: int) -> float:
    warm = min(step / max(h["warmup_steps"], 1), 1.0)
    u = min(max((step - h["warmup_steps"]) / max(h["total_steps"] - h["warmup_steps"], 1), 0.0), 1.0)
    f = h["min_lr_frac"]
    return h["lr"] * warm * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * u)))


def init(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()}, "step": 0}


def update(params: dict, grads: dict, state: dict, h: dict, norm: float | None = None) -> tuple[dict, dict, dict]:
    """One step: (new params, new state, the clipped gradients the moments took); ``norm`` as ``clipped``'s."""
    g = clipped(grads, h["grad_clip"], norm)
    t = state["step"] + 1
    lr = learning_rate(h, t)
    b1, b2 = h["b1"], h["b2"]
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        m = b1 * state["m"][k] + (1 - b1) * g[k]
        v = b2 * state["v"][k] + (1 - b2) * g[k].square()
        step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + h["eps"]) + h["weight_decay"] * p
        new_p[k], new_m[k], new_v[k] = p - lr * step, m, v
    return new_p, {"m": new_m, "v": new_v, "step": t}, g
