"""prefill_step / serve_step factories, ported from ``repro.train.steps``.

``make_serve_step`` is the decode step: one new token against a KV cache.
``make_prefill_step`` is the logits-only forward of the prefill.  Training
steps are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, _, _ = T.forward(params, cfg, batch)
        # serving returns only the last-position logits (next-token dist)
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """Greedy decode step: (params, cache, {"tokens": (B, 1)}) -> (next token, cache)."""

    def serve_step(params, cache, batch):
        logits, _, new_cache = T.forward(params, cfg, batch, cache)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)
        return next_token, new_cache

    return serve_step
