"""prefill_step / serve_step factories, ported from ``repro.train.steps``.

``make_serve_step`` is the decode step: one new token against a KV cache,
eager.  ``capture_serve_step`` is the port's counterpart of the reference's
``jax.jit(serve_step)``: ``serve_step_in_place``, the same step over fixed
buffers, captured once as a CUDA graph and replayed.  ``make_prefill_step`` is the logits-only forward of the prefill.
Training steps are not ported yet.
"""

from __future__ import annotations

import dataclasses

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


def serve_step_in_place(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor) -> torch.Tensor:
    """One greedy step that updates ``cache`` and ``tokens`` in place; returns the logits.

    The new keys, values or states land in the cache's buffers, ``len``
    advances by one in place, and the next token overwrites ``tokens``, so
    the step's inputs and outputs are the same tensors from call to call.
    """
    logits, _, _ = T.forward(params, cfg, {"tokens": tokens}, cache)
    cache["len"] += 1
    tokens.copy_(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
    return logits


@dataclasses.dataclass
class GraphStep:
    """A decode step captured as a CUDA graph over fixed buffers.

    ``tokens`` (B, 1) is the step's input and, after each ``replay``, its
    greedy output; ``logits`` (B, 1, V) fp32 holds the last replay's logits.
    A replay reads and advances the cache the step was captured on.
    """

    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor
    logits: torch.Tensor

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.tokens


def capture_serve_step(cfg: ModelConfig, params, cache: dict, batch: dict) -> GraphStep:
    """Run one decode step eagerly, then capture the next as a CUDA graph.

    ``cache`` (on the card) must hold the prefill; ``batch["tokens"]`` (B, 1)
    is the next input.  The eager step is the warm-up that
    ``torch.cuda.graphs`` asks for (on a side stream: first calls create
    library handles and workspaces); it is a real step, so on return the
    cache has advanced by one and ``tokens`` holds its greedy output.  Each
    ``replay`` of the returned step then decodes one more token.  A failure
    to capture raises; nothing falls back to the eager step.
    """
    tokens = batch["tokens"].clone()
    if not tokens.is_cuda or tokens.shape[1] != 1:
        raise ValueError(f"capture_serve_step takes (B, 1) CUDA tokens, got {tuple(tokens.shape)} "
                         f"on {tokens.device}")
    side = torch.cuda.Stream(device=tokens.device)
    side.wait_stream(torch.cuda.current_stream(tokens.device))
    with torch.cuda.stream(side):
        serve_step_in_place(cfg, params, cache, tokens)
    torch.cuda.current_stream(tokens.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits = serve_step_in_place(cfg, params, cache, tokens)
    return GraphStep(graph=graph, tokens=tokens, logits=logits)
