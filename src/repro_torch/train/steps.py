"""train_step / prefill_step / serve_step factories, ported from ``repro.train.steps``.

``make_train_step`` builds a (params, opt_state, batch) -> (params,
opt_state, metrics) function with optional microbatch gradient
accumulation, unrolled as in the reference (each microbatch's activations
are freed before the next, one optimizer step per global batch), and an
optional ``grad_transform`` hook on the gradients.  It runs eager; a CUDA
graph of the whole step, the counterpart of the reference's ``jax.jit``,
is later work.

``make_serve_step`` is the decode step: one new token against a KV cache,
eager.  ``capture_serve_step`` is the port's counterpart of the reference's
``jax.jit(serve_step)``: ``serve_step_in_place``, the same step over fixed
buffers, captured once as a CUDA graph and replayed.  ``make_prefill_step`` is the logits-only forward of the prefill.

Both record their phases (``repro_torch.phases``): a training step
``train.step`` (its host time is the host's dispatch of the step: nothing
in it waits for the device) around ``train.forward`` (``loss_fn``),
``train.backward`` (``autograd.grad``, the remat's recompute included) and
``train.optimizer`` (``adamw_update``), those three on the device's clock
too, and the counter ``train.steps``; a capture ``serve.capture.warmup``
(the eager step) and ``serve.capture.record`` (the ``torch.cuda.graph``
block, which waits for the device, empties the allocator's cache and
records the step while the device idles).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch import distributed as D
from repro_torch import phases
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import advance
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update, tree_leaves, tree_map, tree_unflatten


def _split_microbatches(batch: dict, n: int) -> dict:
    """Every batch entry (B, ...) -> (n, B/n, ...); M-RoPE positions (3, B, S) -> (n, 3, B/n, S)."""

    def re(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    out = {}
    for k, v in batch.items():
        if k == "positions" and v.ndim == 3:  # (3, B, S) m-rope positions
            if v.shape[1] % n:
                raise ValueError(f"batch {v.shape[1]} does not split into {n} microbatches")
            out[k] = torch.stack(torch.split(v, v.shape[1] // n, dim=1), dim=0)  # (n, 3, B/n, S)
        else:
            out[k] = re(v)
    return out


def _like(g, p):
    """A DTensor gradient redistributed to its parameter's placements (the
    all-reduce or reduce-scatter of its partial sums); a tensor as it is."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(cfg: ModelConfig, params, batch: dict, microbatch: int | None = None):
    """(loss, metrics, grads) of ``T.loss_fn`` at ``params``, which are left as
    they were; the gradients have the parameters' dtypes and tree.
    ``microbatch`` is the index that the phases' spans carry, if any."""
    flat = [p.detach().requires_grad_() for p in tree_leaves(params)]
    device = batch["tokens"].device
    with torch.enable_grad():
        with phases.phase("train.forward", device) as ph:
            if ph and microbatch is not None:
                ph.set(microbatch=microbatch)
            loss, metrics = T.loss_fn(tree_unflatten(params, flat), cfg, batch)
        with phases.phase("train.backward", device) as ph:
            if ph and microbatch is not None:
                ph.set(microbatch=microbatch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like(g, p) for p, g in zip(flat, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, grads)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    n_microbatches: int = 1,
    grad_transform: Callable[[Any], Any] | None = None,
):
    def train_step(params, opt_state, batch):
        """Metrics are 0-d device tensors: loss, ce, aux, grad_norm, lr."""
        with phases.phase("train.step") as step:
            if step:
                step.set(step_id=phases.counter("train.steps").value + 1)
            if n_microbatches == 1:
                loss, metrics, grads = value_and_grad(cfg, params, batch)
            else:
                micro = _split_microbatches(batch, n_microbatches)
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
                loss = 0.0
                metrics_acc = []
                for i in range(n_microbatches):
                    mb = {k: v[i] for k, v in micro.items()}
                    li, mi, gi = value_and_grad(cfg, params, mb, microbatch=i)
                    grads = tree_map(lambda a, b: a + b, grads, gi)
                    loss = loss + li
                    metrics_acc.append(mi)
                grads = tree_map(lambda g: g / n_microbatches, grads)
                loss = loss / n_microbatches
                metrics = {k: torch.mean(torch.stack([m[k] for m in metrics_acc])) for k in metrics_acc[0]}
            if grad_transform is not None:
                grads = grad_transform(grads)
            with phases.phase("train.optimizer", batch["tokens"].device):
                new_params, new_opt, om = adamw_update(params, grads, opt_state, opt_cfg)
        phases.count("train.steps")
        return new_params, new_opt, {"loss": loss, **metrics, **om}

    return train_step


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
        # a vocabulary sharded over tp is gathered first (DTensor's argmax over a
        # sharded dim reads values on the host)
        next_token = torch.argmax(D.shard(logits[:, -1, :], "batch", None), dim=-1)
        return next_token, new_cache

    return serve_step


def serve_step_in_place(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor) -> torch.Tensor:
    """One greedy step that updates ``cache`` and ``tokens`` in place; returns the logits.

    The new keys, values or states land in the cache's buffers, every
    ``len`` advances by one in place (the hybrid's per-group lengths too),
    and the next token overwrites ``tokens``, so the step's inputs and
    outputs are the same tensors from call to call; whisper's step reads the
    encoder's K/V that the prefill left in the cache, the same buffers on
    every call.
    """
    logits, _, _ = T.forward(params, cfg, {"tokens": tokens}, cache)
    advance(cache, 1)
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


@contextlib.contextmanager
def _collector_held_off():
    """Python's cyclic collector disabled inside, as it was outside afterwards."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def capture_serve_step(cfg: ModelConfig, params, cache: dict, batch: dict) -> GraphStep:
    """Run one decode step eagerly, then capture the next as a CUDA graph.

    ``cache`` (on the card) must hold the prefill; ``batch["tokens"]`` (B, 1)
    is the next input.  The eager step is the warm-up that
    ``torch.cuda.graphs`` asks for (on a side stream: first calls create
    library handles and workspaces); it is a real step, so on return the
    cache has advanced by one and ``tokens`` holds its greedy output.  Each
    ``replay`` of the returned step then decodes one more token.  A failure
    to capture raises; nothing falls back to the eager step.

    Python's cyclic collector is held off while the graph records: a CUDA
    graph that it frees then (an earlier step's, left in a reference cycle)
    resets itself, which a capture in progress does not permit, and the
    capture fails.
    """
    tokens = batch["tokens"].clone()
    if not tokens.is_cuda or tokens.shape[1] != 1:
        raise ValueError(f"capture_serve_step takes (B, 1) CUDA tokens, got {tuple(tokens.shape)} "
                         f"on {tokens.device}")
    with phases.phase("serve.capture.warmup"):
        side = torch.cuda.Stream(device=tokens.device)
        side.wait_stream(torch.cuda.current_stream(tokens.device))
        with torch.cuda.stream(side):
            serve_step_in_place(cfg, params, cache, tokens)
        torch.cuda.current_stream(tokens.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with phases.phase("serve.capture.record"), _collector_held_off():
        with torch.cuda.graph(graph):
            logits = serve_step_in_place(cfg, params, cache, tokens)
    return GraphStep(graph=graph, tokens=tokens, logits=logits)
