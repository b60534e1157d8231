"""Plain float32 reference of the benchmark's models: what every family shares, and each family by name.

Written from the models' published equations, in plain PyTorch, for the
comparison that decides a run's ``correct``.  It imports nothing of the
program (``repro_torch``) or of the JAX package and takes none of their
outputs but the ones it judges: it reads the parameter tree that
``perfbench.weights`` makes from the seed, and the sizes in
``perfbench/configs/<name>.json``.  Every operation is float32 with TF32 off
(``fp32_matmuls``), and a product may be swapped for a lower-precision one
(``matmul=``) to make the control that the comparison must fail.

Every family shares the embedding, the final RMSNorm and the head (tied to
the embedding where the configuration says so), here.  The layers between
are the family's, in ``perfbench/reference/<family>.py``, found by the
configuration's ``family`` (``family``): ``ssm.py`` holds mamba2's.  The
residual stream is float32, as published (the program keeps it in
bfloat16, which a configuration lists in ``reduced``).
"""

from __future__ import annotations

import contextlib
import importlib
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def fp32_matmuls():
    """Float32 products in full float32: TF32 off for matmuls and cuDNN, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def linear(x: torch.Tensor, w: torch.Tensor, matmul=fp32_matmul) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32 (``matmul`` takes 2-d operands)."""
    lead = x.shape[:-1]
    return matmul(x.reshape(-1, x.shape[-1]), w.float()).reshape(*lead, w.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def family_module(family: str):
    """The reference's module of ``family``: ``<family>.py`` beside this file (see the module's note)."""
    path = Path(__file__).with_name(f"{family}.py")
    if not family.isidentifier() or not path.is_file():
        raise ValueError(f"the reference has no family {family!r}: no file {path}")
    return importlib.import_module(f"{__package__}.{family}")


def hidden_states(family: str, params: dict, m: dict, tokens: torch.Tensor, matmul=fp32_matmul,
                  remat: bool = False) -> torch.Tensor:
    """The final RMSNorm's output (B, S, D) for integer ``tokens`` (B, S).

    ``remat`` recomputes each layer in the backward pass (for training at
    full size), which changes memory, not values.
    """
    x = F.embedding(tokens, params["embed"].float())

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    x = family_module(family).layers(x, params, m, run, matmul)
    return rms_norm(x, params["final_norm"], m["norm_eps"])


def head_weight(params: dict, m: dict) -> torch.Tensor:
    return params["embed"].t() if m.get("tie_embeddings", False) else params["lm_head"]


def logits_at(family: str, params: dict, m: dict, tokens: torch.Tensor, positions: slice,
              matmul=fp32_matmul) -> torch.Tensor:
    """Float32 logits (B, len(positions), V) at ``positions`` of ``tokens`` (B, S)."""
    with torch.no_grad():
        x = hidden_states(family, params, m, tokens, matmul)[:, positions]
        return linear(x, head_weight(params, m), matmul)


def loss(family: str, params: dict, m: dict, tokens: torch.Tensor, labels: torch.Tensor,
         matmul=fp32_matmul, rows: slice | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy over every position of ``rows`` (default: all rows)."""
    if rows is not None:
        tokens, labels = tokens[rows], labels[rows]
    x = hidden_states(family, params, m, tokens, matmul, remat=True)
    logits = linear(x, head_weight(params, m), matmul)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
