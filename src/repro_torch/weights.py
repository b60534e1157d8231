"""Carry the reference's parameters into the port.

``repro.models.transformer.init_params`` returns a pytree of fp32 arrays
whose ``layers`` entries are stacked on a leading layer axis.  Given that
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``),
``from_jax_params`` returns the port's parameter dict: one dict per layer,
matmul and conv weights and biases in bf16 (what the reference's ``cast``
gives at every call), and in fp32 the leaves the reference computes with in
fp32: norm scales and the SSM's ``dt_bias``, ``a_log`` and ``d_skip``
(``dt_bias`` is added and ``a_log`` exponentiated in fp32; rounding them to
bf16 would move every decay).  Both packages then compute the same
function, which is how the tests hold the port against the reference.

The per-layer loop slices every stacked leaf on its first axis, whatever
its rank: the moe family's router (L, D, E) and experts (L, E, D, F) and
(L, E, F, D) arrive as one layer's (D, E), (E, D, F) and (E, F, D), in bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.transformer import require_ported

_FP32 = frozenset({"ln1", "ln2", "ln", "lnx", "final_norm", "enc_norm", "norm", "dt_bias", "a_log",
                   "d_skip"})


def _leaf(name: str, a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=dev, dtype=torch.float32 if name in _FP32 else COMPUTE_DTYPE)


def _layer(stacked: dict, index: tuple, dev: torch.device) -> dict:
    """One layer's dict: every leaf of ``stacked`` at ``index`` on its leading axes."""
    return {name: _layer(sub, index, dev) if isinstance(sub, dict) else _leaf(name, sub[index], dev)
            for name, sub in stacked.items()}


def from_jax_params(tree: dict, cfg: ModelConfig, device: torch.device | str | None = None) -> dict:
    """The reference's parameter pytree (numpy leaves) -> the port's parameters.

    hybrid: ``layers`` stacked (groups, attn_every, ...) becomes a list of
    groups of layers, and the unstacked ``shared`` block one dict; audio:
    ``enc_layers`` a list too, beside ``enc_norm``.
    """
    require_ported(cfg)
    dev = resolve_device(device)
    params = {k: _leaf(k, tree[k], dev) for k in ("embed", "final_norm", "lm_head", "enc_norm") if k in tree}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        params["layers"] = [[_layer(tree["layers"], (g, j), dev) for j in range(cfg.attn_every)]
                            for g in range(groups)]
        params["shared"] = _layer(tree["shared"], (), dev)
        return params
    params["layers"] = [_layer(tree["layers"], (i,), dev) for i in range(cfg.n_layers)]
    if cfg.family == "audio":
        params["enc_layers"] = [_layer(tree["enc_layers"], (i,), dev) for i in range(cfg.n_encoder_layers)]
    return params
