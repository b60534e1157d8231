"""Carry the reference's parameters into the port.

``repro.models.transformer.init_params`` returns a pytree of fp32 arrays
whose ``layers`` entries are stacked on a leading layer axis.  Given that
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``),
``from_jax_params`` returns the port's parameter dict: one dict per layer,
matmul weights and biases in bf16 (what the reference's ``cast`` gives at
every call), norm scales in fp32.  Both packages then compute the same
function, which is how the tests hold the port against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE

_NORMS = frozenset({"ln1", "ln2", "final_norm"})


def _leaf(name: str, a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=dev, dtype=torch.float32 if name in _NORMS else COMPUTE_DTYPE)


def from_jax_params(tree: dict, cfg: ModelConfig, device: torch.device | str | None = None) -> dict:
    """The reference's parameter pytree (numpy leaves) -> the port's parameters."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (only 'dense')")
    dev = resolve_device(device)
    params = {k: _leaf(k, tree[k], dev) for k in ("embed", "final_norm", "lm_head") if k in tree}
    stacked = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        layer = {}
        for name, sub in stacked.items():
            if isinstance(sub, dict):
                layer[name] = {k: _leaf(k, a[i], dev) for k, a in sub.items()}
            else:
                layer[name] = _leaf(name, sub[i], dev)
        layers.append(layer)
    params["layers"] = layers
    return params
