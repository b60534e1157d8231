"""Shared by ``test_torch_train_loss*.py``: the port's ``loss_fn`` and every
gradient leaf against ``jax.value_and_grad(repro.models.transformer.loss_fn)``.

Both packages start from the reference's parameters (``init_params``,
carried across in fp32 by ``from_jax_params(param_dtype=torch.float32)``)
and one batch of the reference's ``SyntheticLMData`` (batch 2, sequence 64;
vlm adds its vision embeddings and (3, B, S) positions, audio its frames).
The reference runs op by op (``scan_layers=False``, eager), as the serving
tests hold it, with its XLA twin of the scan as it trains.  The bar for each
leaf is relative L2 ``GRAD_REL_L2`` (2e-2, the bf16 bar); where the
reference's own compiled run (``jax.jit``, ``lax.scan`` over layers) differs
from its op-by-op run by more than that in some leaf, the family's bar is
``FLOOR_FACTOR`` x that largest gap, as in ``test_torch_serve_hybrid.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticLMData as JData
from repro.distributed import single_device_rules, use_rules
from repro.models import transformer as JT
from repro.models.config import InputShape as JShape
from repro.models.config import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.models.config import reduced
from repro_torch.train.steps import value_and_grad
from repro_torch.weights import from_jax_params

GRAD_REL_L2 = 2e-2
FLOOR_FACTOR = 1.25
SEQ, BATCH = 64, 2


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _stack_layers(layers):
    """A list of per-layer dicts of tensors -> one dict of (L, ...) numpy arrays."""
    return jax.tree.map(lambda *xs: np.stack([x.detach().numpy() for x in xs]), *layers)


def as_reference_tree(tree, family):
    """The port's parameter-shaped tree in the reference's stacked layout (numpy)."""
    out = {k: v.detach().numpy() for k, v in tree.items() if isinstance(v, torch.Tensor)}
    if family == "hybrid":
        groups = [_stack_layers(g) for g in tree["layers"]]
        out["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *groups)
        out["shared"] = jax.tree.map(lambda t: t.detach().numpy(), tree["shared"])
    else:
        out["layers"] = _stack_layers(tree["layers"])
        if "enc_layers" in tree:
            out["enc_layers"] = _stack_layers(tree["enc_layers"])
    return out


def compare(arch):
    """{leaf path: (port's rel L2 against the op-by-op run, the compiled run's)}, and the three losses."""
    jcfg = jreduced(jget_config(arch))
    op_cfg = dataclasses.replace(jcfg, scan_layers=False)
    cfg = reduced(get_config(arch))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu", param_dtype=torch.float32)
    data = JData(jcfg, JShape("t", SEQ, BATCH, "train"), seed=1).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in data.items()}
    vg = jax.value_and_grad(JT.loss_fn, has_aux=True)
    with use_rules(single_device_rules()):
        (jl, _), jg = vg(jparams, op_cfg, jbatch)
        (cl, _), cg = jax.jit(vg, static_argnums=1)(jparams, jcfg, jbatch)
    loss, metrics, grads = value_and_grad(cfg, params, batch)
    assert set(metrics) == {"ce", "aux"}
    port = as_reference_tree(grads, cfg.family)
    assert jax.tree.structure(port) == jax.tree.structure(jax.tree.map(np.asarray, jg))
    gaps = {}
    for (path, j), p, c in zip(jax.tree_util.tree_flatten_with_path(jg)[0], jax.tree.leaves(port),
                               jax.tree.leaves(cg)):
        assert p.shape == j.shape and p.dtype == np.float32, jax.tree_util.keystr(path)
        gaps[jax.tree_util.keystr(path)] = (_rel_l2(p, j), _rel_l2(c, j))
    return gaps, (float(loss), float(jl), float(cl))


def family_bar(gaps):
    """``GRAD_REL_L2``, or ``FLOOR_FACTOR`` x the reference's own largest gap where that is larger."""
    return max(GRAD_REL_L2, FLOOR_FACTOR * max(c for _, c in gaps.values()))
