"""Parameter / batch / cache spec factories (DP+FSDP x TP x EP), ported from
``repro.launch.shardings``.

Conventions, as the reference's:
  * "batch"  -> activations shard over the dp axes (pod+data),
  * "fsdp"   -> params + optimizer moments additionally shard over the data
                axes when rules.fsdp is on (ZeRO-style),
  * "tp"     -> heads / d_ff / experts / vocab shard over the model axis,
  * head-sharding follows attention.head_policy (q_sharded / kv_sharded /
    replicated) so non-divisible head counts degrade gracefully,
  * KV caches of kv-indivisible archs shard their *sequence* dim over tp
    (flash-decode), all others shard kv-heads.

The trees are the port's: nested dicts and lists (a list of per-layer dicts
where the reference stacks the layers on a leading axis, so a port spec is
the reference's without the stacked axes' leading Nones), and a leaf's path
is its dict keys.  A spec is a ``distributed.PartitionSpec``; the cache's
``len``, a 0-d (or per-group) int32 device tensor, replicates.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import NamedSharding, P, ShardingRules, sanitize_spec, to_placements
from repro_torch.models.config import ModelConfig


def _head_policy(cfg: ModelConfig, rules: ShardingRules) -> str:
    tp = rules.tp_size
    if tp == 1 or cfg.n_kv_heads % tp == 0:
        return "kv_sharded"
    if cfg.n_heads % tp == 0:
        return "q_sharded"
    return "replicated"


def _vocab_divisible(cfg: ModelConfig, rules: ShardingRules) -> bool:
    return cfg.vocab % rules.tp_size == 0


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(keys, leaf)`` over a tree of dicts, lists and tuples; ``keys`` are the dict keys on the way."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path) for v in tree)
    return fn(path, tree)


def map_specs(fn: Callable, spec_tree: Any, *rest: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)) and not isinstance(spec_tree, P):
        return type(spec_tree)(map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(spec_tree))
    return fn(spec_tree, *rest)


def param_specs(cfg: ModelConfig, rules: ShardingRules, params_shape: Any) -> Any:
    """Spec tree matching ``init_params`` (built from its shapes)."""
    policy = _head_policy(cfg, rules)
    q_spec = "tp" if policy in ("kv_sharded", "q_sharded") else None
    kv_spec = "tp" if policy == "kv_sharded" else None
    h_div = cfg.ssm_state and cfg.ssm_heads % rules.tp_size == 0
    ssm_h = "tp" if h_div else None
    vocab_tp = _vocab_divisible(cfg, rules)

    base: dict[str, tuple] = {
        "embed": ("tp", "fsdp") if vocab_tp else (None, "tp"),
        "lm_head": ("fsdp", "tp") if vocab_tp else ("tp", None),
        "final_norm": (None,),
        "enc_norm": (None,),
        "ln1": (None,),
        "ln2": (None,),
        "lnx": (None,),
        "ln": (None,),
        # attention
        "wq": ("fsdp", q_spec),
        "wk": ("fsdp", kv_spec),
        "wv": ("fsdp", kv_spec),
        "wo": (q_spec, "fsdp"),
        "bq": (q_spec,),
        "bk": (kv_spec,),
        "bv": (kv_spec,),
        # mlp
        "w_in": ("fsdp", "tp"),
        "w_gate": ("fsdp", "tp"),
        "w_out": ("tp", "fsdp"),
        "b_in": ("tp",),
        "b_out": (None,),
        # moe (leading experts dim)
        "w_router": (None, None),
        # mamba
        "w_z": ("fsdp", "tp"),
        "w_x": ("fsdp", "tp"),
        "w_b": ("fsdp", None),
        "w_c": ("fsdp", None),
        "w_dt": ("fsdp", None),
        "w_conv_x": (None, "tp"),
        "b_conv_x": ("tp",),
        "w_conv_b": (None, None),
        "b_conv_b": (None,),
        "w_conv_c": (None, None),
        "b_conv_c": (None,),
        "dt_bias": (ssm_h,),
        "a_log": (ssm_h,),
        "d_skip": (ssm_h,),
        "norm": ("tp",),
    }

    def spec_of(keys, leaf) -> P:
        name = keys[-1]
        parent = keys[-2] if len(keys) > 1 else ""
        if parent == "moe":
            logical = {
                "w_router": (None, None),
                "w_in": ("tp", "fsdp", None),
                "w_gate": ("tp", "fsdp", None),
                "w_out": ("tp", None, "fsdp"),
            }[name]
        elif parent == "mamba" and name == "w_out":
            logical = ("tp", "fsdp")
        else:
            logical = base[name]
        pad = leaf.ndim - len(logical)
        logical = (None,) * pad + tuple(logical)
        return rules.spec(*logical)

    return map_with_path(spec_of, params_shape)


def batch_specs(cfg: ModelConfig, rules: ShardingRules, batch_shape: dict) -> dict:
    out = {}
    for k, v in batch_shape.items():
        if k == "positions" and len(v.shape) == 3:
            spec = rules.spec(None, "batch", None)
        else:
            spec = rules.spec("batch", *([None] * (len(v.shape) - 1)))
        out[k] = sanitize_spec(rules, spec, v.shape)
    return out


def cache_specs(cfg: ModelConfig, rules: ShardingRules, cache_shape: Any) -> Any:
    policy = _head_policy(cfg, rules)
    kv_seq_sharded = policy != "kv_sharded"
    h_div = cfg.ssm_state and cfg.ssm_heads % rules.tp_size == 0
    ssm_h = "tp" if h_div else None

    def spec_of(keys, leaf) -> P:
        name = keys[-1] if keys else ""
        if name == "len":
            return rules.spec(*([None] * leaf.ndim))
        if name in ("k", "v") or "enc_kv" in keys:
            # (..., B, S, KV, Dh)
            lead = leaf.ndim - 4
            if name in ("k", "v") and kv_seq_sharded and "enc_kv" not in keys:
                logical = ("batch", "tp", None, None)
            else:
                logical = ("batch", None, "tp" if not kv_seq_sharded else None, None)
            return rules.spec(*(None,) * lead, *logical)
        if name == "state":  # (..., B, H, P, N)
            lead = leaf.ndim - 4
            return rules.spec(*(None,) * lead, "batch", ssm_h, None, None)
        if name == "conv_x":  # (..., B, K-1, di)
            lead = leaf.ndim - 3
            return rules.spec(*(None,) * lead, "batch", None, "tp")
        if name in ("conv_b", "conv_c"):
            lead = leaf.ndim - 3
            return rules.spec(*(None,) * lead, "batch", None, None)
        raise KeyError(f"unmapped cache leaf {keys}")

    return map_with_path(lambda keys, leaf: sanitize_spec(rules, spec_of(keys, leaf), leaf.shape), cache_shape)


def opt_specs(param_spec_tree: Any) -> dict:
    return {
        "m": param_spec_tree,
        "v": param_spec_tree,
        "step": P(),
    }


def to_shardings(rules: ShardingRules, spec_tree: Any, like: Any) -> Any:
    """A ``NamedSharding`` for each spec, for the leaves of ``like`` (same structure)."""
    return map_specs(lambda s, leaf: NamedSharding(
        rules.mesh, to_placements(rules.mesh, sanitize_spec(rules, s, leaf.shape), leaf.ndim)), spec_tree, like)


def distribute_tree(rules: ShardingRules, tree: Any, spec_tree: Any) -> Any:
    """Each tensor of ``tree`` placed on the rules' mesh by its spec.

    A real tensor, the same on every rank, goes through ``distribute_tensor``
    (each rank keeps its shard); a fake tensor (the dry run) becomes a
    DTensor over a fake local shard of the right shape, so nothing is
    allocated.  Without a multi-device mesh the tree comes back as it is.
    """
    from repro_torch.distributed import from_local, is_distributed

    if not is_distributed(rules):
        return tree
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import distribute_tensor

    def place(spec, t):
        spec = sanitize_spec(rules, spec, t.shape)
        placements = to_placements(rules.mesh, spec, t.ndim)
        if isinstance(t, FakeTensor):
            local = list(t.shape)
            for mesh_dim, p in enumerate(placements):
                if hasattr(p, "dim"):
                    local[p.dim] //= rules.mesh.size(mesh_dim)
            return from_local(torch.empty(local, dtype=t.dtype, device=t.device), rules.mesh, placements, t.shape)
        return distribute_tensor(t, rules.mesh, placements)

    return map_specs(place, spec_tree, tree)


def distribute_train_state(cfg: ModelConfig, rules: ShardingRules, make_params: Callable[[], Any]) -> tuple[Any, dict]:
    """(params, AdamW state) for training under ``rules``: the whole
    parameters from ``make_params()`` are placed by ``param_specs`` and
    dropped, then the moments are made like each placed parameter, born as
    ``opt_specs`` places them.  A rank's peak is one whole copy of the
    parameters beside its shards; the moments are never whole."""
    from repro_torch.optim.adamw import adamw_init

    params = make_params()
    p_specs = param_specs(cfg, rules, params)
    params = distribute_tree(rules, params, p_specs)  # the last reference to the whole tree
    opt = adamw_init(params)
    opt["step"] = distribute_tree(rules, opt, opt_specs(p_specs))["step"]
    return params, opt
