"""Parameters made from the seed, on the device, in the tree the port's models read.

One generator on the device, one ``randn`` call for every normal leaf at once
(a flat buffer whose slices are the leaves, each scaled in place), so set-up
draws billions of numbers in one kernel and not leaf by leaf.  The tree and
the scales follow the port's ``init_params`` (matmul weights N(0, 1/fan_in),
embedding 0.02, conv taps 0.5, zero biases, unit norms and
D, dt_bias log(expm1(0.01)), a_log log(linspace(1, 16, H))); the numbers are
the benchmark's own, so the plain reference reads the same values without
taking anything the program made.  The same seed on the same device gives
the same values, which is how the reference gets them again after the window.
"""

from __future__ import annotations

import math

import torch


def _mamba_specs(m: dict, prefix: str) -> list:
    d, di, n = m["d_model"], m["ssm_expand"] * m["d_model"], m["ssm_state"]
    h, k = di // m["ssm_headdim"], m["ssm_conv"]
    mb = prefix + "mamba."
    return [
        (prefix + "ln", (d,), "ones", None),
        (mb + "w_z", (d, di), "normal", 1 / math.sqrt(d)),
        (mb + "w_x", (d, di), "normal", 1 / math.sqrt(d)),
        (mb + "w_b", (d, n), "normal", 1 / math.sqrt(d)),
        (mb + "w_c", (d, n), "normal", 1 / math.sqrt(d)),
        (mb + "w_dt", (d, h), "normal", 1 / math.sqrt(d)),
        (mb + "w_conv_x", (k, di), "normal", 0.5),
        (mb + "b_conv_x", (di,), "zeros", None),
        (mb + "w_conv_b", (k, n), "normal", 0.5),
        (mb + "b_conv_b", (n,), "zeros", None),
        (mb + "w_conv_c", (k, n), "normal", 0.5),
        (mb + "b_conv_c", (n,), "zeros", None),
        (mb + "dt_bias", (h,), "dt_bias", None),
        (mb + "a_log", (h,), "a_log", None),
        (mb + "d_skip", (h,), "ones", None),
        (mb + "norm", (di,), "ones", None),
        (mb + "w_out", (di, d), "normal", 1 / math.sqrt(di)),
    ]


def leaf_specs(family: str, m: dict) -> list:
    """(path, shape, kind, scale) of every leaf, in a fixed order; a path's
    parts are dict keys and list indices joined by dots."""
    d, v = m["d_model"], m["vocab"]
    specs = [("embed", (v, d), "normal", 0.02), ("final_norm", (d,), "ones", None)]
    if not m.get("tie_embeddings", False):
        specs.append(("lm_head", (d, v), "normal", 1 / math.sqrt(d)))
    if family == "ssm":
        for i in range(m["n_layers"]):
            specs += _mamba_specs(m, f"layers.{i}.")
    else:
        raise ValueError(f"no weights for family {family!r}")
    return specs


def _insert(tree: dict, path: str, value) -> None:
    """Put ``value`` at ``path`` (dict keys and list indices joined by dots); a list grows by
    appending, so its indices must arrive in order."""
    keys = path.split(".")
    node = tree
    for key, nxt in zip(keys[:-1], keys[1:]):
        if isinstance(node, list):
            if int(key) == len(node):
                node.append([] if nxt.isdigit() else {})
            node = node[int(key)]
        else:
            node = node.setdefault(key, [] if nxt.isdigit() else {})
    if isinstance(node, list):
        if int(keys[-1]) != len(node):
            raise ValueError(f"{path}: list index out of order")
        node.append(value)
    else:
        node[keys[-1]] = value


def make(family: str, m: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The parameter tree for ``seed``: matmul and conv weights and biases in
    ``dtype`` (bf16 to serve, fp32 masters to train), the other leaves fp32."""
    specs = leaf_specs(family, m)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, kind, _ in specs if kind == "normal")
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    offset = 0
    f32 = dict(dtype=torch.float32, device=device)
    for path, shape, kind, scale in specs:
        if kind == "normal":
            count = math.prod(shape)
            leaf = flat[offset:offset + count].view(shape)
            leaf.mul_(scale)
            offset += count
        elif kind == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "ones":
            leaf = torch.ones(shape, **f32)
        elif kind == "dt_bias":
            leaf = torch.log(torch.expm1(torch.full(shape, 0.01, **f32)))
        elif kind == "a_log":
            leaf = torch.log(torch.linspace(1.0, 16.0, shape[0], **f32))
        else:
            raise ValueError(kind)
        _insert(tree, path, leaf)
    return tree


def unflatten(named: dict) -> dict:
    """The nested tree of ``{path: tensor}`` leaves (``named_leaves``' inverse)."""
    tree: dict = {}
    for path in sorted(named, key=lambda p: [int(x) if x.isdigit() else x for x in p.split(".")]):
        _insert(tree, path, named[path])
    return tree


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, tensor)] of a tree of dicts and lists, in ``leaf_specs``' path form, sorted by path."""
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += named_leaves(v, f"{prefix}{i}.")
    else:
        out.append((prefix[:-1], tree))
    return sorted(out, key=lambda kv: kv[0])
