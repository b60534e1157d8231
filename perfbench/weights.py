"""Parameters made from the seed, on the device, in the tree the port's models read.

One generator on the device, one ``randn`` call for every normal leaf at once
(a flat buffer whose slices are the leaves, each scaled in place), so set-up
draws billions of numbers in one kernel and not leaf by leaf.  The tree and
the scales follow the port's ``init_params`` (matmul weights N(0, 1/fan_in),
embedding 0.02, zero biases, unit norms; a family's own kinds of leaf,
such as mamba2's dt_bias and a_log, in ``KINDS`` of its
``reference/<family>.py``); the numbers are
the benchmark's own, so the plain reference reads the same values without
taking anything the program made.  The same seed on the same device gives
the same values, which is how the reference gets them again after the window.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import model as ref


def leaf_specs(family: str, m: dict) -> list:
    """(path, shape, kind, scale) of every leaf, in a fixed order; a path's
    parts are dict keys and list indices joined by dots.  The embedding, the
    final norm and the head come first; the layers' leaves are the family's
    (``reference/<family>.py``'s ``layer_specs``)."""
    d, v = m["d_model"], m["vocab"]
    specs = [("embed", (v, d), "normal", 0.02), ("final_norm", (d,), "ones", None)]
    if not m.get("tie_embeddings", False):
        specs.append(("lm_head", (d, v), "normal", 1 / math.sqrt(d)))
    return specs + ref.family_module(family).layer_specs(m)


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
    kinds = getattr(ref.family_module(family), "KINDS", {})
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
        elif kind in kinds:
            leaf = kinds[kind](shape, **f32)
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
