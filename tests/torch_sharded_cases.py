"""The sharded cases of ``tests/test_torch_sharded.py``, run in two subprocesses.

``python tests/torch_sharded_cases.py reference OUT.npz`` runs the JAX
reference on a (2, 2) mesh of four host devices (the caller sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu``);
``python tests/torch_sharded_cases.py port REF.npz OUT.npz CKPT_DIR`` runs
the port on four gloo ranks over a (2, 2) ``"cpu"`` mesh, on the same
seeded numpy inputs (and, for training, the reference's initial
parameters).  Each writes its results as one npz; the test compares them.
"""

from __future__ import annotations

import os
import sys

import numpy as np

SEED = 23
TRAIN_ARCHS = ("qwen2-1.5b", "mamba2-780m")
TRAIN_STEPS = 3
TRAIN_SEQ, TRAIN_BATCH = 64, 4
DECODE_IDX = 37  # in the second rank's half of a 64-position cache: the owner is tp rank 1
MESH = (2, 2)


def _cfg(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    return reduced(get_config(arch))


def inputs() -> dict:
    """Seeded float32 inputs; every side rounds them to bf16 where the model takes bf16."""
    rng = np.random.default_rng(SEED)
    g = _cfg("granite-20b")  # 4 heads, 1 kv head
    o = _cfg("olmoe-1b-7b")  # 8 experts: 4 a rank
    hd, d, e, f = g.head_dim, o.d_model, o.moe_experts, o.d_ff
    cache_k = rng.standard_normal((2, 64, 1, hd)).astype(np.float32)
    cache_v = rng.standard_normal((2, 64, 1, hd)).astype(np.float32)
    cache_k[:, DECODE_IDX:] = 0
    cache_v[:, DECODE_IDX:] = 0
    return {
        "q": rng.standard_normal((2, 64, 4, hd)).astype(np.float32),
        "k": rng.standard_normal((2, 64, 1, hd)).astype(np.float32),
        "v": rng.standard_normal((2, 64, 1, hd)).astype(np.float32),
        "dq": rng.standard_normal((2, 1, 4, hd)).astype(np.float32),
        "cache_k": cache_k,
        "cache_v": cache_v,
        "k_new": rng.standard_normal((2, 1, 1, hd)).astype(np.float32),
        "v_new": rng.standard_normal((2, 1, 1, hd)).astype(np.float32),
        "moe_x": rng.standard_normal((4, 16, d)).astype(np.float32),
        "w_router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
        "w_in": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
        "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
        "w_out": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32),
        "grad_a": rng.standard_normal((64, 32)).astype(np.float32),
        "grad_b": (rng.standard_normal((7,)) * 1e-3).astype(np.float32),
    }


def _flatten(tree, prefix: str) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    else:
        out[prefix] = np.asarray(tree, dtype=np.float32)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of the npz entries under ``prefix``."""
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


# ------------------------------------------------------------------ reference
def reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLMData
    from repro.distributed import for_mesh, use_rules
    from repro.models import attention as A
    from repro.models import layers as L
    from repro.models import moe as M
    from repro.models import transformer as T
    from repro.models.config import InputShape, reduced
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.optim.compression import compressed_psum_mean
    from repro.train.steps import make_train_step

    assert jax.device_count() == 4, jax.devices()
    x = inputs()
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    from jax.sharding import Mesh

    rules = for_mesh(Mesh(np.array(jax.devices()).reshape(MESH), ("data", "model")))
    out = {}
    g, o = reduced(get_config("granite-20b")), reduced(get_config("olmoe-1b-7b"))
    with use_rules(rules):
        core = jax.jit(lambda q, k, v: A._q_sharded_core(q, k, v, g, causal=True))
        out["q_sharded"] = np.asarray(core(bf(x["q"]), bf(x["k"]), bf(x["v"])), np.float32)
        dec = jax.jit(lambda *a: A.decode_seq_sharded(*a, g))
        od, ck, cv = dec(bf(x["dq"]), bf(x["cache_k"]), bf(x["cache_v"]), bf(x["k_new"]), bf(x["v_new"]),
                         jnp.int32(DECODE_IDX))
        out["decode_o"], out["decode_k"], out["decode_v"] = (np.asarray(a, np.float32) for a in (od, ck, cv))
        p = {k: jnp.asarray(x[k]) for k in ("w_router", "w_in", "w_gate", "w_out")}
        y, aux = jax.jit(lambda xx, pp: M.moe_block(xx, pp, o))(bf(x["moe_x"]), p)
        out["moe_y"], out["moe_aux"] = np.asarray(y, np.float32), np.asarray(aux, np.float32)
        grads = {"a": jnp.asarray(x["grad_a"]), "b": jnp.asarray(x["grad_b"])}
        comp = jax.jit(lambda gr: compressed_psum_mean(gr, rules, jax.random.PRNGKey(0)))(grads)
        out["comp_a"], out["comp_b"] = np.asarray(comp["a"]), np.asarray(comp["b"])

    # each (dp, tp) shard's kept entries, by the reference's own dispatch steps
    # (repro/models/moe.py:43-67) on that shard's tokens
    e_local = o.moe_experts // MESH[1]
    for dp in range(MESH[0]):
        xl = bf(x["moe_x"])[dp * 2:(dp + 1) * 2]
        t = xl.shape[0] * xl.shape[1]
        logits = jnp.einsum("td,de->te", L.cast(xl.reshape(t, -1)), L.cast(p["w_router"]),
                            preferred_element_type=jnp.float32)
        _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), o.moe_top_k)
        probs = np.sort(np.asarray(jax.nn.softmax(logits, axis=-1)), axis=-1)
        out[f"moe_margin_{dp}"] = np.asarray(probs[:, -o.moe_top_k] - probs[:, -o.moe_top_k - 1])
        for tp in range(MESH[1]):
            ent = top_i.reshape(-1)
            is_local = (ent // e_local) == tp
            local_e = ent % e_local
            cap = max(int(np.ceil(t * o.moe_top_k / o.moe_experts * o.capacity_factor)), 8)
            onehot = (local_e[:, None] == jnp.arange(e_local)[None, :]) & is_local[:, None]
            slot = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
            slot = jnp.take_along_axis(slot, local_e[:, None], axis=1)[:, 0]
            out[f"moe_keep_{dp}_{tp}"] = np.asarray(is_local & (slot < cap))

    for arch in TRAIN_ARCHS:
        cfg = reduced(get_config(arch))
        params = T.init_params(cfg, jax.random.PRNGKey(0))
        out.update(_flatten(jax.tree.map(np.asarray, params), f"train/{arch}/init"))
        data = SyntheticLMData(cfg, InputShape("t", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=0)
        losses = []
        with use_rules(rules):
            step = jax.jit(make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=TRAIN_STEPS)))
            opt = adamw_init(params)
            for s in range(TRAIN_STEPS):
                params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in data.batch(s).items()})
                losses.append(float(m["loss"]))
        out[f"train/{arch}/losses"] = np.asarray(losses)
        out.update(_flatten(jax.tree.map(np.asarray, params), f"train/{arch}/final"))
    np.savez(out_path, **out)


# ------------------------------------------------------------------ port
def _worker(rank: int, ref_path: str, out_path: str, ckpt_dir: str, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # four ranks share the machine's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
    try:
        result = _port_cases(ref_path, ckpt_dir)
        gathered = [None] * 4
        dist.all_gather_object(gathered, result)
        if rank == 0:
            merged = {}
            for r in gathered:
                merged.update(r)
            np.savez(out_path, **merged)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _port_cases(ref_path: str, ckpt_dir: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import distributed as D
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import shardings as SH
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models.config import InputShape
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves, tree_map
    from repro_torch.optim.compression import compressed_psum_mean
    from repro_torch.train.steps import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.weights import from_jax_params

    rank = dist.get_rank()
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    rules = D.for_mesh(mesh)
    x = inputs()
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731

    def place(t, spec):
        return distribute_tensor(t, mesh, D.to_placements(mesh, D.sanitize_spec(rules, D.P(*spec), t.shape), t.ndim))

    full = lambda t: D.full_tensor(t).float().numpy()  # noqa: E731
    out = {}
    g, o = _cfg("granite-20b"), _cfg("olmoe-1b-7b")
    with D.use_rules(rules):
        q, k, v = (place(bf(x[n]), ("data", None, None, None)) for n in ("q", "k", "v"))
        out["q_sharded"] = full(A._q_sharded_core(q, k, v, g, causal=True))
        ck = place(bf(x["cache_k"]), ("data", "model", None, None))
        cv = place(bf(x["cache_v"]), ("data", "model", None, None))
        dq, kn, vn = (place(bf(x[n]), ("data", None, None, None)) for n in ("dq", "k_new", "v_new"))
        od, ck2, cv2 = A.decode_seq_sharded(dq, ck, cv, kn, vn, torch.tensor(DECODE_IDX, dtype=torch.int32), g)
        out["decode_o"], out["decode_k"], out["decode_v"] = full(od), full(ck), full(cv)
        out["decode_in_place"] = np.asarray(ck2 is ck and cv2 is cv)

        keeps = []
        dispatch = M.dispatch

        def recording(*args):
            res = dispatch(*args)
            keeps.append(res[2].numpy())
            return res

        M.dispatch = recording
        try:
            p = {n: torch.from_numpy(x[n]) for n in ("w_router", "w_in", "w_gate", "w_out")}
            specs = {"w_router": (None, None), "w_in": ("model", None, None), "w_gate": ("model", None, None),
                     "w_out": ("model", None, None)}
            p = {n: place(t, specs[n]) for n, t in p.items()}
            y, aux = M.moe_block(place(bf(x["moe_x"]), ("data", None, None)), p, o)
        finally:
            M.dispatch = dispatch
        out["moe_y"], out["moe_aux"] = full(y), full(aux)
        dp_i, tp_i = mesh.get_coordinate()
        out[f"moe_keep_{dp_i}_{tp_i}"] = keeps[0]

        comp = compressed_psum_mean({"a": torch.from_numpy(x["grad_a"]), "b": torch.from_numpy(x["grad_b"])}, rules)
        out["comp_a"], out["comp_b"] = comp["a"].numpy(), comp["b"].numpy()

    ref = dict(np.load(ref_path))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=TRAIN_STEPS)
    shape = InputShape("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    for arch in TRAIN_ARCHS:
        cfg = _cfg(arch)
        data = SyntheticLMData(cfg, shape, seed=0)
        # "fault": one sharded step whose gradients are summed over dp where the
        # mean is meant (psum for pmean), which the per-leaf bars must catch
        for name, run_rules, steps in (("sharded", rules, TRAIN_STEPS), ("single", None, TRAIN_STEPS),
                                       ("fault", rules, 1)):
            params = from_jax_params(unflatten(ref, f"train/{arch}/init"), cfg, "cpu", param_dtype=torch.float32)
            init = [t.numpy().ravel().copy() for t in tree_leaves(params)]
            opt = adamw_init(params)
            if run_rules is not None:
                p_specs = SH.param_specs(cfg, rules, params)
                params = SH.distribute_tree(rules, params, p_specs)
                opt = SH.distribute_tree(rules, opt, SH.opt_specs(p_specs))
            first_grads = []

            def grad_transform(grads, name=name, first_grads=first_grads):
                if name == "fault":
                    grads = tree_map(lambda g: g * rules.dp_size, grads)
                if not first_grads:
                    first_grads.extend(full(g).ravel() for g in tree_leaves(grads))
                return grads

            step = make_train_step(cfg, opt_cfg, grad_transform=grad_transform)
            losses = []
            with D.use_rules(run_rules):
                for s in range(steps):
                    batch = {k: torch.from_numpy(v).long() for k, v in data.batch(s).items()}
                    if run_rules is not None:
                        batch = SH.distribute_tree(rules, batch, SH.batch_specs(cfg, rules, batch))
                    params, opt, m = step(params, opt, batch)
                    losses.append(float(D.full_tensor(m["loss"])))
            final = [full(t).ravel() for t in tree_leaves(params)]
            out[f"train/{arch}/{name}/losses"] = np.asarray(losses)
            out[f"train/{arch}/{name}/params"] = np.concatenate(final)
            # per leaf, in tree order: the first step's gradients and the change over the steps
            out[f"train/{arch}/{name}/grads"] = np.concatenate(first_grads)
            out[f"train/{arch}/{name}/delta"] = np.concatenate([f - i for f, i in zip(final, init)])
            out[f"train/{arch}/sizes"] = np.asarray([len(i) for i in init])

    # the Trainer on the (2, 2) mesh with a checkpoint, restored onto (4, 1) and onto one device
    cfg = _cfg("mamba2-780m")
    tcfg = TrainerConfig(steps=2, checkpoint_every=2, checkpoint_dir=ckpt_dir, seed=0, log_every=10)
    trainer = Trainer(cfg, shape, rules, tcfg, opt_cfg, device="cpu")
    trainer.run()
    saved = [full(t) for t in tree_leaves(trainer.params)]
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    for name, other in (("mesh41", D.for_mesh(mesh41)), ("single", None)):
        t2 = Trainer(cfg, shape, other, tcfg, opt_cfg, device="cpu")
        with D.use_rules(other):
            params, opt = t2._init_state()
            params, opt, step_no = t2._restore(params, opt)
        got = [full(t) for t in tree_leaves(params)]
        out[f"restore/{name}/bitwise"] = np.asarray(
            step_no == 2 and all(a.shape == b.shape and np.array_equal(a, b) for a, b in zip(got, saved)))
        if other is not None:
            out[f"restore/{name}/placements"] = np.asarray(str(tree_leaves(params)[0].placements))
    out["restore/steps"] = np.asarray(CheckpointManager(ckpt_dir).all_steps())
    return out if rank == 0 else {k: v for k, v in out.items() if k.startswith("moe_keep")}


def port(ref_path: str, out_path: str, ckpt_dir: str) -> None:
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        free = s.getsockname()[1]
    mp.spawn(_worker, args=(ref_path, out_path, ckpt_dir, free), nprocs=4, join=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    if sys.argv[1] == "reference":
        reference(sys.argv[2])
    else:
        port(sys.argv[2], sys.argv[3], sys.argv[4])
