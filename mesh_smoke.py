#!/usr/bin/env python3
"""Drive the PyTorch port's sharded paths on four NVIDIA GPUs of one host (the H100s) over NCCL.

  python3 mesh_smoke.py                # four cards: parts (a)-(e)
  python3 mesh_smoke.py --device cpu   # part (a) at reduced sizes, four gloo ranks on the CPU

Four ranks (``torch.multiprocessing.spawn``; each calls
``torch.cuda.set_device(rank)`` before ``init_process_group("nccl")``) build a
(2, 2) ("data", "model") ``DeviceMesh`` and call the port's library entry
points under ``distributed.use_rules``.  The parent builds the three kernel
libraries first (one nvcc per source, all started together) and, while the
ranks run, traces part (e)'s two cells on a fake (2, 2) world.  Rank 0 prints
one JSON line per item:

(a) parity on the cards: each sharded path against the same path on rank
    0's one card, on the same seeded inputs, with the bars of
    ``tests/test_torch_sharded.py``: ``_q_sharded_core`` and
    ``decode_seq_sharded`` on reduced granite-20b (rel L2 2e-2, the caches
    bitwise); the MoE block on reduced olmoe-1b-7b (kept entries equal on
    every shard, y 2e-2, aux 1e-6); ``compressed_psum_mean`` (exact); three
    training steps of mamba2-780m and qwen2-1.5b at full width and 4 layers
    with fsdp (losses and parameters 2e-2, the first step's gradients 5e-2
    leaf by leaf, the parameters' change 0.2; the scan kernels and their
    gradient run on 24 of mamba2's 48 heads a rank); qwen2-1.5b's cached
    prefill at full width and 4 layers on the flash route (6 of 12 heads a
    rank; logits 2e-2).  Every flash, scan and scan-backward call on a shard
    is held against its plain version on the same inputs, and the launches
    are counted per rank;
(b) the ``Trainer`` on reduced olmoe-1b-7b over (2, 2) with fsdp: a run that
    fails at step 3 and resumes from its checkpoint of step 2 equals an
    uninterrupted run (losses and parameters bitwise), whose checkpoint
    restores onto a (4, 1) mesh and onto one card bitwise;
(c) olmoe-1b-7b training at full width and depth (16 layers, 64 experts,
    top-8; 6.92 B parameters, fp32 masters and AdamW: 110.7 GB, more than a
    card), sequence 4,096, global batch 4, remat "full", fsdp, the chunked
    attention route: 6 steps through ``distribute_train_state`` +
    ``make_train_step`` + ``distribute_tree`` of ``SyntheticLMData``
    batches; losses, step ms (median of steps 2-6 by CUDA events after a
    barrier), tokens/s, every rank's peak, rank 0's device-busy ms and idle
    share, and NCCL kernel ms per step by kind (torch.profiler);
(d) granite-20b ``decode_32k`` at full width and depth: batch 128 over a
    32,768-slot MQA cache (111.7 GB, built shard by shard on each rank from
    a seeded generator) at ``len`` 32,760, bf16 weights with fsdp; 8 eager
    decode steps through ``transformer.forward`` under the rules; tokens in
    the vocabulary, logits finite, ``len`` advanced on every rank, ms per
    step, per-rank peaks, NCCL ms by kind;
(e) the dry run (``launch.dryrun.trace_cell``) of (c) and (d) on a fake
    (2, 2) world at the same batch, sequence and knobs, beside the
    measurements: per-rank peak (bar 15 %), collective bytes and counts by
    kind against the NCCL kernels seen, the link term at
    ``H100_HW.ici_bw`` against the NCCL ms, and the achieved bandwidth.

Ends with ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4}}``.
Without four cards (or without ``src/repro_torch`` beside this script) it
exits non-zero and prints no result; a failed check or a crashed rank exits
non-zero after the ranks are stopped.  The port's kernels, checks and
timing helpers come from ``chip_smoke.py`` beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as CS

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

WORLD, MESH, AXES = 4, (2, 2), ("data", "model")
SEED = 0
SECONDS = 1100  # the ranks' deadline: the whole run should end within 1,200 s
# the bars of tests/test_torch_sharded.py
BF16_REL_L2 = 2e-2
AUX_TOL = 1e-6
TRAIN_TOL = 2e-2
GRAD_LEAF_TOL = 5e-2
DELTA_TOL = 0.2
TRAIN_STEPS = 3
# AdamW's rate at full width, no warm-up ((a) and (c)): at 1e-3, the reduced configs' rate, qwen2-1.5b
# and olmoe-1b-7b at full width diverge within three steps (their losses rise; on one card alike)
FULL_WIDTH_LR = 1e-4
DECODE_IDX = 37  # in the second tp rank's half of the 64-position reduced cache
# (a) sizes: (width, layers, train batch x seq, prefill batch x prompt, AdamW's rate) per device
A_SIZES = {"cuda": ("full", 4, (4, 1024), (4, 512), FULL_WIDTH_LR), "cpu": ("reduced", None, (4, 64), (4, 24), 1e-3)}
# (b) reduced olmoe's run: steps, checkpoint period, the step that fails
B_STEPS, B_EVERY, B_FAIL_AT, B_SHAPE = 6, 2, 3, (4, 64)
# (c) olmoe-1b-7b: global batch, sequence, steps
C_BATCH, C_SEQ, C_STEPS = 4, 4096, 6
# (d) granite-20b decode_32k: batch, cache slots, the cache's length, steps
D_BATCH, D_SLOTS, D_LEN, D_STEPS = 128, 32768, 32760, 8
PEAK_TOL = 0.15  # (e): the dry run's predicted peak against the measured, as phase 9's grounding cell
# (e): each collective kind timed alone at these output sizes (bytes), LINK_CALLS calls each
LINK_SIZES, LINK_CALLS = (2**18, 2**20, 2**23, 2**26, 2**28), 20
NCCL_KINDS = (("AllGather", "all-gather"), ("ReduceScatter", "reduce-scatter"), ("AllReduce", "all-reduce"),
              ("SendRecv", "all-to-all"), ("Broadcast", "collective-permute"))


@dataclasses.dataclass
class Rank:
    """One rank's world: its index, device, (2, 2) mesh, and rank 0's record."""

    rank: int
    dev: object
    mesh: object
    cuda: bool
    work: Path
    lines: list = dataclasses.field(default_factory=list)
    failures: list = dataclasses.field(default_factory=list)

    def emit(self, key: str, payload: dict) -> None:
        """Rank 0 prints ``{key: payload}`` as a JSON line and keeps it."""
        if self.rank == 0:
            print(json.dumps({key: payload}), flush=True)
            self.lines.append({key: payload})

    def check(self, name: str, ok: bool, detail) -> None:
        """Record a bar (read on rank 0): a miss fails the run at its end."""
        if not ok:
            self.failures.append(f"{name}: {detail}")
            if self.rank == 0:
                print(f"mesh_smoke: FAIL {name}: {detail}", flush=True)


def rel_l2(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def gather(obj) -> list:
    """``obj`` of every rank, in rank order, on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def full_host(t):
    """A DTensor's full value (collective: every rank calls it) or a tensor, as fp32 on the host."""
    from repro_torch import distributed as D

    return D.full_tensor(t).detach().float().cpu()


def leaves_host(tree, keep: bool) -> list:
    """Every leaf of ``tree`` gathered in turn; rank ``keep`` holds them on the host, the others none."""
    from repro_torch.optim.adamw import tree_leaves

    out = []
    for t in tree_leaves(tree):
        v = full_host(t)
        if keep:
            out.append(v.ravel())
    return out


def place(rules, t, spec):
    """``t`` (the same on every rank) on the rules' mesh by ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import distributed as D

    spec = D.sanitize_spec(rules, D.P(*spec), t.shape)
    return distribute_tensor(t, rules.mesh, D.to_placements(rules.mesh, spec, t.ndim))


def kernel_counts() -> dict:
    from repro_torch.kernels import ops

    return {name: getattr(ops, name).launches for name in CS.TRAIN_KERNELS}


def zero_kernel_counts() -> None:
    from repro_torch.kernels import ops

    for name in CS.TRAIN_KERNELS:
        getattr(ops, name).launches = 0


@contextlib.contextmanager
def scans_checked(fwd: list, bwd: list):
    """Hold every SSD-scan call of the model (forward and backward kernels)
    against its plain version on the same inputs: y and the final state
    within ``SSD_BF16_TOL``, each gradient within ``SSD_BWD_TOL``."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm

    chunked, kernel_bwd = ssm.ssd_chunked, ops.ssd_scan_bwd

    def checked_fwd(x, la, bm, cm, chunk, state0=None):
        y, st = chunked(x, la, bm, cm, chunk, state0)
        with torch.no_grad():
            d = [t if t is None else t.detach() for t in (x, la, bm, cm, state0)]
            yr, sr = ref.ssd_scan_ref(*d[:4], chunk=chunk, state0=d[4])
            ok = (torch.allclose(y.detach().float(), yr.float(), **CS.SSD_BF16_TOL)
                  and torch.allclose(st.detach(), sr, **CS.SSD_BF16_TOL))
            fwd.append(((y.detach().float() - yr.float()).abs().max().item(), ok, tuple(x.shape),
                        yr.float().abs().max().item()))
        return y, st

    def checked_bwd(x, la, bm, cm, dy, dstate, *, chunk=128, state0=None):
        got = kernel_bwd(x, la, bm, cm, dy, dstate, chunk=chunk, state0=state0)
        zero = torch.zeros(got[4].shape, dtype=torch.float32, device=x.device)
        want = ref.ssd_scan_bwd_ref(x, la, bm, cm, dy, zero if dstate is None else dstate, chunk=chunk,
                                    state0=state0)
        atol_frac, rtol = CS.SSD_BWD_TOL[str(x.dtype).removeprefix("torch.")]
        results = [CS._within(g, w, atol_frac, rtol) for g, w in zip(got, want)]
        bwd.append((max(e for _, e in results), all(ok for ok, _ in results), tuple(x.shape),
                    max(w.float().abs().max().item() for w in want)))
        return got

    # the kernel counts its launches on the module's name, this wrapper while it stands there
    checked_bwd.launches = kernel_bwd.launches
    ssm.ssd_chunked, ops.ssd_scan_bwd = checked_fwd, checked_bwd
    try:
        yield
    finally:
        kernel_bwd.launches = checked_bwd.launches
        ssm.ssd_chunked, ops.ssd_scan_bwd = chunked, kernel_bwd


def calls_summary(records: list) -> dict:
    """Kernel calls held against their plain versions, each (max abs error, within the bar,
    input shape, max |plain output| or None)."""
    scales = [r[3] for r in records if r[3] is not None]
    return {"calls": len(records), "max_abs_err": max((r[0] for r in records), default=0.0),
            "ok": sum(bool(r[1]) for r in records), "max_abs_plain": max(scales, default=None),
            "failed": [{"err": r[0], "max_abs_plain": r[3]} for r in records if not r[1]],
            "shapes": sorted({str(r[2]) for r in records})}


def flash_calls(errors: list) -> dict:
    """``calls_summary`` of ``chip_smoke.flashes_checked``'s records (error, q shape, k shape, ok)."""
    return calls_summary([(e[0], e[3], e[1], None) for e in errors])


# ------------------------------------------------------------------ (a) parity
def a_cores(r: Rank) -> None:
    """``_q_sharded_core`` and ``decode_seq_sharded`` on reduced granite-20b (4
    heads, 1 kv head: "q_sharded" at tp 2) against the one-card paths:
    ``_plain_core``, and the cache write plus ``full_attention`` of one query."""
    import numpy as np
    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.config import reduced

    g = reduced(get_config("granite-20b"))
    rng = np.random.default_rng(SEED)
    hd = g.head_dim
    x = {n: rng.standard_normal(s).astype(np.float32) for n, s in (
        ("q", (2, 64, 4, hd)), ("k", (2, 64, 1, hd)), ("v", (2, 64, 1, hd)), ("dq", (2, 1, 4, hd)),
        ("cache_k", (2, 64, 1, hd)), ("cache_v", (2, 64, 1, hd)), ("k_new", (2, 1, 1, hd)),
        ("v_new", (2, 1, 1, hd)))}
    x["cache_k"][:, DECODE_IDX:] = 0
    x["cache_v"][:, DECODE_IDX:] = 0
    bf = {n: torch.from_numpy(a).to(r.dev, torch.bfloat16) for n, a in x.items()}
    idx = torch.tensor(DECODE_IDX, dtype=torch.int32, device=r.dev)
    rules = D.for_mesh(r.mesh)
    with D.use_rules(rules):
        q, k, v = (place(rules, bf[n], ("data", None, None, None)) for n in ("q", "k", "v"))
        o = full_host(A._q_sharded_core(q, k, v, g, causal=True))
        ck, cv = (place(rules, bf[n].clone(), ("data", "model", None, None)) for n in ("cache_k", "cache_v"))
        dq, kn, vn = (place(rules, bf[n], ("data", None, None, None)) for n in ("dq", "k_new", "v_new"))
        od, ck2, cv2 = A.decode_seq_sharded(dq, ck, cv, kn, vn, idx, g)
        in_place = ck2 is ck and cv2 is cv
        od, ckf, cvf = full_host(od), full_host(ck), full_host(cv)
    if r.rank == 0:
        o1 = A.attention_core(bf["q"], bf["k"], bf["v"], g, causal=True).float().cpu()
        ck1, cv1 = bf["cache_k"].clone(), bf["cache_v"].clone()
        ck1[:, DECODE_IDX] = bf["k_new"][:, 0]
        cv1[:, DECODE_IDX] = bf["v_new"][:, 0]
        od1 = A.full_attention(bf["dq"], ck1, cv1, causal=True, q_offset=idx).float().cpu()
        line = {"item": "cores", "arch": "granite-20b (reduced)", "q_sharded_rel_l2": rel_l2(o, o1),
                "decode_rel_l2": rel_l2(od, od1), "caches_bitwise": bool(torch.equal(ckf, ck1.float().cpu())
                                                                         and torch.equal(cvf, cv1.float().cpu())),
                "decode_in_place": in_place, "bar": BF16_REL_L2}
        r.check("q_sharded_core", line["q_sharded_rel_l2"] <= BF16_REL_L2, line)
        r.check("decode_seq_sharded", line["decode_rel_l2"] <= BF16_REL_L2 and line["caches_bitwise"]
                and in_place, line)
        r.emit("a", line)
    barrier()


def a_moe(r: Rank) -> None:
    """The MoE block on reduced olmoe-1b-7b (8 experts: 4 a tp rank) against
    ``local_moe`` with every expert on one card, per data shard: each (dp, tp)
    shard's kept entries, y and aux."""
    import numpy as np
    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models.config import reduced

    o = reduced(get_config("olmoe-1b-7b"))
    rng = np.random.default_rng(SEED + 1)
    d, e, f = o.d_model, o.moe_experts, o.d_ff
    x = torch.from_numpy(rng.standard_normal((4, 16, d)).astype(np.float32)).to(r.dev, torch.bfloat16)
    p = {n: torch.from_numpy(a.astype(np.float32)).to(r.dev) for n, a in (
        ("w_router", rng.standard_normal((d, e)) / np.sqrt(d)),
        ("w_in", rng.standard_normal((e, d, f)) / np.sqrt(d)),
        ("w_gate", rng.standard_normal((e, d, f)) / np.sqrt(d)),
        ("w_out", rng.standard_normal((e, f, d)) / np.sqrt(f)))}
    specs = {"w_router": (None, None), "w_in": ("model", None, None), "w_gate": ("model", None, None),
             "w_out": ("model", None, None)}
    rules = D.for_mesh(r.mesh)
    keeps, dispatch = [], M.dispatch

    def recording(*args):
        res = dispatch(*args)
        keeps.append(res[2].cpu().numpy())
        return res

    M.dispatch = recording
    try:
        with D.use_rules(rules):
            y, aux = M.moe_block(place(rules, x, ("data", None, None)),
                                 {n: place(rules, t, specs[n]) for n, t in p.items()}, o)
            y, aux = full_host(y), full_host(aux)
    finally:
        M.dispatch = dispatch
    shards = gather((tuple(r.mesh.get_coordinate()), keeps[0]))
    if r.rank == 0:
        e_local, half = e // MESH[1], x.shape[0] // MESH[0]
        ys, kept_equal, margins = [], [], []
        for dp in range(MESH[0]):
            xl = x[dp * half:(dp + 1) * half]
            y1, aux1 = M.local_moe(xl, p["w_router"], p["w_in"], p["w_gate"], p["w_out"], o)
            ys.append(y1)
            if dp == 0:
                aux0 = aux1
            xf = xl.reshape(-1, d)
            probs = torch.softmax(L.matmul_f32(xf, p["w_router"]), dim=-1)
            top = torch.sort(probs, dim=-1).values
            margins.append((top[:, -o.moe_top_k] - top[:, -o.moe_top_k - 1]).min().item())
            _, top_i, _ = M.route(xf, p["w_router"], o.moe_top_k)
            cap = M.capacity(xf.shape[0], o.moe_top_k, e, o.capacity_factor)
            for tp in range(MESH[1]):
                want = dispatch(xf, top_i, e_local, cap, tp, e)[2].cpu().numpy()
                got = next(k for c, k in shards if c == (dp, tp))
                kept_equal.append(bool(np.array_equal(got, want)))
        kept = sum(int(k.sum()) for _, k in shards)
        line = {"item": "moe", "arch": "olmoe-1b-7b (reduced)", "kept_equal_per_shard": kept_equal,
                "kept_entries": kept, "entries": 4 * 16 * o.moe_top_k, "min_topk_margin": min(margins),
                "y_rel_l2": rel_l2(y, torch.cat(ys).float().cpu()), "aux_abs_err": abs(aux.item() - aux0.item()),
                "bars": {"y": BF16_REL_L2, "aux": AUX_TOL}}
        r.check("moe", all(kept_equal) and 0 < kept and line["y_rel_l2"] <= BF16_REL_L2
                and line["aux_abs_err"] <= AUX_TOL, line)
        r.emit("a", line)
    barrier()


def a_compression(r: Rank) -> None:
    """``compressed_psum_mean`` over dp, each data rank's own gradients,
    against the same quantisation on one card: exact."""
    import numpy as np
    import torch

    from repro_torch import distributed as D
    from repro_torch.optim.compression import compressed_psum_mean

    def grads(dp):
        rng = np.random.default_rng((SEED, dp))
        return {"a": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)).to(r.dev),
                "b": torch.from_numpy((rng.standard_normal(7) * 1e-3).astype(np.float32)).to(r.dev)}

    dp = r.mesh.get_coordinate()[0]
    out = compressed_psum_mean(grads(dp), D.for_mesh(r.mesh))
    if r.rank == 0:
        each = [grads(i) for i in range(MESH[0])]
        exact = True
        for k in ("a", "b"):
            scale = torch.stack([g[k].abs().max() + 1e-12 for g in each]).max() / 127.0
            total = sum(torch.clamp(torch.round(g[k] / scale), -127, 127).to(torch.int8).to(torch.int32)
                        for g in each)
            exact = exact and torch.equal(out[k], (total.float() / MESH[0]) * scale)
        line = {"item": "compressed_psum_mean", "dp": MESH[0], "exact": bool(exact)}
        r.check("compressed_psum_mean", exact, line)
        r.emit("a", line)
    barrier()


def a_config(r: Rank, arch: str, **repl):
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    width, layers = A_SIZES["cuda" if r.cuda else "cpu"][:2]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers) if width == "full" else reduced(cfg)
    return dataclasses.replace(cfg, **repl)


def train_run(r: Rank, cfg, rules, batch: int, seq: int, steps: int, fwd: list, bwd: list):
    """``steps`` steps of ``make_train_step`` from seeded fp32 masters, sharded
    by ``rules`` (None: this card alone); returns (losses, first gradients,
    final parameters, launches), the leaves on rank 0's host."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.config import InputShape
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    def make_params():
        return T.init_params(cfg, torch.Generator(device=r.dev).manual_seed(SEED), r.dev,
                             param_dtype=torch.float32)

    if rules is None:
        params = make_params()
        opt = adamw_init(params)
    else:
        params, opt = SH.distribute_train_state(cfg, rules, make_params)
    keep = r.rank == 0
    first_grads: list = []

    def grad_transform(grads):
        if not first_grads:
            first_grads.append(leaves_host(grads, keep))
        return grads

    data = SyntheticLMData(cfg, InputShape("train", seq, batch, "train"), seed=SEED)
    lr = A_SIZES["cuda" if r.cuda else "cpu"][4]
    step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=0, total_steps=steps),
                           grad_transform=grad_transform)
    losses = []
    zero_kernel_counts()
    with scans_checked(fwd, bwd), D.use_rules(rules):
        for s in range(steps):
            b = {k: torch.from_numpy(v).long().to(r.dev) for k, v in data.batch(s).items()}
            if rules is not None:
                b = SH.distribute_tree(rules, b, SH.batch_specs(cfg, rules, b))
            params, opt, m = step(params, opt, b)
            losses.append(float(D.full_tensor(m["loss"])))
    counts = kernel_counts()
    final = leaves_host(params, keep)
    return losses, first_grads[0], final, counts


def a_train(r: Rank, arch: str) -> None:
    """Three sharded steps (fsdp, (2, 2)) against the same steps on rank 0's card."""
    import numpy as np
    import torch

    from repro_torch import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves

    cfg = a_config(r, arch)
    batch, seq = A_SIZES["cuda" if r.cuda else "cpu"][2]
    rules = D.for_mesh(r.mesh, fsdp=True)
    fwd, bwd = [], []
    losses, grads, final, counts = train_run(r, cfg, rules, batch, seq, TRAIN_STEPS, fwd, bwd)
    per_rank = gather({"launches": counts, "fwd": calls_summary(fwd), "bwd": calls_summary(bwd),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if r.cuda else None})
    if r.rank == 0:
        if r.cuda:
            torch.cuda.empty_cache()  # the sharded run's blocks, before the one-card run
        fwd1, bwd1 = [], []
        losses1, grads1, final1, counts1 = train_run(r, cfg, None, batch, seq, TRAIN_STEPS, fwd1, bwd1)
        init = [t.float().cpu().ravel() for t in tree_leaves(T.init_params(
            cfg, torch.Generator(device=r.dev).manual_seed(SEED), r.dev, param_dtype=torch.float32))]
        leaf_rels = [rel_l2(g, w) for g, w in zip(grads, grads1)]
        param_rels = [rel_l2(g, w) for g, w in zip(final, final1)]
        cat = lambda ts: torch.cat(ts).numpy()  # noqa: E731
        delta = rel_l2(cat(final) - cat(init), cat(final1) - cat(init))
        ssm_layers = cfg.n_layers if cfg.family == "ssm" else 0
        per_call = (2 if cfg.remat != "none" else 1) * ssm_layers * TRAIN_STEPS  # remat recomputes the scan
        want = ({"flash_attention": 0, "ssd_scan": per_call, "ssd_scan_bwd": ssm_layers * TRAIN_STEPS}
                if r.cuda else dict.fromkeys(CS.TRAIN_KERNELS, 0))
        line = {"item": "train", "arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
                "batch": batch, "seq": seq, "steps": TRAIN_STEPS, "fsdp": True,
                "heads_per_rank": (cfg.ssm_heads if cfg.ssm_state else cfg.n_heads) // MESH[1],
                "losses": losses, "losses_one_card": losses1, "loss_rel_l2": rel_l2(losses, losses1),
                "params_rel_l2": rel_l2(cat(final), cat(final1)), "max_param_leaf_rel_l2": max(param_rels),
                "delta_rel_l2": delta, "grad_leaves": len(leaf_rels), "max_grad_leaf_rel_l2": max(leaf_rels),
                "grad_norms_positive": all(float(w.norm()) > 0 for w in grads1),
                "launches_per_rank": [p["launches"] for p in per_rank], "launches_want": want,
                "launches_one_card": counts1,
                "scan_calls_per_rank": [{"fwd": p["fwd"], "bwd": p["bwd"]} for p in per_rank],
                "scan_calls_one_card": {"fwd": calls_summary(fwd1), "bwd": calls_summary(bwd1)},
                "peak_gib_per_rank": [p["peak_gib"] for p in per_rank],
                "bars": {"losses_params": TRAIN_TOL, "grad_leaf": GRAD_LEAF_TOL, "delta": DELTA_TOL}}
        calls_ok = all(p[k]["ok"] == p[k]["calls"] for p in per_rank for k in ("fwd", "bwd"))
        r.check(f"train {arch}", bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0]
                and line["loss_rel_l2"] <= TRAIN_TOL and line["params_rel_l2"] <= TRAIN_TOL
                and line["max_grad_leaf_rel_l2"] <= GRAD_LEAF_TOL and delta <= DELTA_TOL
                and line["grad_norms_positive"] and calls_ok
                and all(p["launches"] == want for p in per_rank), line)
        r.emit("a", line)
    barrier()


def a_prefill(r: Rank) -> None:
    """qwen2-1.5b's cached prefill on the flash route, its 12 heads over tp (6
    a rank, 1 kv head), against the same prefill on one card."""
    import numpy as np
    import torch

    from repro_torch import distributed as D
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import init_cache

    cfg = a_config(r, "qwen2-1.5b", attention_impl="flash_pallas")
    batch, prompt = A_SIZES["cuda" if r.cuda else "cpu"][3]
    params = T.init_params(cfg, torch.Generator(device=r.dev).manual_seed(SEED), r.dev)
    rng = np.random.default_rng((SEED, 2))
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (batch, prompt))).to(r.dev)
    rules = D.for_mesh(r.mesh, fsdp=True)
    cache = init_cache(cfg, batch, prompt, r.dev)
    sharded = {"params": SH.distribute_tree(rules, params, SH.param_specs(cfg, rules, params)),
               "cache": SH.distribute_tree(rules, cache, SH.cache_specs(cfg, rules, cache)),
               "batch": SH.distribute_tree(rules, {"tokens": tokens},
                                           SH.batch_specs(cfg, rules, {"tokens": tokens}))}
    errors: list = []
    zero_kernel_counts()
    with CS.flashes_checked(errors), D.use_rules(rules):
        logits, _, _ = T.forward(sharded["params"], cfg, sharded["batch"], sharded["cache"])
    counts = kernel_counts()
    logits = full_host(logits)
    per_rank = gather({"launches": counts, "flash": flash_calls(errors)})
    if r.rank == 0:
        errors1: list = []
        zero_kernel_counts()
        with CS.flashes_checked(errors1):
            logits1, _, _ = T.forward(params, cfg, {"tokens": tokens}, init_cache(cfg, batch, prompt, r.dev))
        counts1 = kernel_counts()
        want = {"flash_attention": cfg.n_layers if r.cuda else 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
        line = {"item": "prefill", "arch": "qwen2-1.5b", "attention_impl": "flash_pallas",
                "layers": cfg.n_layers, "batch": batch, "prompt": prompt, "heads_per_rank": cfg.n_heads // MESH[1],
                "kv_heads_per_rank": cfg.n_kv_heads // MESH[1], "fsdp": True,
                "logits_rel_l2": rel_l2(logits, logits1.float().cpu()), "finite": bool(logits.isfinite().all()),
                "launches_per_rank": [p["launches"] for p in per_rank], "launches_want": want,
                "launches_one_card": counts1, "flash_calls_per_rank": [p["flash"] for p in per_rank],
                "flash_calls_one_card": flash_calls(errors1),
                "bar": BF16_REL_L2, "flash_bar": CS.BF16_TOL}
        r.check("prefill qwen2-1.5b", line["logits_rel_l2"] <= BF16_REL_L2 and line["finite"]
                and all(p["launches"] == want for p in per_rank) and counts1 == want
                and all(p["flash"]["ok"] == p["flash"]["calls"] for p in per_rank), line)
        r.emit("a", line)
    barrier()


def part_a(r: Rank) -> None:
    for fn in (a_cores, a_moe, a_compression):
        fn(r)
    for arch in ("mamba2-780m", "qwen2-1.5b"):
        a_train(r, arch)
    a_prefill(r)


# ------------------------------------------------------------------ (b) restart and elastic restore
def part_b(r: Rank) -> None:
    """The ``Trainer`` on reduced olmoe over (2, 2) with fsdp: a run failing at
    step ``B_FAIL_AT`` resumes and equals an uninterrupted run bitwise; the
    latter's checkpoint restores onto (4, 1) and onto one card bitwise."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import distributed as D
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.config import InputShape, reduced
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = reduced(get_config("olmoe-1b-7b"))
    shape = InputShape("train", B_SHAPE[1], B_SHAPE[0], "train")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=B_STEPS)
    rules = D.for_mesh(r.mesh, fsdp=True)
    resume_dir, straight_dir = str(r.work / "b_resume"), str(r.work / "b_straight")

    def trainer(directory, rules, hook=None):
        tcfg = TrainerConfig(steps=B_STEPS, checkpoint_every=B_EVERY, checkpoint_dir=directory, keep=1,
                             seed=SEED, log_every=B_STEPS)
        return Trainer(cfg, shape, rules, tcfg, opt_cfg, failure_hook=hook, device=r.dev)

    def fail(step):
        if step == B_FAIL_AT:
            raise CS.InjectedFailure(f"injected failure at step {step}")

    first = trainer(resume_dir, rules, fail)
    try:
        first.run()
    except CS.InjectedFailure:
        pass
    else:
        raise AssertionError("the injected failure did not stop the run")
    latest = CheckpointManager(resume_dir).latest_step()
    resumed = trainer(resume_dir, rules)
    resumed.run()
    straight = trainer(straight_dir, rules)
    straight.run()
    keep = r.rank == 0
    want = leaves_host(straight.params, keep)
    got_resumed = leaves_host(resumed.params, keep)
    mesh41 = init_device_mesh(r.mesh.device_type, (WORLD, 1), mesh_dim_names=AXES)
    on41 = trainer(straight_dir, D.for_mesh(mesh41, fsdp=True))
    on41.run()  # restores the last step: nothing left to train
    placements = str(tree_leaves(on41.params)[0].placements)
    got41 = leaves_host(on41.params, keep)
    if r.rank == 0:
        one = trainer(straight_dir, None)
        one.run()
        got1 = [t.float().cpu().ravel() for t in tree_leaves(one.params)]
        losses = [h["loss"] for h in straight.history]
        first_losses, resumed_losses = ([h["loss"] for h in t.history] for t in (first, resumed))
        bitwise = lambda a, b: len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))  # noqa: E731
        line = {"item": "restart", "arch": "olmoe-1b-7b (reduced)", "mesh": list(MESH), "fsdp": True,
                "steps": B_STEPS, "failed_at": B_FAIL_AT, "restored_step": latest, "losses": losses,
                "interrupted_losses": first_losses, "resumed_losses": resumed_losses,
                "losses_bitwise": first_losses == losses[:B_FAIL_AT] and resumed_losses == losses[latest:],
                "params_bitwise": bitwise(got_resumed, want),
                "restore_4x1_bitwise": bitwise(got41, want), "restore_4x1_placements": placements,
                "restore_one_card_bitwise": bitwise(got1, want),
                "restored_steps": [len(on41.history), len(one.history)]}
        r.check("restart", latest == B_FAIL_AT - B_FAIL_AT % B_EVERY and line["losses_bitwise"]
                and line["params_bitwise"] and line["restore_4x1_bitwise"] and line["restore_one_card_bitwise"]
                and line["restored_steps"] == [0, 0], line)
        r.emit("b", line)
    barrier()


# ------------------------------------------------------------------ profiling on every rank
def _union_ms(spans) -> float:
    """Milliseconds covered by the union of (start, end) microsecond intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def profile_step(step, sessions: int = 2, retries: int = 3) -> dict:
    """Device time of one call of ``step`` on this rank, by torch.profiler.

    Every rank runs the same sessions (the step's collectives need them
    all), each a warm-up call and one profiled call, timed by CUDA events
    (``wall_ms``); a session that comes back without kernel records is
    followed by more, decided together.  Of the sessions with the most
    kernels, the one with the median busy time is kept: ``busy_ms`` (the
    union of the kernels' intervals), ``compute_busy_ms`` (the same without
    NCCL's kernels, which run on their own stream beside compute), the idle
    shares of both against ``wall_ms``, NCCL's kernel ms and counts by
    kind, and the ten kernels of most device time (``top``: name, ms,
    count).  An NCCL kernel runs from its launch until its peers' data has
    arrived, so its time includes the wait for the slowest rank.
    """
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda_type = torch.autograd.DeviceType.CUDA
    runs = []
    while True:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for i in range(2):
                barrier()
                if i:
                    a.record()
                step()
                if i:
                    b.record()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in prof.events() if e.device_type == cuda_type
                   and not getattr(e, "is_user_annotation", False) and not e.name.startswith("ProfilerStep")]
        is_nccl = [e.name.lower().startswith("nccl") for e in kernels]
        nccl = {kind: {"ms": 0.0, "count": 0} for _, kind in NCCL_KINDS}
        for e, yes in zip(kernels, is_nccl):
            if yes:
                kind = next((k for pat, k in NCCL_KINDS if pat.lower() in e.name.lower()), "other")
                slot = nccl.setdefault(kind, {"ms": 0.0, "count": 0})
                slot["ms"] += (e.time_range.end - e.time_range.start) / 1e3
                slot["count"] += 1
        spans = [(e.time_range.start, e.time_range.end) for e in kernels]
        by_name: dict = {}
        for e, (start, end) in zip(kernels, spans):
            ms_count = by_name.setdefault(e.name[:80], [0.0, 0])
            ms_count[0] += (end - start) / 1e3
            ms_count[1] += 1
        runs.append({"kernels": len(kernels), "wall_ms": a.elapsed_time(b), "busy_ms": _union_ms(spans),
                     "compute_busy_ms": _union_ms(s for s, yes in zip(spans, is_nccl) if not yes),
                     "nccl": nccl, "top": sorted(([k, *v] for k, v in by_name.items()), key=lambda t: -t[1])[:10]})
        done = torch.tensor([int(len(runs) >= sessions and any(x["kernels"] for x in runs)
                                 or len(runs) >= sessions + retries)], device="cuda")
        dist.all_reduce(done, op=dist.ReduceOp.MIN)
        if done.item():
            break
    most = max(x["kernels"] for x in runs)
    full = sorted((x for x in runs if x["kernels"] == most), key=lambda x: x["busy_ms"])
    kept = dict(full[len(full) // 2])
    if most:
        kept["idle_share"] = CS.idle_share(kept["busy_ms"], kept["wall_ms"])
        kept["compute_idle_share"] = CS.idle_share(kept["compute_busy_ms"], kept["wall_ms"])
    else:  # not measured: never read zero
        kept.update(busy_ms=None, compute_busy_ms=None, idle_share=None, compute_idle_share=None)
    kept["sessions_kernels"] = [x["kernels"] for x in runs]
    kept["sessions_busy_ms"] = [x["busy_ms"] for x in runs]
    return kept


def timed_steps(step, n: int) -> list:
    """CUDA-event ms of ``n`` calls of ``step``, each after a barrier."""
    import torch

    out = []
    for _ in range(n):
        barrier()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


# ------------------------------------------------------------------ (c) olmoe-1b-7b training
def part_c(r: Rank, smi: str) -> None:
    """olmoe-1b-7b at full width and depth, 6 steps on (2, 2) with fsdp, as the
    ``Trainer``'s sharded init and batches place them (no checkpoint: a full
    one is 110.7 GB)."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.config import InputShape
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step

    cfg = get_config("olmoe-1b-7b")
    rules = D.for_mesh(r.mesh, fsdp=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=r.dev).manual_seed(SEED)
    params, opt = SH.distribute_train_state(
        cfg, rules, lambda: T.init_params(cfg, gen, r.dev, param_dtype=torch.float32))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    data = SyntheticLMData(cfg, InputShape("train_4k", C_SEQ, C_BATCH, "train"), seed=SEED)

    def batch(step):
        b = {k: torch.from_numpy(v).long().to(r.dev) for k, v in data.batch(step).items()}
        return SH.distribute_tree(rules, b, SH.batch_specs(cfg, rules, b))

    step_fn = make_train_step(cfg, AdamWConfig(lr=FULL_WIDTH_LR, warmup_steps=0, total_steps=C_STEPS))
    state = {"params": params, "opt": opt, "step": 0}
    del params, opt
    losses = []

    def step():
        b = batch(state["step"])
        with D.use_rules(rules):
            state["params"], state["opt"], m = step_fn(state["params"], state["opt"], b)
        state["step"] += 1
        state["loss"] = m["loss"]

    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    step_ms = []
    for _ in range(C_STEPS):
        step_ms += timed_steps(step, 1)
        losses.append(float(D.full_tensor(state["loss"])))
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(step)
    per_rank = gather({"peak_bytes": peak, "init_peak_bytes": init_peak, "init_s": init_s,
                       "launches": counts, "nccl": prof["nccl"], "busy_ms": prof["busy_ms"]})
    if r.rank == 0:
        med = statistics.median(step_ms[1:])
        line = {"item": "train", "arch": "olmoe-1b-7b", "card": smi, "mesh": list(MESH), "fsdp": True,
                "layers": cfg.n_layers, "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
                "params": cfg.param_count(), "batch": C_BATCH, "seq": C_SEQ, "remat": cfg.remat,
                "attention_impl": cfg.attention_impl, "steps": C_STEPS, "losses": losses, "step_ms": step_ms,
                "step_ms_median_2_6": med, "tokens_per_s": C_BATCH * C_SEQ / (med / 1e3),
                "peak_bytes_per_rank": [p["peak_bytes"] for p in per_rank],
                "init_peak_bytes_per_rank": [p["init_peak_bytes"] for p in per_rank],
                "init_s_per_rank": [p["init_s"] for p in per_rank],
                "launches_per_rank": [p["launches"] for p in per_rank],
                "profile_rank0": prof,
                "nccl_per_rank": [p["nccl"] for p in per_rank]}
        r.check("train olmoe-1b-7b", all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                and prof["busy_ms"] is not None and not any(counts.values()), line)
        r.emit("c", line)
    barrier()


# ------------------------------------------------------------------ (d) granite-20b decode_32k
def local_shape(mesh, shape, placements) -> tuple:
    """This rank's shard of a tensor of ``shape`` placed by ``placements`` (even splits)."""
    local = list(shape)
    coord = mesh.get_coordinate()
    for d, p in enumerate(placements):
        if hasattr(p, "dim"):
            local[p.dim] //= mesh.size(d)
    return tuple(local), coord


def sharded_cache(r: Rank, cfg, rules) -> dict:
    """granite's decode cache placed by ``cache_specs``, each rank filling only
    its own shard (seeded by the shard's place on the mesh), ``len`` D_LEN."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.launch import shardings as SH
    from repro_torch.models.kvcache import init_cache

    skeleton = init_cache(cfg, D_BATCH, D_SLOTS, "meta")
    specs = SH.cache_specs(cfg, rules, skeleton)
    out = {}
    for name in ("k", "v"):
        t = skeleton[name]
        placements = D.to_placements(r.mesh, specs[name], t.ndim)
        local, coord = local_shape(r.mesh, t.shape, placements)
        # ranks that hold the same shard (a replicated mesh dim) fill it alike
        key = [c if hasattr(p, "dim") else 0 for c, p in zip(coord, placements)]
        gen = torch.Generator(device=r.dev).manual_seed(SEED * 1000 + ("k", "v").index(name) * 100
                                                        + key[0] * 10 + key[1])
        shard = torch.empty(local, dtype=t.dtype, device=r.dev)
        for layer in range(local[0]):  # a layer at a time: no fp32 copy of the shard
            shard[layer] = torch.randn(local[1:], generator=gen, device=r.dev, dtype=torch.float32).to(t.dtype)
        out[name] = D.from_local(shard, r.mesh, placements, t.shape)
    out["len"] = D.from_local(torch.tensor(D_LEN, dtype=torch.int32, device=r.dev), r.mesh,
                              D.to_placements(r.mesh, specs["len"], 0))
    return out


def part_d(r: Rank, smi: str) -> None:
    """granite-20b decode_32k at full width and depth on (2, 2) with fsdp: 8
    eager decode steps through ``transformer.forward`` under the rules."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T

    cfg = get_config("granite-20b")
    rules = D.for_mesh(r.mesh, fsdp=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=r.dev).manual_seed(SEED), r.dev)  # bf16, whole
    params = SH.distribute_tree(rules, params, SH.param_specs(cfg, rules, params))  # the whole copy goes
    torch.cuda.synchronize()
    params_peak = torch.cuda.max_memory_allocated()
    cache = sharded_cache(r, cfg, rules)
    gen = torch.Generator(device=r.dev).manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab, (D_BATCH, 1), generator=gen, device=r.dev)
    state = {"tokens": SH.distribute_tree(rules, {"tokens": tokens}, SH.batch_specs(cfg, rules, {"tokens": tokens}))}
    torch.cuda.synchronize()
    setup_s, setup_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    state["cache"] = cache
    del cache

    def step():
        with D.use_rules(rules):
            logits, _, new_cache = T.forward(params, cfg, state["tokens"], state["cache"])
            # the vocabulary sharded over tp is gathered first, as make_serve_step does
            nxt = torch.argmax(D.shard(logits[:, -1, :], "batch", None), dim=-1)
            state["tokens"] = {"tokens": nxt[:, None]}
        state["cache"], state["logits"] = new_cache, logits

    torch.cuda.reset_peak_memory_stats()
    step_ms, tokens_ok, finite = [], True, True
    for _ in range(D_STEPS):
        step_ms += timed_steps(step, 1)
        local_tok = state["tokens"]["tokens"].to_local()
        tokens_ok = tokens_ok and bool(((local_tok >= 0) & (local_tok < cfg.vocab)).all())
        finite = finite and bool(state["logits"].to_local().isfinite().all())
    peak = torch.cuda.max_memory_allocated()
    final_len = int(state["cache"]["len"].to_local())
    cache_bytes = sum(state["cache"][k].to_local().numel() * 2 for k in ("k", "v"))
    # the profiled steps write the last slots again: the length goes back first
    state["cache"]["len"] = D.from_local(torch.tensor(D_LEN, dtype=torch.int32, device=r.dev), r.mesh,
                                         state["cache"]["len"].placements)
    prof = profile_step(step)
    per_rank = gather({"peak_bytes": peak, "params_peak_bytes": params_peak, "setup_peak_bytes": setup_peak,
                       "setup_s": setup_s, "len": final_len, "tokens_ok": tokens_ok, "finite": finite,
                       "cache_bytes": cache_bytes, "nccl": prof["nccl"], "busy_ms": prof["busy_ms"]})
    if r.rank == 0:
        med = statistics.median(step_ms[1:])
        line = {"item": "decode", "arch": "granite-20b", "shape": "decode_32k", "card": smi, "mesh": list(MESH),
                "fsdp": True, "layers": cfg.n_layers, "params": cfg.param_count(), "batch": D_BATCH,
                "cache_slots": D_SLOTS, "len_before": D_LEN, "steps": D_STEPS, "step_ms": step_ms,
                "step_ms_median_2_8": med, "tokens_per_s": D_BATCH / (med / 1e3),
                "len_after_per_rank": [p["len"] for p in per_rank],
                "tokens_in_vocab": all(p["tokens_ok"] for p in per_rank),
                "logits_finite": all(p["finite"] for p in per_rank),
                "cache_bytes_per_rank": [p["cache_bytes"] for p in per_rank],
                "peak_bytes_per_rank": [p["peak_bytes"] for p in per_rank],
                "params_peak_bytes_per_rank": [p["params_peak_bytes"] for p in per_rank],
                "setup_peak_bytes_per_rank": [p["setup_peak_bytes"] for p in per_rank],
                "setup_s_per_rank": [p["setup_s"] for p in per_rank],
                "profile_rank0": prof,
                "nccl_per_rank": [p["nccl"] for p in per_rank]}
        r.check("decode granite-20b", line["tokens_in_vocab"] and line["logits_finite"]
                and line["len_after_per_rank"] == [D_LEN + D_STEPS] * WORLD and prof["busy_ms"] is not None, line)
        r.emit("d", line)
    barrier()


# ------------------------------------------------------------------ (e) the dry run
def link_rates(r: Rank) -> None:
    """Each collective kind of the two cells timed alone on its mesh dim's
    group (2 ranks), as the cells move them (fp32 gathers and scatters over
    "data", bf16 all-reduces over "model"): ms a call at each of
    ``LINK_SIZES`` output bytes, by CUDA events over ``LINK_CALLS``
    back-to-back calls after a barrier, and the rate in output bytes a second
    (the bytes the dry run counts)."""
    import torch
    import torch.distributed as dist

    out = {}
    for kind, dim, dtype in (("all-gather", "data", torch.float32), ("reduce-scatter", "data", torch.float32),
                             ("all-reduce", "model", torch.bfloat16)):
        group = r.mesh.get_group(dim)
        n = dist.get_world_size(group)
        rows = []
        for size in LINK_SIZES:
            elems = size // torch.tensor([], dtype=dtype).element_size()
            if kind == "all-gather":
                dst, src = torch.zeros(elems, dtype=dtype, device=r.dev), torch.zeros(elems // n, dtype=dtype,
                                                                                      device=r.dev)
                call = lambda: dist.all_gather_into_tensor(dst, src, group=group)  # noqa: E731
            elif kind == "reduce-scatter":
                dst, src = torch.zeros(elems, dtype=dtype, device=r.dev), torch.zeros(elems * n, dtype=dtype,
                                                                                      device=r.dev)
                call = lambda: dist.reduce_scatter_tensor(dst, src, group=group)  # noqa: E731
            else:
                dst = torch.zeros(elems, dtype=dtype, device=r.dev)
                call = lambda: dist.all_reduce(dst, group=group)  # noqa: E731
            for _ in range(3):
                call()
            ms = timed_steps(lambda: [call() for _ in range(LINK_CALLS)], 1)[0] / LINK_CALLS
            rows.append({"bytes": size, "ms": ms, "bytes_per_s": size / (ms / 1e3)})
        out[kind] = rows
    r.emit("e", {"item": "link", "group_size": MESH[0], "calls": LINK_CALLS, "rates": out})


def alone_ms(rows: list, nbytes: float) -> float:
    """A collective's ms a call at ``nbytes`` from ``link_rates``' rows: log-log
    between the sizes measured; below the smallest its ms, above the largest its rate."""
    if nbytes <= rows[0]["bytes"]:
        return rows[0]["ms"]
    for lo, hi in zip(rows, rows[1:]):
        if nbytes <= hi["bytes"]:
            f = math.log(nbytes / lo["bytes"]) / math.log(hi["bytes"] / lo["bytes"])
            return math.exp(math.log(lo["ms"]) + f * (math.log(hi["ms"]) - math.log(lo["ms"])))
    return nbytes / rows[-1]["bytes_per_s"] * 1e3


def dryrun_cells(out: dict) -> None:
    """Trace (c)'s and (d)'s cells on a fake (2, 2) world over a ``"cuda"`` mesh (in the parent)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.config import InputShape

    for key, arch, shape in (("c", "olmoe-1b-7b", InputShape("train_4k", C_SEQ, C_BATCH, "train")),
                             ("d", "granite-20b", InputShape("decode_32k", D_SLOTS, D_BATCH, "decode"))):
        t0 = time.perf_counter()
        out[key] = DR.trace_cell(arch, get_config(arch), shape.name, shape, MESH, AXES, DR.DryrunKnobs(),
                                 True, "cuda", "2x2")
        out[key]["seconds"] = time.perf_counter() - t0


def dryrun_against(art: dict, measured: dict, step_key: str, rates: dict) -> dict:
    """One cell's prediction beside the measurement (rank 0's: the dry run traces
    rank 0); ``alone_ms``: the counted collectives at their mean payload, at
    the rates ``link_rates`` measured with no rank waiting."""
    from repro_torch.roofline.analysis import H100_HW

    predicted = art["memory_analysis"]["peak_bytes"]
    peak = measured["peak_bytes_per_rank"][0]
    nccl = measured["profile_rank0"]["nccl"]
    nccl_ms = sum(v["ms"] for v in nccl.values())
    coll = art["collective"]
    counted = sum(coll["bytes"].values())
    alone = {kind: coll["counts"][kind] * alone_ms(rates[kind], coll["bytes"][kind] / coll["counts"][kind])
             for kind in rates if coll["counts"].get(kind)}
    return {"cell": f"{art['arch']} {art['shape']} (2, 2) fsdp", "trace_s": art["seconds"],
            "predicted_peak_bytes": predicted, "measured_peak_bytes": peak,
            "peak_gap": predicted / peak - 1, "peak_within_bar": abs(predicted / peak - 1) <= PEAK_TOL,
            "argument_bytes": art["memory_analysis"]["argument_size_in_bytes"],
            "collectives": {kind: {"predicted_bytes": coll["bytes"].get(kind, 0.0),
                                   "predicted_count": coll["counts"].get(kind, 0),
                                   "nccl_kernels": nccl.get(kind, {}).get("count", 0),
                                   "nccl_ms": nccl.get(kind, {}).get("ms", 0.0)}
                            for kind in sorted(set(coll["bytes"]) | set(nccl))},
            "link_ms_predicted": art["roofline"]["collective_s"] * 1e3, "nccl_ms_measured": nccl_ms,
            "link_bw_assumed": H100_HW.ici_bw,
            "achieved_bytes_per_s": counted / (nccl_ms / 1e3) if nccl_ms else None,
            "alone_ms_by_kind": alone, "alone_ms": sum(alone.values()),
            "alone_bytes_per_s": counted / (sum(alone.values()) / 1e3) if alone else None,
            "compute_ms_predicted": art["roofline"]["compute_s"] * 1e3,
            "memory_ms_predicted": art["roofline"]["memory_s"] * 1e3,
            "step_ms_predicted": art["roofline"]["step_time_s"] * 1e3, "bottleneck": art["roofline"]["bottleneck"],
            "step_ms_measured": measured[step_key], "flops_per_rank": art["cost"]["flops"]}


# ------------------------------------------------------------------ the ranks
def loaded_reference_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def worker(rank: int, device: str, port: int, work: str, smi: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(SRC))
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products as true fp32, as chip_smoke.py
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)  # four ranks share the machine's cores
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=300),
                            **({"device_id": torch.device("cuda", rank)} if cuda else {}))
    r = Rank(rank, torch.device("cuda", rank) if cuda else torch.device("cpu"),
             init_device_mesh(device, MESH, mesh_dim_names=AXES), cuda, Path(work))
    try:
        seconds = {}
        parts = [("a", part_a)] + ([("b", part_b), ("d", lambda r: part_d(r, smi)),
                                     ("c", lambda r: part_c(r, smi)), ("e", link_rates)] if cuda else [])
        for name, fn in parts:
            t0 = time.perf_counter()
            fn(r)
            seconds[name] = time.perf_counter() - t0
            if cuda:
                torch.cuda.empty_cache()
        modules = gather(loaded_reference_modules())
        if rank == 0:
            with open(Path(work) / "rank0.json", "w") as f:
                json.dump({"lines": r.lines, "failures": r.failures, "seconds": seconds,
                           "reference_modules": modules}, f)
        barrier()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: four cards over NCCL, parts (a)-(e); cpu: part (a) at reduced sizes on gloo")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"mesh_smoke: the port's sources are missing ({SRC / 'repro_torch'})", file=sys.stderr)
        return 1
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, str(SRC))
    cuda = args.device == "cuda"
    smi = "cpu"
    if cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            raise RuntimeError(f"mesh_smoke needs {WORLD} CUDA devices, found "
                               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
        smi = cards[0]
        for line in cards:
            print(line, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
              f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}", flush=True)
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(CS.TRAIN_KERNELS)) as pool:
            built = list(pool.map(build.build, CS.TRAIN_KERNELS))
        print(f"build: {len(built)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    work_root = ROOT / "build" if cuda else None
    if work_root:
        work_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work_root) as work:
        ctx = mp.spawn(worker, args=(args.device, free_port(), work, smi), nprocs=WORLD, join=False)
        deadline = time.perf_counter() + SECONDS
        arts: dict = {}
        dryrun_error = None
        try:
            if cuda:
                try:
                    dryrun_cells(arts)  # on the host, beside the ranks
                except Exception:  # reported below, after the ranks' results: the run fails
                    dryrun_error = traceback.format_exc()
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"the ranks did not finish in {SECONDS} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        with open(Path(work) / "rank0.json") as f:
            result = json.load(f)
    failures = list(result["failures"])
    if dryrun_error:
        print(dryrun_error, file=sys.stderr)
        failures.append("the dry run of part (e) raised")
    modules = [m for per in result["reference_modules"] for m in per] + loaded_reference_modules()
    if modules:
        failures.append(f"JAX or the JAX package was imported: {sorted(set(modules))}")
    if cuda and not dryrun_error:
        measured = {k: v for line in result["lines"] for k, v in line.items() if k in ("c", "d")}
        rates = next(line["e"]["rates"] for line in result["lines"] if "e" in line)
        for key, step_key in (("c", "step_ms_median_2_6"), ("d", "step_ms_median_2_8")):
            line = dryrun_against(arts[key], measured[key], step_key, rates)
            print(json.dumps({"e": line}), flush=True)
    print(json.dumps({"seconds": {**result["seconds"], "total": time.perf_counter() - t_start},
                      "reference_modules": sorted(set(modules))}), flush=True)
    if failures:
        print("mesh_smoke: failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(json.dumps({"ok": True, "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                                             "count": torch.cuda.device_count() if cuda else WORLD}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
