"""Multi-pod dry run, ported from ``repro.launch.dryrun``: trace every (arch x
shape x mesh) cell on fake tensors.

Proves the distribution config is coherent without the devices: every cell
must trace one full step on the single-pod (16, 16) mesh (256 ranks) and on
the multi-pod (2, 16, 16) mesh (512 ranks), as a rank of a fake process
group, on fake tensors (nothing is allocated).  The reference lowers and
compiles each cell; the port runs the eager step once, at full depth, under
four counters of its own (``StepCounters``, a dispatch mode that sees each
rank's local operations below DTensor):

* per-rank FLOPs (``torch.utils.flop_counter``'s formulas, and the port's
  kernels' own, ``kernels/costs.py``), counted on each rank's shards --
  ``FlopCounterMode`` counts a DTensor op at its global shape;
* per-rank collective payload by kind (the functional collectives DTensor
  issues, at their local shapes);
* per-rank argument bytes (the local shards of parameters, optimizer state,
  batch and cache);
* peak live bytes (every local storage from its creation to its release,
  the arguments included, plus the scan kernels' scratch while they run).

The reference's cost probes at 1 and 2 units and their least-squares fit
(``repro/launch/dryrun.py:168-246``) are not ported: they exist because
XLA's cost analysis visits a loop body once; an eager trace visits every
layer, so the full-depth count is exact.

The mesh's device type is ``cuda`` (the card's: fake CUDA tensors take the
kernels' routes, whose fake implementations are shape-only).  ``--mesh-device
cpu`` traces fake CPU tensors on a ``cpu`` mesh instead: a CPU-only build
cannot run autograd on fake CUDA tensors (its engine needs a CUDA device
guard), so there the kernels' plain versions are traced.  Figures are
predictions *for* H100s (``roofline.analysis.H100_HW``), never
measurements.  Artifacts go to ``experiments/artifacts/dryrun_torch/<cell>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                       # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh multi --force
  ... --microbatches 4 --remat dots --fsdp on   # perf-iteration knobs
  ... --mesh-device cpu                          # on a machine without CUDA
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import threading
import time
import traceback
import weakref
from typing import Any

import torch

from repro_torch import distributed as D
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.network import decompose
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import production_shape
from repro_torch.models.config import SHAPES, InputShape, ModelConfig, shape_applicable
from repro_torch.roofline.analysis import H100_HW, analyze_compiled

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "artifacts", "dryrun_torch")

#: the functional collectives DTensor and the port issue, by the reference's kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D for training, 2*N_active per generated/processed token otherwise."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.seq_len * shape.global_batch
    return 2.0 * n_act * shape.global_batch  # decode: one token per sequence


def cell_id(arch: str, shape: str, mesh: str, tag: str = "base") -> str:
    return f"{arch}__{shape}__{mesh}__{tag}"


@dataclasses.dataclass
class DryrunKnobs:
    """Perf-iteration levers."""

    microbatches: int = 1
    remat: str | None = None  # override cfg.remat
    fsdp: bool | None = None  # override default fsdp policy
    attention_block_k: int | None = None
    capacity_factor: float | None = None
    seq_parallel: bool = False  # SP mode: model axis shards tokens, not weights
    tag: str = "base"


#: archs whose parameters and optimizer state need ZeRO/FSDP sharding to fit
#: a device's memory beside their activations
FSDP_DEFAULT = {"granite-20b", "granite-34b", "qwen3-moe-235b-a22b", "zamba2-2.7b"}


def apply_knobs(cfg: ModelConfig, knobs: DryrunKnobs) -> ModelConfig:
    repl: dict[str, Any] = {}
    if knobs.remat:
        repl["remat"] = knobs.remat
    if knobs.attention_block_k:
        repl["attention_block_k"] = knobs.attention_block_k
    if knobs.capacity_factor:
        repl["capacity_factor"] = knobs.capacity_factor
    return dataclasses.replace(cfg, **repl)


# ------------------------------------------------------------------ counters
_META = threading.local()


@contextlib.contextmanager
def _tensor_meta_hidden():
    """Hide DTensor's own shape propagation from the counters: on a cache miss
    it runs the op once at the *global* shapes on the same fake mode."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, *args, **kwargs):
        prev = getattr(_META, "hidden", False)
        _META.hidden = True
        try:
            return orig(self, *args, **kwargs)
        finally:
            _META.hidden = prev

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


class StepCounters:
    """Per-rank FLOPs, collective bytes by kind, bytes accessed and peak live
    bytes of what runs inside ``counting()``, on the fake tensors of ``mode``.

    ``mode`` is a ``FakeTensorMode`` that counts each operation it runs.  A
    DTensor op reaches it first as itself, and it declines (as every fake
    mode does with a tensor subclass); DTensor then runs the op's local
    operations on this rank's shards, and those it counts.
    """

    def __init__(self) -> None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import flop_registry

        from repro_torch.kernels.ops import SCRATCH_BYTES

        counters = self
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collective = {k: 0.0 for k in _COLLECTIVES.values()}
        self.collective_counts = {k: 0 for k in _COLLECTIVES.values()}
        self.flops_by_op: dict[str, float] = {}
        self._live: dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.active = False
        self._depth = 0

        class _Mode(FakeTensorMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, D.DTensor) for t in types):
                    return super().__torch_dispatch__(func, types, args, kwargs)
                counters._depth += 1
                try:
                    out = super().__torch_dispatch__(func, types, args, kwargs)
                finally:
                    counters._depth -= 1
                if (counters.active and counters._depth == 0 and out is not NotImplemented
                        and not getattr(_META, "hidden", False)):
                    counters._count(func, args, kwargs, out, flop_registry, SCRATCH_BYTES)
                return out

        self.mode = _Mode(allow_non_fake_inputs=True)

    def add_live(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors (local shards) as live; returns their bytes."""
        from repro_torch.optim.adamw import tree_leaves

        total = 0
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                local = t.to_local() if isinstance(t, D.DTensor) else t
                total += self._track(local)
        return total

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.current -= self._live.pop(key, 0)

    def _count(self, func, args, kwargs, out, flop_registry, scratch) -> None:
        packet = func._overloadpacket
        outs = _tensors(out)
        if func.namespace == "_c10d_functional" and packet.__name__ in _COLLECTIVES:
            kind = _COLLECTIVES[packet.__name__]
            self.collective[kind] += float(sum(t.numel() * t.element_size() for t in outs))
            self.collective_counts[kind] += 1
        elif packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[str(packet)] = self.flops_by_op.get(str(packet), 0.0) + f
        if not _is_view(func) and func.namespace not in ("prim", "_c10d_functional"):
            ins = _tensors(list(args) + list(kwargs.values()))
            self.bytes_accessed += float(sum(t.numel() * t.element_size() for t in ins + outs))
        for t in outs:
            self._track(t)
        if func in scratch:
            # the kernel's scratch lives while it runs, beside its outputs
            self.peak = max(self.peak, self.current + scratch[func](*args, **kwargs))

    @contextlib.contextmanager
    def counting(self):
        with _tensor_meta_hidden():
            self.active = True
            try:
                yield self
            finally:
                self.active = False


# ------------------------------------------------------------------ analytic terms
def _layer_terms(layer_type: str, cfg: dict, kv_ratio: int = 4) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one layer: the formulas of ``TPUv5eSim._terms``
    without the TPU's tile padding."""
    if layer_type == "dense":
        m, k, n = cfg["tokens"], cfg["d_in"], cfg["d_out"]
        return 2.0 * m * k * n, 2.0 * (m * k + m * n + k * n)
    if layer_type == "attention_prefill":
        b, h, dh, s = cfg["B"], cfg["H"], cfg["Dh"], cfg["S"]
        kvh = max(1, h // cfg.get("kv_ratio", kv_ratio))
        return 2.0 * b * h * s * s * dh, 2.0 * (b * h * s * dh + 2 * b * kvh * s * dh + b * h * s * dh)
    if layer_type == "attention_decode":
        b, h, dh, s = cfg["B"], cfg["H"], cfg["Dh"], cfg["S_kv"]
        kvh = max(1, h // cfg.get("kv_ratio", kv_ratio))
        return 4.0 * b * h * s * dh, 2.0 * (2 * b * kvh * s * dh + 2 * b * h * dh)
    if layer_type == "moe_gemm":
        e, topk = cfg["E"], cfg["topk"]
        per_expert = int(math.ceil(cfg["tokens"] * topk / e))
        dm, df = cfg["d_model"], cfg["d_ff"]
        return 3.0 * 2.0 * e * per_expert * dm * df, 2.0 * (3 * e * dm * df + e * per_expert * (2 * dm + 2 * df))
    if layer_type == "ssd_scan":
        b, h, p, n, s = cfg["B"], cfg["H"], cfg["P"], cfg["N"], cfg["S"]
        q = 128
        nchunks = -(-s // q)
        per_chunk = 2.0 * q * q * n + 2.0 * q * q * p + 4.0 * q * n * p
        return b * h * nchunks * per_chunk, 2.0 * b * s * (h * p * 2 + 2 * n + h)
    if layer_type == "embed":
        t, dm = cfg["tokens"], cfg["d_model"]
        return 0.0, 2.0 * t * dm * 2 + 4.0 * t
    raise KeyError(layer_type)


def analytic_terms(cfg: ModelConfig, shape: InputShape, dp: int, tp: int) -> dict:
    """Fusion-aware analytic compute / HBM terms per device, for H100s.

    An eager trace's bytes accessed count every intermediate of every
    unfused elementwise op, far above what a fused step moves through HBM;
    this term counts weights plus the necessary activation streaming per
    layer (``core.network.decompose``, by the layer formulas above) over
    ``H100_HW``'s rates.
    """
    flops = nbytes = 0.0
    for b in decompose(cfg, shape, dp, tp):
        for lt, c in b.layers:
            f, m = _layer_terms(lt, c)
            flops += f * b.repeat
            nbytes += m * b.repeat
    return {"compute_s": flops / H100_HW.peak_flops, "memory_s": nbytes / H100_HW.hbm_bw}


# ------------------------------------------------------------------ one cell
@contextlib.contextmanager
def fake_world(size: int, mesh_shape, axis_names, device_type: str):
    """A fake process group of ``size`` ranks (this process is rank 0) and a
    ``DeviceMesh`` over it; destroyed on exit, so nothing else sees it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield init_device_mesh(device_type, tuple(mesh_shape), mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


def _fake_inputs(cfg: ModelConfig, shape: InputShape, rules, device: str) -> dict:
    """Parameters (fp32 masters for training, as the reference's; bf16 for
    prefill and decode, the weights the port serves), optimizer state, batch
    and cache of a cell, placed by their specs; call under ``FakeTensorMode``."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import init_cache

    def make_params():
        dtype = torch.float32 if shape.kind == "train" else L.COMPUTE_DTYPE
        return T.init_params(cfg, None, device, param_dtype=dtype)

    out: dict[str, Any] = {}
    if shape.kind == "train":
        out["params"], out["opt"] = SH.distribute_train_state(cfg, rules, make_params)
    else:
        params = make_params()
        out["params"] = SH.distribute_tree(rules, params, SH.param_specs(cfg, rules, params))
    batch = {}
    for k, (s, dt) in make_batch_specs(cfg, shape).items():
        batch[k] = torch.empty(s, dtype=torch.long if k in ("tokens", "labels") else getattr(torch, dt),
                               device=device)
    out["batch"] = SH.distribute_tree(rules, batch, SH.batch_specs(cfg, rules, batch))
    if shape.kind == "decode":
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device)
        out["cache"] = SH.distribute_tree(rules, cache, SH.cache_specs(cfg, rules, cache))
    return out


def trace_step(cfg: ModelConfig, shape: InputShape, rules, knobs: DryrunKnobs, device: str) -> dict:
    """One full-depth step of ``shape.kind`` on fake tensors under ``rules``,
    counted; returns the counts, per rank."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step

    t0 = time.perf_counter()
    counters = StepCounters()
    with counters.mode, D.use_rules(rules):
        inputs = _fake_inputs(cfg, shape, rules, device)
        arg_bytes = counters.add_live(inputs)
        t_inputs = time.perf_counter() - t0
        t0 = time.perf_counter()
        with counters.counting():
            if shape.kind == "train":
                fn = make_train_step(cfg, AdamWConfig(), n_microbatches=knobs.microbatches)
                result = fn(inputs["params"], inputs["opt"], inputs["batch"])
            elif shape.kind == "prefill":
                result = make_prefill_step(cfg)(inputs["params"], inputs["batch"])
            else:
                result = make_serve_step(cfg)(inputs["params"], inputs["cache"], inputs["batch"])
        del result
    return {
        "argument_size_in_bytes": int(arg_bytes),
        "peak_bytes": int(counters.peak),
        "flops": counters.flops,
        "bytes_accessed": counters.bytes_accessed,
        "collective": dict(counters.collective),
        "collective_counts": dict(counters.collective_counts),
        "flops_by_op": dict(sorted(counters.flops_by_op.items(), key=lambda kv: -kv[1])[:8]),
        "inputs_s": t_inputs,
        "trace_s": time.perf_counter() - t0,
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool, knobs: DryrunKnobs,
               mesh_device: str = "cuda") -> dict:
    """Trace one cell at full depth on its production mesh of fake ranks."""
    base_cfg = get_config(arch)
    fsdp = knobs.fsdp if knobs.fsdp is not None else (arch in FSDP_DEFAULT)
    if knobs.seq_parallel:
        assert base_cfg.family in ("dense", "vlm"), "SP mode targets dense archs"
        fsdp = True  # weights replicate over tp; optimizer must shard over data
    mesh_shape, names = production_shape(multi_pod)
    return trace_cell(arch, apply_knobs(base_cfg, knobs), shape_name, SHAPES[shape_name], mesh_shape, names,
                      knobs, fsdp, mesh_device, "multi" if multi_pod else "single")


def trace_cell(arch: str, cfg: ModelConfig, shape_name: str, shape: InputShape, mesh_shape, names,
               knobs: DryrunKnobs, fsdp: bool, mesh_device: str, mesh_name: str) -> dict:
    """``trace_step`` on a fake world over a mesh of any shape; returns the artifact."""
    chips = math.prod(mesh_shape)
    with fake_world(chips, mesh_shape, names, mesh_device) as mesh:
        rules = D.for_mesh(mesh, fsdp=fsdp, seq_parallel=knobs.seq_parallel)
        counts = trace_step(cfg, shape, rules, knobs, mesh_device)
        dp, tp = rules.dp_size, rules.tp_size
    return artifact(arch, shape_name, mesh_name, cfg, shape, chips, dp, tp, fsdp, knobs, counts)


def artifact(arch: str, shape_name: str, mesh_name: str, cfg: ModelConfig, shape: InputShape, chips: int,
             dp: int, tp: int, fsdp: bool, knobs: DryrunKnobs, counts: dict) -> dict:
    """The cell's artifact: the reference's keys where they mean something here."""
    cost = {"flops": counts["flops"], "bytes accessed": counts["bytes_accessed"]}
    coll = {**counts["collective"], "_counts": counts["collective_counts"]}
    terms = analyze_compiled(cost, "", chips, model_flops=model_flops(cfg, shape), hw=H100_HW,
                             collective_bytes=coll)
    ana = analytic_terms(cfg, shape, dp, tp)
    # step model: counted compute term (captures sharding waste) + analytic
    # HBM term (what a fused step streams) + link term
    step_model = max(terms.compute_s, ana["memory_s"], terms.collective_s)
    ideal = (terms.model_flops / chips) / H100_HW.peak_flops
    bottleneck = ["compute", "memory", "collective"][
        [terms.compute_s, ana["memory_s"], terms.collective_s].index(step_model)]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": int(chips),
        "dp": dp,
        "tp": tp,
        "knobs": dataclasses.asdict(knobs),
        "fsdp": fsdp,
        "trace_s": counts["trace_s"],
        "inputs_s": counts["inputs_s"],
        "hw": "H100_HW (prediction for NVIDIA H100 SXM5 80GB, 700 W datasheet figures)",
        "memory_analysis": {"argument_size_in_bytes": counts["argument_size_in_bytes"],
                            "peak_bytes": counts["peak_bytes"]},
        "fits_80gb": counts["peak_bytes"] <= 80e9,
        "cost": cost,
        "flops_by_op": counts["flops_by_op"],
        "collective": {"bytes": counts["collective"], "counts": counts["collective_counts"]},
        "roofline": {
            "flops": terms.flops,
            "hbm_bytes": terms.hbm_bytes,
            "collective_bytes": terms.collective_bytes,
            "compute_s": terms.compute_s,
            "memory_s_traced": terms.memory_s,
            "memory_s": ana["memory_s"],
            "compute_s_analytic": ana["compute_s"],
            "collective_s": terms.collective_s,
            "bottleneck_traced": terms.bottleneck,
            "bottleneck": bottleneck,
            "step_time_traced_s": terms.step_time_s,
            "step_time_s": step_model,
            "model_flops": terms.model_flops,
            "useful_flops_frac": terms.useful_flops_frac,
            "roofline_frac": ideal / step_model if step_model else 0.0,
        },
    }


def run_cells(archs, shapes, meshes, knobs: DryrunKnobs, force: bool = False, out_dir: str | None = None,
              mesh_device: str = "cuda"):
    out_dir = out_dir or os.path.abspath(ART_DIR)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not shape_applicable(cfg, SHAPES[shape_name]):
                print(f"SKIP {arch} x {shape_name}: inapplicable")
                continue
            for mesh_name in meshes:
                cid = cell_id(arch, shape_name, mesh_name, knobs.tag)
                path = os.path.join(out_dir, cid + ".json")
                if os.path.exists(path) and not force:
                    print(f"CACHED {cid}")
                    with open(path) as f:
                        results.append(json.load(f))
                    continue
                print(f"RUN {cid} ...", flush=True)
                try:
                    art = lower_cell(arch, shape_name, mesh_name == "multi", knobs, mesh_device)
                except Exception as e:  # a failing cell is a bug; record it
                    art = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "knobs": dataclasses.asdict(knobs),
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    print(f"FAIL {cid}: {e}")
                with open(path, "w") as f:
                    json.dump(art, f, indent=1)
                if "roofline" in art:
                    r = art["roofline"]
                    print(
                        f"OK {cid}: trace={art['trace_s']:.1f}s peak={art['memory_analysis']['peak_bytes'] / 2**30:.2f}GiB "
                        f"bottleneck={r['bottleneck']} step={r['step_time_s'] * 1e3:.2f}ms "
                        f"roofline_frac={r['roofline_frac']:.3f}",
                        flush=True,
                    )
                results.append(art)
    return results


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="base")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None, choices=[None, "none", "full", "dots"])
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--attention-block-k", type=int, default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--mesh-device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake mesh's device type (cpu: fake CPU tensors, the kernels' plain versions)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    knobs = DryrunKnobs(
        microbatches=args.microbatches,
        remat=args.remat,
        fsdp=None if args.fsdp is None else args.fsdp == "on",
        attention_block_k=args.attention_block_k,
        seq_parallel=args.seq_parallel,
        tag=args.tag,
    )
    results = run_cells(archs, shapes, meshes, knobs, force=args.force, out_dir=args.out,
                        mesh_device=args.mesh_device)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results) - n_fail}/{len(results)} cells traced OK")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
