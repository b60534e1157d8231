"""The port's dry run (``repro_torch.launch.dryrun``) on fake ranks and fake tensors.

Each test makes a fake process group and destroys it before it returns
(``fake_world``), so no other test in the worker sees one.  Meshes are
``"cpu"`` meshes of fake CPU tensors: a CPU-only build cannot run autograd on
fake CUDA tensors.
"""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.models.config import InputShape, reduced  # noqa: E402

NAMES = ("data", "model")


def _counted(fn, mesh_shape=(2, 2)):
    counters = DR.StepCounters()
    with DR.fake_world(mesh_shape[0] * mesh_shape[1], mesh_shape, NAMES, "cpu") as mesh, counters.mode:
        out = fn(mesh, counters)
    assert not dist.is_initialized()
    return counters, out


@pytest.mark.parametrize("sharded", [True, False])
def test_product_flops_are_counted_per_rank(sharded):
    m, k, n = 256, 128, 64

    def run(mesh, counters):
        pa = (Shard(0), Replicate()) if sharded else (Replicate(), Replicate())
        pb = (Replicate(), Shard(1)) if sharded else (Replicate(), Replicate())
        a = D.from_local(torch.empty(m // 2 if sharded else m, k, dtype=torch.bfloat16), mesh, pa, (m, k))
        b = D.from_local(torch.empty(k, n // 2 if sharded else n, dtype=torch.bfloat16), mesh, pb, (k, n))
        with counters.counting():
            return a @ b

    counters, out = _counted(run)
    assert counters.flops == 2 * m * n * k / (4 if sharded else 1)
    assert out.shape == (m, n)


def test_row_parallel_all_reduce_payload_is_the_local_output():
    m, k, n = 64, 128, 96

    def run(mesh, counters):
        a = D.from_local(torch.empty(m, k // 2), mesh, (Replicate(), Shard(1)), (m, k))
        b = D.from_local(torch.empty(k // 2, n), mesh, (Replicate(), Shard(0)), (k, n))
        with counters.counting():
            y = (a @ b).redistribute(mesh, (Replicate(), Replicate()))
        return y

    counters, y = _counted(run)
    assert counters.collective["all-reduce"] == m * n * 4 == y.to_local().numel() * 4
    assert counters.collective_counts["all-reduce"] == 1
    assert counters.flops == 2 * m * n * k / 2


def _cell(arch, kind, mesh_shape=(2, 2), seq=64, batch=4, **knobs):
    cfg = reduced(get_config(arch))
    return DR.trace_cell(arch, cfg, kind, InputShape(kind, seq, batch, kind), mesh_shape, NAMES,
                         DR.DryrunKnobs(**knobs), bool(knobs.get("seq_parallel")), "cpu", "x".join(map(str, mesh_shape)))


def test_argument_bytes_equal_the_references_mini_dryrun():
    """tests/test_distribution.py::test_mini_dryrun_lowering's cell on a 1 x 1 mesh:
    the same parameters, AdamW moments and step; the port's tokens and labels are
    int64 where the reference's are int32, the one difference."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import single_device_rules, use_rules
    from repro.models import transformer as RT
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.train.steps import make_train_step

    cfg = reduced(get_config("internlm2-1.8b"))
    with use_rules(single_device_rules()):
        params_s = jax.eval_shape(lambda: RT.init_params(cfg, jax.random.PRNGKey(0)))
        opt_s = jax.eval_shape(adamw_init, params_s)
        batch_s = {k: jax.ShapeDtypeStruct((4, 16), jnp.int32) for k in ("tokens", "labels")}
        compiled = jax.jit(make_train_step(cfg, AdamWConfig())).lower(params_s, opt_s, batch_s).compile()
    ref_bytes = compiled.memory_analysis().argument_size_in_bytes
    art = _cell("internlm2-1.8b", "train", (1, 1), seq=16, batch=4)
    token_gap = 2 * 4 * 16 * (8 - 4)  # tokens and labels, int64 against int32
    assert art["memory_analysis"]["argument_size_in_bytes"] == ref_bytes + token_gap
    assert art["memory_analysis"]["peak_bytes"] > art["memory_analysis"]["argument_size_in_bytes"]


def test_per_rank_flops_divide_by_the_mesh_for_a_kv_sharded_config():
    single = _cell("internlm2-1.8b", "train", (1, 1))
    quad = _cell("internlm2-1.8b", "train", (2, 2))
    assert quad["tp"] == 2 and single["cost"]["flops"] > 0
    assert abs(4 * quad["cost"]["flops"] / single["cost"]["flops"] - 1) <= 0.05
    assert quad["collective"]["bytes"]["all-reduce"] > 0 and not any(single["collective"]["bytes"].values())


@pytest.mark.parametrize("arch,kind,knobs", [
    ("qwen2-1.5b", "train", {}),
    ("olmoe-1b-7b", "train", {}),
    ("mamba2-780m", "train", {}),
    ("zamba2-2.7b", "train", {"fsdp": True}),
    ("qwen2-vl-2b", "train", {}),
    ("whisper-medium", "train", {}),
    ("granite-20b", "decode", {}),
    ("olmoe-1b-7b", "prefill", {}),
    ("qwen2-1.5b", "train", {"seq_parallel": True}),
])
def test_a_reduced_cell_of_each_family_traces_on_a_2x2_mesh(arch, kind, knobs):
    art = _cell(arch, kind, **knobs)
    mem = art["memory_analysis"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_bytes"]
    assert art["cost"]["flops"] > 0 and art["roofline"]["step_time_s"] > 0
    assert art["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert any(art["collective"]["bytes"].values())
    assert not dist.is_initialized()


@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_training_state_holds_one_whole_copy_of_the_parameters(tmp_path, fsdp):
    """The trainer's sharded init on a fake (2, 2) mesh: AdamW's moments are
    born as shards with their parameters' placements, so a rank's peak is
    one whole copy of the fp32 parameters beside its shards (the whole
    parameters then the rank's three shards), not whole moments too."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = reduced(get_config("qwen2-1.5b"))

    def run(mesh, counters):
        rules = D.for_mesh(mesh, fsdp=fsdp)
        trainer = Trainer(cfg, InputShape("train", 64, 4, "train"), rules,
                          TrainerConfig(checkpoint_dir=str(tmp_path)), device="cpu")
        with D.use_rules(rules), counters.counting():
            return trainer._init_state()

    counters, (params, opt) = _counted(run)
    leaves = tree_leaves(params)
    whole = sum(t.numel() * 4 for t in leaves)
    local = sum(t.to_local().numel() * 4 for t in leaves)
    assert local < (0.26 if fsdp else 0.51) * whole  # tp halves the weights, fsdp halves them again
    for moment in (opt["m"], opt["v"]):
        assert [m.placements for m in tree_leaves(moment)] == [p.placements for p in leaves]
    assert isinstance(opt["step"], D.DTensor) and all(isinstance(p, Replicate) for p in opt["step"].placements)
    assert counters.peak <= 1.01 * max(whole + local, 3 * local), (counters.peak, whole, local)


def test_fake_world_is_destroyed_after_a_failure():
    with pytest.raises(RuntimeError, match="boom"):
        with DR.fake_world(4, (2, 2), NAMES, "cpu"):
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_analytic_terms_use_the_h100_figures():
    from repro_torch.roofline.analysis import H100_HW, V5E_HW

    cfg = get_config("qwen2-1.5b")
    shape = InputShape("t", 4096, 256, "train")
    terms = DR.analytic_terms(cfg, shape, 16, 16)
    assert terms["compute_s"] > 0 and terms["memory_s"] > 0
    assert H100_HW.peak_flops == 989e12 and H100_HW.hbm_bw == 3.35e12 and V5E_HW.peak_flops == 197e12
    f, m = DR._layer_terms("dense", {"tokens": 100, "d_in": 30, "d_out": 50})
    assert (f, m) == (2.0 * 100 * 30 * 50, 2.0 * (100 * 30 + 100 * 50 + 30 * 50))
