"""The port's sharding rules and spec factories against the reference's.

``repro_torch.distributed`` / ``launch.shardings`` on the port's
``AbstractMesh`` against ``repro.distributed`` / ``repro.launch.shardings``
on jax's, leaf for leaf on both production meshes: the parameter specs of
all ten archs (a port spec is the reference's without the leading Nones of
its stacked layer axes), the decode caches' and the batches' specs, the head
policies, and the dry run's cell list.  No process group is made here.
"""

import os

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from jax.tree_util import DictKey  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import distributed as RD  # noqa: E402
from repro.launch import shardings as RSH  # noqa: E402
from repro.models import kvcache as RKV  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.data.pipeline import make_batch_specs  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import SHAPES, shape_applicable  # noqa: E402
from repro_torch.models.kvcache import init_cache  # noqa: E402

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
FSDP_ARCHS = ("granite-20b", "granite-34b", "qwen3-moe-235b-a22b")  # as tests/test_distribution.py sets it


def _ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512 host
    devices: imported after this process's backend has started, with the
    variable restored, so nothing else here sees it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _rules(shape, names, fsdp=False):
    dp = tuple(n for n in names if n != "model")
    ref = RD.ShardingRules(mesh=JaxAbstractMesh(shape, names), dp_axes=dp, tp_axis="model", fsdp=fsdp)
    port = D.ShardingRules(mesh=D.AbstractMesh(shape, names), dp_axes=dp, tp_axis="model", fsdp=fsdp)
    return ref, port


def _ref_by_path(specs, shapes) -> dict:
    """{dict-key path: (spec entries, leaf ndim)} of a reference spec tree."""
    out = {}

    def visit(path, leaf, spec):
        keys = tuple(k.key for k in path if isinstance(k, DictKey))
        out.setdefault(keys, []).append((tuple(spec), leaf.ndim))

    jax.tree_util.tree_map_with_path(visit, shapes, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


def _port_by_path(specs, shapes) -> list:
    out = []
    SH.map_specs(lambda spec, leaf, keys: out.append((keys, tuple(spec), leaf.ndim)), specs, shapes,
                 SH.map_with_path(lambda keys, leaf: keys, shapes))
    return out


def _fake_params(cfg):
    with FakeTensorMode():
        return T.init_params(cfg, None, "cpu", param_dtype=torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_shape,names", MESHES)
def test_param_specs_match_the_reference(arch, mesh_shape, names):
    cfg = get_config(arch)
    ref_rules, rules = _rules(mesh_shape, names, fsdp=arch in FSDP_ARCHS)
    shapes = jax.eval_shape(lambda: RT.init_params(cfg, jax.random.PRNGKey(0)))
    ref = _ref_by_path(RSH.param_specs(cfg, ref_rules, shapes), shapes)
    params = _fake_params(cfg)
    port = _port_by_path(SH.param_specs(cfg, rules, params), params)
    assert {keys for keys, _, _ in port} == set(ref)
    for keys, spec, ndim in port:
        (ref_spec, ref_ndim), = set(ref[keys])
        lead = ref_ndim - ndim  # the reference's stacked layer axes
        assert ref_spec[:lead] == (None,) * lead and ref_spec[lead:] == spec, (keys, ref_spec, spec)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_shape,names", MESHES)
def test_cache_specs_match_the_reference(arch, mesh_shape, names):
    cfg = get_config(arch)
    shape = SHAPES["decode_32k"]
    ref_rules, rules = _rules(mesh_shape, names)
    ref_cache = RKV.init_cache(cfg, shape.global_batch, shape.seq_len, concrete=False)
    ref = _ref_by_path(RSH.cache_specs(cfg, ref_rules, ref_cache), ref_cache)
    # the reference nests the dense and ssm caches under "layers" (with a per-layer
    # "len" the port does not keep); the port's leaves sit at the top
    ref = {tuple(k for k in keys if k != "layers"): v for keys, v in ref.items() if keys != ("layers", "len")}
    with FakeTensorMode():
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, "cpu")
    port = _port_by_path(SH.cache_specs(cfg, rules, cache), cache)
    assert {keys for keys, _, _ in port} == set(ref)
    for keys, spec, ndim in port:
        assert set(ref[keys]) == {(spec, ndim)}, (keys, ref[keys], spec)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_shape,names", MESHES)
def test_batch_specs_match_the_reference(arch, shape_name, mesh_shape, names):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ref_rules, rules = _rules(mesh_shape, names)
    ref = RSH.batch_specs(cfg, ref_rules, _ref_dryrun()._batch_structs(cfg, shape))
    with FakeTensorMode():
        batch = {k: torch.empty(s) for k, (s, _) in make_batch_specs(cfg, shape).items()}
    port = SH.batch_specs(cfg, rules, batch)
    assert {k: tuple(v) for k, v in ref.items()} == {k: tuple(v) for k, v in port.items()}


def test_head_policies_match_the_reference():
    ref_rules, rules = _rules((16, 16), ("data", "model"))
    for arch in ("whisper-medium", "granite-20b", "qwen3-moe-235b-a22b", "qwen2-1.5b", "internlm2-1.8b",
                 "olmoe-1b-7b", "zamba2-2.7b"):
        cfg = get_config(arch)
        assert SH._head_policy(cfg, rules) == RSH._head_policy(cfg, ref_rules), arch
    assert SH._head_policy(get_config("granite-20b"), rules) == "q_sharded"
    assert SH._head_policy(get_config("qwen2-1.5b"), rules) == "replicated"


def test_rules_spec_and_sizes_match_the_reference():
    for shape, names in MESHES:
        for fsdp in (False, True):
            for sp in (False, True):
                ref = RD.for_mesh(JaxAbstractMesh(shape, names), fsdp=fsdp, seq_parallel=sp)
                port = D.for_mesh(D.AbstractMesh(shape, names), fsdp=fsdp, seq_parallel=sp)
                assert (port.dp_axes, port.tp_axis, port.dp_size, port.tp_size) == (
                    ref.dp_axes, ref.tp_axis, ref.dp_size, ref.tp_size)
                for logical in (("batch", None, "tp"), ("fsdp", "tp"), ("tp", "fsdp"), ("batch", "seq", None)):
                    assert tuple(port.spec(*logical)) == tuple(ref.spec(*logical))
                    assert (tuple(D.sanitize_spec(port, port.spec(*logical), (6, 32, 48)[:len(logical)]))
                            == tuple(RD.sanitize_spec(ref, ref.spec(*logical), (6, 32, 48)[:len(logical)])))


def test_to_placements_follows_the_spec():
    mesh = D.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert D.to_placements(mesh, D.P(("pod", "data"), None, "model"), 3) == (Shard(0), Shard(0), Shard(2))
    assert D.to_placements(mesh, D.P(None, "data"), 3) == (Replicate(), Shard(1), Replicate())
    assert D.to_placements(mesh, D.P(), 2) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        D.to_placements(mesh, D.P("model", "model"), 2)


def test_shard_is_the_identity_on_one_device():
    x = torch.arange(12.0).reshape(3, 4)
    assert D.shard(x, "batch", "tp") is x
    with D.use_rules(D.single_device_rules()):
        assert D.shard(x, "batch", "tp") is x
        assert D.local_call(lambda a: a * 2, [(x, D.P("data", "model"))], [D.P()]).equal(x * 2)
    assert D.single_device_rules().mesh.axis_names == ("data", "model")


def test_dryrun_cells_and_skips_match_the_reference():
    from repro_torch.launch import dryrun as DR

    RDR = _ref_dryrun()
    assert DR.FSDP_DEFAULT == RDR.FSDP_DEFAULT
    from repro.configs import ARCHS as REF_ARCHS
    from repro.models.config import SHAPES as REF_SHAPES, shape_applicable as ref_applicable

    assert list(ARCHS) == list(REF_ARCHS) and list(SHAPES) == list(REF_SHAPES)
    for arch in ARCHS:
        for name in SHAPES:
            cfg, shape = get_config(arch), SHAPES[name]
            ref_cfg = __import__("repro.configs", fromlist=["get_config"]).get_config(arch)
            assert shape_applicable(cfg, shape) == ref_applicable(ref_cfg, REF_SHAPES[name]), (arch, name)
            if shape_applicable(cfg, shape):
                assert DR.model_flops(cfg, shape) == RDR.model_flops(ref_cfg, REF_SHAPES[name])
                assert DR.cell_id(arch, name, "multi") == RDR.cell_id(arch, name, "multi")


@pytest.mark.parametrize("flag,need", [("--production-mesh", 256), ("--multi-pod", 512)])
def test_production_mesh_on_a_world_of_one_names_the_size_it_needs(flag, need):
    from repro_torch.launch import train

    argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--steps", "1", "--production-mesh"]
    if flag == "--multi-pod":
        argv.append(flag)
    with pytest.raises(ValueError, match=str(need)):
        train.main(argv)


def test_abstract_mesh_sizes():
    rules = D.ShardingRules(mesh=D.AbstractMesh((2, 16, 16), ("pod", "data", "model")), dp_axes=("pod", "data"))
    assert rules.dp_size == 32 and rules.tp_size == 16 and rules.size == 512
    assert rules.spec("batch", None, "tp") == D.P(("pod", "data"), None, "model")
    assert np.prod(list(D.axis_sizes(rules.mesh).values())) == 512
