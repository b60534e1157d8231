"""The port's estimation pipeline against the reference's, on the CPU.

``Campaign.run`` -> ``PerfOracle.predict`` / ``predict_network_batch`` of
``repro_torch.api`` on the ``torch_device`` platform, held against ``repro.api``
on ``xla_cpu``.  Both platforms' synthetic modes are the same deterministic
tile-quantised model, so whole campaigns compare bit for bit.

Parity bars (the reference's own, ``repro/core/jax_predict.py``): layer
predictions bitwise; networks bitwise when no estimator has a log target,
rtol 1e-12 otherwise (``torch.exp`` against ``np.exp``).

The reference's jax backend imports ``jax.experimental.enable_x64``, which
this jax no longer has; without it the reference quietly serves numpy.  The
``jax_backend`` fixture hands it ``jax.enable_x64`` instead, so the
comparisons with "jax" below run the reference's compiled programs.
"""

import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import jax_predict  # noqa: E402
from repro.core.blocks import Block as JBlock  # noqa: E402
from repro.core.blocks import FusingModel as JFusing  # noqa: E402
from repro.core.forest import RandomForestRegressor as JForest  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.accelerators.torch_device import TorchDevicePlatform  # noqa: E402
from repro_torch.core import torch_predict  # noqa: E402
from repro_torch.core.blocks import Block as TBlock  # noqa: E402
from repro_torch.core.blocks import FusingModel as TFusing  # noqa: E402
from repro_torch.core.forest import RandomForestRegressor as TForest  # noqa: E402
from repro_torch.core.forest import _Tree as TTree  # noqa: E402
from repro_torch.obs.metrics import metrics as tmetrics  # noqa: E402

CPU = torch.device("cpu")
SAMPLINGS = ("pr", "random", "random_pr")
NET_RTOL = 1e-12


@pytest.fixture
def jax_backend(monkeypatch):
    if jax_predict.jax_modules() is None:
        import jax
        import jax.numpy as jnp
        from jax import lax

        monkeypatch.setattr(jax_predict, "_modules_cache", (jax, jnp, lax, jax.enable_x64))
    assert jax_predict.resolve_backend("jax") == "jax"


def _recording(platform):
    """Record every ``measure_batch`` call that reaches ``platform``."""
    calls = []
    inner = platform.measure_batch

    def measure_batch(layer_type, batch):
        y = inner(layer_type, batch)
        calls.append((layer_type, batch.params, batch.matrix(batch.params), np.array(y)))
        return y

    platform.measure_batch = measure_batch
    return calls


def _run_pair(sampling, n_samples=150, hub_dirs=(None, None)):
    ref_platform = japi.get_platform("xla_cpu", synthetic=True)
    port_platform = tapi.get_platform("torch_device", synthetic=True, device="cpu")
    ref_calls, port_calls = _recording(ref_platform), _recording(port_platform)
    common = dict(layer_types=("dense",), n_samples=n_samples, seed=0, sampling=sampling)
    ref = japi.Campaign(
        japi.CampaignSpec(platform="xla_cpu", platform_kwargs={"synthetic": True},
                          hub_dir=hub_dirs[0], **common),
        platform=ref_platform,
    )
    port = tapi.Campaign(
        tapi.CampaignSpec(platform="torch_device",
                          platform_kwargs={"synthetic": True, "device": "cpu"},
                          hub_dir=hub_dirs[1], **common),
        platform=port_platform,
    )
    return {
        "ref": ref, "port": port, "ref_oracle": ref.run(), "port_oracle": port.run(device="cpu"),
        "ref_calls": ref_calls, "port_calls": port_calls,
    }


@pytest.fixture(scope="module", params=SAMPLINGS)
def campaigns(request):
    return _run_pair(request.param)


def _held_out(n=200, seed=1, space=((16, 256), (32, 768), (32, 768))):
    rng = np.random.default_rng(seed)
    return [
        {p: int(rng.integers(lo, hi + 1)) for p, (lo, hi) in zip(("tokens", "d_in", "d_out"), space)}
        for _ in range(n)
    ]


# ---------------------------------------------------------------- campaigns
def test_the_platform_is_registered_and_the_spec_builds_it():
    assert tapi.list_platforms() == ("torch_device", "tpu_v5e", "ultratrail", "vta")
    p = tapi.Campaign(tapi.CampaignSpec(
        platform="torch_device", platform_kwargs={"synthetic": True, "device": "cpu"})).platform
    assert isinstance(p.inner, TorchDevicePlatform) and p.knowledge == "black"


def test_synthetic_campaign_discovers_the_reference_widths(campaigns):
    ref, port = campaigns["ref_oracle"], campaigns["port_oracle"]
    assert dict(port.estimators["dense"].widths) == dict(ref.estimators["dense"].widths)
    assert port.estimators["dense"].n_sweep == ref.estimators["dense"].n_sweep


def test_synthetic_campaign_counts_equal_the_reference(campaigns):
    def counts(c):
        return {k: v for k, v in c.stats().items() if not k.endswith("seconds")}

    assert counts(campaigns["port"]) == counts(campaigns["ref"])
    assert counts(campaigns["port"])["unique_measurements"] > 0


def test_synthetic_measure_batch_is_bitwise_on_the_sweep_and_sample_batches(campaigns):
    ref, port = campaigns["ref_calls"], campaigns["port_calls"]
    assert len(port) == len(ref) >= 1
    for (lt, params, m, y), (jlt, jparams, jm, jy) in zip(port, ref):
        assert (lt, params) == (jlt, jparams)
        np.testing.assert_array_equal(m, jm)
        assert y.tobytes() == jy.tobytes()


def test_synthetic_predictions_are_bitwise_under_both_backends(campaigns, jax_backend):
    ref, port = campaigns["ref_oracle"], campaigns["port_oracle"]
    cfgs = _held_out()
    expect = ref.predict("dense", cfgs, backend="numpy")
    assert ref.predict("dense", cfgs, backend="jax").tobytes() == expect.tobytes()
    assert port.predict("dense", cfgs, backend="numpy").tobytes() == expect.tobytes()
    assert port.predict("dense", cfgs).tobytes() == expect.tobytes()  # "torch" on the CPU
    assert port.predict_backend is None and port.device == "cpu"


# ---------------------------------------------------------------- forests
def _port_forest(jforest):
    forest = TForest(n_estimators=jforest.n_estimators, seed=jforest.seed)
    forest._trees = [TTree(t.feature, t.threshold, t.left, t.right, t.value) for t in jforest._trees]
    return forest


def _fit(layer_type, ranges, widths, log_target, times, seed):
    from repro.core.estimator import LayerEstimator
    from repro.core.prs import ParamSpace

    est = LayerEstimator(
        layer_type=layer_type, params=tuple(ranges), widths=widths,
        space=ParamSpace(ranges=ranges), forest=JForest(n_estimators=16, seed=seed),
        log_target=log_target,
    )
    rng = np.random.default_rng(seed)
    cfgs = [{p: int(rng.integers(lo, hi + 1)) for p, (lo, hi) in ranges.items()} for _ in range(300)]
    y = np.array([times(c) for c in cfgs])
    est.forest.fit(est._features(cfgs), np.log(y) if log_target else y)
    return est


@pytest.fixture(scope="module")
def estimators():
    """Dense estimators (log target from a reference campaign, plain on raw
    times) and embed ones, so that networks mix groups and log flags."""
    dense = japi.get_platform("xla_cpu", synthetic=True)
    dense_ranges = {"tokens": (16, 256), "d_in": (32, 768), "d_out": (32, 768)}
    embed_ranges = {"tokens": (16, 256), "d_model": (32, 768)}

    def embed_time(c):
        return 1e-6 + math.ceil(c["tokens"] / 8) * math.ceil(c["d_model"] / 64) * 3e-9

    def fit(layer_type, log_target, seed):
        if layer_type == "dense":
            return _fit("dense", dense_ranges, {"tokens": 8, "d_in": 64, "d_out": 64},
                        log_target, lambda c: dense.measure("dense", c), seed)
        return _fit("embed", embed_ranges, {"tokens": 8, "d_model": 64}, log_target, embed_time, seed)

    return {
        "dense_log": _run_pair("pr")["ref_oracle"].estimators["dense"],
        "dense_plain": fit("dense", False, 3),
        "embed_log": fit("embed", True, 4),
        "embed_plain": fit("embed", False, 5),
    }


def _to_port(jest):
    from repro_torch.core.estimator import LayerEstimator
    from repro_torch.core.prs import ParamSpace

    space = ParamSpace(ranges=dict(jest.space.ranges), fixed=dict(jest.space.fixed))
    return LayerEstimator(
        layer_type=jest.layer_type, params=tuple(jest.params), widths=dict(jest.widths),
        space=space, forest=_port_forest(jest.forest), log_target=jest.log_target,
    )


@pytest.mark.parametrize("kind", ["dense_log", "dense_plain"])
@pytest.mark.parametrize("n", [1, 64, 257])
def test_forest_traversal_is_bitwise_with_numpy_and_jax(estimators, kind, n, jax_backend):
    jest = estimators[kind]
    X = jest._features(_held_out(n, seed=n), snap=(n != 64))
    expect = jest.forest.predict(X, backend="numpy")
    assert jax_predict.forest_predict_raw(jest.forest, X).tobytes() == expect.tobytes()
    forest = _port_forest(jest.forest)
    assert forest.predict(X, backend="numpy").tobytes() == expect.tobytes()
    before = tmetrics().counter("torch.forest.calls").value
    assert torch_predict.forest_predict_raw(forest, X, CPU).tobytes() == expect.tobytes()
    assert forest.predict(X, backend=CPU).tobytes() == expect.tobytes()
    assert tmetrics().counter("torch.forest.calls").value == before + 2
    # the estimator level: np.exp on the host for the log target
    cfgs = _held_out(n, seed=n)
    est = _to_port(jest)
    assert est.predict(cfgs, backend=CPU).tobytes() == jest.predict(cfgs, backend="numpy").tobytes()


def test_forest_engine_is_uploaded_once_and_retired_on_refit(estimators):
    forest = _port_forest(estimators["dense_plain"].forest)
    X = estimators["dense_plain"]._features(_held_out(8))
    forest.predict(X, backend=CPU)
    engine = torch_predict._engine(forest, CPU)
    forest.predict(X, backend=CPU)
    assert torch_predict._engine(forest, CPU) is engine
    assert engine.depth == max(_tree_depth(t) for t in forest._trees)
    forest._trees = forest._trees[:4]
    assert torch_predict._engine(forest, CPU) is not engine


def _tree_depth(tree, node=0):
    if tree.feature[node] < 0:
        return 0
    return 1 + max(_tree_depth(tree, tree.left[node]), _tree_depth(tree, tree.right[node]))


# ---------------------------------------------------------------- networks
def _networks(Block):
    def dense(t, i, o):
        return ("dense", {"tokens": t, "d_in": i, "d_out": o})

    def embed(t, d):
        return ("embed", {"tokens": t, "d_model": d})

    mlp = Block("mlp", (dense(64, 256, 704), embed(64, 700)), repeat=3)
    attn = Block("attn", (dense(64, 256, 768), embed(64, 256), dense(33, 100, 40)))
    head = Block("head", (embed(17, 500),), repeat=2)
    mixed = Block("mlp", (dense(200, 700, 90),))
    return [
        [mlp, attn, head],
        [attn],
        [head, mlp, mlp, mixed],
        [Block("plain", (dense(16, 32, 32), dense(256, 768, 768))), head],
    ]


def _oracles(estimators, types):
    fusing = {"mlp": (2.5e-13, 1e-7)}
    common = dict(overlap_kinds=frozenset({"attn"}), launch_overhead_s=3e-6, platform_name="syn")
    ref = japi.PerfOracle(
        estimators={lt: estimators[k] for lt, k in types.items()},
        fusing={kd: JFusing(w=w, c=c) for kd, (w, c) in fusing.items()}, **common)
    port = tapi.PerfOracle(
        estimators={lt: _to_port(estimators[k]) for lt, k in types.items()},
        fusing={kd: TFusing(w=w, c=c) for kd, (w, c) in fusing.items()}, device="cpu", **common)
    return ref, port


@pytest.mark.parametrize("types,bitwise", [
    ({"dense": "dense_plain", "embed": "embed_plain"}, True),
    ({"dense": "dense_log", "embed": "embed_plain"}, False),
    ({"dense": "dense_plain", "embed": "embed_log"}, False),
    ({"dense": "dense_log", "embed": "embed_log"}, False),
])
def test_network_predictions_hold_the_reference_bars(estimators, types, bitwise, jax_backend):
    ref, port = _oracles(estimators, types)
    jnets, tnets = _networks(JBlock), _networks(TBlock)
    expect = ref.predict_networks(jnets, backend="numpy")
    assert port.predict_networks(tnets, backend="numpy").tobytes() == expect.tobytes()
    before = tmetrics().counter("torch.network.calls").value
    got = port.predict_networks(tnets)
    assert tmetrics().counter("torch.network.calls").value == before + 1
    jax_got = ref.predict_networks(jnets, backend="jax")
    if bitwise:
        assert got.tobytes() == expect.tobytes()
        assert jax_got.tobytes() == expect.tobytes()
    else:
        np.testing.assert_allclose(got, expect, rtol=NET_RTOL, atol=0)
    for net, t in zip(tnets, got):
        np.testing.assert_allclose(port.predict_network(net), t, rtol=NET_RTOL, atol=0)


def test_network_batch_with_an_empty_block_takes_the_numpy_semantics(estimators):
    ref, port = _oracles(estimators, {"dense": "dense_log", "embed": "embed_plain"})
    jnets, tnets = _networks(JBlock), _networks(TBlock)
    jnets[1].append(JBlock("plain", ()))
    tnets[1].append(TBlock("plain", ()))
    expect = ref.predict_networks(jnets, backend="numpy")
    np.testing.assert_allclose(port.predict_networks(tnets), expect, rtol=NET_RTOL, atol=0)
    with pytest.raises(ValueError, match="overlap block with zero layers"):
        port.predict_networks([[TBlock("attn", ())]])


def test_predict_network_batch_takes_explicit_net_ids(estimators):
    ref, port = _oracles(estimators, {"dense": "dense_plain", "embed": "embed_plain"})
    jb = japi.BlockBatch.from_blocks([b for net in _networks(JBlock) for b in net])
    tb = tapi.BlockBatch.from_blocks([b for net in _networks(TBlock) for b in net])
    net_id = np.array([0, 2, 2, 1, 0, 2, 1, 1, 0, 2])
    expect = ref.predict_network_batch(jb, net_id, 3, backend="numpy")
    got = port.predict_network_batch(tb, net_id, 3)
    assert got.shape == (3,) and got.tobytes() == expect.tobytes()


# ---------------------------------------------------------------- wall clock
def test_wallclock_on_the_cpu_gives_positive_finite_times():
    plat = TorchDevicePlatform(device="cpu", repeats=3)
    cfgs = [{"tokens": 16, "d_in": 32, "d_out": 40}, {"tokens": 64, "d_in": 256, "d_out": 256},
            {"tokens": 16, "d_in": 32, "d_out": 40}]
    y = plat.measure_many("dense", cfgs)
    assert y.shape == (3,) and np.all(np.isfinite(y)) and np.all(y > 0)
    assert y[0] == y[2]  # one timing per unique row
    assert plat.cache_key() == "torch_device|device=cpu|dtype=float32|repeats=3"
    assert plat.param_space("dense").ranges == {"tokens": (16, 256), "d_in": (32, 768), "d_out": (32, 768)}
    bf16 = TorchDevicePlatform(device="cpu", repeats=1, dtype=torch.bfloat16)
    assert bf16.dtype == "bfloat16" and math.isfinite(bf16.measure("dense", cfgs[0]))


def test_wallclock_keeps_fp32_true_and_restores_the_flag(monkeypatch):
    seen = []
    real = torch.matmul

    def matmul(a, b, out=None):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b, out=out)

    monkeypatch.setattr(torch, "matmul", matmul)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    TorchDevicePlatform(device="cpu", repeats=2).measure("dense", {"tokens": 16, "d_in": 32, "d_out": 32})
    assert seen and not any(seen)
    assert len(seen) == 1 + 2 * 10  # one warm-up, then 10 launches a sample
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_the_card_space_is_sized_for_the_h100(monkeypatch):
    monkeypatch.setattr(TorchDevicePlatform, "_on_card", lambda self: True)
    plat = TorchDevicePlatform(device="cpu")
    assert plat.param_space("dense").ranges == {
        "tokens": (16, 4096), "d_in": (64, 8192), "d_out": (64, 8192)}
    assert plat.defaults("dense") == {"tokens": 1024, "d_in": 2048, "d_out": 2048}
    with pytest.raises(ValueError, match="dense"):
        plat.param_space("conv1d")


# ---------------------------------------------------------------- no card
def test_without_a_card_the_entry_points_raise(monkeypatch, estimators):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDevicePlatform()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Campaign(tapi.CampaignSpec(platform="torch_device"))
    oracle = tapi.PerfOracle(estimators={"dense": _to_port(estimators["dense_log"])})
    cfgs = _held_out(4)
    for backend in (None, "torch"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            oracle.predict("dense", cfgs, backend=backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dataclasses.replace(oracle, predict_backend="torch").predict_networks(_networks(TBlock)[:1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        oracle.estimators["dense"].predict(cfgs)
    with pytest.raises(ValueError, match="unknown predict backend"):
        oracle.predict("dense", cfgs, backend="jax")
    # numpy is chosen, never fallen back to
    expect = estimators["dense_log"].predict(cfgs, backend="numpy")
    assert oracle.predict("dense", cfgs, backend="numpy").tobytes() == expect.tobytes()


# ---------------------------------------------------------------- unported
def test_paths_that_reach_the_runtime_raise(tmp_path):
    """The runtime's paths run (they raised until the runtime was ported):
    every stage takes a runtime and stamps its stats, a session attaches the
    runtime to the cached platform for its span only, and ``gc`` compacts a
    hub's journal.  Restoring onto a mesh still raises (ROADMAP.md, queue 1,
    item 5)."""
    from repro_torch.checkpoint.manager import CheckpointManager, journal_path

    hub = tapi.EstimatorHub(str(tmp_path / "hub"))
    campaign = tapi.Campaign(tapi.CampaignSpec(
        platform="torch_device", platform_kwargs={"synthetic": True, "device": "cpu"},
        n_samples=20, hub_dir=hub.directory))
    campaign.run(runtime=tapi.RuntimeSpec(workers=1), device="cpu")
    assert campaign.last_run_stats["measured"] > 0
    assert campaign.calibrate_fusing({}, runtime=tapi.RuntimeSpec(workers=1)) == {}
    assert campaign.last_run_stats["measured"] == 0
    with campaign.runtime_session(tapi.RuntimeSpec(workers=1, journal_path="")) as rt:
        assert isinstance(rt, tapi.MeasurementRuntime) and campaign.platform.runtime is rt
    assert campaign.platform.runtime is None
    assert os.path.getsize(journal_path(hub.directory)) > 0
    gc = hub.gc()
    assert gc["journal"]["records_in"] >= gc["journal"]["records_out"] > 0
    assert hub.gc(compact_journal=False)["journal"] is None
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"w": torch.arange(4.0), "b": np.ones(2)})
    tree, step = mgr.restore({"w": None, "b": None})
    assert step == 1 and tree["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mgr.restore({"w": None, "b": None}, shardings={"w": None, "b": None})


def test_the_api_exports_the_reference_surface_but_the_runtime():
    """The runtime's names too, now that it is ported: the whole surface."""
    assert set(tapi.__all__) == set(japi.__all__)
    assert all(hasattr(tapi, name) for name in tapi.__all__)


# ---------------------------------------------------------------- hubs
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_hubs_cross_over_between_the_packages(tmp_path, writer):
    hub_dir = str(tmp_path / "hub")
    run = _run_pair("pr", n_samples=60,
                    hub_dirs=(hub_dir, None) if writer == "reference" else (None, hub_dir))
    cfgs = _held_out(100, seed=11)
    if writer == "reference":
        name = "xla_cpu"
        expect = run["ref_oracle"].predict("dense", cfgs, backend="numpy")
        loaded = tapi.PerfOracle.load(tapi.EstimatorHub(hub_dir), name, device="cpu")
        got = [loaded.predict("dense", cfgs), loaded.predict("dense", cfgs, backend="numpy")]
    else:
        name = "torch_device"
        expect = run["port_oracle"].predict("dense", cfgs, backend="numpy")
        loaded = japi.PerfOracle.load(japi.EstimatorHub(hub_dir), name)
        got = [loaded.predict("dense", cfgs, backend="numpy")]
    assert loaded.platform_name == name
    for y in got:
        assert y.tobytes() == expect.tobytes()
