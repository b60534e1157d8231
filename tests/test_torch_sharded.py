"""The port's sharded paths on four gloo ranks against the JAX reference on four host devices.

Two subprocesses (``tests/torch_sharded_cases.py``): the reference on a
(2, 2) mesh of forced host devices, then the port on four gloo ranks over a
(2, 2) ``"cpu"`` mesh, on the same seeded numpy inputs; neither leaves a
process group in this process.  At tp = 2 (dp = 2 for the compression):
``_q_sharded_core`` (reduced granite-20b, 4 heads, 1 kv head) and
``decode_seq_sharded`` within bf16's 2e-2 with the caches bitwise; the MoE
block (reduced olmoe-1b-7b, 4 experts a rank) with the same kept entries on
every (dp, tp) shard, y within 2e-2 and aux within 1e-6;
``compressed_psum_mean`` within 1e-6; reduced qwen2-1.5b and mamba2-780m
(ssm heads over tp) trained 3 steps from the reference's initial parameters,
losses and parameters within relative L2 2e-2 of the port on one device and
of the reference, the first step's gradients within ``GRAD_LEAF_TOL`` of one
device leaf by leaf and the parameters' change within ``DELTA_TOL`` (a planted
fault, gradients summed over dp where the mean is meant, must fail the
gradient bar on every leaf); and the ``Trainer``'s (2, 2) checkpoint
restored with ``shardings=`` onto a (4, 1) mesh and onto one device, bitwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch_sharded_cases import _cfg, unflatten  # noqa: E402

from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

HERE = Path(__file__).resolve().parent
CASES = HERE / "torch_sharded_cases.py"
BF16_TOL = 2e-2
TRAIN_TOL = 2e-2
# The sharded step's first gradients against one device's, relative L2 per
# leaf: the runs read at most 1.6e-2 (qwen2) and 2.1e-2 (mamba2, a 16-element
# leaf), bf16 partial sums in another order; a gradient off by a factor
# (psum for pmean, a dp size missed) or a partial sum left unreduced reads
# near 1.
GRAD_LEAF_TOL = 5e-2
# The parameters' change over the 3 steps, relative L2 of the whole vector:
# Adam's first steps move each element by about lr whatever its gradient's
# size, so tiny gradient differences flip small elements (the runs read 8.7e-2
# and 8.2e-2; per leaf up to 0.77); a wrong learning rate or a missed update
# reads near 1.
DELTA_TOL = 0.2


def _run(args, env):
    proc = subprocess.run([sys.executable, str(CASES), *args], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    env = {**os.environ, "PYTHONPATH": str(HERE.parent / "src"), "JAX_PLATFORMS": "cpu"}
    _run(["reference", str(tmp / "ref.npz")], {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    _run(["port", str(tmp / "ref.npz"), str(tmp / "port.npz"), str(tmp / "ckpt")], env)
    return dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz"))


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(np.asarray(b, np.float64)))


def _leaf_rels(port, arch, run, key) -> list[float]:
    """``run``'s ``key`` (grads, delta) against the one-device run's, per leaf."""
    splits = np.cumsum(port[f"train/{arch}/sizes"])[:-1]
    got = np.split(port[f"train/{arch}/{run}/{key}"], splits)
    want = np.split(port[f"train/{arch}/single/{key}"], splits)
    assert all(np.linalg.norm(w) > 0 for w in want)
    return [_rel(g, w) for g, w in zip(got, want)]


def test_q_sharded_core_matches_the_reference(results):
    ref, port = results
    assert port["q_sharded"].shape == ref["q_sharded"].shape
    assert _rel(port["q_sharded"], ref["q_sharded"]) <= BF16_TOL


def test_decode_seq_sharded_matches_the_reference(results):
    ref, port = results
    assert _rel(port["decode_o"], ref["decode_o"]) <= BF16_TOL
    np.testing.assert_array_equal(port["decode_k"], ref["decode_k"])
    np.testing.assert_array_equal(port["decode_v"], ref["decode_v"])
    assert bool(port["decode_in_place"])


def test_moe_keeps_the_references_entries_on_every_shard(results):
    ref, port = results
    for dp in range(2):
        # the top-k sets are not at a near tie, so both sides route alike
        assert ref[f"moe_margin_{dp}"].min() > 1e-4
        for tp in range(2):
            np.testing.assert_array_equal(port[f"moe_keep_{dp}_{tp}"], ref[f"moe_keep_{dp}_{tp}"])
    assert 0 < sum(port[f"moe_keep_{dp}_{tp}"].sum() for dp in range(2) for tp in range(2)) < 4 * 64


def test_moe_block_matches_the_reference(results):
    ref, port = results
    assert _rel(port["moe_y"], ref["moe_y"]) <= BF16_TOL
    assert abs(float(port["moe_aux"]) - float(ref["moe_aux"])) <= 1e-6


def test_compressed_psum_mean_matches_the_reference(results):
    ref, port = results
    for k in ("comp_a", "comp_b"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-780m"])
def test_three_sharded_steps_match_one_device_and_the_reference(results, arch):
    ref, port = results
    sharded, single = port[f"train/{arch}/sharded/losses"], port[f"train/{arch}/single/losses"]
    ref_losses = ref[f"train/{arch}/losses"]
    assert np.all(np.isfinite(sharded)) and sharded[-1] < sharded[0]
    assert _rel(sharded, single) <= TRAIN_TOL and _rel(sharded, ref_losses) <= TRAIN_TOL
    p_sharded, p_single = port[f"train/{arch}/sharded/params"], port[f"train/{arch}/single/params"]
    assert _rel(p_sharded, p_single) <= TRAIN_TOL
    # the reference's final parameters, in the port's tree and leaf order
    final = from_jax_params(unflatten(ref, f"train/{arch}/final"), _cfg(arch), "cpu", param_dtype=torch.float32)
    p_ref = np.concatenate([t.numpy().ravel() for t in tree_leaves(final)])
    assert _rel(p_sharded, p_ref) <= TRAIN_TOL
    assert max(_leaf_rels(port, arch, "sharded", "grads")) <= GRAD_LEAF_TOL
    delta = port[f"train/{arch}/sharded/delta"]
    assert _rel(delta, port[f"train/{arch}/single/delta"]) <= DELTA_TOL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-780m"])
def test_a_planted_gradient_fault_fails_the_per_leaf_bar(results, arch):
    _, port = results
    assert min(_leaf_rels(port, arch, "fault", "grads")) > GRAD_LEAF_TOL


@pytest.mark.parametrize("target", ["mesh41", "single"])
def test_the_2x2_checkpoint_restores_bitwise(results, target):
    _, port = results
    assert bool(port[f"restore/{target}/bitwise"])
    assert list(port["restore/steps"]) == [2]
    if target == "mesh41":
        assert str(port["restore/mesh41/placements"]) == "(Replicate(), Shard(dim=0))"
