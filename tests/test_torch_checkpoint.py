"""The port's checkpoints of bf16 tensors against the reference's, on the CPU.

numpy has no bfloat16, so the reference's ``np.savez`` stores a jax bf16
leaf as raw 2-byte words (npz dtype ``|V2``).  The port writes a bf16 tensor
as the same words with the same dtype, so a file from either package reads
the same in the other, and restores a bf16 tensor where the skeleton holds
one.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402


def _values():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 5)) * 4).astype(np.float32)
    w[0, :3] = [np.inf, -0.0, 1e-40]  # inf, a signed zero and a subnormal keep their bits
    return {"w": w, "b": rng.standard_normal(4).astype(np.float32), "step": np.int64(7)}


def _trees():
    v = _values()
    port = {"layers": [{"w": torch.from_numpy(v["w"]).bfloat16()}], "b": torch.from_numpy(v["b"]),
            "step": v["step"]}
    ref = {"layers": [{"w": jnp.asarray(v["w"], jnp.bfloat16)}], "b": v["b"], "step": v["step"]}
    return port, ref


def test_bf16_tree_saves_as_the_reference_saves_it(tmp_path):
    port, ref = _trees()
    p_dir = CheckpointManager(str(tmp_path / "port")).save(3, port)
    r_dir = JCheckpointManager(str(tmp_path / "ref")).save(3, ref)
    with np.load(os.path.join(p_dir, "arrays.npz")) as zp, np.load(os.path.join(r_dir, "arrays.npz")) as zr:
        assert sorted(zp.files) == sorted(zr.files) == ["b", "layers/0/w", "step"]
        for k in zp.files:
            assert zp[k].dtype == zr[k].dtype, k
            assert zp[k].shape == zr[k].shape, k
            assert zp[k].tobytes() == zr[k].tobytes(), k
        assert zp["layers/0/w"].dtype.str == "|V2"
    with open(os.path.join(p_dir, "manifest.json")) as f, open(os.path.join(r_dir, "manifest.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_round_trip_is_bitwise(tmp_path, writer):
    port, ref = _trees()
    if writer == "port":
        CheckpointManager(str(tmp_path)).save(1, port)
    else:
        JCheckpointManager(str(tmp_path)).save(1, ref)
    skeleton = {"layers": [{"w": torch.zeros((3, 5), dtype=torch.bfloat16)}], "b": None, "step": None}
    tree, step = CheckpointManager(str(tmp_path)).restore(skeleton)
    assert step == 1
    w = tree["layers"][0]["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16 and w.shape == (3, 5)
    want = port["layers"][0]["w"]
    assert torch.equal(w.view(torch.int16), want.view(torch.int16))
    # every other leaf keeps the stored numpy array
    assert isinstance(tree["b"], np.ndarray) and tree["b"].dtype == np.float32
    np.testing.assert_array_equal(tree["b"], port["b"].numpy())
    assert tree["step"] == 7


def test_restore_without_a_bf16_skeleton_keeps_the_raw_words(tmp_path):
    port, _ = _trees()
    CheckpointManager(str(tmp_path)).save(1, port)
    tree, _ = CheckpointManager(str(tmp_path)).restore({"layers": [{"w": None}], "b": None, "step": None})
    assert tree["layers"][0]["w"].dtype.str == "|V2"
