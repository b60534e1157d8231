"""The sharded checkpoint's save on four gloo ranks (``CheckpointManager.save``).

A subprocess runs this file as a script: four gloo ranks over a (2, 2)
``"cpu"`` mesh place reduced qwen2-1.5b's training state (fp32 masters with
fsdp, AdamW's moments as shards) and a bf16 leaf by their specs and save
them, with ``checkpoint.manager._to_host`` wrapped to count, per rank, the
leaves it was called for and the host arrays it returned.  The test holds:
every rank joins every leaf's gather, ranks other than 0 keep no gathered
array, and the written files equal those of an unsharded save of the same
tree in this process (``manifest.json`` and every member of ``arrays.npz``
byte for byte; the zip's own timestamps are the clock's).
"""

import json
import os
import socket
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
STEP = 7


def _tree(mesh=None) -> dict:
    """Reduced qwen2-1.5b's fp32 parameters, AdamW state and a bf16 leaf;
    placed by their specs on ``mesh`` (fsdp) when one is given."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.optim.adamw import adamw_init, tree_map

    cfg = reduced(get_config("qwen2-1.5b"))

    def make_params():
        return T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", param_dtype=torch.float32)

    if mesh is None:
        params = make_params()
        opt = adamw_init(params)
    else:
        params, opt = SH.distribute_train_state(cfg, D.for_mesh(mesh, fsdp=True), make_params)
    # moments that are not all zero, as after a step
    opt = {**opt, "m": tree_map(lambda p: p * 0.5, params), "v": tree_map(lambda p: p * p, params)}
    served = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")["embed"]  # bf16: ``|V2`` words
    if mesh is not None:
        served = distribute_tensor(served, mesh, D.to_placements(mesh, D.P("model", "data"), 2))
    return {"params": params, "opt": opt, "served": served}


def _worker(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager
    from repro_torch.optim.adamw import tree_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
    try:
        tree = _tree(init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")))
        seen = {"calls": 0, "kept": 0}
        to_host = manager._to_host

        def counting(v, keep=True):
            a = to_host(v, keep)
            seen["calls"] += 1
            seen["kept"] += a is not None
            return a

        manager._to_host = counting
        try:
            CheckpointManager(os.path.join(out, "sharded")).save(STEP, tree)
        finally:
            manager._to_host = to_host
        leaves = tree_leaves(tree)
        seen.update(leaves=len(leaves), sharded=sum(type(t).__name__ == "DTensor" for t in leaves))
        every = [None] * 4
        dist.all_gather_object(every, seen)
        if rank == 0:
            with open(os.path.join(out, "counts.json"), "w") as f:
                json.dump(every, f)
    finally:
        dist.barrier()
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    from repro_torch.checkpoint import CheckpointManager

    tmp = tmp_path_factory.mktemp("ckpt")
    proc = subprocess.run([sys.executable, __file__, str(tmp)], capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    CheckpointManager(str(tmp / "single")).save(STEP, _tree())
    with open(tmp / "counts.json") as f:
        return tmp, json.load(f)


def _files(directory: Path) -> tuple[bytes, dict]:
    step = directory / f"step_{STEP:09d}"
    with zipfile.ZipFile(step / "arrays.npz") as z:
        members = {name: z.read(name) for name in z.namelist()}
    return (step / "manifest.json").read_bytes(), members


def test_every_rank_joins_every_leafs_gather(saved):
    _, counts = saved
    assert all(c["calls"] == c["leaves"] for c in counts)
    assert all(c["sharded"] > c["leaves"] // 2 for c in counts)  # most leaves are shards


def test_ranks_other_than_0_keep_no_gathered_array(saved):
    _, counts = saved
    assert counts[0]["kept"] == counts[0]["leaves"]
    assert [c["kept"] for c in counts[1:]] == [0, 0, 0]


def test_the_manifest_equals_an_unsharded_saves(saved):
    tmp, _ = saved
    assert _files(tmp / "sharded")[0] == _files(tmp / "single")[0]


def test_every_array_equals_an_unsharded_saves_byte_for_byte(saved):
    tmp, _ = saved
    sharded, single = _files(tmp / "sharded")[1], _files(tmp / "single")[1]
    assert list(sharded) == list(single) and "served.npy" in sharded
    assert all(sharded[name] == single[name] for name in single)


def test_the_sharded_save_restores_the_whole_tree(saved):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim.adamw import tree_leaves

    tmp, _ = saved
    want = _tree()
    got, step = CheckpointManager(str(tmp / "sharded")).restore(want)
    assert step == STEP and got["served"].dtype == torch.bfloat16
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(torch.as_tensor(g).float()), w.float().numpy())


if __name__ == "__main__":
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        free = s.getsockname()[1]
    mp.spawn(_worker, args=(free, sys.argv[1]), nprocs=4, join=True)
