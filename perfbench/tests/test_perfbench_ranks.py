"""The rank frame (``perfbench/ranks.py``) and the sharded training driver on the CPU: four gloo ranks.

A cell on four chips is added to a copy of the tree as files and entries
alone (a configuration, a ``train_mesh`` mix on a (2, 2) mesh with fsdp, a
limits file and a per-layer metric), and runs through ``harness.run_cell``
at reduced sizes; a step broken underneath makes it not correct; the
calibration's readings come back through the ranks; and a rank that raises
or hangs fails the run within the frame's limit, with every rank process
stopped and waited for.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from perfbench import harness, ranks
from perfbench.tests.conftest import ROOT
from perfbench.tests.test_perfbench_harness import LAST_LINE_KEYS, _digest, copy_tree, small_cell

CELL = "mamba2-780m-x4.train-4k-x4"
MIX = {"kind": "train_mesh", "mesh": [2, 2], "axes": ["data", "model"], "fsdp": True, "batch": 16, "seq": 4096,
       "tokens": "uniform", "setup_steps": 3}
LIMITS = {"grad_gap": 0.35, "change_gap": 0.25, "grad_median_gap": 0.004}
NCCL_READER = "def read(ctx):\n    nccl = ctx.get('nccl_s')\n    return 1e3 * sum(nccl.values()) if nccl else None\n"
#: a driver whose step returns its state unchanged, over train_mesh's frame
UNCHANGED_DRIVER = '''
from perfbench.drivers import train_mesh

SMALL, SMALL_KEEPS, FAULTS = train_mesh.SMALL, train_mesh.SMALL_KEEPS, train_mesh.FAULTS


def run_rank(cell, world):
    from repro_torch.train import steps

    real = steps.make_train_step

    def make_train_step(cfg, opt_cfg, *args, **kwargs):
        step = real(cfg, opt_cfg, *args, **kwargs)

        def unchanged(params, opt_state, batch):
            _, _, metrics = step(params, opt_state, batch)
            return params, opt_state, metrics

        return unchanged

    steps.make_train_step = make_train_step
    return train_mesh.run_rank(cell, world)
'''
#: a driver whose ranks step alone, each on its own block of rows, with nothing exchanged between them
NO_EXCHANGE_DRIVER = '''
import dataclasses

from perfbench.drivers import train_mesh
from repro_torch import distributed as D

SMALL, SMALL_KEEPS, FAULTS = train_mesh.SMALL, train_mesh.SMALL_KEEPS, train_mesh.FAULTS


def run_rank(cell, world):
    alone = dataclasses.replace(world, rules=D.for_mesh(D.AbstractMesh((1, 1), ("data", "model"))))
    program_step, first_steps = train_mesh.program_step, train_mesh.first_steps

    def own_block(cell, world):
        cfg, step, feed = program_step(cell, alone)
        block = cell.traffic["batch"] // world.size
        return cfg, step, lambda k: {key: v[world.rank * block:(world.rank + 1) * block] for key, v in feed(k).items()}

    train_mesh.program_step = own_block
    train_mesh.first_steps = lambda cell, world, *args: first_steps(cell, alone, *args)
    return train_mesh.run_rank(cell, world)
'''
#: a driver that returns the sharded reference's readings (``train_mesh.follow``)
FOLLOW_DRIVER = '''
from perfbench.drivers import train_mesh

SMALL, SMALL_KEEPS, FAULTS = train_mesh.SMALL, train_mesh.SMALL_KEEPS, train_mesh.FAULTS
run_rank = train_mesh.run_rank


def follow_rank(cell, world):
    return train_mesh.follow(cell, world)
'''
#: a driver whose rank 2 raises or hangs while the others wait for it in a collective
FAILING_DRIVER = '''
import time

SMALL = {}


def run_rank(cell, world):
    world.barrier()
    if world.rank == 2:
        if cell.traffic["fault"] == "raise":
            raise RuntimeError("rank 2 fails on purpose")
        time.sleep(3600)
    world.barrier()
    return {}
'''


def _four_chip_cell(tmp_path, kind: str = "train_mesh") -> tuple:
    """A copy of the tree with a four-chip cell added as files and entries: (root, BENCHMARK.json)."""
    here = copy_tree(tmp_path)
    config = json.loads((here / "configs/mamba2-780m.json").read_text())
    (here / "configs/mamba2-780m-x4.json").write_text(json.dumps({**config, "source": "copy for the test"}))
    (here / "traffic/train-4k-x4.json").write_text(json.dumps({**MIX, "kind": kind}))
    (here / f"limits/{CELL}.json").write_text(json.dumps(LIMITS))
    (here / "metrics/nccl_ms.train_mesh.py").write_text(NCCL_READER)
    planted = {"train_mesh_unchanged": UNCHANGED_DRIVER, "train_mesh_no_exchange": NO_EXCHANGE_DRIVER,
               "train_mesh_follow": FOLLOW_DRIVER}
    if kind in planted:
        (here / f"drivers/{kind}.py").write_text(planted[kind])
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mamba2-780m-x4", "source": "https://example.org/x",
                             "file": "perfbench/configs/mamba2-780m-x4.json", "reduced": config["reduced"],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "mamba2-780m-x4", "traffic": "train-4k-x4", "chips": 4,
                               "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "train_tok_s")["workloads"].append(CELL)
    bench["per_layer"].append({"name": "nccl_ms.train_mesh", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "collectives", "moves": "train_tok_s",
                               "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, bench


def test_a_four_chip_cell_added_as_files_runs_over_four_ranks_without_edits(tmp_path):
    root, bench = _four_chip_cell(tmp_path)
    before = _digest(ROOT)
    t0 = time.perf_counter()
    cell = small_cell(CELL, seed=2147483999, root=root)
    assert cell.chips == 4 and cell.traffic["kind"] == "train_mesh" and cell.traffic["seq"] == 64
    line, outcome = harness.run_cell(cell, bench)
    assert time.perf_counter() - t0 < 120
    assert list(line) == LAST_LINE_KEYS
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line["checks"]
    assert line["device"]["count"] == 4 and outcome["banned"] == []
    assert set(line["metrics"]) == {"train_tok_s", "setup_s"} and all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(LIMITS)
    assert harness.reader("nccl_ms.train_mesh", cell.here).read({"nccl_s": {"ncclDevKernel_AllGather": 0.002}}) == 2.0
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "perfbench/configs/mamba2-780m-x4.json", f"perfbench/limits/{CELL}.json",
        "perfbench/metrics/nccl_ms.train_mesh.py", "perfbench/traffic/train-4k-x4.json"]


def test_a_step_that_returns_its_state_unchanged_over_four_ranks_is_not_correct(tmp_path):
    root, bench = _four_chip_cell(tmp_path, kind="train_mesh_unchanged")
    line, _ = harness.run_cell(small_cell(CELL, seed=22, root=root), bench)
    assert line["correct"] is False
    assert line["checks"]["grad_gap"]["value"] == line["checks"]["change_gap"]["value"] == 1.0


def test_a_step_without_the_exchange_between_chips_over_four_ranks_is_not_correct(tmp_path):
    root, bench = _four_chip_cell(tmp_path, kind="train_mesh_no_exchange")
    line, _ = harness.run_cell(small_cell(CELL, seed=23, root=root), bench)
    assert line["correct"] is False, line["checks"]


def test_the_sharded_reference_reads_as_the_reference_in_one_process(tmp_path):
    """Blocks of rows summed onto each leaf's owner, the state split by leaf: the readings of
    ``train.follow`` over the whole batch, to rounding."""
    from perfbench.drivers import train

    root, _ = _four_chip_cell(tmp_path, kind="train_mesh_follow")
    cell = small_cell(CELL, seed=35, root=root)
    split = ranks.run(cell, "follow_rank")
    assert split.pop("banned") == []
    whole = train.follow(cell)
    assert list(split["grad"]) == list(whole["grad"]) and list(split["change"]) == list(whole["change"])
    for a, b in zip(split["loss"], whole["loss"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for key in ("grad", "change"):
        scale = max(whole[key].values())
        assert max(abs(split[key][k] - v) for k, v in whole[key].items()) <= 1e-4 * scale, key


def test_each_leaf_has_one_owner_and_the_ranks_share_the_elements():
    import torch

    from perfbench.drivers import train_mesh

    shapes = {f"l{i}": torch.empty(n) for i, n in enumerate([10, 9, 8, 7, 3, 3, 2, 1])}
    owner = train_mesh.owners(shapes, 4)
    load = [sum(shapes[k].numel() for k, r in owner.items() if r == rank) for rank in range(4)]
    assert set(owner) == set(shapes) and sorted(load) == [10, 11, 11, 11]  # the largest first, to the least kept
    assert owner == train_mesh.owners(dict(reversed(list(shapes.items()))), 4)  # the same on every rank


def test_the_calibrations_readings_come_through_the_ranks(tmp_path):
    from perfbench import calibrate

    root, _ = _four_chip_cell(tmp_path)
    readings = calibrate.readings(small_cell(CELL, seed=33, root=root), control=True)
    assert readings.pop("banned") == []
    for k in LIMITS:
        assert readings[k] <= LIMITS[k]
        for fault in ("control", "fault_half_batch", "fault_no_exchange", "fault_unchanged"):
            assert f"{fault}.{k}" in readings
    assert readings["fault_unchanged.grad_gap"] == readings["fault_unchanged.change_gap"] == 1.0
    assert readings["control.grad_median_gap"] > readings["grad_median_gap"]
    assert readings["fault_half_batch.grad_median_gap"] > readings["grad_median_gap"]
    assert readings["fault_no_exchange.grad_median_gap"] > readings["grad_median_gap"]


def test_the_blocks_are_summed_as_contiguous_tensors(monkeypatch):
    """NCCL refuses a tensor that is not contiguous, as the fp8 control's gradients of a transposed
    product are; gloo takes any, so the CPU runs would not show it.  The owner alone keeps the sum."""
    import torch
    import torch.distributed as dist

    from perfbench.drivers import train_mesh

    reduced = []

    def reduce(t, dst):
        assert t.is_contiguous()
        reduced.append(dst)
        t.mul_(2)  # two ranks holding the same block

    monkeypatch.setattr(dist, "reduce", reduce)
    world = ranks.World(rank=0, size=2, device=torch.device("cpu"), mesh=None, rules=None)
    g = torch.arange(12.0).reshape(3, 4)
    kept = {}
    for key, grad in (("w", g.t()), ("b", g[:, 0])):
        train_mesh.to_owner(world, key, grad, {"w": 0, "b": 1}, kept)
    assert reduced == [0, 1] and list(kept) == ["w"] and torch.equal(kept["w"], g.t())
    kept = {}
    train_mesh.to_owner(world, "w", g.t(), {"w": 0}, kept, exchange=False)
    assert reduced == [0, 1] and torch.equal(kept["w"], g.t())  # its own block's, nothing exchanged


def _gone(pid: int) -> bool:
    """No process ``pid``, or only its exit status left to collect."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("fault", ["raise", "hang"])
def test_a_rank_that_fails_stops_every_rank_within_the_limit(tmp_path, fault):
    here = copy_tree(tmp_path)
    (here / "drivers/failing.py").write_text(FAILING_DRIVER)
    cell = harness.Cell(name="failing", config_name="none", config={}, limits={}, seed=1, seconds=1.0, trace=False,
                        t_start=time.perf_counter(), device="cpu", here=here, chips=4,
                        traffic={"kind": "failing", "mesh": [2, 2], "axes": ["data", "model"], "fault": fault})
    limit = 20.0
    t0 = time.perf_counter()
    with pytest.raises(harness.RanksFailed) as failed:
        ranks.run(cell, limit_s=limit)
    took = time.perf_counter() - t0
    assert took < limit + 2 * ranks.STOP_GRACE_S
    if fault == "raise":
        assert "rank 2 failed" in str(failed.value) and "on purpose" in str(failed.value) and took < limit
    else:
        assert "did not finish within the frame's limit" in str(failed.value)
    assert len(failed.value.pids) == 4 and all(_gone(pid) for pid in failed.value.pids)


def test_a_mesh_that_does_not_fill_the_cells_chips_is_refused(tmp_path):
    root, _ = _four_chip_cell(tmp_path)
    cell = small_cell(CELL, root=root)
    cell.traffic = {**cell.traffic, "mesh": [2, 1]}
    with pytest.raises(ValueError, match="needs 2 chips"):
        ranks.run(cell)


def _spawned_children(pid: int) -> list[int]:
    """The processes that ``pid`` started with multiprocessing's spawn (its ranks)."""
    found = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                spawned = b"spawn_main" in f.read()
        except FileNotFoundError:
            continue
        if ppid == pid and spawned:
            found.append(int(entry))
    return found


def test_the_ranks_die_with_their_parent(tmp_path):
    """A parent killed outright (as a run's time limit kills it) leaves no rank behind."""
    here = copy_tree(tmp_path)
    (here / "drivers/failing.py").write_text(FAILING_DRIVER)
    script = (f"import sys, time; sys.path[:0] = [{str(tmp_path / 'src')!r}, {str(tmp_path)!r}]\n"
              "from perfbench import harness, ranks\n"
              "cell = harness.Cell(name='failing', config_name='none', config={}, limits={}, seed=1, seconds=1.0, "
              "trace=False, t_start=time.perf_counter(), device='cpu', "
              f"here=harness.Path({str(here)!r}), chips=4, "
              "traffic={'kind': 'failing', 'mesh': [2, 2], 'axes': ['data', 'model'], 'fault': 'hang'})\n"
              "if __name__ == '__main__':\n    ranks.run(cell, limit_s=600)\n")
    (tmp_path / "parent.py").write_text(script)
    parent = subprocess.Popen([sys.executable, str(tmp_path / "parent.py")], cwd=tmp_path)
    try:
        deadline = time.monotonic() + 60
        while len(ranks_seen := _spawned_children(parent.pid)) < 4:
            assert time.monotonic() < deadline and parent.poll() is None, ranks_seen
            time.sleep(0.5)
    finally:
        os.kill(parent.pid, signal.SIGKILL)
        parent.wait(timeout=30)
    deadline = time.monotonic() + 30
    while not all(_gone(pid) for pid in ranks_seen):
        assert time.monotonic() < deadline, [pid for pid in ranks_seen if not _gone(pid)]
        time.sleep(0.5)
