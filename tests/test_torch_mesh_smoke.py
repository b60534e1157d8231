"""``mesh_smoke.py --device cpu``: part (a) at reduced sizes on four gloo ranks, in a subprocess.

The script's JSON lines are held against the bars of
``tests/test_torch_sharded.py`` once more here (the script fails on them
too): the sharded cores, the MoE block, the compressed all-reduce, three
sharded training steps of reduced mamba2-780m and qwen2-1.5b against one
device, and the flash-route prefill.  On the CPU every kernel wrapper runs
its plain version, so each call on a shard matches it exactly and no kernel
launches.  The script imports neither JAX nor the JAX package (its own
report of every rank's modules, and its source and ``chip_smoke.py``'s),
and without four cards it refuses to run and prints no result.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "mesh_smoke.py"
BF16_REL_L2, TRAIN_TOL, GRAD_LEAF_TOL, DELTA_TOL, AUX_TOL = 2e-2, 2e-2, 5e-2, 0.2, 1e-6
NO_KERNEL = {"flash_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


@pytest.fixture(scope="module")
def lines():
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def _item(lines, item: str, arch: str | None = None) -> dict:
    found = [line["a"] for line in lines if "a" in line and line["a"]["item"] == item
             and (arch is None or line["a"]["arch"] == arch)]
    assert len(found) == 1, found
    return found[0]


def test_the_run_ends_with_its_result_line(lines):
    assert lines[-1] == {"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 4}}


def test_the_sharded_cores_match_one_device(lines):
    cores = _item(lines, "cores")
    assert cores["q_sharded_rel_l2"] <= BF16_REL_L2 and cores["decode_rel_l2"] <= BF16_REL_L2
    assert cores["caches_bitwise"] and cores["decode_in_place"]


def test_the_moe_keeps_one_devices_entries_on_every_shard(lines):
    moe = _item(lines, "moe")
    assert moe["kept_equal_per_shard"] == [True] * 4 and 0 < moe["kept_entries"] < moe["entries"]
    assert moe["min_topk_margin"] > 1e-4  # no near tie: both sides route alike
    assert moe["y_rel_l2"] <= BF16_REL_L2 and moe["aux_abs_err"] <= AUX_TOL


def test_the_compressed_all_reduce_is_exact(lines):
    assert _item(lines, "compressed_psum_mean")["exact"]


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2-1.5b"])
def test_three_sharded_steps_match_one_device(lines, arch):
    t = _item(lines, "train", arch)
    assert t["losses"][-1] < t["losses"][0] and t["fsdp"]
    assert t["loss_rel_l2"] <= TRAIN_TOL and t["params_rel_l2"] <= TRAIN_TOL
    assert t["max_grad_leaf_rel_l2"] <= GRAD_LEAF_TOL and t["grad_norms_positive"]
    assert t["delta_rel_l2"] <= DELTA_TOL
    assert t["launches_per_rank"] == [NO_KERNEL] * 4 and t["launches_one_card"] == NO_KERNEL
    scan_calls = t["layers"] * t["steps"] if arch == "mamba2-780m" else 0  # reduced: remat "none"
    for per_rank in t["scan_calls_per_rank"]:
        for way in ("fwd", "bwd"):
            assert per_rank[way]["calls"] == per_rank[way]["ok"] == scan_calls
    assert t["scan_calls_one_card"]["bwd"]["calls"] == scan_calls


def test_the_flash_route_prefill_matches_one_device(lines):
    p = _item(lines, "prefill")
    assert p["logits_rel_l2"] <= BF16_REL_L2 and p["finite"]
    assert [c["calls"] for c in p["flash_calls_per_rank"]] == [p["layers"]] * 4
    assert all(c["ok"] == c["calls"] for c in p["flash_calls_per_rank"])
    assert p["flash_calls_one_card"]["calls"] == p["layers"]
    # each rank's calls take its half of the heads and of the batch
    shard = ast.literal_eval(p["flash_calls_per_rank"][0]["shapes"][0])
    whole = ast.literal_eval(p["flash_calls_one_card"]["shapes"][0])
    assert shard[2] == p["heads_per_rank"] == whole[2] // 2 and shard[0] == whole[0] // 2


def test_no_rank_loaded_jax_or_the_jax_package(lines):
    seconds = [line for line in lines if "seconds" in line]
    assert seconds and seconds[0]["reference_modules"] == []


@pytest.mark.parametrize("script", ["mesh_smoke.py", "chip_smoke.py"])
def test_the_scripts_import_neither_jax_nor_the_jax_package(script):
    offenders = []
    for node in ast.walk(ast.parse((ROOT / script).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        offenders += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert offenders == []


@pytest.mark.parametrize("alone", [False, True])
def test_it_refuses_without_four_cards_or_without_the_repo(tmp_path, alone):
    where = ROOT
    if alone:
        shutil.copy(SCRIPT, tmp_path / SCRIPT.name)
        where = tmp_path
    proc = subprocess.run([sys.executable, str(where / SCRIPT.name)], cwd=where, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
