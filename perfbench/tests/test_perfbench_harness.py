"""The benchmark's frame on the CPU: its files found by name, the result line, names, imports.

None of these needs the card: a run on the CPU goes through ``harness.run_cell``
at reduced sizes (``small_cell``), and ``run.py`` itself is only checked to
refuse a machine without CUDA.
"""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

BENCH = harness.benchmark(ROOT)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
BANNED = {"jax", "jaxlib", "flax", "repro"}
LAST_LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def small_cell(workload: str, seed: int = 3, traffic: dict | None = None, root=ROOT):
    """``workload`` at the port's reduced sizes on the CPU, its traffic shrunk to its driver's ``SMALL``
    and then by ``traffic``; the sizes cut are listed in ``reduced``, as a configuration file would
    list them.  The sizes in the driver's ``SMALL_KEEPS`` stay (serving keeps ``d_model``: the tied
    head's logits, which its comparison reads, scale with it)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    cell, _ = harness.load_cell(workload, seed, 0.5, False, time.perf_counter(), root=root, device="cpu")
    drv = harness.driver(cell.traffic["kind"], cell.here)
    small = reduced(get_config(cell.config["arch"]))
    keep = set(harness.EXECUTION_KEYS) | set(drv.SMALL_KEEPS)
    model = {k: (v if k in keep or isinstance(v, bool) else getattr(small, k))
             for k, v in cell.config["model"].items()}
    published = cell.config["published"]
    cell.config = {**cell.config, "model": model,
                   "reduced": [k for k, v in published.items() if k not in model or model[k] != v]}
    cell.traffic = {**cell.traffic, **drv.SMALL, **(traffic or {})}
    return cell


def _digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def copy_tree(root):
    """A checkout's benchmark under ``root``: ``BENCHMARK.json`` and ``perfbench/`` copied, ``src`` linked."""
    (root / "src").symlink_to(ROOT / "src")
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root / "perfbench"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cells_files_load_by_name(workload):
    cell, entry = harness.load_cell(workload, 1, 1.0, False, 0.0, ROOT)
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cell.config == json.loads((ROOT / conf["file"]).read_text())
    drv = harness.driver(cell.traffic["kind"])
    ranked = hasattr(drv, "run_rank")
    assert callable(drv.run_rank if ranked else drv.run)
    assert callable(drv.readings_rank if ranked else drv.readings)  # calibrate.py's, by the driver alone
    assert isinstance(drv.SMALL, dict) and drv.SMALL and isinstance(drv.SMALL_KEEPS, tuple)
    assert isinstance(drv.FAULTS, dict) and drv.FAULTS["control"] == 3
    assert cell.chips == entry["chips"]
    cfg = harness.port_config(cell.config)
    for key, value in cell.config["model"].items():
        assert getattr(cfg, key) == value
    for metric in BENCH["per_layer"]:
        if harness.applies(metric, workload):
            assert callable(harness.reader(metric["name"]).read)
    assert set(cell.limits) and all(isinstance(v, float) and v > 0 for v in cell.limits.values())


def test_a_config_mix_cell_and_metric_added_as_files_are_found_without_edits(tmp_path):
    here = copy_tree(tmp_path)
    before = _digest(tmp_path)
    config = json.loads((here / "configs/mamba2-780m.json").read_text())
    (here / "configs/mamba2-780m-short.json").write_text(json.dumps({**config, "source": "copy for the test"}))
    traffic = {**json.loads((here / "traffic/prompt-2k.json").read_text()), "gen": 4}
    (here / "traffic/prompt-2k-short.json").write_text(json.dumps(traffic))
    (here / "limits/mamba2-780m-short.prompt-2k-short.json").write_text(json.dumps({"logit_gap": 1.5}))
    (here / "metrics/batches.serve.py").write_text("def read(ctx):\n    return float(len(ctx['latencies_s']))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mamba2-780m-short", "source": "https://example.org/x",
                             "file": "perfbench/configs/mamba2-780m-short.json", "reduced": config["reduced"],
                             "why": "test"})
    bench["workloads"].append({"name": "mamba2-780m-short.prompt-2k-short", "config": "mamba2-780m-short",
                               "traffic": "prompt-2k-short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "batches.serve", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "launcher", "moves": "out_tok_s",
                               "workloads": ["mamba2-780m-short.prompt-2k-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell, entry = harness.load_cell("mamba2-780m-short.prompt-2k-short", 1, 1.0, True, 0.0, tmp_path)
    assert cell.here == here and cell.traffic["gen"] == 4 and cell.limits == {"logit_gap": 1.5}
    assert cell.config["source"] == "copy for the test" and entry["traffic"] == "prompt-2k-short"
    assert harness.reader("batches.serve", cell.here).read({"latencies_s": [1.0, 2.0]}) == 2.0
    outcome = {"correct": True, "attempted": 8, "failed": 0, "device": {"platform": "gpu"},
               "ctx": {"latencies_s": [1.0, 2.0, 3.0]}, "checks": {"logit_gap": (0.1, 1.5)}, "profile": None}
    line = harness.result_line(cell, outcome, bench)
    assert line["metrics"]["batches.serve"] == {"value": 3.0, "unit": "batches"}
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before  # no file that was there changed


def _outcome(trace: bool) -> dict:
    profile = {"busy_s": 0.5, "window_s": 0.6, "device_ops": [("gemm", 0.25)], "idle_gaps": [("capture: x", 0.05)],
               "complete": {"flash_attention": True, "ssd_scan": True, "ssd_scan_bwd": True}, "launches": {}}
    return {"correct": True, "attempted": 16, "failed": 0, "e2e": {"out_tok_s": 9.5, "setup_s": 3.0,
                                                                    "latency_p95_ms": 250.0},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 7},
            "ctx": {"spans": {"capture": [0.1, 0.2]}, "decode_ms": [3.0], "peak_bytes_window": 2**30,
                    "model": {}, "traffic": {}, "profile": profile},
            "checks": {"logit_gap": (0.01, 0.5)}, "profile": profile if trace else None}


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_lines_keys(trace):
    cell, _ = harness.load_cell("mamba2-780m.prompt-2k", 1, 1.0, trace, 0.0, ROOT)
    line = harness.result_line(cell, _outcome(trace), BENCH)
    want = LAST_LINE_KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["checks"] == {"logit_gap": {"value": 0.01, "limit": 0.5}}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) == {"capture_ms", "decode_step_ms", "idle_share.serve", "peak_gib.serve"}
    else:
        assert set(line["metrics"]) == {"latency_p95_ms", "out_tok_s", "setup_s"}
    json.dumps(line)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_cpu_run_of_every_cell_prints_the_contracts_keys(workload):
    line, outcome = harness.run_cell(small_cell(workload), BENCH)
    assert list(line) == LAST_LINE_KEYS
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    e2e = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, workload)}
    assert set(line["metrics"]) == e2e and all(m["value"] > 0 for m in line["metrics"].values())


def test_names_units_and_texts_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(names[:len(BENCH["configs"]) + len(WORKLOADS)])) == len(BENCH["configs"]) + len(WORKLOADS)
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(path.relative_to(ROOT))), path


def test_the_benchmark_json_keeps_to_its_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = 24  # the budget of a full check must hold with the most cells a benchmark may have
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for w in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], w), (m["name"], w)
    for w in WORKLOADS:
        assert any(harness.applies(m, w) and m["name"] != "setup_s" for m in BENCH["end_to_end"])
        assert any(harness.applies(m, w) for m in BENCH["per_layer"])
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert all(c in (1, 4) for c in chips)
    assert chips.count(4) <= max(1, len(chips) // 4, len(_accepted_four_chip_cells()))


def _accepted_four_chip_cells() -> set:
    """The four-chip cells of the accepted benchmark, by `PERF_LEDGER.jsonl` (none without one)."""
    ledger = ROOT / "PERF_LEDGER.jsonl"
    lines = [json.loads(line) for line in ledger.read_text().splitlines() if line.strip()] if ledger.exists() else []
    return {x["workload"] for x in lines if x.get("verdict") == "accepted" and x.get("chips") == 4}


@pytest.mark.parametrize("change", ["departure_not_listed", "listed_but_as_published", "no_published_value"])
def test_a_configuration_is_held_to_its_published_values(change):
    config = json.loads((ROOT / "perfbench/configs/mamba2-780m.json").read_text())
    harness.port_config(config)
    if change == "departure_not_listed":
        config["model"] = {**config["model"], "d_model": 1024}
    elif change == "listed_but_as_published":
        config["reduced"] = config["reduced"] + ["n_layers"]
    else:
        config["model"] = {**config["model"], "n_heads": 8}
    with pytest.raises(ValueError):
        harness.port_config(config)


def _imported_tops(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_nothing_under_perfbench_imports_jax_or_the_jax_package():
    found = {str(p): _imported_tops(p) & BANNED for p in (ROOT / "perfbench").rglob("*.py")}
    assert not any(found.values()), found
    assert "repro" not in {"repro_torch"}  # top-level names are compared whole


def test_the_reference_imports_nothing_of_the_program():
    """Every file under ``reference/``, the families' too: no absolute import of the program, the JAX
    package or the benchmark, and relative imports only of the reference's own modules."""
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        assert not _imported_tops(path) & (BANNED | {"repro_torch", "perfbench"}), path
        relative = [n for n in ast.walk(ast.parse(path.read_text())) if isinstance(n, ast.ImportFrom) and n.level]
        assert all(n.level == 1 for n in relative), path


def test_banned_modules_are_compared_by_their_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert harness.banned_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.banned_loaded() == ["jax"]


@pytest.mark.parametrize("bare", [False, True])
def test_run_refuses_without_cuda_and_prints_no_result(tmp_path, bare):
    """On the CPU (no CUDA here), and in a directory holding only BENCHMARK.json and perfbench/."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root = ROOT
    if bare:
        shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        root = tmp_path
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", WORKLOADS[0], "--seed", "2147483999",
                           "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
