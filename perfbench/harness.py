"""The benchmark's frame: finds a cell's files by name, runs its driver, prints the result line.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by the name that ``BENCHMARK.json`` gives:

* ``perfbench/configs/<config>.json``: the source's values (``published``),
  the sizes as they are run (``model``), ``reduced``, ``assumed``, dtypes
  and deployment;
* ``perfbench/traffic/<traffic>.json``: the mix's parameters, and ``kind``,
  which names the driver;
* ``perfbench/drivers/<kind>.py``: ``run(cell) -> dict`` for every mix of
  that kind (set-up, the measured window, the traced part, the comparison),
  run in this process on one card; or ``run_rank(cell, world) -> dict``,
  run in each of the cell's ``chips`` processes, one a card, by
  ``perfbench/ranks.py`` (the mesh and sharding rules of the mix's
  ``mesh``, ``axes`` and ``fsdp`` in ``world``); ``readings(cell, control)``
  or, by ranks, ``readings_rank(cell, world, control)`` with ``FAULTS``, the
  readings and multiples that ``calibrate.py`` sets a limit from; and
  ``SMALL`` and ``SMALL_KEEPS``, the mix's keys that a CPU run of the tests
  shrinks, with their values, and the model's sizes that it keeps;
* ``perfbench/reference/<family>.py``: the plain reference's layers of the
  configuration's ``family`` and their leaves (``layer_specs``, ``layers``),
  which ``weights`` and ``reference/model.py`` find by that name;
* ``perfbench/limits/<workload>.json``: the limit of each number that the
  cell's comparison reads;
* ``perfbench/metrics/<metric>.py``: ``read(ctx) -> float | None`` for a
  per-layer metric, from what a traced run recorded.

So a later change adds a configuration (of a new family too), a mix (of a
new kind too), a cell (on four chips too) or a metric by adding files and
entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")
#: execution knobs of the port's ModelConfig: a configuration may set them without a published value
EXECUTION_KEYS = ("attention_impl", "attention_block_q", "attention_block_k", "remat", "ssm_chunk",
                  "scan_layers", "inner_unroll")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_{label}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, here: Path = HERE):
    return _module(here / "drivers" / f"{kind}.py", "driver")


def reader(metric: str, here: Path = HERE):
    return _module(here / "metrics" / f"{metric}.py", "metric")


@dataclasses.dataclass
class Cell:
    """One run of one cell: its files' contents, the command's arguments, and where to run."""

    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    here: Path = HERE
    chips: int = 1

    @property
    def model(self) -> dict:
        return self.config["model"]


class RanksFailed(RuntimeError):
    """A rank of ``perfbench/ranks.py`` raised, died or hung; ``pids`` are the rank processes, all
    stopped and waited for."""

    def __init__(self, message: str, pids: list[int]):
        super().__init__(message)
        self.pids = pids


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float, root: Path = ROOT,
              device: str = "cuda") -> tuple[Cell, dict]:
    """(the cell, its entry in ``BENCHMARK.json``) for ``workload``."""
    bench = benchmark(root)
    here = root / bench["paths"][0]
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = Cell(name=workload, config_name=conf["name"], config=load_json(root / conf["file"]),
                traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(here / "limits" / f"{workload}.json"),
                seed=seed, seconds=seconds, trace=trace, t_start=t_start, device=device, here=here,
                chips=entry["chips"])
    return cell, entry


def port_config(config: dict):
    """The port's ``ModelConfig`` as the configuration file states it.

    ``published`` holds the source's values under the port's names, and
    ``model`` what is run; ``reduced`` lists exactly the published keys that
    the run departs from, including those the port has no field for.  Every
    other key of ``model`` is an execution knob.  The registry gives only the
    fields that neither names.
    """
    from repro_torch.configs import get_config

    base = get_config(config["arch"])
    model, published = config["model"], config["published"]
    fields = {f.name for f in dataclasses.fields(base)}
    unknown = set(model) - fields
    if unknown:
        raise ValueError(f"{config['arch']}: keys {sorted(unknown)} are not fields of the port's ModelConfig")
    departed = sorted(k for k, v in published.items() if k not in model or model[k] != v)
    if departed != sorted(config["reduced"]):
        raise ValueError(f"{config['arch']}: the run departs from the published {departed}, "
                         f"but reduced lists {sorted(config['reduced'])}")
    loose = sorted(set(model) - set(published) - set(EXECUTION_KEYS))
    if loose:
        raise ValueError(f"{config['arch']}: {loose} have no published value and are no execution knob")
    return dataclasses.replace(base, **model)


def median(values) -> float | None:
    values = list(values)
    return statistics.median(values) if values else None


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank: the smallest value with at least q of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def device_info(device: str, peak: int, count: int = 1) -> dict:
    """The result line's ``device``: the card's name, the ``count`` cards the run uses (on the CPU,
    the processes it uses: its ranks, or 1), and the peak of allocated memory on the fullest of them
    (``peak``)."""
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count, "memory_peak_bytes": int(peak)}


def banned_loaded() -> list[str]:
    """Top-level names of JAX, Flax or the JAX package in ``sys.modules``, compared whole."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(BANNED_MODULES))


def result_line(cell: Cell, outcome: dict, bench: dict) -> dict:
    """The last line of standard output, from the driver's outcome."""
    metrics = {}
    if cell.trace:
        ctx = outcome["ctx"]
        for m in bench["per_layer"]:
            if applies(m, cell.name):
                value = reader(m["name"], cell.here).read(ctx)
                if value is None:
                    print(f"per-layer metric {m['name']}: nothing to read in this run", file=sys.stderr)
                else:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell.name):
                if m["name"] not in outcome["e2e"]:
                    raise RuntimeError(f"the {cell.traffic['kind']} driver gave no {m['name']}")
                metrics[m["name"]] = {"value": float(outcome["e2e"][m["name"]]), "unit": m["unit"]}
    line = {"correct": bool(outcome["correct"]), "attempted": int(outcome["attempted"]),
            "failed": int(outcome["failed"]), "metrics": metrics, "device": outcome["device"]}
    if cell.trace and outcome.get("profile"):
        prof = outcome["profile"]
        line["device"] = {**line["device"], "busy_s": prof["busy_s"], "window_s": prof["window_s"]}
        line["breakdown"] = {"device_ops": [[n, s] for n, s in prof["device_ops"]],
                             "idle_gaps": [[n, s] for n, s in prof["idle_gaps"]]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome["checks"].items()}
    return line


def judge(checks: dict) -> bool:
    """True when every number compared is finite and within its limit."""
    return bool(checks) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def print_checks(checks: dict) -> None:
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r}) {'ok' if math.isfinite(v) and v <= lim else 'FAIL'}",
              file=sys.stderr)


def run_cell(cell: Cell, bench: dict) -> tuple[dict, dict]:
    """Runs the cell's driver, in this process or over ranks (``perfbench/ranks.py``): (the result
    line, the driver's outcome, with ``banned`` from the ranks); prints nothing to stdout."""
    drv = driver(cell.traffic["kind"], cell.here)
    if hasattr(drv, "run_rank"):
        from perfbench import ranks

        outcome = ranks.run(cell)
    else:
        outcome = drv.run(cell)
    outcome["correct"] = judge(outcome["checks"]) and outcome["failed"] == 0 and outcome["attempted"] > 0
    return result_line(cell, outcome, bench), outcome
