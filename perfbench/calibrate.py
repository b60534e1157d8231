"""Readings that the limits in ``perfbench/limits/`` are set from, at a cell's own size.

    python3 perfbench/calibrate.py --workload mamba2-780m.prompt-2k --seeds 1001-1012 --control-seeds 1001-1004

For each seed, in one process (a cell whose driver runs by ranks: in one
process a chip, ``perfbench/ranks.py``): the program's reading of every number the
cell compares, from the driver's own set-up and timed path at the cell's
sizes (a serving cell serves as many requests as a run compares; a training
cell runs its first steps), and, on the control seeds, the readings of

* the control: the plain reference with its products in fp8
  (``reference.lowp``), the precision below the bf16 that the configuration
  states, put in the program's place;
* the faults a cell of that kind can have, which its driver names in
  ``FAULTS``: for serving a served token altered where it is produced (the
  next id in the vocabulary); for training, half of the batch left out with
  the mean taken over the rest (planted in the reference put in the
  program's place), a step that returns its state unchanged, which reads 1
  on the gradient and the change by their definition, and, over ranks, the
  exchange between chips left out.

Each driver takes its own readings (``readings`` in ``drivers/<kind>.py``, or
``readings_rank`` in each rank); nothing here depends on the kind.  One JSON
line per seed on standard output, then a summary: each number's lower
reading (the largest of the program's), its upper reading (the smallest of
those of the control and the faults that reach the driver's ``FAULTS``
multiple of the lower), and the readings it was taken from.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.run import prepare_environment  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(cell, control: bool) -> dict:
    """The cell's readings by its driver (``drivers/<kind>.py``): its ``readings(cell, control)`` in
    this process, or, for a driver that runs by ranks, its ``readings_rank`` over the cell's chips
    (rank 0's, with ``banned``: the JAX modules that the ranks loaded)."""
    from perfbench import harness, ranks

    drv = harness.driver(cell.traffic["kind"], cell.here)
    if hasattr(drv, "run_rank"):
        return ranks.run(cell, "readings_rank", (control,))
    return drv.readings(cell, control)


def numbers(row: dict) -> list[str]:
    """The numbers a row holds the program's reading of (no control or fault prefix)."""
    return [k for k in row if k.endswith("_gap") and "." not in k]


def summary(rows: list[dict], faults: dict) -> dict:
    """Each number's lower reading (the program's largest), the control's and the faults' smallest
    readings, and the upper reading: the least of those that reach ``faults[prefix]`` times the lower."""
    out = {}
    for k in numbers(rows[0]):
        lower = max(r[k] for r in rows)
        found = {p: min(r[f"{p}.{k}"] for r in rows if f"{p}.{k}" in r) for p in faults
                 if any(f"{p}.{k}" in r for r in rows)}
        counted = [v for p, v in found.items() if v >= faults[p] * lower]
        out[k] = {"lower": lower, "upper": min(counted) if counted else None, "readings": found, "seeds": len(rows)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="e.g. 1001-1012")
    parser.add_argument("--control-seeds", default="", help="the seeds that also read the control and faults")
    args = parser.parse_args(argv)
    prepare_environment()
    import torch

    from perfbench import harness

    control_seeds = set(seeds(args.control_seeds)) if args.control_seeds else set()
    rows = []
    banned: set = set()
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        cell, _ = harness.load_cell(args.workload, seed, 0.0, False, T_START, ROOT)
        found = readings(cell, seed in control_seeds)
        banned |= set(found.pop("banned", []))
        row = {"workload": args.workload, "seed": seed, **found, "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(0)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        _free()
    faults = harness.driver(cell.traffic["kind"], cell.here).FAULTS
    banned |= set(harness.banned_loaded())
    print(json.dumps({"summary": summary(rows, faults), "banned_modules": sorted(banned)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
