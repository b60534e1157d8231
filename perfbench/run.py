"""Runs one cell of the benchmark once and prints its result as the last line of standard output.

    python3 perfbench/run.py --workload mamba2-780m.prompt-2k --seed 7 --seconds 51 --trace 0

From the root of a checkout.  ``--trace 0`` measures the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (``BENCHMARK.json``).  A cell
runs in this process on one card, or, where its driver runs by ranks, in
one process a card (``perfbench/ranks.py``; ``chips`` in its entry), rank
0's outcome printed here.  Every run compares what its window produced
with the plain reference and prints each number compared beside its
limit, last on standard error and under ``checks`` in the result line.  It
exits with another code than 0, and prints no result, without as many
CUDA devices as the cell asks for, without the program under ``src/``,
when a rank fails or outlasts the frame's limit, or when this process or
any rank loaded JAX, Flax or the JAX package ``repro``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def prepare_environment() -> None:
    """The program from ``src/``, and every cache of a build inside the checkout, at fixed paths."""
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    prepare_environment()

    from perfbench import harness

    bench = harness.benchmark(ROOT)
    cell, entry = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    try:
        line, outcome = harness.run_cell(cell, bench)
    except harness.RanksFailed as failed:
        print(f"{args.workload}: {failed}", file=sys.stderr)
        return 4
    banned = sorted(set(harness.banned_loaded()) | set(outcome.get("banned", [])))
    if banned:
        print(f"the process or a rank loaded {banned}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    harness.print_checks(outcome["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
