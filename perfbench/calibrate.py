"""Readings that the limits in ``perfbench/limits/`` are set from, at a cell's own size.

    python3 perfbench/calibrate.py --workload mamba2-780m.prompt-2k --seeds 1001-1012 --control-seeds 1001-1004

For each seed, in one process: the program's reading of every number the
cell compares, from the driver's own set-up and timed path at the cell's
sizes (a serving cell serves as many requests as a run compares; a training
cell runs its first steps), and, on the control seeds, the readings of

* the control: the plain reference with its products in fp8
  (``reference.lowp``), the precision below the bf16 that the configuration
  states, put in the program's place;
* the faults a cell of that kind can have: a served token altered where it is
  produced (the next id in the vocabulary); for training, half of the batch
  left out with the mean taken over the rest (planted in the reference put
  in the program's place), and a step that returns its state unchanged,
  which reads 1 on the gradient and the change by their definition.

One JSON line per seed on standard output, then a summary: each number's
lower reading (the largest of the program's), its upper reading (the
smallest of the control's and the faults'), and their ratio.  The benchmark's
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


def serve_readings(cell, control: bool) -> dict:
    import numpy as np
    import torch

    from perfbench import harness, weights
    from perfbench.drivers import serve
    from perfbench.reference.lowp import fp8_matmul
    from repro_torch.launch.serve import generate

    cfg = harness.port_config(cell.config)
    m, tr = cell.model, cell.traffic
    params = weights.make(cell.config["family"], m, cell.seed, cell.device, torch.bfloat16)
    n_batches = -(-tr["check_requests"] // tr["batch"])
    served = []
    for i in range(n_batches):
        prompts = serve.prompts_for(cell.seed, i, tr["batch"], tr["prompt"], m["vocab"])
        served.append((prompts, generate(cfg, params, prompts, tr["gen"], device=cell.device).cpu().numpy()))
    del params
    _free()
    requests = serve.sample_requests(cell, served)
    want = serve.reference_logits(cell, requests)
    out = {"logit_gap": max(serve.gaps(want, [t for _, t in requests]))}
    if control:
        low = serve.reference_logits(cell, requests, fp8_matmul)
        out["control.logit_gap"] = max(serve.gaps(want, [lg.argmax(dim=-1).cpu().numpy() for lg in low]))
        altered = [np.where(np.arange(len(t)) == len(t) // 2, (t + 1) % m["vocab"], t) for _, t in requests]
        out["fault_token.logit_gap"] = max(serve.gaps(want, altered))
    return out


def train_readings(cell, control: bool) -> dict:
    import torch

    from perfbench import harness
    from perfbench.drivers import train
    from perfbench.reference.lowp import fp8_matmul
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step

    cfg = harness.port_config(cell.config)
    step_fn = make_train_step(cfg, AdamWConfig(**cell.config["train"]))
    params, opt, program = train.first_steps(cell, step_fn)
    del params, opt, step_fn
    _free()
    reference = train.follow(cell)
    out = dict(train.training_gaps(program, reference))
    if control:
        for label, kwargs in (("control", {"matmul": fp8_matmul}),
                              ("fault_half_batch", {"rows": slice(0, cell.traffic["batch"] // 2)})):
            for k, v in train.training_gaps(train.follow(cell, **kwargs), reference).items():
                out[f"{label}.{k}"] = v
        unchanged = {"loss": program["loss"], "grad": {k: 0.0 for k in program["grad"]},
                     "change": {k: 0.0 for k in program["change"]}}
        found = train.training_gaps(unchanged, reference)
        out.update({f"fault_unchanged.{k}": v for k, v in found.items() if k != "loss_gap"})
    return out


def train_or_serve_numbers(row: dict) -> list[str]:
    """The numbers a row holds the program's reading of (no control or fault prefix)."""
    return [k for k in row if k.endswith("_gap") and "." not in k]


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
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        cell, _ = harness.load_cell(args.workload, seed, 0.0, False, T_START, ROOT)
        kind = cell.traffic["kind"]
        readings = (serve_readings if kind == "serve" else train_readings)(cell, seed in control_seeds)
        row = {"workload": args.workload, "seed": seed, **readings, "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(0)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        _free()
    numbers = [k for k in rows[0] if k in train_or_serve_numbers(rows[0])]
    summary = {}
    for k in numbers:
        lower = max(r[k] for r in rows)
        # the control counts at 3 x the lower reading, a fault at 10 x, an unchanged state at 3 x
        factors = {"control": 3, "fault_token": 10, "fault_half_batch": 10, "fault_unchanged": 3}
        found = {p: min(r[f"{p}.{k}"] for r in rows if f"{p}.{k}" in r) for p in factors
                 if any(f"{p}.{k}" in r for r in rows)}
        counted = [v for p, v in found.items() if v >= factors[p] * lower]
        summary[k] = {"lower": lower, "upper": min(counted) if counted else None, "readings": found,
                      "seeds": len(rows)}
    print(json.dumps({"summary": summary, "banned_modules": harness.banned_loaded()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
