#!/usr/bin/env python3
"""Host cost of the port's one-device serving path on one NVIDIA GPU.

  python3 scripts/host_cost.py [--reps N] [--ops-from OPS_PY]

Imports ``repro_torch`` from the ``src`` directory of the checkout that holds
this script, builds the flash and scan kernels there, and prints, after the
card's name and power limit, one JSON line ``{"host_cost": {...}}``:

* ``wrapper_us``: microseconds of host time per call of ``ops.flash_attention``
  (q/k/v (1, 64, 2, 64) bf16, causal) and ``ops.ssd_scan`` (x (1, 128, 2, 64)
  bf16, N 64, chunk 128), 1,000 calls back to back, the median of ``--reps``
  runs; at these shapes the kernels take a few microseconds, so the loop is
  host-bound.  Where the checkout registers the kernels as
  ``torch.library.custom_op``s, ``op_us`` times the same calls through
  ``torch.ops.repro_torch`` (the custom op's Python dispatch).  With
  ``--ops-from OPS_PY`` (another checkout's ``src/repro_torch/kernels/ops.py``,
  loaded as a second module over this checkout's kernels) ``ab_us`` times
  both modules' wrappers in one process, alternating, ten runs each, and
  beside them this checkout's launch alone (``launch``: no argument checks);
* ``mamba2-780m`` and ``qwen2-1.5b`` at full width (random weights from a
  seed, batch 4, prompt 512): the prefill's and the eager decode step's wall
  ms (a synchronize before and after) and host ms (from the call to its
  return; the card runs behind), and for mamba2 one ``_mamba_layer`` of the
  prefill and of a decode step, medians of ``--reps`` calls.

Run it in two checkouts on the same card to compare them (each builds its own
kernels under its own ``build/``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
BATCH, PROMPT = 4, 512


def median_ms(fn, reps: int) -> tuple[float, float]:
    """(median wall ms, median host ms) of ``fn()``: wall from a synchronize to
    the next, host from the call to its return."""
    import torch

    walls, hosts = [], []
    fn()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        hosts.append((t1 - t0) * 1e3)
        walls.append((t2 - t0) * 1e3)
    return statistics.median(walls), statistics.median(hosts)


def per_call_us(fn, reps: int, calls: int = 1000) -> float:
    import torch

    runs = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(runs[1:])  # the first run warms up


def wrappers(reps: int, ops_from: str | None) -> dict:
    import importlib.util

    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((1, 64, 2, 64), generator=g, device="cuda").bfloat16() for _ in range(3))
    x = torch.randn((1, 128, 2, 64), generator=g, device="cuda").bfloat16()
    la = -torch.rand((1, 128, 2), generator=g, device="cuda")
    bm, cm = (torch.randn((1, 128, 64), generator=g, device="cuda").bfloat16() for _ in range(2))
    out = {"wrapper_us": {
        "flash_attention": per_call_us(lambda: ops.flash_attention(q, k, v, causal=True), reps),
        "ssd_scan": per_call_us(lambda: ops.ssd_scan(x, la, bm, cm, chunk=128), reps),
    }}
    lib = getattr(torch.ops, "repro_torch", None)
    if lib is not None and hasattr(lib, "flash_attention"):
        out["op_us"] = {
            "flash_attention": per_call_us(lambda: lib.flash_attention(q, k, v, True, 0), reps),
            "ssd_scan": per_call_us(lambda: lib.ssd_scan_fwd(x, la, bm, cm, None, 128), reps),
        }
    if ops_from:
        spec = importlib.util.spec_from_file_location("other_ops", ops_from)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        calls = {"flash_attention": lambda m: m.flash_attention(q, k, v, causal=True),
                 "ssd_scan": lambda m: m.ssd_scan(x, la, bm, cm, chunk=128)}
        launches = {"flash_attention": lambda: ops._flash_launch(q, k, v, True, 0),
                    "ssd_scan": lambda: ops._ssd_fwd_launch(x, la, bm, cm, None, 128)}
        ab = {name: {"this": [], "other": [], "launch": []} for name in calls}
        for _ in range(10):
            for name, call in calls.items():
                ab[name]["this"].append(per_call_us(lambda: call(ops), 1))
                ab[name]["other"].append(per_call_us(lambda: call(other), 1))
                ab[name]["launch"].append(per_call_us(launches[name], 1))
        out["ab_us"] = {name: {side: statistics.median(runs) for side, runs in sides.items()}
                        for name, sides in ab.items()}
        out["ab_runs_us"] = ab
    return out


def serving(arch: str, reps: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import init_cache

    cfg = get_config(arch)
    if cfg.family != "ssm":
        import dataclasses

        cfg = dataclasses.replace(cfg, attention_impl="flash_pallas")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, size=(BATCH, PROMPT))
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    line = {}
    with torch.no_grad():
        cache = init_cache(cfg, BATCH, PROMPT + 8, "cuda")
        line["prefill_ms"] = median_ms(lambda: T.forward(params, cfg, batch, cache), reps)
        _, _, filled = T.forward(params, cfg, batch, cache)
        step = {"tokens": batch["tokens"][:, :1]}

        def decode():
            c = {**filled, "len": torch.full((), PROMPT, dtype=torch.int32, device="cuda")}
            return T.forward(params, cfg, step, c)

        line["decode_step_ms"] = median_ms(decode, reps)
        if cfg.family == "ssm":
            p0 = params["layers"][0]
            x = torch.randn((BATCH, PROMPT, cfg.d_model), device="cuda").bfloat16()
            line["mamba_layer_prefill_ms"] = median_ms(lambda: T._mamba_layer(cfg, x, p0, None), reps)
            c0 = {key: filled[key][0] for key in S.CACHE_KEYS}
            line["mamba_layer_decode_ms"] = median_ms(lambda: T._mamba_layer(cfg, x[:, :1], p0, c0), reps)
    del params
    torch.cuda.empty_cache()
    return {key: {"wall": w, "host": h} for key, (w, h) in line.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=15)
    parser.add_argument("--ops-from", default=None, help="another checkout's kernels/ops.py to time beside this one's")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("host_cost: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build

    for name in ("flash_attention", "ssd_scan"):
        build.build(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    result = {"checkout": str(ROOT), **wrappers(args.reps, args.ops_from)}
    for arch in ("mamba2-780m", "qwen2-1.5b"):
        result[arch] = serving(arch, args.reps)
    print(json.dumps({"host_cost": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
