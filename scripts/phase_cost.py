#!/usr/bin/env python3
"""Host cost, synchronisations and clock of the port's phase recorder on one NVIDIA GPU.

  python3 scripts/phase_cost.py cost [--calls N]
  python3 scripts/phase_cost.py syncs [--src DIR]
  python3 scripts/phase_cost.py gap --trace-dir DIR
  python3 scripts/phase_cost.py bench [--tracer] --workload W --seed N --seconds S --trace 1

Each part prints the card's name and power limit, then one JSON line.  The
shapes are the benchmark's (``perfbench/traffic/prompt-2k.json``: batch 32 x
prompt 2,032 + 16 tokens; ``train-4k.json``: batch 4 x 4,096) and the weights
its own (``perfbench.weights``, mamba2-780m at full size).

* ``cost``: the host time that ``repro_torch.phases`` takes (phase entry
  and exit, counters, the allocator's counts) per ``generate`` call and per
  training step, with no tracer and with an in-memory ``obs`` tracer.  The
  recorder's calls of one real call (after a warm-up) are logged, then
  replayed ``--reps`` times on the idle card and timed, the median less the
  replay loop's own time (``replay_us``; the loop timed over phases that do
  nothing, ``replay_loop_us``).  Timed inside the real calls instead (``in_call_us``,
  timers around the same functions less the timers' own cost, the median
  of ``--calls`` calls), the figure also holds the waits of an event record
  for room in the card's full launch queue, which the next kernel launch
  would have waited for anyway.
* ``syncs``: the profiler's records of host-device synchronisations
  (``cuda*Synchronize``) in one profiled ``generate`` and one profiled
  training step, and of ``cudaMalloc`` / ``cudaFree``; the count includes
  the one ``torch.cuda.synchronize()`` that closes the profiled stretch, and
  for ``generate`` the tokens' copy to the host.  ``--src`` imports
  ``repro_torch`` from another checkout's ``src`` (a parent commit unpacked
  under ``build/``), so the two counts come from the same card.
* ``gap``: ``python -m repro_torch.launch.serve --trace-dir DIR`` at the
  prompt-2k shapes (after one warm-up run) under ``torch.profiler``: the
  longest stretch of the ``serve.generate`` call with no device operation,
  and the ``serve.capture.record`` span of the trace the launcher wrote,
  mapped onto the profiler's clock by ``wall_ns``; whether the span covers
  the gap, and the offset between the span and the profiler's own
  annotation of it.
* ``bench``: ``perfbench/run.py`` with the arguments given (``--tracer``:
  with an in-memory ``obs`` tracer installed, so that ``serve.decode`` is
  timed on the device too), then the program's phase histograms (every
  observation) as one more JSON line.
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
SEED = 2147483001
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
ALLOCS = ("cudaMalloc", "cudaFree")


def card() -> dict:
    import torch

    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(limit, flush=True)
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": limit, "torch": torch.__version__}


def cell_inputs(traffic: str):
    """(port config, model dict, traffic dict) of the benchmark's mamba2-780m cell ``traffic``."""
    from perfbench import harness

    config = harness.load_json(ROOT / "perfbench" / "configs" / "mamba2-780m.json")
    return harness.port_config(config), config, harness.load_json(ROOT / "perfbench" / "traffic" / f"{traffic}.json")


def serving(seed: int = SEED):
    """A ``generate`` call at the prompt-2k shapes: ``call()`` returns its tokens on the host."""
    import numpy as np
    import torch

    from perfbench import weights
    from repro_torch.launch.serve import generate

    cfg, config, tr = cell_inputs("prompt-2k")
    params = weights.make(config["family"], config["model"], seed, "cuda", torch.bfloat16)
    rng = np.random.default_rng(seed)

    def call():
        prompts = rng.integers(0, config["model"]["vocab"], size=(tr["batch"], tr["prompt"]))
        return generate(cfg, params, prompts, tr["gen"], device="cuda").cpu()

    return call


def training(seed: int = SEED):
    """A training step at the train-4k shapes: ``call()`` runs one and waits for the device."""
    import torch

    from perfbench import weights
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg, config, tr = cell_inputs("train-4k")
    state = {"params": weights.make(config["family"], config["model"], seed, "cuda", torch.float32)}
    state["opt"] = adamw_init(state["params"])
    step = make_train_step(cfg, AdamWConfig(**config["train"]))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def call():
        ids = torch.randint(0, config["model"]["vocab"], (tr["batch"], tr["seq"] + 1), generator=gen, device="cuda")
        state["params"], state["opt"], _ = step(state["params"], state["opt"],
                                                {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
        torch.cuda.synchronize()

    return call


class Timers:
    """Timers around the recorder's entry points: seconds spent inside them, and calls."""

    def __init__(self, phases):
        self.phases, self.spent, self.calls, self._saved = phases, 0.0, 0, []

    def _wrap(self, fn):
        perf = time.perf_counter

        def timed(*args, **kwargs):
            t0 = perf()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spent += perf() - t0
                self.calls += 1

        return timed

    def install(self) -> None:
        p = self.phases
        for owner, name in ((p._Phase, "__enter__"), (p._Phase, "__exit__"), (p._Phase, "set"), (p, "phase"),
                            (p, "count"), (p, "counter"), (p, "allocator_calls")):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn))

    def uninstall(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def overhead_s(self, n: int = 200000) -> float:
        """Seconds a timer adds to one call (a wrapped no-op against the bare one)."""

        def noop():
            return None

        wrapped, perf = self._wrap(noop), time.perf_counter
        spent, calls = self.spent, self.calls
        t0 = perf()
        for _ in range(n):
            noop()
        t1 = perf()
        for _ in range(n):
            wrapped()
        t2 = perf()
        self.spent, self.calls = spent, calls
        return ((t2 - t1) - (t1 - t0)) / n


class Log:
    """The recorder's calls of one real call, in order, to be replayed on the idle card."""

    def __init__(self, phases):
        self.phases, self.calls, self._saved = phases, [], []

    def install(self) -> None:
        p, calls = self.phases, self.calls

        def logged(kind, fn, method=False):
            def inner(*args, **kwargs):
                out = fn(*args, **kwargs)
                if kind == "phase":
                    calls.append(("phase", args, kwargs, id(out)))
                elif method:
                    calls.append((kind, id(args[0]), args[1:], kwargs))
                else:
                    calls.append((kind, args, kwargs))
                return out

            return inner

        for owner, name, method in ((p._Phase, "__enter__", True), (p._Phase, "__exit__", True),
                                    (p._Phase, "set", True), (p, "phase", False), (p, "count", False),
                                    (p, "counter", False), (p, "allocator_calls", False)):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, logged(name, fn, method))

    def uninstall(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def replay(self, p=None) -> float:
        """Seconds to make the logged calls once more (on ``p``, the recorder module by default)."""
        p, live = p or self.phases, {}
        perf = time.perf_counter
        t0 = perf()
        for call in self.calls:
            kind = call[0]
            if kind == "phase":
                live[call[3]] = p.phase(*call[1], **call[2])
            elif kind == "__enter__":
                live[call[1]].__enter__()
            elif kind == "__exit__":
                live[call[1]].__exit__(None, None, None)
            elif kind == "set":
                live[call[1]].set(**call[3])
            else:
                getattr(p, kind)(*call[1], **call[2])
        return perf() - t0


class _Idle:
    """A phase that does nothing: replayed through it, the log times the replay's own loop."""

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


def _nothing(*args, **kwargs):
    return None


IDLE = _Idle()
NO_RECORDER = type("NoRecorder", (), {"phase": staticmethod(lambda *a, **k: IDLE), "count": staticmethod(_nothing),
                                      "counter": staticmethod(_nothing),
                                      "allocator_calls": staticmethod(_nothing)})()


def cost(args) -> dict:
    import torch

    from repro_torch import obs, phases

    out = {}
    for label, make in (("generate", serving), ("train_step", training)):
        call = make()
        for _ in range(2):
            call()
        replayed = {}
        for mode in ("no_tracer", "tracer"):
            tracer = obs.Tracer(None) if mode == "tracer" else None
            with obs.tracing(tracer):
                log = Log(phases)
                log.install()
                try:
                    call()
                finally:
                    log.uninstall()
                torch.cuda.synchronize()
                phases.flush()
                times = [log.replay() for _ in range(args.reps)]
                phases.flush()
            loop = statistics.median([log.replay(NO_RECORDER) for _ in range(args.reps)])
            kinds = [c[0] for c in log.calls]
            replayed[mode] = {"replay_us": 1e6 * (statistics.median(times) - loop),
                              "replay_us_quartiles": [1e6 * (q - loop) for q in statistics.quantiles(times, n=4)],
                              "replay_loop_us": 1e6 * loop,
                              "calls": {k: kinds.count(k) for k in sorted(set(kinds))},
                              "device_phases": sum(1 for c in log.calls if c[0] == "phase" and len(c[1]) > 1
                                                   and c[1][1] is not None)}
        timers = Timers(phases)
        per_call = timers.overhead_s()
        rows = {}
        for mode in ("no_tracer", "tracer"):
            tracer = obs.Tracer(None) if mode == "tracer" else None
            us, counted = [], []
            with obs.tracing(tracer):
                for _ in range(args.calls):
                    timers.spent, timers.calls = 0.0, 0
                    timers.install()
                    try:
                        call()
                    finally:
                        timers.uninstall()
                    us.append(1e6 * (timers.spent - timers.calls * per_call))
                    counted.append(timers.calls)
            rows[mode] = {**replayed[mode], "in_call_us": statistics.median(us),
                          "in_call_us_each": [round(u, 2) for u in us], "recorder_calls": counted[0],
                          "spans": len(tracer.events()) if tracer else 0}
        rows["timer_overhead_us"] = per_call * 1e6
        out[label] = rows
        del call
    phases.flush()
    registry = obs.metrics()
    medians = {n: statistics.median(registry.histogram(n).values())
               for n in sorted(registry.snapshot()["histograms"]) if registry.histogram(n).values()}
    return {"cost": out, "medians": medians}


def profiled(call) -> dict:
    """Counts of synchronisation and allocator records in one profiled ``call()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return {n: names.count(n) for n in SYNCS + ALLOCS}


def syncs(args) -> dict:
    out = {}
    for label, make in (("generate", serving), ("train_step", training)):
        call = make()
        for _ in range(2):
            call()
        out[label] = profiled(call)
        del call
    return {"syncs": out}


def gap(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import trace as pbtrace
    from repro_torch.launch import serve
    from repro_torch.obs.trace import epoch, load_events, wall_ns

    _, _, tr = cell_inputs("prompt-2k")
    argv = ["--arch", "mamba2-780m", "--batch", str(tr["batch"]), "--prompt-len", str(tr["prompt"]),
            "--gen", str(tr["gen"])]
    serve.main(argv)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve.main(argv + ["--trace-dir", args.trace_dir])
    torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    kinds = pbtrace._kinds(events)
    notes = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e, k in zip(events, kinds) if k == "user_annotation" and e.name().startswith("serve.")}
    w0, w1 = notes["serve.generate"]
    device = pbtrace._merge([(max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1))
                             for e, k in zip(events, kinds)
                             if k in pbtrace.DEVICE_ACTIVITIES and e.start_ns() + e.duration_ns() > w0
                             and e.start_ns() < w1])
    edges = [w0] + [x for iv in device for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    longest, g0, g1 = gaps[0]
    trace_file, = sorted(Path(args.trace_dir).glob("serve-*[0-9].json"))
    spans = load_events(str(trace_file))
    wall = epoch(spans)["wall"]
    rec, = [e for e in spans if e.get("ph") == "X" and e["name"] == "serve.capture.record"]
    r0, r1 = wall_ns(rec["ts"], wall), wall_ns(rec["ts"] + rec["dur"], wall)
    offsets = {}
    for e in spans:
        if e.get("ph") == "X" and e["name"] in notes:
            s0 = wall_ns(e["ts"], wall)
            offsets[e["name"]] = round((s0 - notes[e["name"]][0]) / 1e3, 3)
    return {"gap": {"window_ms": (w1 - w0) / 1e6, "busy_ms": sum(b - a for a, b in device) / 1e6,
                    "longest_gaps_ms": [round(g / 1e6, 3) for g, _, _ in gaps[:5]],
                    "longest_gap": [g0, g1], "capture_record_span": [r0, r1],
                    "record_ms": rec["dur"] / 1e3,
                    "covered_within_ms": max(r0 - g0, g1 - r1, 0) / 1e6,
                    "covers": r0 <= g0 + 500_000 and r1 >= g1 - 500_000,
                    "span_minus_annotation_start_us": offsets, "trace": str(trace_file)}}


def bench(rest: list[str], tracer: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    from repro_torch import obs, phases

    with obs.tracing(obs.Tracer(None) if tracer else None):
        rc = run.main(rest)

    phases.flush()
    hists = obs.metrics().snapshot()["histograms"]
    names = [n for n in hists if n.startswith(("serve.", "train."))]
    return {"program": {n: obs.metrics().histogram(n).values() for n in sorted(names)},
            "counters": obs.metrics().snapshot()["counters"], "rc": rc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    ap.add_argument("part", choices=("cost", "syncs", "gap", "bench"))
    ap.add_argument("--src", default=str(ROOT / "src"), help="the checkout's src to import repro_torch from")
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--reps", type=int, default=1000)
    ap.add_argument("--tracer", action="store_true", help="bench: with an in-memory obs tracer installed")
    ap.add_argument("--trace-dir", default=str(ROOT / "chiprun_out" / "phase_trace"))
    args, rest = ap.parse_known_args(argv)
    for path in (str(ROOT), args.src):
        sys.path.insert(0, path)
    info = card()
    if args.part == "bench":
        result = bench(rest, args.tracer)
    else:
        result = {"cost": cost, "syncs": syncs, "gap": gap}[args.part](args)
    import repro_torch

    print(json.dumps({**result, "device": info, "repro_torch": repro_torch.__file__}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
