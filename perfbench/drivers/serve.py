"""The serving driver: a closed loop of ``generate`` calls, then the served tokens against the reference.

Set-up makes the weights on the device from the seed and runs one
``repro_torch.launch.serve.generate`` at the mix's shapes (which builds or
loads the kernels and warms every shape the window uses).  The window is a
closed loop: one client makes a batch of ``batch`` prompts of ``prompt``
uniform token ids from the seed, calls ``generate`` for ``gen`` greedy tokens
and waits until the tokens are on the host, then sends the next batch, until
``--seconds`` have passed; the batch in flight then is finished.  Each
request's latency runs from its batch's call to its tokens on the host.
``generate`` runs the eager prefill, captures the decode step as a CUDA graph
(``train.steps.capture_serve_step``) and replays it for the other tokens.

A traced run wraps, from here, ``transformer.forward``'s prefill and the
capture in spans, times each batch's replays by CUDA events, records the
kernels' calls, and profiles one whole batch of the window (prefill,
capture and every replay), another if that one's records are incomplete.

Then the comparison: a sample of the finished requests, drawn from the seed,
goes through the plain float32 reference (prompt and served tokens, teacher
forced), and each served token's logit is read against the reference's best
at its position.  ``logit_gap``, the widest of those gaps, is compared with
the cell's limit.  Greedy tokens only, so the gap is zero wherever the
program agrees with the reference on the best token.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from perfbench import harness, trace, weights
from perfbench.reference import model as ref

PROFILE_TRIES = 4
#: the traffic that a CPU run of the benchmark's tests shrinks to
SMALL = {"batch": 2, "prompt": 40, "gen": 5, "check_requests": 3}
#: the model's sizes that such a run keeps at the configuration's (beside ``harness.EXECUTION_KEYS``):
#: the tied head's logits, which the comparison reads, scale with ``d_model``
SMALL_KEEPS = ("d_model",)
#: the readings that ``calibrate.py`` takes beside the program's on its control seeds (``readings``),
#: each with the multiple of the program's largest reading from which it counts as an upper one
FAULTS = {"control": 3, "fault_token": 10}


def prompts_for(seed: int, batch_index: int, batch: int, prompt: int, vocab: int) -> np.ndarray:
    """Batch ``batch_index``'s prompts: uniform token ids, the same for the same seed (-1: the warm-up's)."""
    rng = np.random.default_rng([seed, 1, batch_index + 1])
    return rng.integers(0, vocab, size=(batch, prompt), dtype=np.int64)


class Tracer:
    """A traced run's wrappers around the program's layers (see the module's note)."""

    def __init__(self, ops, transformer, steps):
        import torch

        self.torch, self.ops, self.T, self.steps = torch, ops, transformer, steps
        self.spans = trace.Spans()
        self.calls = trace.KernelCalls(ops)
        self.decode_ms: list[float] = []
        self.profiled: trace.Profiled | None = None
        self.kept: dict | None = None
        self._saved = None

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def install(self) -> None:
        T, steps, tracer = self.T, self.steps, self
        forward, capture = T.forward, steps.capture_serve_step
        self._saved = (forward, capture)

        def traced_forward(params, cfg, batch, cache=None):
            if cache is not None and batch["tokens"].shape[1] > 1:
                with tracer.spans.span("prefill", tracer.sync):
                    return forward(params, cfg, batch, cache)
            return forward(params, cfg, batch, cache)

        def traced_capture(cfg, params, cache, batch):
            with tracer.spans.span("capture", tracer.sync):
                step = capture(cfg, params, cache, batch)
            tracer._wrap_replay(step)
            return step

        T.forward, steps.capture_serve_step = traced_forward, traced_capture
        self.calls.install()

    def uninstall(self) -> None:
        self.T.forward, self.steps.capture_serve_step = self._saved
        self.calls.uninstall()

    def _wrap_replay(self, step) -> None:
        torch = self.torch
        replay = step.replay
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        count = [0]

        def timed_replay():
            if count[0] == 0:
                start.record()
            out = replay()
            count[0] += 1
            end.record()
            return out

        step.replay = timed_replay
        self._batch_events = (start, end, count)

    def batch_done(self) -> None:
        start, end, count = self._batch_events
        end.synchronize()
        if count[0]:
            self.decode_ms.append(start.elapsed_time(end) / count[0])
        if self.profiled is not None:
            self.stop_profile()

    def start_profile(self) -> None:
        self.profiled = trace.Profiled(self.ops, self.calls)
        self.profiled.start()

    def stop_profile(self) -> None:
        result = self.profiled.stop()
        self.profiled = None
        if self.kept is None or not all(self.kept["complete"].values()):
            self.kept = result

    @property
    def done(self) -> bool:
        return self.kept is not None and all(self.kept["complete"].values())


class GcClock:
    """Seconds that Python's cyclic collector takes while installed (``gc.callbacks``): a stall in
    a batch is told apart from the collector's by it."""

    def __init__(self):
        self.total, self.longest, self.count, self._t = 0.0, 0.0, 0, None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            took = time.perf_counter() - self._t
            self.total += took
            self.longest = max(self.longest, took)
            self.count += 1
            self._t = None


def run(cell) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer
    from repro_torch.train import steps

    cfg = harness.port_config(cell.config)
    m, tr, dev = cell.model, cell.traffic, cell.device
    family = cell.config["family"]
    batch, prompt, gen = tr["batch"], tr["prompt"], tr["gen"]
    cuda = dev == "cuda"
    if cell.trace and not cuda:
        raise ValueError("a traced run profiles the card: it needs device cuda")

    t_weights = time.perf_counter()
    params = weights.make(family, m, cell.seed, dev, torch.bfloat16)
    t_warm = time.perf_counter()
    generate(cfg, params, prompts_for(cell.seed, -1, batch, prompt, m["vocab"]), gen, device=dev).cpu()
    tracer = Tracer(ops, transformer, steps) if cell.trace else None
    if tracer:
        tracer.install()
    setup_s = time.perf_counter() - cell.t_start
    print(f"set-up: to the weights {t_weights - cell.t_start:.3f} s, weights {t_warm - t_weights:.3f} s, "
          f"warm-up {cell.t_start + setup_s - t_warm:.3f} s", file=sys.stderr)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    served, latencies = [], []
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < cell.seconds:
        prompts = prompts_for(cell.seed, i, batch, prompt, m["vocab"])
        profile_this = tracer is not None and i >= 1 and not tracer.done and i <= PROFILE_TRIES
        if profile_this:
            tracer.start_profile()
        tb = time.perf_counter()
        tokens = generate(cfg, params, prompts, gen, device=dev).cpu().numpy()
        latencies.append(time.perf_counter() - tb)
        if tracer:
            tracer.batch_done()
        served.append((prompts, tokens))
        i += 1
    t_end = time.perf_counter()
    gc.callbacks.remove(gc_clock)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    if tracer:
        tracer.uninstall()

    e2e = {
        "latency_p95_ms": 1e3 * harness.nearest_rank([lat for lat in latencies for _ in range(batch)], 0.95),
        "out_tok_s": batch * gen * len(served) / (t_end - t0),
        "setup_s": setup_s,
    }
    print(f"window: {len(served)} batches in {t_end - t0:.3f} s, batch s min {min(latencies):.4f} median "
          f"{harness.median(latencies):.4f} max {max(latencies):.4f}; set-up {setup_s:.3f} s", file=sys.stderr)
    print(f"batches ms: {[round(1e3 * lat, 1) for lat in latencies]}; collector {gc_clock.count} runs, "
          f"{gc_clock.total:.4f} s, longest {gc_clock.longest:.4f} s; reserved "
          f"{torch.cuda.memory_reserved() if cuda else 0} bytes", file=sys.stderr)
    if tracer:
        print(f"capture ms: {[round(1e3 * c, 1) for c in tracer.spans.by_name['capture']]}", file=sys.stderr)
    ctx = {"model": m, "traffic": tr, "peak_bytes_window": peak_window}
    if tracer:
        ctx.update(spans=dict(tracer.spans.by_name), decode_ms=tracer.decode_ms, profile=tracer.kept)

    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gap = logit_gap(cell, served)
    return {"e2e": e2e, "ctx": ctx, "profile": tracer.kept if tracer else None,
            "attempted": batch * len(served), "failed": 0,
            "device": harness.device_info(dev, max(peak_setup, peak_window)),
            "checks": {"logit_gap": (gap, cell.limits["logit_gap"])}}


def readings(cell, control: bool) -> dict:
    """``calibrate.py``'s readings: the program's ``logit_gap`` over as many requests as a run
    compares, served by the window's own call and, with ``control``, those of the fp8 control (the
    gap of the token that it puts first) and of a served token altered where it is produced (the
    next id in the vocabulary)."""
    import torch

    from perfbench.reference.lowp import fp8_matmul
    from repro_torch.launch.serve import generate

    cfg = harness.port_config(cell.config)
    m, tr = cell.model, cell.traffic
    params = weights.make(cell.config["family"], m, cell.seed, cell.device, torch.bfloat16)
    served = []
    for i in range(-(-tr["check_requests"] // tr["batch"])):
        prompts = prompts_for(cell.seed, i, tr["batch"], tr["prompt"], m["vocab"])
        served.append((prompts, generate(cfg, params, prompts, tr["gen"], device=cell.device).cpu().numpy()))
    del params
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    requests = sample_requests(cell, served)
    want = reference_logits(cell, requests)
    out = {"logit_gap": max(gaps(want, [t for _, t in requests]))}
    if control:
        low = reference_logits(cell, requests, fp8_matmul)
        out["control.logit_gap"] = max(gaps(want, [lg.argmax(dim=-1).cpu().numpy() for lg in low]))
        altered = [np.where(np.arange(len(t)) == len(t) // 2, (t + 1) % m["vocab"], t) for _, t in requests]
        out["fault_token.logit_gap"] = max(gaps(want, altered))
    return out


def sample_requests(cell, served: list) -> list:
    """The requests the comparison reads: ``check_requests`` of the finished ones, drawn from the seed.
    Every request of a mix has the same length, so the longest are among them."""
    n = len(served) * cell.traffic["batch"]
    k = min(cell.traffic["check_requests"], n)
    picks = np.random.default_rng([cell.seed, 3]).choice(n, size=k, replace=False)
    b = cell.traffic["batch"]
    return [(served[p // b][0][p % b], served[p // b][1][p % b]) for p in sorted(picks)]


def reference_logits(cell, requests: list, matmul=ref.fp32_matmul):
    """Per request, the reference's float32 logits (gen, V) at the positions that chose its served tokens."""
    import torch

    m, family, dev = cell.model, cell.config["family"], cell.device
    params = weights.make(family, m, cell.seed, dev, torch.bfloat16)
    prompt = cell.traffic["prompt"]
    out = []
    per_call = max(1, 8192 // (prompt + cell.traffic["gen"]))
    with ref.fp32_matmuls():
        for i in range(0, len(requests), per_call):
            group = requests[i:i + per_call]
            seqs = torch.as_tensor(np.stack([np.concatenate([p, t[:-1]]) for p, t in group]), device=dev)
            logits = ref.logits_at(family, params, m, seqs, slice(prompt - 1, None), matmul)
            out += list(logits)
    return out


def gaps(logits: list, chosen: list) -> list[float]:
    """Per request, the widest gap of a chosen token's reference logit below the reference's best."""
    import torch

    widest = []
    for lg, tok in zip(logits, chosen):
        tok = torch.as_tensor(np.asarray(tok), device=lg.device).long()
        picked = lg.gather(-1, tok[:, None])[:, 0]
        widest.append(float((lg.max(dim=-1).values - picked).max()))
    return widest


def logit_gap(cell, served: list) -> float:
    requests = sample_requests(cell, served)
    return max(gaps(reference_logits(cell, requests), [t for _, t in requests]))
