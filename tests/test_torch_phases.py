"""The port's phase recorder (``repro_torch.phases``) and the ``obs`` repairs it rests on, on the CPU.

The recorder's device side runs here on fake events and a fake stream: a
pair is resolved only once its end event says it is done, and only
``flush`` waits.  The rest runs the real call sites at reduced sizes:
``generate`` and ``make_train_step`` give the same tokens and losses with a
tracer installed as without, their spans nest under one root, a phase with
no tracer allocates nothing but its observation, and under the CPU's
``torch.profiler`` a span's ``wall_ns`` lands on the annotation it opened.
"""

from __future__ import annotations

import ctypes.util
import json
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs, phases  # noqa: E402
from repro_torch.analysis import lint_source  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import epoch, load_events, wall_ns  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

CUDA = torch.device("cuda")  # a device object only: nothing here runs on a card


@pytest.fixture
def registry():
    """A fresh process-global metrics registry for the test, the previous one restored after."""
    fresh = MetricsRegistry()
    previous = obs.set_metrics(fresh)
    try:
        yield fresh
    finally:
        obs.set_metrics(previous)


class FakeEvent:
    """A timing event whose completion the test sets; counts the reads and the waits."""

    def __init__(self):
        self.done = False
        self.at = None
        self.reads = self.waits = 0


class FakeEvents:
    """The recorder's device side over fake events and one fake stream with a clock."""

    def __init__(self):
        self.made = 0
        self.clock = 0
        self.capture = False

    def make(self):
        self.made += 1
        return FakeEvent()

    def capturing(self):
        return self.capture

    def stream(self, device):
        return 1

    def record(self, event, stream):
        event.done, event.at = False, self.clock

    def elapsed_ms(self, start, end):
        end.reads += 1
        return float(end.at - start.at) if end.done else None

    def wait(self, event):
        event.waits += 1
        event.done = True


def test_pairs_resolve_lazily_and_only_flush_waits(registry):
    fake = FakeEvents()
    rec = phases.Recorder(events=fake)
    with rec.phase("a", CUDA):
        fake.clock = 7
    assert len(rec.pending) == 1
    (_, start, end, _), = rec.pending
    with rec.phase("b"):  # host only: resolves at entry, finds nothing done
        with rec.phase("c"):  # not outermost: does not look
            pass
    assert len(rec.pending) == 1 and end.reads == 1 and end.waits == 0
    assert registry.histogram("a.device_ms").count == 0
    assert registry.histogram("a.host_ms").count == 1 and registry.histogram("b.host_ms").count == 1
    end.done = True
    with rec.phase("b"):
        pass
    assert not rec.pending and end.waits == 0
    assert registry.histogram("a.device_ms").values() == [7.0]
    # the events went back to the pool: the next pair makes none
    made = fake.made
    with rec.phase("a", CUDA):
        fake.clock = 10
    assert fake.made == made
    (_, start, end, _), = rec.pending
    rec.flush()
    assert end.waits == 1 and not rec.pending
    assert registry.histogram("a.device_ms").values() == [7.0, 3.0]


def test_a_pair_not_done_holds_back_the_later_ones_of_its_stream(registry):
    fake = FakeEvents()
    rec = phases.Recorder(events=fake)
    with rec.phase("outer"):
        for _ in range(3):
            with rec.phase("a", CUDA):
                fake.clock += 2
    ends = [end for _, _, end, _ in rec.pending]
    ends[0].done = ends[2].done = True
    with rec.phase("b"):
        pass
    assert [e.reads for e in ends] == [1, 1, 0] and len(rec.pending) == 2
    assert registry.histogram("a.device_ms").values() == [2.0]
    ends[1].done = True
    with rec.phase("b"):
        pass
    assert not rec.pending and not any(e.waits for e in ends)
    assert registry.histogram("a.device_ms").values() == [2.0, 2.0, 2.0]


def test_no_events_inside_a_capture_and_none_off_cuda(registry):
    fake = FakeEvents()
    rec = phases.Recorder(events=fake)
    fake.capture = True
    with rec.phase("a", CUDA):
        pass
    with rec.phase("a", torch.device("cpu")):
        pass
    assert not rec.pending and fake.made == 0 and registry.histogram("a.host_ms").count == 2


def test_names_are_the_phases_entered(registry):
    """``phases.names()``: what a profile's ranges of the port's phases are called (``chip_smoke.py``
    leaves them out of a call's kernels)."""
    before = phases.names()
    with phases.phase("test.names.outer"):
        with phases.phase("test.names.inner"):
            pass
    assert phases.names() - before == {"test.names.outer", "test.names.inner"}


def test_histogram_window_and_values_are_a_copy():
    h = Histogram("h", window=3)
    for v in range(5):
        h.observe(v)
    got = h.values()
    assert got == [2.0, 3.0, 4.0] and h.count == 5 and h.total == 10.0
    got.append(9.0)
    assert h.values() == [2.0, 3.0, 4.0]


def test_spans_nest_with_ids_parents_and_one_root():
    tracer = obs.Tracer(None)
    with obs.tracing(tracer):
        with obs.span("root"):
            with obs.span("child"):
                with obs.span("leaf"):
                    pass
        with obs.span("other"):
            pass
    spans = {e["name"]: e["args"] for e in tracer.events() if e["ph"] == "X"}
    root, child, leaf, other = (spans[n] for n in ("root", "child", "leaf", "other"))
    assert root["parent_id"] is None and root["root_id"] == root["span_id"]
    assert child["parent_id"] == root["span_id"] and leaf["parent_id"] == child["span_id"]
    assert child["root_id"] == leaf["root_id"] == root["span_id"]
    assert other["root_id"] == other["span_id"] != root["span_id"]
    assert len({a["span_id"] for a in spans.values()}) == 4


def test_each_thread_has_its_own_stack():
    tracer = obs.Tracer(None)
    with obs.tracing(tracer):
        with obs.span("main"):
            t = threading.Thread(target=lambda: obs.span("worker").__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    spans = {e["name"]: e["args"] for e in tracer.events() if e["ph"] == "X"}
    assert spans["worker"]["parent_id"] is None


@pytest.fixture(scope="module")
def mamba():
    cfg = reduced(get_config("mamba2-780m"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(2, 40))
    return cfg, params, prompts


def test_generate_is_bitwise_the_same_traced_and_its_spans_share_a_root(mamba, registry):
    cfg, params, prompts = mamba
    plain = generate(cfg, params, prompts, 4, device="cpu")
    tracer = obs.Tracer(None)
    with obs.tracing(tracer):
        traced = generate(cfg, params, prompts, 4, device="cpu")
    assert torch.equal(plain, traced)
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["serve.prefill", "serve.first_token", "serve.decode", "serve.generate"]
    root = spans[-1]["args"]
    assert root["batch"] == 2 and root["prompt"] == 40 and root["gen"] == 4 and root["batch_id"] == 2
    assert {e["args"]["root_id"] for e in spans} == {root["span_id"]}
    by_name = {e["name"]: e["args"] for e in spans}
    assert by_name["serve.prefill"]["parent_id"] == by_name["serve.first_token"]["span_id"]
    assert by_name["serve.decode"]["parent_id"] == root["span_id"]
    counters = registry.snapshot()["counters"]
    assert counters["serve.batches"] == 2 and counters["serve.prompt_tokens"] == 160
    assert counters["serve.generated_tokens"] == 16
    assert registry.histogram("serve.generate.host_ms").count == 2


def test_train_losses_are_bitwise_the_same_traced(registry):
    cfg = reduced(get_config("mamba2-780m"))

    def three_losses():
        params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu", param_dtype=torch.float32)
        opt = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=10))
        rng = np.random.default_rng(2)
        losses = []
        for _ in range(3):
            ids = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 33)), dtype=torch.long)
            params, opt, m = step(params, opt, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
            losses.append(m["loss"])
        return torch.stack(losses)

    plain = three_losses()
    tracer = obs.Tracer(None)
    with obs.tracing(tracer):
        traced = three_losses()
    assert torch.equal(plain, traced)
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    steps = [e for e in spans if e["name"] == "train.step"]
    assert [s["args"]["step_id"] for s in steps] == [4, 5, 6]
    for s in steps:
        kids = [e["name"] for e in spans if e["args"]["parent_id"] == s["args"]["span_id"]]
        assert kids == ["train.forward", "train.backward", "train.optimizer"]
    assert registry.snapshot()["counters"]["train.steps"] == 6
    assert registry.histogram("train.backward.host_ms").count == 6


def test_a_phase_with_no_tracer_allocates_nothing_but_its_observation(registry):
    rec = phases.Recorder()
    n = 2000
    for _ in range(10):  # the site, its phase object and the histogram exist before counting
        with rec.phase("p"):
            pass
    hist = registry.histogram("p.host_ms")
    plain = registry.histogram("plain")
    clock = time.perf_counter
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(n):
            plain.observe((clock() - clock()) * 1e3)  # a new float each time, as a phase's host time
        mid = tracemalloc.take_snapshot()
        for _ in range(n):
            with rec.phase("p"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    observe_only = sum(s.size_diff for s in mid.compare_to(before, "filename"))
    with_phase = sum(s.size_diff for s in after.compare_to(mid, "filename"))
    assert hist.count == n + 10
    # slack for a few of the deques' 528-byte blocks; one object a phase would be 2000 x 16 bytes or more
    assert with_phase <= observe_only + 4096, (with_phase, observe_only)


def test_a_spans_wall_ns_lands_on_its_record_function_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    tracer = obs.Tracer(None)
    with obs.tracing(tracer), profile(activities=[ProfilerActivity.CPU]) as prof:
        with phases.phase("phase.under_profiler"):
            torch.ones(64).sum()
    span, = [e for e in tracer.events() if e.get("name") == "phase.under_profiler" and e["ph"] == "X"]
    ann, = [e for e in prof.profiler.kineto_results.events() if e.name() == "phase.under_profiler"]
    start, end = tracer.wall_ns(span["ts"]), tracer.wall_ns(span["ts"] + span["dur"])
    assert abs(start - ann.start_ns()) < 1_000_000
    assert abs(end - (ann.start_ns() + ann.duration_ns())) < 1_000_000


def test_in_memory_tracer_exports_chrome_with_its_epoch(tmp_path):
    tracer = obs.Tracer(None)
    with obs.tracing(tracer), obs.span("s"):
        pass
    out = tmp_path / "t.json"
    assert tracer.export_chrome(str(out)) == len(tracer.events())
    doc = json.loads(out.read_text())
    assert doc["otherData"] == {"epoch_wall": tracer.epoch_wall, "epoch_perf": tracer.epoch_perf}
    assert load_events(str(out)) == doc["traceEvents"]
    assert epoch(doc["traceEvents"])["wall"] == tracer.epoch_wall
    assert wall_ns(1.5, 2.0) == 2_000_001_500


def test_report_self_time_and_chrome_epoch_on_a_synthetic_trace(tmp_path, capsys):
    trace = tmp_path / "t.jsonl"
    records = [
        {"ph": "M", "name": "trace_epoch", "pid": 1, "tid": 0, "ts": 0, "args": {"wall": 100.0, "perf": 5.0}},
        {"ph": "X", "name": "step", "pid": 1, "tid": 1, "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "name": "fwd", "pid": 1, "tid": 1, "ts": 100.0, "dur": 300.0},
        {"ph": "X", "name": "inner", "pid": 1, "tid": 1, "ts": 150.0, "dur": 100.0},
        {"ph": "X", "name": "bwd", "pid": 1, "tid": 1, "ts": 450.0, "dur": 500.0},
        {"ph": "X", "name": "other", "pid": 1, "tid": 2, "ts": 200.0, "dur": 50.0},
    ]
    trace.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert report.self_times(records) == [200.0, 200.0, 100.0, 500.0, 50.0]
    chrome = tmp_path / "out.json"
    assert report.main([str(trace), "--chrome", str(chrome)]) == 0
    table = capsys.readouterr().out
    row = next(line for line in table.splitlines() if line.startswith("step "))
    assert row.split()[6] == "0.200"  # self_ms: 1.0 ms less fwd's 0.3 and bwd's 0.5
    assert "self_ms" in table
    assert json.loads(chrome.read_text())["otherData"] == {"epoch_wall": 100.0, "epoch_perf": 5.0}


def test_phase_names_built_at_a_call_site_are_flagged():
    bad = "from repro_torch import phases\ndef f(n):\n    with phases.phase(f'train.{n}'):\n        pass\n"
    good = "from repro_torch import phases\ndef f():\n    with phases.phase('train.step'):\n        pass\n"
    assert {f.rule for f in lint_source(bad, module="repro_torch.train.x").findings} == {"obs-zero-overhead"}
    assert not lint_source(good, module="repro_torch.train.x").findings


def test_kernel_loads_count_builds_and_cache_hits(monkeypatch, registry):
    libc = ctypes.util.find_library("c")
    seconds = {"fresh": 1.5, "old": 0.0}
    monkeypatch.setattr(build, "build", lambda name: (Path(libc), "", seconds[name]))
    build.load.cache_clear()
    tracer = obs.Tracer(None)
    try:
        with obs.tracing(tracer):
            build.load("fresh")
            build.load("old")
            build.load("old")
    finally:
        build.load.cache_clear()
    counters = registry.snapshot()["counters"]
    assert counters["kernels.builds"] == 1 and counters["kernels.cache_loads"] == 1
    loads = [e["args"] for e in tracer.events() if e.get("name") == "kernels.load"]
    assert [(a["kernel"], a["build"]) for a in loads] == [("fresh", "built"), ("old", "cached")]


def test_the_launchers_write_a_trace_and_a_snapshot_that_the_report_renders(tmp_path, capsys, registry):
    serve_launch.main(["--arch", "mamba2-780m", "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "24", "--gen", "3", "--trace-dir", str(tmp_path)])
    train_launch.main(["--arch", "mamba2-780m", "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32", "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "100",
                       "--trace-dir", str(tmp_path)])
    capsys.readouterr()
    for stem, span in (("serve", "serve.generate"), ("train", "train.step")):
        trace, = tmp_path.glob(f"{stem}-*[0-9].json")
        snapshot, = tmp_path.glob(f"{stem}-*.metrics.json")
        assert report.main([str(trace)]) == 0
        assert span in capsys.readouterr().out
        assert report.main([str(snapshot)]) == 0
        assert span + ".host_ms" in capsys.readouterr().out
