"""The per-layer metrics that read the program's own phases and counters, on a synthetic registry.

Each reader flushes the program's pending device times, then takes the
median of the last N observations of its histogram, N the window's count of
the benchmark's own span; it reads nothing untraced, when the histogram is
shorter than the window, or when the program has no phase recorder.
"""

import builtins

import pytest

from perfbench import harness

READERS = {
    "first_token_ms": ("serve.first_token.device_ms", "prefill"),
    "graph_record_ms": ("serve.capture.record.host_ms", "prefill"),
    "device_allocs.serve": ("serve.device_allocs", "prefill"),
    "forward_ms.train": ("train.forward.device_ms", "train_step"),
    "backward_ms.train": ("train.backward.device_ms", "train_step"),
    "optimizer_ms.train": ("train.optimizer.device_ms", "train_step"),
    "dispatch_ms.train": ("train.step.host_ms", "train_step"),
}


@pytest.fixture
def program(monkeypatch):
    """A fresh registry for the program, and a log of its ``phases.flush`` calls."""
    from repro_torch import obs, phases
    from repro_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    previous = obs.set_metrics(registry)
    flushed = []
    monkeypatch.setattr(phases, "flush", lambda: flushed.append(len(registry.snapshot()["histograms"])))
    try:
        yield registry, flushed
    finally:
        obs.set_metrics(previous)


def test_every_new_reader_is_declared_for_its_cell():
    declared = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name, (_, span) in READERS.items():
        cell = "mamba2-780m.prompt-2k" if span == "prefill" else "mamba2-780m.train-4k"
        assert declared[name]["workloads"] == [cell]


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_takes_the_median_of_the_windows_observations_after_a_flush(name, program):
    registry, flushed = program
    histogram, span = READERS[name]
    for v in [1000.0, 900.0, 5.0, 3.0, 4.0, 100.0]:  # two set-up calls, then a window of four
        registry.histogram(histogram).observe(v)
    ctx = {"spans": {span: [0.1] * 4}}
    assert harness.reader(name).read(ctx) == 4.5
    assert flushed == [1]  # flushed once, with the histogram already there


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_untraced_or_short(name, program):
    registry, flushed = program
    histogram, span = READERS[name]
    for v in [1.0, 2.0]:
        registry.histogram(histogram).observe(v)
    reader = harness.reader(name)
    assert reader.read({}) is None and reader.read({"spans": {}}) is None
    assert reader.read({"spans": {span: [0.1] * 3}}) is None
    assert len(flushed) == 1


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_from_a_program_without_phases(name, monkeypatch):
    real_import = builtins.__import__

    def no_phases(module, globals=None, locals=None, fromlist=(), level=0):
        if module == "repro_torch" and fromlist and "phases" in fromlist:
            raise ImportError("no repro_torch.phases in this checkout")
        return real_import(module, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_phases)
    assert harness.reader(name).read({"spans": {READERS[name][1]: [0.1]}}) is None
