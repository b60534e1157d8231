"""The OLMoE cell's own pieces on the CPU: its yardstick against the program's, its readers, its
reference's leaves.

``costs_moe.py`` copies the program's cost of the grouped expert products
(``repro_torch/kernels/costs.py``); these tests pin the copy at the cell's
shapes.  The readers of the MoE phases sum a prefill's layers and take the
median over the window's batches, and read nothing from a program without
the phases; the roofline reader reads the prefill entry point's device time
of a profiled batch.  The reference's leaf tree is the one the port's
``init_params`` makes for the family, so one tree from the seed serves both.
"""

import builtins
import dataclasses
import json

import pytest

from perfbench import costs, costs_moe, harness, weights
from perfbench.tests.conftest import ROOT

CELL = "olmoe-1b-7b-0924.prompt-4k"
MODEL = json.loads((ROOT / "perfbench/configs/olmoe-1b-7b-0924.json").read_text())["model"]
TRAFFIC = json.loads((ROOT / "perfbench/traffic/prompt-4k.json").read_text())
# (rows, experts, d, f): the cell's prefill (8 x 4,080 tokens, top 8) and decode (8 tokens), a ragged case
GROUPED = [(8 * 4080 * 8, 64, 2048, 1024), (64, 41, 2048, 1024), (300, 5, 128, 64)]
PHASE_READERS = {"moe_experts_ms.prefill": "moe.experts.device_ms", "moe_route_ms.prefill": "moe.route.device_ms"}


@pytest.mark.parametrize("args", GROUPED)
def test_moe_grouped_cost_is_the_programs(args):
    from repro_torch.kernels import costs as program

    assert costs_moe.moe_grouped_cost(*args) == program.moe_grouped_cost(*args)


def test_the_prefill_flops_count_the_active_products_attention_and_the_head():
    m, b, s = MODEL, TRAFFIC["batch"], TRAFFIC["prompt"]
    tokens = b * s
    experts = 16 * 6 * tokens * 8 * 2048 * 1024
    assert round(experts / 1e12, 1) == 52.6  # the grouped products: three quarters of the prefill
    flops = costs_moe.moe_prefill_flops(m, b, s)
    head = 2 * tokens * 2048 * 50304
    attn = 16 * costs.flash_cost(b, s, s, 16, 16, 128, 2, True)[1]
    proj = 16 * 2 * tokens * 2048 * 4 * 2048
    router = 16 * 2 * tokens * 2048 * 64
    assert flops == experts + head + attn + proj + router
    least = costs_moe.prefill_grouped_least_ms(m, b, s)
    assert least == pytest.approx(16 * costs.least_ms(*costs_moe.moe_grouped_cost(tokens * 8, 64, 2048, 1024)))
    assert 50 < least < 60  # ms: operations bind it (3.29 TFLOP a layer at 989 TFLOP/s)


@pytest.fixture
def program(monkeypatch):
    from repro_torch import obs, phases
    from repro_torch.obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    previous = obs.set_metrics(registry)
    monkeypatch.setattr(phases, "flush", lambda: None)
    try:
        yield registry
    finally:
        obs.set_metrics(previous)


@pytest.mark.parametrize("name", sorted(PHASE_READERS))
def test_phase_readers_sum_each_prefills_layers_then_take_the_median(name, program):
    for v in [100.0] * 3 + [1.0, 2.0, 3.0] + [2.0, 2.0, 2.0] + [5.0, 5.0, 5.0]:  # set-up, then three prefills
        program.histogram(PHASE_READERS[name]).observe(v)
    ctx = {"spans": {"prefill": [0.1] * 3}, "model": {"n_layers": 3}}
    assert harness.reader(name).read(ctx) == 6.0
    assert harness.reader(name).read({**ctx, "spans": {"prefill": [0.1] * 5}}) is None  # fewer observations
    assert harness.reader(name).read({"model": {"n_layers": 3}}) is None  # untraced


@pytest.mark.parametrize("name", sorted(PHASE_READERS))
def test_phase_readers_read_nothing_from_a_program_without_phases(name, monkeypatch):
    real_import = builtins.__import__

    def no_phases(module, globals=None, locals=None, fromlist=(), level=0):
        if module == "repro_torch" and fromlist and "phases" in fromlist:
            raise ImportError("no repro_torch.phases in this checkout")
        return real_import(module, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_phases)
    assert harness.reader(name).read({"spans": {"prefill": [0.1]}, "model": {"n_layers": 1}}) is None


def _profile(kernel_s: dict, complete: bool = True) -> dict:
    return {"kernel_s": kernel_s, "complete": {"flash_attention": complete, "ssd_scan": True, "ssd_scan_bwd": True}}


def test_the_roofline_reader_reads_the_prefill_entry_point_only():
    read = harness.reader("moe_grouped_roofline.prefill").read
    ctx = {"model": MODEL, "traffic": TRAFFIC}
    least_s = costs_moe.prefill_grouped_least_ms(MODEL, TRAFFIC["batch"], TRAFFIC["prompt"]) / 1e3
    profile = _profile({"moe_grouped_prefill": 4 * least_s, "moe_grouped_decode": 1.0})
    assert read({**ctx, "profile": profile}) == pytest.approx(25.0)
    assert read({**ctx, "profile": _profile({"moe_grouped_decode": 1.0})}) is None  # a parent: no such kernel
    assert read({**ctx, "profile": _profile({"moe_grouped_prefill": 1.0}, complete=False)}) is None
    assert read(ctx) is None


def test_mfu_reads_the_median_prefill_span():
    read = harness.reader("mfu.prefill_moe").read
    flops = costs_moe.moe_prefill_flops(MODEL, TRAFFIC["batch"], TRAFFIC["prompt"])
    seconds = flops / costs.PEAK_FLOPS["bfloat16"] / 0.25
    ctx = {"model": MODEL, "traffic": TRAFFIC, "spans": {"prefill": [seconds, seconds, 9.0]}}
    assert read(ctx) == pytest.approx(25.0)
    assert read({**ctx, "spans": {}}) is None


def test_the_references_leaves_are_the_ports():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced

    cfg = reduced(get_config("olmoe-1b-7b-0924"))
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab", "tie_embeddings",
              "moe_experts", "moe_top_k", "qk_norm")
    m = {f: getattr(cfg, f) for f in fields}
    ours = {p: tuple(t.shape) for p, t in weights.named_leaves(weights.make("moe", m, 1, "cpu", torch.bfloat16))}
    port = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ours == {p: tuple(t.shape) for p, t in weights.named_leaves(port)}
    assert {p for p in ours if p.endswith(("q_norm", "k_norm"))} == {f"layers.{i}.attn.{n}" for i in range(2)
                                                                    for n in ("q_norm", "k_norm")}
    plain = dataclasses.replace(cfg, qk_norm=False)
    m_plain = {**m, "qk_norm": False}
    assert {p for p, *_ in weights.leaf_specs("moe", m_plain)} == {p for p, _ in weights.named_leaves(
        T.init_params(plain, torch.Generator().manual_seed(0), "cpu"))}


def test_the_cell_is_declared_with_the_serve_metrics():
    bench = harness.benchmark(ROOT)
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 1 and entry["traffic"] == "prompt-4k" and entry["config"] == "olmoe-1b-7b-0924"
    reported = {m["name"] for m in bench["end_to_end"] + bench["per_layer"] if harness.applies(m, CELL)}
    # first_token_ms, graph_record_ms and device_allocs.serve stay the mamba cell's alone, as
    # test_perfbench_program_spans.py pins them
    assert reported == {"latency_p95_ms", "out_tok_s", "setup_s", "prefill_ms", "capture_ms",
                        "decode_step_ms", "idle_share.serve", "peak_gib.serve", "moe_experts_ms.prefill",
                        "moe_route_ms.prefill", "moe_grouped_roofline.prefill", "mfu.prefill_moe"}
