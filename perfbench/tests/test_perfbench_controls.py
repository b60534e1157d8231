"""The comparison that decides ``correct`` fails what it must: the control and each fault.

On the CPU, at the port's reduced sizes: a run drives the rest of a cell
(``harness.run_cell``, no look for a card) with its timed path broken
underneath, once per fault the cell can have, and ``correct`` must come out
false, while the same run unbroken comes out true, under the cell's own
limits.  The control, the reference with fp8 products put in the program's
place (``perfbench.reference.lowp``), must read far above the program.  On
the card, ``test_the_control_fails_every_cell_at_its_size`` runs the control
at the cell's own sizes on three seeds (``perfbench/calibrate.py``'s
readings) against the cell's limits.
"""

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT
from perfbench.tests.test_perfbench_harness import BENCH, WORKLOADS, small_cell

DRIVERS = {w: harness.driver(harness.load_cell(w, 1, 1.0, False, 0.0, ROOT)[0].traffic["kind"]) for w in WORKLOADS}
#: the one-process cells by the faults that their drivers name (a ranked kind's are planted in test_perfbench_ranks)
SERVE = [w for w, drv in DRIVERS.items() if "fault_token" in drv.FAULTS and not hasattr(drv, "run_rank")]
TRAIN = [w for w, drv in DRIVERS.items() if "fault_half_batch" in drv.FAULTS and not hasattr(drv, "run_rank")]
#: a serving kind of another name, added as a driver file (``serve.py``'s text) and a mix
NEW_KIND = "serve_again"


def _altered_generate(monkeypatch):
    """``generate`` whose middle token of every request is the next id: a token altered where it is produced."""
    from repro_torch.launch import serve

    real = serve.generate

    def generate(cfg, params, prompts, gen_len, device=None, extras=None):
        tokens = real(cfg, params, prompts, gen_len, device=device, extras=extras)
        tokens[:, gen_len // 2] = (tokens[:, gen_len // 2] + 1) % cfg.vocab
        return tokens

    monkeypatch.setattr(serve, "generate", generate)


def _broken_step(monkeypatch, fault: str):
    """``make_train_step`` whose step returns its state unchanged, or takes half of the batch."""
    from repro_torch.train import steps

    real = steps.make_train_step

    def make_train_step(cfg, opt_cfg, *args, **kwargs):
        step = real(cfg, opt_cfg, *args, **kwargs)

        def broken(params, opt_state, batch):
            if fault == "unchanged":
                _, _, metrics = step(params, opt_state, batch)
                return params, opt_state, metrics
            half = batch["tokens"].shape[0] // 2
            return step(params, opt_state, {k: v[:half] for k, v in batch.items()})

        return broken

    monkeypatch.setattr(steps, "make_train_step", make_train_step)


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", [None, "token"])
def test_a_served_token_altered_where_it_is_produced_is_not_correct(workload, fault, monkeypatch):
    if fault:
        _altered_generate(monkeypatch)
    line, _ = harness.run_cell(small_cell(workload, seed=21), BENCH)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(workload, fault, monkeypatch):
    if fault:
        _broken_step(monkeypatch, fault)
    line, _ = harness.run_cell(small_cell(workload, seed=22), BENCH)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("seed", [31, 32])
def test_the_fp8_control_reads_far_above_the_program_when_serving(seed):
    from perfbench import calibrate

    cell = small_cell(SERVE[0], seed=seed, traffic={"check_requests": 4})
    readings = calibrate.readings(cell, control=True)
    assert readings["control.logit_gap"] >= 3 * max(readings["logit_gap"], 1e-3)
    assert readings["fault_token.logit_gap"] > readings["logit_gap"]


def test_the_fp8_control_reads_far_above_the_program_when_training():
    from perfbench import calibrate

    readings = calibrate.readings(small_cell(TRAIN[0], seed=33), control=True)
    assert readings["control.grad_gap"] >= 3 * readings["grad_gap"]
    assert readings["fault_unchanged.grad_gap"] == readings["fault_unchanged.change_gap"] == 1.0


def test_a_one_process_kind_added_as_files_gives_its_readings_without_edits(tmp_path):
    """``calibrate.py`` takes a new kind's readings and the multiples it counts them at from its driver."""
    import json
    import shutil

    from perfbench import calibrate
    from perfbench.tests.test_perfbench_harness import _digest, copy_tree

    here = copy_tree(tmp_path)
    before = _digest(tmp_path)
    shutil.copy(here / "drivers/serve.py", here / f"drivers/{NEW_KIND}.py")
    mix = {**json.loads((here / "traffic/prompt-2k.json").read_text()), "kind": NEW_KIND}
    (here / f"traffic/{NEW_KIND}.json").write_text(json.dumps(mix))
    name = f"mamba2-780m.{NEW_KIND}"
    (here / f"limits/{name}.json").write_text((here / f"limits/{SERVE[0]}.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "mamba2-780m", "traffic": NEW_KIND, "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = small_cell(name, seed=34, root=tmp_path)
    assert cell.traffic["kind"] == NEW_KIND and cell.model == small_cell(SERVE[0]).model  # its SMALL_KEEPS
    readings = calibrate.readings(cell, control=True)
    assert set(readings) == {"logit_gap", "control.logit_gap", "fault_token.logit_gap"}
    faults = harness.driver(NEW_KIND, cell.here).FAULTS
    summary = calibrate.summary([readings], faults)["logit_gap"]
    assert summary["readings"] == {"control": readings["control.logit_gap"],
                                   "fault_token": readings["fault_token.logit_gap"]}
    assert summary["lower"] == readings["logit_gap"]
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before  # no file that was there changed


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_every_cell_at_its_size(workload, card):
    """At the cell's own sizes on three seeds: the program within every limit, the control past one."""
    import torch

    from perfbench import calibrate

    if harness.load_cell(workload, 1, 0.0, False, 0.0, ROOT)[1]["chips"] > torch.cuda.device_count():
        pytest.skip(f"{workload} needs more cards than this machine has")
    for seed in (2147483001, 2147483002, 2147483003):
        cell, _ = harness.load_cell(workload, seed, 0.0, False, 0.0, ROOT)
        readings = calibrate.readings(cell, control=True)
        assert all(readings[k] <= lim for k, lim in cell.limits.items()), readings
        assert any(readings[f"control.{k}"] > lim for k, lim in cell.limits.items()), readings
