"""The port's measurement runtime against the reference's, on the CPU.

``repro_torch.runtime`` is a pinned copy of ``repro.runtime``
(``tests/test_torch_copies.py``); these tests hold what it does with the
port's platforms to what the reference does with its own: campaigns through
a worker pool, journals that each package replays into the other's
campaign, fault plans, a SIGKILLed worker, ``fsck`` and the hub's journal
compaction.  Every platform here is deterministic, so every comparison is
bitwise.

Each pool worker of the port imports torch (the port's platforms live in a
package that registers ``torch_device``), which takes seconds; the pools
here are few and every wait is bounded.
"""

import os
import shutil
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime.testing  # noqa: E402,F401  (registers "stepped_sim")
from repro import api as japi  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.checkpoint.manager import journal_path  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.batch import ConfigBatch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime import workers as tworkers  # noqa: E402
from repro_torch.runtime.faults import CHUNK_SITE, JOURNAL_SITE  # noqa: E402

#: every pool wait is bounded: a chunk attempt that outlasts this is retried
CHUNK_TIMEOUT_S = 60.0
FAST_FOREST = {"n_estimators": 4, "max_depth": 10}
TOY_QUERIES = [{"a": 3, "b": 31}, {"a": 10, "b": 5}, {"a": 33, "b": 17}, {"a": 64, "b": 1}]
COUNTS = ("measured", "cached", "replayed", "chunks", "retries", "failures")


def _counts(stats: dict) -> dict:
    return {k: stats[k] for k in COUNTS}


def _degradation(stats: dict) -> dict:
    d = dict(stats["degradation"])
    d["events"] = [e["kind"] for e in d["events"]]
    return d


@pytest.fixture
def stepped_sim():
    """The port's ``stepped_sim``, registered for one test only: the port's
    registry lists exactly its built-in platforms elsewhere
    (``test_torch_estimation.py``)."""
    from repro_torch import registry
    from repro_torch.runtime import testing

    registry.register_platform("stepped_sim", testing.SteppedSimPlatform)
    yield testing
    registry._REGISTRY.pop("stepped_sim", None)


def _held_out(n=60, seed=1):
    rng = np.random.default_rng(seed)
    return [{"tokens": int(rng.integers(16, 257)), "d_in": int(rng.integers(32, 769)),
             "d_out": int(rng.integers(32, 769))} for _ in range(n)]


# ------------------------------------------------------------ worker counts
@pytest.mark.parametrize("workers", [1, 2])
def test_pooled_torch_device_campaign_equals_the_reference(workers):
    """Synthetic ``torch_device`` against synthetic ``xla_cpu`` (the same
    deterministic model) through ``RuntimeSpec(workers=...)``: widths,
    predictions and the runtime's counts equal the reference's."""
    common = dict(layer_types=("dense",), n_samples=150, seed=0, sampling="pr")

    def spec(rt):
        return rt.RuntimeSpec(workers=workers, chunk_size=64, chunk_timeout_s=CHUNK_TIMEOUT_S)

    ref = japi.Campaign(japi.CampaignSpec(
        platform="xla_cpu", platform_kwargs={"synthetic": True}, **common))
    port = tapi.Campaign(tapi.CampaignSpec(
        platform="torch_device", platform_kwargs={"synthetic": True, "device": "cpu"}, **common))
    ref_oracle = ref.run(runtime=spec(japi))
    port_oracle = port.run(runtime=spec(tapi), device="cpu")
    assert dict(port_oracle.estimators["dense"].widths) == dict(ref_oracle.estimators["dense"].widths)
    cfgs = _held_out()
    expect = ref_oracle.predict("dense", cfgs, backend="numpy")
    for backend in ("torch", "numpy"):
        assert port_oracle.predict("dense", cfgs, backend=backend).tobytes() == expect.tobytes()
    assert _counts(port.last_run_stats) == _counts(ref.last_run_stats)
    assert port.last_run_stats["measured"] > 0 and port.last_run_stats["chunks"] > 1


# ------------------------------------------------- journals across packages
def _ultratrail(api, journal, workers=1):
    kwargs = {"device": "cpu"} if api is tapi else {}
    campaign = api.Campaign(api.CampaignSpec(
        platform="ultratrail", layer_types=("conv1d",), n_samples=60, seed=0,
        forest_kwargs=FAST_FOREST, platform_kwargs=kwargs))
    run_kwargs = {"device": "cpu"} if api is tapi else {}
    oracle = campaign.run(runtime=api.RuntimeSpec(
        workers=workers, chunk_size=16, journal_path=str(journal), chunk_timeout_s=CHUNK_TIMEOUT_S),
        **run_kwargs)
    return campaign, oracle


def test_journals_replay_across_the_packages_and_cpu_reaches_the_pool(tmp_path, monkeypatch):
    """The port's ultratrail campaign on the CPU through a pool of two
    workers, and the reference's serially, each journaled.  Each journal
    replays into the other package's campaign with nothing measured anew and
    bitwise the writer's predictions.  The pool ran here, where there is no
    card: its workers got ``"cpu"`` (a worker given None would open the card,
    which raises without one, as shown last)."""
    port, port_oracle = _ultratrail(tapi, tmp_path / "port.jsonl", workers=2)
    ref, ref_oracle = _ultratrail(japi, tmp_path / "ref.jsonl")
    queries = [{"C": c, "K": k, "C_w": w, "F": f, "s": s, "pad": pad} for c, k, w, f, s, pad in
               [(3, 8, 17, 3, 1, 0), (40, 16, 101, 5, 2, 1), (56, 56, 256, 9, 3, 4)]]
    want = ref_oracle.predict("conv1d", queries)
    assert port_oracle.predict("conv1d", queries).tobytes() == want.tobytes()
    assert port.last_run_stats["measured"] == ref.last_run_stats["measured"] > 0

    port_again, port_again_oracle = _ultratrail(tapi, tmp_path / "ref.jsonl")
    ref_again, ref_again_oracle = _ultratrail(japi, tmp_path / "port.jsonl")
    for campaign in (port_again, ref_again):
        assert campaign.last_run_stats["measured"] == 0
        assert campaign.last_run_stats["replayed"] == ref.last_run_stats["measured"]
    assert port_again_oracle.predict("conv1d", queries).tobytes() == want.tobytes()
    assert ref_again_oracle.predict("conv1d", queries).tobytes() == want.tobytes()

    spec = port.platform.inner.spawn_spec()
    assert spec[1]["device"] == "cpu"
    batch = ConfigBatch.from_dicts(queries)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tworkers, "_WORKER_PLATFORM", None)
    tworkers._init_worker(spec)
    assert tworkers._WORKER_PLATFORM.measure_batch("conv1d", batch).tobytes() == \
        port.platform.inner.measure_batch("conv1d", batch).tobytes()
    tworkers._init_worker((spec[0], {**spec[1], "device": None}, spec[2]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tworkers._WORKER_PLATFORM.measure_batch("conv1d", batch)


# ------------------------------------------------------------- fault plans
def _toy(api, runtime, **spec):
    campaign = api.Campaign(api.CampaignSpec(
        platform="stepped_sim", layer_types=("toy",), n_samples=48, seed=0,
        forest_kwargs=FAST_FOREST, **spec))
    run_kwargs = {"device": "cpu"} if api is tapi else {}
    return campaign, (lambda: campaign.run(runtime=runtime, **run_kwargs))


def _plan(rt, kind):
    site = JOURNAL_SITE if kind == "torn_write" else CHUNK_SITE
    return rt.FaultPlan([rt.FaultEvent(site, 2, kind)])


@pytest.mark.parametrize("kind", ["crash", "corrupt", "torn_write"])
def test_a_fault_plan_gives_the_reference_result(kind, tmp_path, stepped_sim):
    """``stepped_sim`` under the same one-event plan in both packages: the
    same degradation counts, and bitwise the same predictions, for a torn
    journal write after the resume from the journal it left."""
    results = {}
    for name, api, rt in (("ref", japi, jrt), ("port", tapi, trt)):
        journal = str(tmp_path / f"{name}.jsonl")
        runtime = rt.RuntimeSpec(workers=1, chunk_size=8, retry_backoff_s=0.001,
                                 journal_path=journal, fault_plan=_plan(rt, kind))
        campaign, run = _toy(api, runtime)
        if kind == "torn_write":
            with pytest.raises(rt.TornWrite):
                run()
            report = rt.MeasurementJournal(journal).fsck()
            report.pop("path")
            degradation = _degradation(campaign.last_run_stats)
            campaign, run = _toy(api, rt.RuntimeSpec(workers=1, chunk_size=8, journal_path=journal))
            oracle = run()
        else:
            oracle = run()
            report = None
            degradation = _degradation(campaign.last_run_stats)
        preds = (oracle.predict("toy", TOY_QUERIES, backend="numpy") if api is tapi
                 else oracle.predict("toy", TOY_QUERIES))
        results[name] = (preds, degradation, _counts(campaign.last_run_stats),
                         campaign.cache.misses, report)
    (jp, jd, jc, jm, jr), (tp, td, tc, tm, tr) = results["ref"], results["port"]
    assert tp.tobytes() == jp.tobytes()
    assert td == jd and td["survived"] == 1
    assert td[{"crash": "crashes", "corrupt": "corrupt_results", "torn_write": "torn_writes"}[kind]] == 1
    assert (tc, tm, tr) == (jc, jm, jr)
    if kind == "torn_write":
        assert tr["torn_tail"] and tr["records"] == 2 and tc["replayed"] == tr["rows"] == 16


def test_a_sigkilled_pool_worker_is_respawned_bitwise(stepped_sim):
    """A worker process SIGKILLed while the pool measures: the pool breaks,
    the scheduler respawns it and retries the lost chunks, and the merged
    result is bitwise an undisturbed run's (and the reference platform's)."""
    platform = stepped_sim.SteppedSimPlatform(delay_s=0.02)
    batch = ConfigBatch.from_columns({"a": np.arange(1, 49), "b": (np.arange(1, 49) % 32) + 1})
    expected = jrt.testing.SteppedSimPlatform().measure_batch("toy", batch)
    pool = trt.WorkerPool(platform.spawn_spec(), workers=2)
    killed = []

    def assassin() -> None:
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline:
            procs = list((pool._pool._processes or {}).values())
            if procs:
                os.kill(procs[0].pid, signal.SIGKILL)
                killed.append(procs[0].pid)
                return
            time.sleep(0.01)

    try:
        scheduler = trt.MeasurementScheduler(pool, chunk_size=8, max_retries=3, retry_backoff_s=0.01,
                                             chunk_timeout_s=CHUNK_TIMEOUT_S)
        killer = threading.Thread(target=assassin, daemon=True)
        killer.start()
        y = scheduler.measure_batch("stepped_sim", "toy", batch)
        killer.join(timeout=60)
        assert not killer.is_alive()
    finally:
        pool.close()
    assert killed, "no worker process appeared to kill"
    assert y.tobytes() == expected.tobytes()
    assert pool.respawns >= 1 and scheduler.stats.failures == 0


# ---------------------------------------------------- fsck and compaction
def _journal_with_duplicates(path, rt, batch_cls):
    with rt.MeasurementJournal(str(path)) as journal:
        for c in range(3):
            batch = batch_cls.from_columns({"a": np.arange(1, 5) + 10 * c, "b": np.arange(1, 5)})
            journal.append_chunk("stepped_sim", "toy", batch, np.full(4, 1e-6 * (c + 1)))
        batch = batch_cls.from_columns({"a": np.arange(1, 5), "b": np.arange(1, 5)})
        journal.append_chunk("stepped_sim", "toy", batch, np.full(4, 9e-6))  # a retry's duplicate


def test_fsck_of_a_torn_journal_and_the_launchers_repair(tmp_path, capsys):
    """A journal cut mid-record: the port's ``fsck`` reports what the
    reference's does, the launcher's ``--fsck`` exits 1, ``--fsck --repair``
    compacts it to the bytes the reference's repair writes, and a second
    ``--fsck`` exits 0."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    path = journal_path(str(port_dir))
    _journal_with_duplicates(path, trt, ConfigBatch)
    with open(path, "rb") as f:
        data = f.read()
    last = data.rstrip(b"\n").rfind(b"\n") + 1
    with open(path, "r+b") as f:
        f.truncate(last + (len(data) - last) // 2)
    ref_path = journal_path(str(ref_dir))
    shutil.copyfile(path, ref_path)

    def report(rt, p, **kw):
        r = rt.MeasurementJournal(p).fsck(**kw)
        r.pop("path")
        return r

    assert report(trt, path) == report(jrt, ref_path)
    assert tserve.main(["--fsck", "--journal-dir", str(port_dir)]) == 1
    assert '"torn_tail": true' in capsys.readouterr().out
    assert tserve.main(["--fsck", "--repair", "--journal-dir", str(port_dir)]) == 0
    assert '"repaired": true' in capsys.readouterr().out
    ref_report = report(jrt, ref_path, repair=True)
    assert ref_report["repaired"] and ref_report["after"]["duplicate_keys"] == 0
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    assert tserve.main(["--fsck", "--journal-dir", str(port_dir)]) == 0
    assert report(trt, path) == report(jrt, ref_path)


def test_hub_gc_compacts_the_journal_as_the_reference_does(tmp_path):
    from repro.core.batch import ConfigBatch as JBatch

    port_hub, ref_hub = tapi.EstimatorHub(str(tmp_path / "port")), japi.EstimatorHub(str(tmp_path / "ref"))
    _journal_with_duplicates(journal_path(port_hub.directory), trt, ConfigBatch)
    _journal_with_duplicates(journal_path(ref_hub.directory), jrt, JBatch)
    got, want = port_hub.gc(), ref_hub.gc()
    assert got == want and got["journal"]["records_in"] == 4 > got["journal"]["records_out"]
    with open(journal_path(port_hub.directory), "rb") as a, open(journal_path(ref_hub.directory), "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------- the launcher
def test_estimate_decode_step_through_a_pool_and_its_journal(tmp_path, capsys):
    """The launcher's estimate with two pool workers on the CPU and a
    journal: the reference's estimate; a second run resumes from the journal
    with nothing measured and the same estimate, bitwise."""
    want = jserve.estimate_decode_step(jget_config("qwen2-1.5b"), 4, 48, n_samples=60)
    cfg, journal_dir = get_config("qwen2-1.5b"), str(tmp_path / "j")
    first = tserve.estimate_decode_step(cfg, 4, 48, n_samples=60, workers=2, journal_dir=journal_dir,
                                        device="cpu")
    out = capsys.readouterr().out
    assert first == want
    assert "workers=2" in out and " 0 replayed" in out
    again = tserve.estimate_decode_step(cfg, 4, 48, n_samples=60, workers=2, journal_dir=journal_dir,
                                        device="cpu")
    out = capsys.readouterr().out
    assert again == want
    assert out.startswith("runtime: 0 measured,") and " 0 replayed" not in out
