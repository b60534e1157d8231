"""The port's oracle service against the reference's, on the CPU.

One hub, trained by a reference campaign (``tpu_v5e[gray]``, the
launcher's estimate platform, every estimator with a log target), is served
by the port's ``OracleServer`` with its oracles on the CPU and by the
reference's.  Parity bars: layer answers bitwise under both of the port's
backends; network answers (``predict_networks``, ``autotune``) bitwise with
``"numpy"`` and within rtol 1e-12 with ``"torch"``, whose network cache
keys are therefore scoped apart.  Then the wire in both directions, the
overload, deadline and drain answers, the launcher's ``--serve-oracle`` in a
subprocess, and the trace report.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.api import get_platform as jget_platform  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import network as jnetwork  # noqa: E402
from repro.core import prs as jprs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.config import InputShape as JShape  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.api import EstimatorHub, PerfOracle  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PLATFORM = "tpu_v5e[gray]"
LAYER_TYPES = ("dense", "attention_decode", "moe_gemm", "ssd_scan", "embed")
NET_RTOL = 1e-12
#: every client call and join here is bounded
TIMEOUT_S = 30.0


@pytest.fixture(scope="module")
def hub_dir(tmp_path_factory):
    hub = str(tmp_path_factory.mktemp("hub"))
    jserve.estimate_decode_step(jget_config("qwen2-1.5b"), 4, 48, hub_dir=hub, n_samples=60)
    return hub


@pytest.fixture(scope="module")
def queries():
    platform = jget_platform("tpu_v5e", knowledge="gray")
    rng = np.random.default_rng(0)
    layers = {lt: jprs.sample_random_batch(platform.param_space(lt), 25, rng).to_dicts()
              for lt in LAYER_TYPES}
    layers = {lt: [{k: int(v) for k, v in cfg.items()} for cfg in cfgs] for lt, cfgs in layers.items()}
    nets = [[jserving.block_payload(b) for b in jnetwork.decompose(
        jget_config(arch), JShape(name="serve", seq_len=s, global_batch=b, kind="decode"), dp=1, tp=1)]
        for arch, s, b in (("qwen2-1.5b", 48, 4), ("mamba2-780m", 544, 4), ("olmoe-1b-7b", 2048, 1))]
    return layers, nets


def _serve_all(client, layers, nets):
    return {
        "layers": {lt: client.predict(PLATFORM, lt, cfgs) for lt, cfgs in layers.items()},
        "networks": client.predict_networks(PLATFORM, nets),
        "autotune": client.autotune(PLATFORM, "qwen2-1.5b", seq_len=4096, batch=8, chips=16),
        "platforms": client.platforms(),
    }


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_served_answers_equal_the_reference_server(hub_dir, queries, backend):
    layers, nets = queries
    with jserving.OracleServer(spec=jserving.ServeSpec(hub_dir=hub_dir)) as ref_server:
        want = _serve_all(jserving.OracleClient(server=ref_server), layers, nets)
    spec = tserving.ServeSpec(hub_dir=hub_dir, device="cpu", predict_backend=backend)
    with tserving.OracleServer(spec=spec) as server:
        client = tserving.OracleClient(server=server)
        got = _serve_all(client, layers, nets)
        again = _serve_all(client, layers, nets)  # all from the result cache
        scope = server._network_key_scope(server._oracle(PLATFORM))
        assert server.cache.stats()["hits"] > 0
    assert got == again
    assert got["layers"] == want["layers"]
    assert got["platforms"] == want["platforms"] and got["platforms"]["loaded"] == [PLATFORM]
    assert [{k: r[k] for k in ("dp", "tp", "microbatches")} for r in got["autotune"]] == \
        [{k: r[k] for k in ("dp", "tp", "microbatches")} for r in want["autotune"]]
    seconds = [[r["seconds"] for r in got["autotune"]], [r["seconds"] for r in want["autotune"]]]
    assert [s is None for s in seconds[0]] == [s is None for s in seconds[1]]
    finite = [[s for s in row if s is not None] for row in seconds]
    if backend == "numpy":
        assert scope == ()
        assert got["networks"] == want["networks"] and finite[0] == finite[1]
    else:
        assert scope == ("torch",)
        np.testing.assert_allclose(got["networks"], want["networks"], rtol=NET_RTOL, atol=0)
        np.testing.assert_allclose(finite[0], finite[1], rtol=NET_RTOL, atol=0)


def test_clients_and_servers_of_the_two_packages_speak_one_wire(hub_dir, queries):
    layers, nets = queries
    cfgs = layers["dense"]
    port_server = tserving.OracleServer(spec=tserving.ServeSpec(
        hub_dir=hub_dir, device="cpu", predict_backend="numpy"))
    ref_server = jserving.OracleServer(spec=jserving.ServeSpec(hub_dir=hub_dir))
    with tserving.OracleSocketServer(port_server, port=0).start() as port_sock, \
            jserving.OracleSocketServer(ref_server, port=0).start() as ref_sock:
        ref_client = jserving.OracleClient(address=port_sock.address, timeout=TIMEOUT_S)
        port_client = tserving.OracleClient(address=ref_sock.address, timeout=TIMEOUT_S)
        try:
            for client in (ref_client, port_client):
                assert client.ping()
                assert client.predict(PLATFORM, "dense", cfgs) == jserving.OracleClient(
                    server=ref_server).predict(PLATFORM, "dense", cfgs)
                assert client.predict_networks(PLATFORM, nets) == tserving.OracleClient(
                    server=port_server).predict_networks(PLATFORM, nets)
        finally:
            ref_client.close()
            port_client.close()


def _blocked_server(hub_dir, **spec):
    """A served port oracle whose batcher blocks in its first forest pass
    until the returned event is set; ``entered`` is set once it blocks."""
    oracle = PerfOracle.load(EstimatorHub(hub_dir), PLATFORM, device="cpu")
    server = tserving.OracleServer(oracles={PLATFORM: oracle},
                                   spec=tserving.ServeSpec(window_s=0.001, **spec))
    entered, release = threading.Event(), threading.Event()
    real = server.batcher.process

    def slow(payloads):
        entered.set()
        release.wait(timeout=TIMEOUT_S)
        return real(payloads)

    server.batcher.process = slow
    return server, entered, release


def _predict(i: int, **extra) -> dict:
    return {"id": i, "op": "predict", "platform": PLATFORM, "layer_type": "dense",
            "configs": [{"tokens": 16 + i, "d_in": 64, "d_out": 64}], **extra}


def _run(threads):
    for t in threads:
        t.start()
    return threads


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT_S)
        assert not t.is_alive()


def test_overload_is_an_explicit_answer(hub_dir):
    """With one queue slot and the batcher busy, one request queues and the
    others are answered at once with ``"overloaded": true``; none vanishes."""
    server, entered, release = _blocked_server(hub_dir, max_queue=1)
    answers: dict[int, dict] = {}
    try:
        plug = _run([threading.Thread(target=lambda: answers.setdefault(0, server.handle(_predict(0))))])
        assert entered.wait(TIMEOUT_S)
        rest = _run([threading.Thread(target=lambda i=i: answers.setdefault(i, server.handle(_predict(i))))
                     for i in range(1, 5)])
        deadline = time.perf_counter() + TIMEOUT_S
        while len(answers) < 3 and time.perf_counter() < deadline:
            time.sleep(0.005)
    finally:
        release.set()
    _join(plug + rest)
    server.close()
    overloaded = [i for i, a in answers.items() if a.get("overloaded")]
    assert len(answers) == 5 and len(overloaded) == 3
    assert all(answers[i]["ok"] for i in answers if i not in overloaded)
    assert all("OverloadError" in answers[i]["error"] for i in overloaded)


def test_a_deadline_is_answered_and_a_generous_one_is_met(hub_dir):
    server, entered, release = _blocked_server(hub_dir)
    try:
        plug = _run([threading.Thread(target=server.handle, args=(_predict(0),))])
        assert entered.wait(TIMEOUT_S)
        late = server.handle(_predict(1, deadline_ms=50))
        bad = server.handle(_predict(2, deadline_ms=-1))
    finally:
        release.set()
    _join(plug)
    met = server.handle(_predict(3, deadline_ms=30_000))
    server.close()
    assert late["ok"] is False and late["deadline_exceeded"] is True
    assert bad["ok"] is False and "deadline_ms" in bad["error"]
    direct = PerfOracle.load(EstimatorHub(hub_dir), PLATFORM, device="cpu").predict(
        "dense", _predict(3)["configs"])
    assert met["ok"] is True and met["result"] == [float(v) for v in direct]


def test_drain_answers_what_is_in_flight_and_refuses_new_work(hub_dir):
    server, entered, release = _blocked_server(hub_dir)
    answers: list[dict] = []
    try:
        inflight = _run([threading.Thread(target=lambda: answers.append(server.handle(_predict(0))))])
        assert entered.wait(TIMEOUT_S)
        assert server.drain(timeout_s=0.05) is False
        refused = server.handle({"id": 1, "op": "ping"})
    finally:
        release.set()
    _join(inflight)
    assert server.drain(timeout_s=TIMEOUT_S) is True
    server.close()
    assert refused["ok"] is False and refused["draining"] is True
    assert answers and answers[0]["ok"] is True


def test_the_launcher_serves_the_hub_on_the_cpu_and_drains_on_sigint(hub_dir, queries):
    layers, _ = queries
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve-oracle", "--device", "cpu",
         "--port", "0", "--hub-dir", hub_dir, "--warm-platforms", PLATFORM],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("oracle server on 127.0.0.1:"), (line, proc.stderr.read())
        port = int(line.split()[3].split(":")[1])
        client = tserving.OracleClient(address=("127.0.0.1", port), timeout=TIMEOUT_S)
        try:
            assert client.ping()
            got = client.predict(PLATFORM, "dense", layers["dense"])
        finally:
            client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=TIMEOUT_S) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        proc.stderr.close()
    direct = PerfOracle.load(EstimatorHub(hub_dir), PLATFORM, device="cpu").predict("dense", layers["dense"])
    assert got == [float(v) for v in direct]


def test_both_reports_render_one_trace_alike(hub_dir, queries, tmp_path, capsys):
    """A trace of the port's server answering queries, rendered by the
    port's ``obs.report`` and by the reference's: the same table, and the
    same Chrome export."""
    layers, nets = queries
    trace = str(tmp_path / "serve.jsonl")
    with tobs.tracing(trace):
        with tserving.OracleServer(spec=tserving.ServeSpec(hub_dir=hub_dir, device="cpu")) as server:
            client = tserving.OracleClient(server=server)
            client.predict(PLATFORM, "dense", layers["dense"])
            client.predict_networks(PLATFORM, nets)
    out = {}
    for name, report in (("port", treport), ("ref", jreport)):
        chrome = str(tmp_path / f"{name}.json")
        assert report.main([trace, "--chrome", chrome]) == 0
        out[name] = capsys.readouterr().out.replace(chrome, "OUT")
        with open(chrome) as f:
            out[name + "_chrome"] = json.load(f)
    assert out["port"] == out["ref"] and "serve.predict" in out["port"]
    assert out["port_chrome"] == out["ref_chrome"]
    assert jobs.load_events(trace) == tobs.load_events(trace)
