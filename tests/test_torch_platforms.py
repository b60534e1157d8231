"""The port's analytic platforms, advisor and launcher estimate against the reference's, on the CPU.

``tpu_v5e``, ``ultratrail`` and ``vta`` are the reference's timing models;
in the port their ``measure_batch`` hooks (``accelerators/torch_kernels.py``)
run the models as float64 / int64 torch programs on the platform's device,
here the CPU (``device="cpu"``).  Parity bars, the reference's own
(``repro/accelerators/jax_kernels.py``): hooks and layer predictions bitwise
against numpy; networks rtol 1e-12 on the torch backend.

The reference's ultratrail block path misses its own frozen golden digest
on this tree (``tests/test_block_batch.py``; ROADMAP queue 3), so the port's
ultratrail is held against the reference's outputs on the same path, not the
digest.  The ``jax_backend`` fixture hands the reference ``jax.enable_x64``,
which its jax predict backend needs and this jax has under another name
(as in ``test_torch_estimation.py``).
"""

import functools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.accelerators import jax_kernels  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import advisor as jadvisor  # noqa: E402
from repro.core import jax_predict  # noqa: E402
from repro.core import network as jnetwork  # noqa: E402
from repro.core.batch import ConfigBatch as JBatch  # noqa: E402
from repro.core.blocks import Block as JBlock  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.config import InputShape as JShape  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.accelerators import torch_kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import advisor as tadvisor  # noqa: E402
from repro_torch.core import network as tnetwork  # noqa: E402
from repro_torch.core import prs  # noqa: E402
from repro_torch.core.batch import ConfigBatch as TBatch  # noqa: E402
from repro_torch.core.blocks import Block as TBlock  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.config import InputShape as TShape  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402

NET_RTOL = 1e-12
KWARGS = {"ultratrail": {}, "vta": {}, "tpu_v5e": {"knowledge": "white"}}
HOOKS = {
    "ultratrail": (torch_kernels.ultratrail_measure_batch, jax_kernels.ultratrail_measure_batch),
    "vta": (torch_kernels.vta_measure_batch, jax_kernels.vta_measure_batch),
    "tpu_v5e": (torch_kernels.tpu_measure_batch, jax_kernels.tpu_measure_batch),
}
CASES = [(name, lt) for name in KWARGS for lt in japi.get_platform(name, **KWARGS[name]).layer_types()]


@pytest.fixture
def jax_backend(monkeypatch):
    if jax_predict.jax_modules() is None:
        import jax
        import jax.numpy as jnp
        from jax import lax

        monkeypatch.setattr(jax_predict, "_modules_cache", (jax, jnp, lax, jax.enable_x64))
    assert jax_predict.resolve_backend("jax") == "jax"


def _pair(name, **kw):
    kw = {**KWARGS[name], **kw}
    return japi.get_platform(name, **kw), tapi.get_platform(name, device="cpu", **kw)


def _batches(platform, layer_type, n, seed=None):
    """The same n random configs of the layer type, as a reference and a port batch."""
    rng = np.random.default_rng(n if seed is None else seed)
    b = prs.sample_random_batch(platform.param_space(layer_type), n, rng)
    return JBatch(b.params, b.values), TBatch(b.params, b.values)


# ---------------------------------------------------------------- hooks
@pytest.mark.parametrize("n", (1, 64, 257))
@pytest.mark.parametrize("name,layer_type", CASES)
def test_torch_hook_is_bitwise_with_numpy(name, layer_type, n):
    jp, tp = _pair(name)
    jb, tb = _batches(tp, layer_type, n)
    want = jp.measure_batch(layer_type, jb)  # the reference's numpy path
    got = HOOKS[name][0](tp, layer_type, tb)
    assert got is not None and got.dtype == np.float64 and got.shape == (n,)
    assert got.tobytes() == want.tobytes()
    assert tp.measure_batch(layer_type, tb).tobytes() == want.tobytes()


@pytest.mark.parametrize("name,layer_type", CASES)
def test_torch_hook_is_bitwise_with_the_reference_jax_hook(name, layer_type, jax_backend):
    jp, tp = _pair(name)
    jp.predict_backend = "jax"
    jb, tb = _batches(tp, layer_type, 257)
    want = HOOKS[name][1](jp, layer_type, jb)
    assert want is not None
    assert HOOKS[name][0](tp, layer_type, tb).tobytes() == want.tobytes()


def test_noisy_tpu_stays_numpy():
    jp, tp = _pair("tpu_v5e", knowledge="gray", noise=0.002)
    jb, tb = _batches(tp, "dense", 64)
    assert torch_kernels.tpu_measure_batch(tp, "dense", tb) is None
    assert tp.measure_batch("dense", tb).tobytes() == jp.measure_batch("dense", jb).tobytes()


@pytest.mark.parametrize("name,layer_type", [("ultratrail", "conv1d"), ("vta", "conv2d"),
                                             ("tpu_v5e", "dense")])
def test_where_the_reference_hook_declines_the_port_hook_declines(name, layer_type):
    _, tp = _pair(name)
    hook = HOOKS[name][0]
    _, tb = _batches(tp, layer_type, 8)
    assert hook(tp, "no_such_layer", tb) is None
    assert hook(tp, layer_type, tb.take(np.arange(0))) is None
    tp.predict_backend = "numpy"
    assert hook(tp, layer_type, tb) is None


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("name,layer_type", [("ultratrail", "conv1d"), ("vta", "fully_connected"),
                                             ("tpu_v5e", "embed")])
def test_a_hook_on_the_card_raises_without_one(name, layer_type, device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    platform = tapi.get_platform(name, device=device, **KWARGS[name])
    _, tb = _batches(platform, layer_type, 4)
    with pytest.raises(RuntimeError, match="is_available"):
        platform.measure_batch(layer_type, tb)


@pytest.mark.parametrize("name", KWARGS)
def test_the_device_enters_no_name_key_or_number(name):
    jp, tp = _pair(name)
    assert (tp.name, tp.cache_key()) == (jp.name, jp.cache_key())
    assert tp.spawn_spec()[1]["device"] == "cpu"
    assert type(tp)(**tp.spawn_spec()[1]).cache_key() == tp.cache_key()


def test_an_int_column_promoted_to_float32_would_fail():
    """torch computes ``2.0 * int64_tensor`` in float32; numpy in float64.

    At this dense layer the float32 product loses bits (which the first
    assertion checks), so a hook that skipped the cast to float64 fails here.
    """
    jp, tp = _pair("tpu_v5e")
    values = np.array([[131064, 16255, 16129]], dtype=np.int64)  # tokens, d_in, d_out
    jb, tb = JBatch(("tokens", "d_in", "d_out"), values), TBatch(("tokens", "d_in", "d_out"), values)
    m, k, n = (torch.tensor([-(-int(v) // w) * w]) for v, w in zip(values[0], (8, 128, 128)))
    flops32 = (2.0 * m * k * n).to(torch.float64).numpy()
    flops = (2.0 * m.double() * k * n).numpy()
    assert flops32.tobytes() != flops.tobytes()
    c = tp.chip  # the FLOP term sets the time here
    assert flops[0] / c.peak_bf16_flops > 2.0 * int(m * k + m * n + k * n) / c.hbm_bandwidth
    assert tp.measure_batch("dense", tb).tobytes() == jp.measure_batch("dense", jb).tobytes()


# ---------------------------------------------------------------- campaigns
CAMPAIGNS = {
    "ultratrail": ({}, ("conv1d",)),
    "vta": ({}, ("conv2d", "fully_connected")),
    "tpu_v5e[gray]": ({"knowledge": "gray"}, None),
}


def _recording(platform):
    calls = []
    inner = platform.measure_batch

    def measure_batch(layer_type, batch):
        y = inner(layer_type, batch)
        calls.append((layer_type, batch.params, batch.values.copy(), np.array(y)))
        return y

    platform.measure_batch = measure_batch
    return calls


@pytest.fixture(scope="module", params=sorted(CAMPAIGNS))
def campaign(request):
    kw, layer_types = CAMPAIGNS[request.param]
    name = request.param.split("[")[0]
    jp, tp = japi.get_platform(name, **kw), tapi.get_platform(name, device="cpu", **kw)
    jcalls, tcalls = _recording(jp), _recording(tp)
    common = dict(layer_types=layer_types, n_samples=120, seed=0)
    jc = japi.Campaign(japi.CampaignSpec(platform=name, platform_kwargs=kw, **common), platform=jp)
    tc = tapi.Campaign(tapi.CampaignSpec(platform=name, platform_kwargs={**kw, "device": "cpu"},
                                         **common), platform=tp)
    return {"name": request.param, "ref": jc, "port": tc, "ref_oracle": jc.run(),
            "port_oracle": tc.run(device="cpu"), "ref_calls": jcalls, "port_calls": tcalls}


def test_campaign_widths_and_counts_equal_the_reference(campaign):
    jo, to = campaign["ref_oracle"], campaign["port_oracle"]
    assert to.layer_types() == jo.layer_types()
    for lt in jo.layer_types():
        assert dict(to.estimators[lt].widths) == dict(jo.estimators[lt].widths)
        assert to.estimators[lt].n_sweep == jo.estimators[lt].n_sweep
    keys = ("unique_measurements", "hits", "misses")
    assert {k: campaign["port"].stats()[k] for k in keys} == {k: campaign["ref"].stats()[k] for k in keys}


def test_campaign_measure_batches_are_bitwise(campaign):
    jcalls, tcalls = campaign["ref_calls"], campaign["port_calls"]
    assert len(tcalls) == len(jcalls) > 0
    for (jlt, jparams, jvals, jy), (tlt, tparams, tvals, ty) in zip(jcalls, tcalls):
        assert (tlt, tparams) == (jlt, jparams) and np.array_equal(tvals, jvals)
        assert ty.tobytes() == jy.tobytes()


def test_campaign_layer_predictions_are_bitwise(campaign):
    jo, to = campaign["ref_oracle"], campaign["port_oracle"]
    kw = CAMPAIGNS[campaign["name"]][0]
    platform = tapi.get_platform(campaign["name"].split("[")[0], device="cpu", **kw)
    for lt in jo.layer_types():
        jb, tb = _batches(platform, lt, 200, seed=5)
        want = jo.predict(lt, jb, backend="numpy")
        assert to.predict(lt, tb, backend="numpy").tobytes() == want.tobytes()
        assert to.predict(lt, tb).tobytes() == want.tobytes()  # torch on the CPU


def _networks(name, Block, network, shape_cls, cfg):
    if name == "ultratrail":
        conv = ("conv1d", {"C": 16, "K": 24, "C_w": 101, "F": 3, "s": 1, "pad": 1})
        return [[Block("conv", (conv, conv), repeat=3)], [Block("conv", (conv,))]]
    if name == "vta":
        conv = ("conv2d", {"C": 48, "C_h": 28, "C_w": 28, "K": 64, "F": 3, "s": 1, "pad": 1})
        fc = ("fully_connected", {"in": 384, "out": 100})
        return [[Block("conv", (conv,), repeat=4), Block("fc", (fc,))], [Block("fc", (fc, fc))]]
    return [network.decompose(cfg, shape_cls(name="s", seq_len=s, global_batch=b, kind="decode"), 1, 1)
            for s, b in ((64, 4), (300, 2))]


def test_campaign_networks_hold_the_reference_bar(campaign):
    name = campaign["name"].split("[")[0]
    jcfg, cfg = jreduced(jget_config("olmoe-1b-7b")), reduced(get_config("olmoe-1b-7b"))
    jnets = _networks(name, JBlock, jnetwork, JShape, jcfg)
    tnets = _networks(name, TBlock, tnetwork, TShape, cfg)
    want = campaign["ref_oracle"].predict_networks(jnets, backend="numpy")
    got = campaign["port_oracle"].predict_networks(tnets)
    assert np.all(np.isfinite(want)) and np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=NET_RTOL, atol=0)


# ---------------------------------------------------------------- advisor
@pytest.mark.parametrize("campaign", ["tpu_v5e[gray]"], indirect=True)  # a transformer's layer types
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_autotune_through_a_hub_both_ways(campaign, writer, tmp_path):
    hub = str(tmp_path / "hub")
    jcfg, cfg = jget_config("qwen2-1.5b"), get_config("qwen2-1.5b")
    jshape = JShape(name="d", seq_len=1024, global_batch=64, kind="decode")
    tshape = TShape(name="d", seq_len=1024, global_batch=64, kind="decode")
    if writer == "reference":
        campaign["ref_oracle"].save(japi.EstimatorHub(hub))
        jo = campaign["ref_oracle"]
        to = tapi.PerfOracle.load(tapi.EstimatorHub(hub), campaign["name"], device="cpu")
    else:
        campaign["port_oracle"].save(tapi.EstimatorHub(hub))
        to = campaign["port_oracle"]
        jo = japi.PerfOracle.load(japi.EstimatorHub(hub), campaign["name"])
    want = jadvisor.autotune(jo, jcfg, jshape, chips=16)
    got = tadvisor.autotune(to, cfg, tshape, chips=16)
    assert [str(c) for c, _ in got] == [str(c) for c, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=NET_RTOL, atol=0)
    assert np.isfinite(want[0][1])


# ---------------------------------------------------------------- launcher
def test_estimate_decode_step_equals_the_reference(tmp_path):
    cfg, jcfg = get_config("qwen2-1.5b"), jget_config("qwen2-1.5b")
    want = jserve.estimate_decode_step(jcfg, 4, 48, n_samples=60)
    got = tserve.estimate_decode_step(cfg, 4, 48, hub_dir=str(tmp_path / "hub"), n_samples=60,
                                      device="cpu")
    np.testing.assert_allclose(got, want, rtol=NET_RTOL, atol=0)


def test_estimate_only_prints_the_reference_number_from_the_same_hub(tmp_path, capsys):
    hub = str(tmp_path / "hub")
    tserve.estimate_decode_step(get_config("qwen2-1.5b"), 4, 48, hub_dir=hub, n_samples=60,
                                device="cpu")
    assert tserve.main(["--arch", "qwen2-1.5b", "--estimate-only", "--device", "cpu",
                        "--hub-dir", hub]) == 0
    out = capsys.readouterr().out
    want = jserve.estimate_decode_step(jget_config("qwen2-1.5b"), 4, 48, hub_dir=hub)
    assert f"oracle estimate (tpu_v5e[gray], dp=1 tp=1): {want * 1e3:.3f} ms/decode-step" in out


@pytest.mark.parametrize("flags", [["--workers", "2"], ["--journal-dir", "j"]])
def test_estimate_through_the_runtime_is_refused(flags, monkeypatch, tmp_path, capsys):
    """The launcher's runtime flags run the estimate's campaign through the
    runtime (they were refused until it was ported): a pool of two workers
    on the CPU, or a journal in ``j``.  The estimate is the reference's, and
    the ``runtime:`` line counts what was measured."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tserve, "estimate_decode_step",
                        functools.partial(tserve.estimate_decode_step, n_samples=60))
    rc = tserve.main(["--arch", "qwen2-1.5b", "--estimate-only", "--device", "cpu", *flags])
    assert rc == 0
    out = capsys.readouterr().out
    want = jserve.estimate_decode_step(jget_config("qwen2-1.5b"), 4, 48, n_samples=60)
    assert f"oracle estimate (tpu_v5e[gray], dp=1 tp=1): {want * 1e3:.3f} ms/decode-step" in out
    workers = flags[1] if flags[0] == "--workers" else "1"
    assert re.search(rf"runtime: [1-9][0-9]* measured, .* chunks .*workers={workers}\)", out), out
    assert os.path.exists(tmp_path / "j" / "measurements.jsonl") == (flags[0] == "--journal-dir")


@pytest.mark.parametrize("flag", ["--estimate-only", "--estimate"])
def test_the_launcher_estimates_the_decode_shape_on_its_device(flag, monkeypatch, capsys):
    seen = {}

    def fake(cfg, batch, seq_len, **kw):
        seen.update(arch=cfg.name, batch=batch, seq_len=seq_len, **kw)
        return 2e-3

    monkeypatch.setattr(tserve, "estimate_decode_step", fake)
    assert tserve.main(["--arch", "qwen2-1.5b", "--reduced", flag, "--device", "cpu",
                        "--batch", "3", "--prompt-len", "20", "--gen", "5"]) == 0
    assert seen == {"arch": "qwen2-1.5b", "batch": 3, "seq_len": 25, "hub_dir": None, "workers": 1,
                    "journal_dir": None, "device": "cpu"}
    out = capsys.readouterr().out
    assert "oracle estimate (tpu_v5e[gray], dp=1 tp=1): 2.000 ms/decode-step (~1500 tok/s)" in out
    assert ("generated (3, 5) on cpu" in out) == (flag == "--estimate")
