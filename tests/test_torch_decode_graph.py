"""The decode step's capture safety, on the CPU.

On the card ``generate`` captures its decode step as a CUDA graph
(``repro_torch.train.steps.capture_serve_step``), which freezes every host
value the step reads.  So the step must read no tensor's value on the host:
the cache's ``len`` is a device tensor, and the one-token path of every
family keeps it there.  The CPU has no graphs; the proxy here runs one eager
step per family while every way of reading a tensor's value on the host
raises.  ``chip_smoke.py`` captures and replays the step on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.kvcache import init_cache  # noqa: E402
from repro_torch.train.steps import capture_serve_step, make_serve_step  # noqa: E402

ARCHS = ("qwen2-1.5b", "mamba2-780m", "olmoe-1b-7b")
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__index__", "__float__")
BATCH, PROMPT = 2, 12


def _prefilled(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), attention_impl="flash_pallas")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, size=(BATCH, PROMPT)))
    cache = init_cache(cfg, BATCH, PROMPT + 4, "cpu")
    with torch.no_grad():
        logits, _, cache = TT.forward(params, cfg, {"tokens": prompts}, cache)
    return cfg, params, cache, logits[:, -1].argmax(-1)[:, None]


def _host_read(self, *args, **kwargs):
    raise AssertionError("a tensor's value was read on the host")


def _forbid_host_reads(monkeypatch):
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, _host_read)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_len_is_a_device_int_tensor(arch):
    cfg = reduced(get_config(arch))
    cache = init_cache(cfg, BATCH, PROMPT, "cpu")
    assert isinstance(cache["len"], torch.Tensor)
    assert cache["len"].shape == () and cache["len"].dtype == torch.int32 and int(cache["len"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_no_tensor_value_on_the_host(arch, monkeypatch):
    cfg, params, cache, tok = _prefilled(arch)
    expect_tok, expect_cache = make_serve_step(cfg)(params, {**cache}, {"tokens": tok})
    expect_tok = expect_tok.clone()
    fresh = _prefilled(arch)[2]  # the same prefill again: the step above wrote into its cache

    _forbid_host_reads(monkeypatch)
    with torch.no_grad():
        got_tok, got_cache = make_serve_step(cfg)(params, fresh, {"tokens": tok})
    monkeypatch.undo()
    assert torch.equal(got_tok, expect_tok)
    assert int(got_cache["len"]) == int(expect_cache["len"]) == PROMPT + 1
    assert int(fresh["len"]) == PROMPT  # forward returns a new len; a graph step advances it in place


def test_the_proxy_catches_a_host_read(monkeypatch):
    """The prefill reads ``len`` on the host (its flash offset), so the proxy stops it."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash_pallas")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = init_cache(cfg, BATCH, PROMPT, "cpu")
    _forbid_host_reads(monkeypatch)
    with pytest.raises(AssertionError, match="read on the host"):
        TT.forward(params, cfg, {"tokens": torch.ones((BATCH, 3), dtype=torch.long)}, cache)


def test_capture_takes_card_tokens_only():
    cfg, params, cache, tok = _prefilled("qwen2-1.5b")
    with pytest.raises(ValueError, match="CUDA tokens"):
        capture_serve_step(cfg, params, cache, {"tokens": tok})
