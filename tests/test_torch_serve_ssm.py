"""The port's mamba2 serving slice against ``repro``'s, on the CPU.

``reduced(mamba2-780m)`` (2 layers, d_model 128, d_inner 256, 8 SSM heads of
width 32, state 16, chunk 128) is initialised by
``repro.models.transformer.init_params`` and carried across with
``from_jax_params``, so both packages compute the same function.

Logits bar: atol/rtol 2e-2, the reference's bf16 bar.  Two facts shape the
teacher-forced comparison:

* The reference's compiled model (``lax.scan`` over layers, fused by XLA)
  keeps some bf16 intermediates at higher precision, and so disagrees with
  its own op-by-op run (``scan_layers=False``, run eagerly) by more than
  this bar on some logits of this model.  The port rounds at
  every bf16 op, as the op-by-op run does, so it is held against that run.
* The reference's model path runs the XLA twin ``ssd_chunked``, which rounds
  its intra-chunk weights to bf16 before the second product; the Pallas
  kernel, which is what the port's kernel replaces, keeps them in fp32.  The
  twin is therefore replaced, for the teacher-forced comparison only, by the
  reference's own oracle ``repro.kernels.ref.ssd_ref``: the function the
  Pallas kernel computes, with the state it carries.

Greedy ``generate`` is held against the reference's compiled ``generate``
as it stands, twin included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.ssm as JS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.models.kvcache import init_cache as jinit_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.kvcache import init_cache  # noqa: E402
from repro_torch.models.ssm import CACHE_KEYS  # noqa: E402
from repro_torch.train.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

LOGITS = dict(atol=2e-2, rtol=2e-2)
BATCH, GEN = 2, 4


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jreduced(jget_config("mamba2-780m"))
    cfg = reduced(get_config("mamba2-780m"))
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state) == (
        2, 128, 256, 8, 32, 16)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _prompts(seed, s):
    return np.random.default_rng(seed).integers(1, 512, size=(BATCH, s)).astype(np.int32)


def _oracle_scan(xbar, log_da, bmat, cmat, chunk, state0=None, unroll=False):
    return jref.ssd_ref(xbar, log_da, bmat, cmat, state0)


def test_from_jax_params_keeps_the_fp32_leaves(slice_setup):
    _, _, _, params = slice_setup
    m = params["layers"][0]["mamba"]
    for k in ("dt_bias", "a_log", "d_skip", "norm"):
        assert m[k].dtype == torch.float32, k
    assert params["layers"][0]["ln"].dtype == torch.float32
    for k in ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_out", "w_conv_x", "b_conv_x"):
        assert m[k].dtype == torch.bfloat16, k


@pytest.mark.parametrize("prompt", [24, 200])
def test_teacher_forced_logits_match(slice_setup, prompt, monkeypatch):
    """Prefill (200 crosses a chunk boundary with a ragged tail), then decode steps."""
    jcfg, cfg, jparams, params = slice_setup
    monkeypatch.setattr(JS, "ssd_chunked", _oracle_scan)
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    prompts = _prompts(prompt, prompt)
    forced = _prompts(prompt + 1, GEN - 1)
    jcache = jinit_cache(jcfg, BATCH, prompt + GEN)
    cache = init_cache(cfg, BATCH, prompt + GEN, "cpu")
    for tokens in [prompts] + [forced[:, i : i + 1] for i in range(GEN - 1)]:
        jl, _, jcache = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jcache)
        tl, aux, cache = TT.forward(params, cfg, {"tokens": torch.from_numpy(tokens).long()}, cache)
        assert tl.dtype == torch.float32 and tl.shape == (BATCH, tokens.shape[1], cfg.vocab)
        assert float(aux) == 0.0
        assert int(cache["len"]) == int(jcache["len"])
        assert cache["len"].dtype == torch.int32 and cache["len"].shape == ()  # a tensor, like the reference's int32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        for k in CACHE_KEYS:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache["layers"][k]), **LOGITS, err_msg=k)


def test_prefill_step_matches_forward_without_cache(slice_setup, monkeypatch):
    jcfg, cfg, jparams, params = slice_setup
    monkeypatch.setattr(JS, "ssd_chunked", _oracle_scan)
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    prompts = _prompts(7, 40)
    jl, _, _ = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(prompts)})
    last = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **LOGITS)


@pytest.mark.parametrize("prompt", [24, 200])
def test_greedy_generate_matches_reference(slice_setup, prompt):
    """Tokens equal repro's compiled generate; a difference is excused only at
    a step where JAX's top-two logits lie within the logits bar (a near tie),
    and the sequences are not compared past it."""
    jcfg, cfg, jparams, params = slice_setup
    prompts = _prompts(prompt + 2, prompt)
    tokens = generate(cfg, params, prompts, GEN, device="cpu").numpy()
    assert ops.ssd_scan.launches == 0  # CPU tensors never launch
    jtokens = np.asarray(jgenerate(jcfg, jparams, prompts, GEN))
    assert tokens.shape == jtokens.shape == (BATCH, GEN)
    fwd = jax.jit(lambda p, b, c: JT.forward(p, jcfg, b, c))
    jcache = jinit_cache(jcfg, BATCH, prompt + GEN)
    feed = prompts
    for t in range(GEN):
        jl, _, jcache = fwd(jparams, {"tokens": jnp.asarray(feed)}, jcache)
        last = np.asarray(jl)[:, -1]
        for row in range(BATCH):
            if tokens[row, t] != jtokens[row, t]:
                top2 = np.sort(last[row])[-2:]
                assert top2[1] - top2[0] <= LOGITS["atol"] + LOGITS["rtol"] * abs(top2[1]), (
                    f"token {t} of row {row}: {tokens[row, t]} != {jtokens[row, t]} "
                    f"with JAX's top-two logits {top2}"
                )
                return
        feed = jtokens[:, t : t + 1]


def test_serve_step_continues_the_cache(slice_setup):
    """A decode step after the prefill equals the prefill of the longer prompt."""
    _, cfg, _, params = slice_setup
    prompts = torch.from_numpy(_prompts(9, 30)).long()
    cache = init_cache(cfg, BATCH, 32, "cpu")
    logits, _, cache = TT.forward(params, cfg, {"tokens": prompts[:, :-1]}, cache)
    state_after_prefill = cache["state"].clone()
    tok, cache = make_serve_step(cfg)(params, cache, {"tokens": prompts[:, -1:]})
    assert tok.shape == (BATCH,) and int(cache["len"]) == 30
    assert not torch.equal(cache["state"], state_after_prefill)
    full, _, _ = TT.forward(params, cfg, {"tokens": prompts})
    assert torch.equal(tok, full[:, -1].argmax(-1))
    ref_cache = init_cache(cfg, BATCH, 32, "cpu")
    TT.forward(params, cfg, {"tokens": prompts}, ref_cache)
    for k in CACHE_KEYS:
        np.testing.assert_allclose(cache[k].numpy(), ref_cache[k].numpy(), **LOGITS, err_msg=k)
