"""The port's serving slice against ``repro``'s, on the CPU.

``reduced(qwen2-1.5b)`` with ``attention_impl="flash_pallas"`` (2 layers,
d_model 128, 4 heads, 2 KV heads, head_dim 32) is initialised by
``repro.models.transformer.init_params`` and carried across with
``from_jax_params``, so both packages compute the same function.

Logits bar: atol/rtol 2e-2, the reference's bf16 bar.  The residual stream
is bf16 and the two packages round it at different points (see
``test_torch_layers.py``), which moves logits of magnitude ~1 by about 1e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
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
from repro_torch.train.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

LOGITS = dict(atol=2e-2, rtol=2e-2)
BATCH, PROMPT, GEN = 2, 24, 4


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = dataclasses.replace(jreduced(jget_config("qwen2-1.5b")), attention_impl="flash_pallas")
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")), attention_impl="flash_pallas")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (2, 128, 4, 2, 32)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    return jcfg, cfg, jparams, params, prompts


def test_teacher_forced_logits_match(slice_setup):
    jcfg, cfg, jparams, params, prompts = slice_setup
    rng = np.random.default_rng(1)
    forced = rng.integers(1, cfg.vocab, size=(BATCH, GEN - 1)).astype(np.int32)
    fwd = jax.jit(lambda p, b, c: JT.forward(p, jcfg, b, c))
    jcache = jinit_cache(jcfg, BATCH, PROMPT + GEN)
    cache = init_cache(cfg, BATCH, PROMPT + GEN, "cpu")
    steps = [prompts] + [forced[:, i : i + 1] for i in range(GEN - 1)]
    for tokens in steps:
        jl, _, jcache = fwd(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
        tl, aux, cache = TT.forward(params, cfg, {"tokens": torch.from_numpy(tokens).long()}, cache)
        assert tl.dtype == torch.float32 and tl.shape == (BATCH, tokens.shape[1], cfg.vocab)
        assert float(aux) == 0.0
        assert int(cache["len"]) == int(jcache["len"])
        assert cache["len"].dtype == torch.int32 and cache["len"].shape == ()  # a tensor, like the reference's int32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)


def test_prefill_step_matches_forward_without_cache(slice_setup):
    jcfg, cfg, jparams, params, prompts = slice_setup
    jl, _, _ = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(prompts)})
    last = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **LOGITS)


def test_greedy_generate_matches_reference(slice_setup):
    """Tokens equal repro's generate; a difference is excused only at a step
    where JAX's top-two logits lie within the logits bar (a near tie), and the
    sequences are not compared past it."""
    jcfg, cfg, jparams, params, prompts = slice_setup
    before = ops.flash_attention.launches
    tokens = generate(cfg, params, prompts, GEN, device="cpu").numpy()
    assert ops.flash_attention.launches == before == 0  # CPU tensors never launch
    jtokens = np.asarray(jgenerate(jcfg, jparams, prompts, GEN))
    assert tokens.shape == jtokens.shape == (BATCH, GEN)
    fwd = jax.jit(lambda p, b, c: JT.forward(p, jcfg, b, c))
    jcache = jinit_cache(jcfg, BATCH, PROMPT + GEN)
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
    _, cfg, _, params, prompts = slice_setup
    cache = init_cache(cfg, BATCH, PROMPT + 2, "cpu")
    logits, _, cache = TT.forward(params, cfg, {"tokens": torch.from_numpy(prompts).long()}, cache)
    tok, cache = make_serve_step(cfg)(params, cache, {"tokens": logits[:, -1].argmax(-1)[:, None]})
    assert tok.shape == (BATCH,) and int(cache["len"]) == PROMPT + 1
    assert torch.all(cache["k"][:, :, PROMPT + 1 :] == 0)
