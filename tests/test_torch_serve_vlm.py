"""The port's qwen2-vl (vlm, M-RoPE) serving slice against ``repro``'s, on the CPU.

``reduced(qwen2-vl-2b)`` (2 layers, d_model 128, 4 heads, 2 KV heads, head
dim 32, M-RoPE sections (4, 6, 6), 16 vision tokens) is initialised by
``repro.models.transformer.init_params`` and carried across with
``from_jax_params``, so both packages compute the same function.

M-RoPE with t == h == w is RoPE, so a text-only check cannot tell them
apart: the layer and the cached prefill are held with three position
streams that differ.  Bars: fp32 2e-5 and bf16 2e-2, the reference's kernel
bars; logits against the reference's op-by-op run (``scan_layers=False``),
greedy tokens against its compiled ``generate`` under both attention routes
(its flash route runs the Pallas kernel in interpret mode), a difference
excused only at a near tie.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.models.kvcache import init_cache as jinit_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.kvcache import init_cache  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
BATCH, PROMPT, GEN = 2, 24, 4
ARCH = "qwen2-vl-2b"


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (2, 128, 4, 2, 32)
    assert cfg.mrope and cfg.mrope_sections == (4, 6, 6) and cfg.vision_tokens == 16
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _streams(seed, b, s, n_vis=0, start=0):
    """(3, B, S) positions: text runs t == h == w; vision patches on a 4-wide
    grid (t fixed, h and w by row and column), so the three streams differ."""
    pos = np.tile(np.arange(start, start + s), (3, b, 1)).astype(np.int32)
    if n_vis:
        grid = np.arange(n_vis)
        pos[0, :, :n_vis] = start
        pos[1, :, :n_vis] = start + grid // 4
        pos[2, :, :n_vis] = start + grid % 4
        pos[:, :, n_vis:] = start + 4 + np.arange(s - n_vis)
    pos += np.random.default_rng(seed).integers(0, 3, size=(1, b, 1)).astype(np.int32)
    assert not (np.array_equal(pos[0], pos[1]) and np.array_equal(pos[1], pos[2])) or not n_vis
    return pos


@pytest.mark.parametrize("dt,tol", [("float32", F32), ("bfloat16", BF16)])
def test_apply_mrope_matches_reference_on_distinct_streams(dt, tol):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    pos = _streams(1, 2, 24, n_vis=16, start=300)
    jx = jnp.asarray(x).astype(jnp.float32 if dt == "float32" else jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.float32 if dt == "float32" else torch.bfloat16)
    out = TL.apply_mrope(tx, torch.from_numpy(pos).long(), 1e6, (4, 6, 6))
    assert out.dtype == tx.dtype
    ref = JL.apply_mrope(jx, jnp.asarray(pos), 1e6, (4, 6, 6))
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    # with distinct streams M-RoPE is not RoPE on any one stream
    for i in range(3):
        rope = TL.apply_rope(tx, torch.from_numpy(pos[i]).long(), 1e6)
        assert not torch.allclose(out.float(), rope.float(), **tol)


def test_apply_mrope_is_rope_when_the_streams_agree():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 10, 4, 32)).astype(np.float32))
    pos = torch.arange(5, 15).expand(2, 10)
    same = TL.apply_mrope(x, pos[None].expand(3, 2, 10), 1e4, (4, 6, 6))
    torch.testing.assert_close(same, TL.apply_rope(x, pos, 1e4), **F32)
    with pytest.raises(ValueError, match="sections"):
        TL.apply_mrope(x, pos[None].expand(3, 2, 10), 1e4, (4, 6, 4))


def _vision(seed, cfg):
    return (np.random.default_rng(seed).standard_normal((BATCH, cfg.vision_tokens, cfg.d_model)) * 0.1
            ).astype(np.float32)


def test_teacher_forced_logits_with_vision_and_distinct_streams(slice_setup):
    """A cached prefill of 16 vision embeddings and 24 text tokens at three
    distinct position streams, then decode steps, whose (3, B, 1) positions
    come from the cache's length."""
    jcfg, cfg, jparams, params = slice_setup
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    forced = rng.integers(1, cfg.vocab, size=(BATCH, GEN - 1)).astype(np.int32)
    vis = _vision(2, cfg)
    n = cfg.vision_tokens + PROMPT
    pos = _streams(3, BATCH, n, n_vis=cfg.vision_tokens)
    jcache = jinit_cache(jcfg, BATCH, n + GEN)
    cache = init_cache(cfg, BATCH, n + GEN, "cpu")
    jbatch = {"tokens": jnp.asarray(prompts), "vision_embeds": jnp.asarray(vis), "positions": jnp.asarray(pos)}
    tbatch = {"tokens": torch.from_numpy(prompts).long(), "vision_embeds": torch.from_numpy(vis),
              "positions": torch.from_numpy(pos).long()}
    steps = [(jbatch, tbatch)] + [({"tokens": jnp.asarray(forced[:, i : i + 1])},
                                   {"tokens": torch.from_numpy(forced[:, i : i + 1]).long()})
                                  for i in range(GEN - 1)]
    for jb, tb in steps:
        jl, _, jcache = JT.forward(jparams, jcfg, jb, jcache)
        tl, aux, cache = TT.forward(params, cfg, tb, cache)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape and float(aux) == 0.0
        assert int(cache["len"]) == int(jcache["len"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)
        # the first layer's keys, rotated by the three streams from the same
        # input (the second layer's input already carries the first's bf16 steps)
        np.testing.assert_allclose(_np(cache["k"][0]), _np(jcache["layers"]["k"][0]), **BF16)
    assert int(cache["len"]) == n + GEN - 1


def test_forward_without_cache_with_vision(slice_setup):
    jcfg, cfg, jparams, params = slice_setup
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    vis = _vision(6, cfg)
    jl, _, _ = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(prompts), "vision_embeds": jnp.asarray(vis)})
    tl, _, tc = TT.forward(params, cfg, {"tokens": torch.from_numpy(prompts).long(),
                                         "vision_embeds": torch.from_numpy(vis)})
    assert tc is None and tl.shape == (BATCH, cfg.vision_tokens + PROMPT, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)


@pytest.mark.parametrize("impl", ["xla_chunked", "flash_pallas"])
def test_greedy_generate_text_only_matches_reference(slice_setup, impl):
    """Text only, as the reference's launcher serves qwen2-vl: 3-stream
    positions with t == h == w.  A difference is excused only at a step where
    JAX's top-two logits lie within the logits bar (a near tie)."""
    jcfg, cfg, jparams, params = slice_setup
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    prompts = np.random.default_rng(4).integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    ops.flash_attention.launches = 0
    tokens = generate(cfg, params, prompts, GEN, device="cpu").numpy()
    assert ops.flash_attention.launches == 0  # CPU tensors never launch
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
                assert top2[1] - top2[0] <= BF16["atol"] + BF16["rtol"] * abs(top2[1]), (
                    f"token {t} of row {row}: {tokens[row, t]} != {jtokens[row, t]} "
                    f"with JAX's top-two logits {top2}"
                )
                return
        feed = jtokens[:, t : t + 1]


def test_generate_with_vision_overflows_the_prompt_sized_cache_as_the_reference_does(slice_setup):
    """The reference sizes the cache from the prompt alone, so vision tokens
    overflow it and its prefill fails; the port refuses before any work."""
    jcfg, cfg, jparams, params = slice_setup
    prompts = np.random.default_rng(8).integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    vis = _vision(9, cfg)
    with pytest.raises(TypeError, match="update shape"):
        jgenerate(jcfg, jparams, prompts, GEN, {"vision_embeds": vis})
    with pytest.raises(ValueError, match=f"cache of {PROMPT + GEN} positions"):
        generate(cfg, params, prompts, GEN, device="cpu", extras={"vision_embeds": vis})
