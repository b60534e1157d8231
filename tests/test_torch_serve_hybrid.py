"""The port's zamba2 (hybrid) serving slice against ``repro``'s, on the CPU.

``reduced(zamba2-2.7b)`` (12 mamba layers in 6 groups of ``attn_every`` 2,
each group followed by the one shared attention block; d_model 128, 4 MHA
heads of 32, SSM heads of 32, state 16) is initialised by
``repro.models.transformer.init_params`` and carried across with
``from_jax_params``, so both packages compute the same function.

Held, as in ``test_torch_serve_ssm.py``, against the reference's op-by-op
run (``scan_layers=False``) with its XLA twin ``ssd_chunked`` replaced by the
oracle ``ssd_ref``, the function the Pallas kernel (and the port's)
computes: each group at the bf16 bar 2e-2 on the same inputs, and the
logits of the whole stack within the reference's own gap between its two
attention cores (see the logits tests).  Greedy ``generate`` is held against
the reference's compiled ``generate`` under both attention routes, a
difference excused only at a near tie.  The caches are compared group by
group: an off-by-one between a group and a layer gives finite but wrong
logits.
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
from repro_torch.weights import from_jax_params  # noqa: E402

BF16 = dict(atol=2e-2, rtol=2e-2)
FLOOR_FACTOR = 1.25  # as chip_smoke.py's SSM_FLOOR_FACTOR and MOE_FLOOR_FACTOR
BATCH, GEN = 2, 4
ARCH = "zamba2-2.7b"


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jreduced(jget_config(ARCH))
    cfg = reduced(get_config(ARCH))
    assert (cfg.n_layers, cfg.attn_every, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (
        12, 2, 128, 4, 4, 32)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture
def oracle_scan(monkeypatch):
    monkeypatch.setattr(JS, "ssd_chunked", lambda x, la, b, c, chunk, state0=None, unroll=False:
                        jref.ssd_ref(x, la, b, c, state0))


def _prompts(seed, s, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=(BATCH, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_from_jax_params_nests_groups_and_keeps_the_shared_block(slice_setup):
    _, cfg, jparams, params = slice_setup
    groups = cfg.n_layers // cfg.attn_every
    assert len(params["layers"]) == groups and all(len(g) == cfg.attn_every for g in params["layers"])
    for g in range(groups):
        for j in range(cfg.attn_every):
            np.testing.assert_array_equal(
                _np(params["layers"][g][j]["mamba"]["w_x"]),
                np.asarray(jnp.asarray(jparams["layers"]["mamba"]["w_x"][g, j]).astype(jnp.bfloat16)
                           .astype(jnp.float32)))
            assert params["layers"][g][j]["mamba"]["a_log"].dtype == torch.float32
    shared = params["shared"]
    assert shared["ln1"].dtype == torch.float32 and shared["attn"]["wq"].dtype == torch.bfloat16
    assert shared["attn"]["wq"].shape == jparams["shared"]["attn"]["wq"].shape


def test_init_params_and_cache_shapes_match_the_reference(slice_setup):
    jcfg, cfg, jparams, _ = slice_setup
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["layers"][1][0]["mamba"]["w_z"].shape == jparams["layers"]["mamba"]["w_z"].shape[2:]
    assert params["shared"]["mlp"]["w_in"].shape == jparams["shared"]["mlp"]["w_in"].shape
    cache, jcache = init_cache(cfg, BATCH, 16, "cpu"), jinit_cache(jcfg, BATCH, 16)
    for k in CACHE_KEYS:
        assert cache["mamba"][k].shape == jcache["mamba"][k].shape
    for k in ("k", "v", "len"):
        assert cache["attn"][k].shape == jcache["attn"][k].shape
    assert cache["attn"]["len"].dtype == torch.int32 and cache["attn"]["len"][0].shape == ()
    assert cache["len"].shape == () and cache["len"].dtype == torch.int32


def _to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.to(dtype) if dtype is not None else t


def test_hybrid_stack_matches_reference_group_by_group(slice_setup, oracle_scan):
    """``_hybrid_stack`` one group at a time, each group fed the same bf16
    input and the same incoming caches in both packages: a 40-token prefill
    from empty caches, then a one-token decode step at len 40.  Each group's
    output, mamba buffers, attention K/V and length are held at the bf16 bar."""
    jcfg, cfg, jparams, params = slice_setup
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    groups, s = cfg.n_layers // cfg.attn_every, 40
    rng = np.random.default_rng(3)
    jcache, tcache = jinit_cache(jcfg, BATCH, s + 1), init_cache(cfg, BATCH, s + 1, "cpu")
    for step, (n, pos0) in enumerate([(s, 0), (1, s)]):
        jx = jnp.asarray(rng.standard_normal((BATCH, n, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
        pos = np.tile(np.arange(pos0, pos0 + n), (BATCH, 1)).astype(np.int32)
        new_groups = []
        for g in range(groups):
            jp = {**jparams, "layers": jax.tree.map(lambda a: a[g : g + 1], jparams["layers"])}
            tp = {**params, "layers": params["layers"][g : g + 1]}
            jc = jax.tree.map(lambda a: a[g : g + 1], {"mamba": jcache["mamba"], "attn": jcache["attn"]})
            tc = {part: {k: v[g : g + 1] for k, v in tcache[part].items()} for part in ("mamba", "attn")}
            jy, _, jnew = JT._hybrid_stack(jcfg, jx, jp, jnp.asarray(pos), jc)
            ty, taux = TT._hybrid_stack(cfg, _to_torch(jx, torch.bfloat16), tp, torch.from_numpy(pos).long(), tc)
            assert ty.dtype == torch.bfloat16 and float(taux) == 0.0
            where = f"step {step} group {g}"
            np.testing.assert_allclose(_np(ty), _np(jy), **BF16, err_msg=where)
            for k in CACHE_KEYS:
                for j in range(cfg.attn_every):
                    np.testing.assert_allclose(_np(tc["mamba"][k][0, j]), _np(jnew["mamba"][k][0, j]), **BF16,
                                               err_msg=f"{where} layer {j} {k}")
            for k in ("k", "v"):
                np.testing.assert_allclose(_np(tc["attn"][k][0]), _np(jnew["attn"][k][0]), **BF16,
                                           err_msg=f"{where} attention {k}")
            # the next group, and the next step, start from the reference's state
            for part in ("mamba", "attn"):
                for k, v in jnew[part].items():
                    if k != "len":
                        tc[part][k].copy_(_to_torch(v, tc[part][k].dtype))
            new_groups.append(jnew)
            jx = jy
        jcache = {**jcache, **jax.tree.map(lambda *xs: jnp.concatenate(xs), *new_groups)}
        assert np.asarray(jcache["attn"]["len"]).tolist() == [pos0 + n] * groups
        tcache["attn"]["len"] += n


def _gap(a, b):
    """(max abs, relative L2) of a against b."""
    return np.abs(a - b).max(), np.linalg.norm(a - b) / np.linalg.norm(b)


def _floor(jparams, jcfg, max_len, steps):
    """The reference's own gap per step: its compiled run (``jax.jit``,
    ``lax.scan`` over layers: what its ``generate`` runs) against its op-by-op
    run, over the same steps (a prefill, then decode steps on each run's own
    cache)."""
    outs = {}
    for name, c in (("compiled", jcfg), ("op_by_op", dataclasses.replace(jcfg, scan_layers=False))):
        fwd = jax.jit(lambda p, b, cache, c=c: JT.forward(p, c, b, cache)) if c.scan_layers else (
            lambda p, b, cache, c=c: JT.forward(p, c, b, cache))
        cache = jinit_cache(c, BATCH, max_len) if max_len else None
        outs[name] = []
        for tokens in steps:
            jl, _, cache = fwd(jparams, {"tokens": jnp.asarray(tokens)}, cache)
            outs[name].append(np.asarray(jl))
    return [_gap(a, b) for a, b in zip(outs["compiled"], outs["op_by_op"])]


def _within_floor(tl, jl, floor):
    gap = _gap(tl.numpy(), np.asarray(jl))
    assert all(g <= FLOOR_FACTOR * f for g, f in zip(gap, floor)), (gap, floor)


@pytest.mark.parametrize("prompt", [24, 200])
def test_teacher_forced_logits_within_the_reference_own_floor(slice_setup, oracle_scan, prompt):
    """Prefill (200 crosses a scan chunk with a ragged tail), then decode steps.

    Twelve mamba layers and six shared blocks amplify single bf16 rounding
    steps: the reference misses the 2e-2 bar against itself here (its
    compiled run against its op-by-op run by up to 0.167 in max abs and 3.9 %
    in relative L2 over these steps, at |logits| about 5), so the port's
    logits are held to that gap at each step, in max abs and in relative L2
    (``FLOOR_FACTOR`` x).  Each group is
    held at the bf16 bar by the group-by-group test above."""
    jcfg, cfg, jparams, params = slice_setup
    op_cfg = dataclasses.replace(jcfg, scan_layers=False)
    prompts, forced = _prompts(prompt, prompt), _prompts(prompt + 1, GEN - 1)
    steps = [prompts] + [forced[:, i : i + 1] for i in range(GEN - 1)]
    floors = _floor(jparams, jcfg, prompt + GEN, steps)
    jcache = jinit_cache(op_cfg, BATCH, prompt + GEN)
    cache = init_cache(cfg, BATCH, prompt + GEN, "cpu")
    for tokens, floor in zip(steps, floors):
        jl, _, jcache = JT.forward(jparams, op_cfg, {"tokens": jnp.asarray(tokens)}, jcache)
        tl, aux, cache = TT.forward(params, cfg, {"tokens": torch.from_numpy(tokens).long()}, cache)
        assert tl.dtype == torch.float32 and tl.shape == (BATCH, tokens.shape[1], cfg.vocab)
        assert float(aux) == 0.0
        _within_floor(tl, jl, floor)
        assert cache["attn"]["len"].tolist() == np.asarray(jcache["attn"]["len"]).tolist()
        assert int(cache["len"]) == int(jcache["len"])


def test_forward_without_cache_within_the_reference_own_floor(slice_setup, oracle_scan):
    jcfg, cfg, jparams, params = slice_setup
    prompts = _prompts(7, 40)
    (floor,) = _floor(jparams, jcfg, None, [prompts])
    jl, _, jc = JT.forward(jparams, dataclasses.replace(jcfg, scan_layers=False), {"tokens": jnp.asarray(prompts)})
    tl, _, tc = TT.forward(params, cfg, {"tokens": torch.from_numpy(prompts).long()})
    assert tc is None and jc is None
    _within_floor(tl, jl, floor)


@pytest.mark.parametrize("impl", ["xla_chunked", "flash_pallas"])
def test_greedy_generate_matches_reference(slice_setup, impl):
    """Tokens equal repro's compiled generate (its flash route runs the Pallas
    kernel in interpret mode); a difference is excused only at a step where
    JAX's top-two logits lie within the logits bar (a near tie), and the
    sequences are not compared past it."""
    jcfg, cfg, jparams, params = slice_setup
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    prompt = 24
    prompts = _prompts(prompt + 2, prompt)
    ops.flash_attention.launches = ops.ssd_scan.launches = 0
    tokens = generate(cfg, params, prompts, GEN, device="cpu").numpy()
    assert ops.flash_attention.launches == ops.ssd_scan.launches == 0  # CPU tensors never launch
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
                assert top2[1] - top2[0] <= BF16["atol"] + BF16["rtol"] * abs(top2[1]), (
                    f"token {t} of row {row}: {tokens[row, t]} != {jtokens[row, t]} "
                    f"with JAX's top-two logits {top2}"
                )
                return
        feed = jtokens[:, t : t + 1]


def test_prefill_runs_every_scan_and_shared_block(slice_setup, monkeypatch):
    """One prefill calls the scan once per mamba layer and the attention core
    once per group, each group's block at its own cache length."""
    _, cfg, _, params = slice_setup
    from repro_torch.models import attention as TA
    from repro_torch.models import ssm as TS

    calls = {"scan": 0, "attn": []}
    scan, core = TS.ssd_chunked, TA.attention_core

    def counted_scan(*a, **k):
        calls["scan"] += 1
        return scan(*a, **k)

    def counted_core(q, k, v, c, *, causal, q_offset=0):
        calls["attn"].append(q_offset)
        return core(q, k, v, c, causal=causal, q_offset=q_offset)

    monkeypatch.setattr(TS, "ssd_chunked", counted_scan)
    monkeypatch.setattr(TA, "attention_core", counted_core)
    cache = init_cache(cfg, BATCH, 40, "cpu")
    cache["attn"]["len"] += torch.arange(cache["attn"]["len"].shape[0], dtype=torch.int32)
    with torch.no_grad():
        _, _, new = TT.forward(params, cfg, {"tokens": torch.from_numpy(_prompts(1, 8)).long()}, cache)
    groups = cfg.n_layers // cfg.attn_every
    assert calls["scan"] == cfg.n_layers
    assert calls["attn"] == list(range(groups))
    assert new["attn"]["len"].tolist() == [g + 8 for g in range(groups)] and int(new["len"]) == 8
