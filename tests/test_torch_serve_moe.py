"""The port's moe serving slice against ``repro``'s, on the CPU.

``reduced(olmoe-1b-7b)`` with ``attention_impl="flash_pallas"`` (2 layers,
d_model 128, 4 heads of 32, 8 experts of d_ff 256, top-2) is initialised by
``repro.models.transformer.init_params`` and carried across with
``from_jax_params``, so both packages compute the same function.  The
reference's MoE block needs sharding rules, so it runs under
``single_device_rules()``.

Logits bar: atol/rtol 2e-2, the reference's bf16 bar, as for the dense slice
(``test_torch_serve.py``).  The reference's compiled model (``lax.scan``
over layers, fused by XLA) keeps some bf16 intermediates at higher precision
and on this model disagrees with its own op-by-op run (``scan_layers=False``,
run eagerly) by more than that bar on a few logits of every step; compiled
without the scan, it even routes some tokens to other experts.  The port
rounds at every bf16 op, as the op-by-op run does, so the teacher-forced
comparison holds it against that run, as ``test_torch_serve_ssm.py`` does.
Greedy ``generate`` is held against the reference's compiled ``generate``.

The forward's aux sums the layers' load-balance losses, whose inputs past the
first layer carry those bf16 differences, so it is held to the logits bar;
``test_torch_moe.py`` holds one block's aux to rtol 1e-6 on equal inputs.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import single_device_rules, use_rules  # noqa: E402
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
from repro_torch.weights import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGITS = dict(atol=2e-2, rtol=2e-2)
BATCH, PROMPT, GEN = 2, 24, 4


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = dataclasses.replace(jreduced(jget_config("olmoe-1b-7b")), attention_impl="flash_pallas")
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")), attention_impl="flash_pallas")
    assert cfg.family == "moe"
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (2, 128, 4, 4, 32)
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.d_ff) == (8, 2, 256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    return jcfg, cfg, jparams, params, prompts


def test_carried_parameters_are_the_references_in_bf16(slice_setup):
    jcfg, cfg, jparams, params, _ = slice_setup
    assert len(params["layers"]) == cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        assert "mlp" not in layer and layer["moe"].keys() == {"w_router", "w_in", "w_gate", "w_out"}
        for name, t in layer["moe"].items():
            want = np.asarray(jparams["layers"]["moe"][name][i])
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == want.shape
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32))


def test_teacher_forced_logits_match(slice_setup):
    jcfg, cfg, jparams, params, prompts = slice_setup
    rng = np.random.default_rng(1)
    forced = rng.integers(1, cfg.vocab, size=(BATCH, GEN - 1)).astype(np.int32)
    op_by_op = dataclasses.replace(jcfg, scan_layers=False)

    def fwd(p, b, c):
        return JT.forward(p, op_by_op, b, c)

    jcache = jinit_cache(jcfg, BATCH, PROMPT + GEN)
    cache = init_cache(cfg, BATCH, PROMPT + GEN, "cpu")
    steps = [prompts] + [forced[:, i : i + 1] for i in range(GEN - 1)]
    with use_rules(single_device_rules()):
        for tokens in steps:
            jl, jaux, jcache = fwd(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
            tl, aux, cache = TT.forward(params, cfg, {"tokens": torch.from_numpy(tokens).long()}, cache)
            assert tl.dtype == torch.float32 and tl.shape == (BATCH, tokens.shape[1], cfg.vocab)
            assert int(cache["len"]) == int(jcache["len"])
            assert cache["len"].dtype == torch.int32 and cache["len"].shape == ()  # a tensor, like the reference's int32
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
            assert aux.dtype == torch.float32 and aux.shape == ()
            assert float(jaux) > 0
            np.testing.assert_allclose(float(aux), float(jaux), **LOGITS)


def test_greedy_generate_matches_reference(slice_setup):
    """Tokens equal repro's generate; a difference is excused only at a step
    where JAX's top-two logits lie within the logits bar (a near tie), and the
    sequences are not compared past it."""
    jcfg, cfg, jparams, params, prompts = slice_setup
    ops.flash_attention.launches = ops.ssd_scan.launches = 0
    tokens = generate(cfg, params, prompts, GEN, device="cpu").numpy()
    assert ops.flash_attention.launches == ops.ssd_scan.launches == 0  # CPU tensors never launch
    with use_rules(single_device_rules()):
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


def test_moe_cache_is_the_dense_cache():
    cfg = reduced(get_config("olmoe-1b-7b"))
    cache = init_cache(cfg, 3, 40, "cpu")
    assert cache.keys() == {"k", "v", "len"} and int(cache["len"]) == 0
    for name in ("k", "v"):
        assert cache[name].shape == (cfg.n_layers, 3, 40, cfg.n_kv_heads, cfg.head_dim)
        assert cache[name].dtype == torch.bfloat16


def test_init_params_shapes_and_scales():
    jcfg, cfg = jreduced(jget_config("olmoe-1b-7b")), reduced(get_config("olmoe-1b-7b"))
    jshapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k), jax.random.PRNGKey(0))
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params.keys() == jshapes.keys()
    d, f = cfg.d_model, cfg.d_ff
    fan_in = {"w_router": d, "w_in": d, "w_gate": d, "w_out": f}
    for layer in params["layers"]:
        assert layer.keys() == jshapes["layers"].keys()
        for name, t in layer["moe"].items():
            assert tuple(t.shape) == jshapes["layers"]["moe"][name].shape[1:], name
            assert t.dtype == torch.bfloat16
            std = float(t.float().std())
            want = 1.0 / np.sqrt(fan_in[name])
            assert abs(std / want - 1) < 0.1, (name, std, want)


def test_launcher_runs_reduced_olmoe_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmoe-1b-7b", "--reduced",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 3) on cpu" in proc.stdout
