"""The published OLMoE-1B-7B-0924 on the port's serving path, on the CPU.

``olmoe-1b-7b-0924`` is a configuration of the port alone
(``repro_torch.models.published.PublishedConfig``): QK-norm, the raw top-k
router probabilities (``norm_topk_prob`` false) and dropless routing, none
of which the JAX reference's ``olmoe-1b-7b`` has.  So it is held against the
benchmark's plain float32 reference of the published equations
(``perfbench/reference/moe.py``), on weights that ``perfbench.weights``
makes from a seed.  With the port's compute dtype set to float32 the two
compute the same function, so a prefill and the decode steps after it
through the cache agree with the reference's full forward to float32
rounding (``FP32_REL_L2``), and turning any one of the three mechanisms off
moves the logits far past that bar; as the port runs (bf16) they agree
within ``BF16_REL_L2``.  The grouped products' plain version, which the CPU
and autograd run, equals the capacity route's batched experts bit for bit;
the decode step reads no tensor's value on the host; and the sharded path
refuses dropless routing.
"""

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import model as ref  # noqa: E402
from perfbench.reference import moe as ref_moe  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch import phases  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import moe_grouped_mm_ref, silu  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig, reduced  # noqa: E402
from repro_torch.models.published import PublishedConfig  # noqa: E402

ARCH = "olmoe-1b-7b-0924"
# the same function in float32: reduced olmoe reads 4.8e-7 (prefill and decode)
FP32_REL_L2 = 1e-4
# bf16 products, norms, residual adds and cache: 7.5e-3 on seed 3; the reference's own bf16 bar
BF16_REL_L2 = 5e-2
# a mechanism turned off moves float32 logits by 0.12 (QK-norm), 0.38 (renormalised top-k) and 0.20
# (capacity 1.25) at this size: each at least this far
MECHANISM_REL_L2 = 1e-2
BATCH, PROMPT, STEPS = 2, 16, 8
REF_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab", "tie_embeddings",
              "norm_eps", "rope_theta", "moe_experts", "moe_top_k", "qk_norm", "norm_topk_prob")


def _rel_l2(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm())


def _tiny():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), attention_impl="flash_pallas")
    return cfg, {f: getattr(cfg, f) for f in REF_FIELDS}


@contextlib.contextmanager
def _compute(dtype):
    """The port's compute and cache dtypes set to ``dtype`` inside."""
    kept = L.COMPUTE_DTYPE, kvcache.CACHE_DTYPE
    L.COMPUTE_DTYPE = kvcache.CACHE_DTYPE = dtype
    try:
        yield
    finally:
        L.COMPUTE_DTYPE, kvcache.CACHE_DTYPE = kept


def _served_logits(cfg, params, tokens) -> torch.Tensor:
    """A prefill of the first ``PROMPT`` tokens through the cache, then one decode step a token."""
    with torch.no_grad():
        cache = kvcache.init_cache(cfg, tokens.shape[0], tokens.shape[1], "cpu")
        logits, _, cache = T.forward(params, cfg, {"tokens": tokens[:, :PROMPT]}, cache)
        out = [logits]
        for i in range(PROMPT, tokens.shape[1]):
            step, _, cache = T.forward(params, cfg, {"tokens": tokens[:, i:i + 1]}, cache)
            out.append(step)
    return torch.cat(out, dim=1)


def _gap(cfg, m, dtype, seed: int = 3) -> float:
    with _compute(dtype):
        params = weights.make("moe", m, seed, "cpu", dtype)
        tokens = torch.as_tensor(np.random.default_rng(seed).integers(0, m["vocab"], size=(BATCH, PROMPT + STEPS)))
        served = _served_logits(cfg, params, tokens)
    with ref.fp32_matmuls():
        want = ref.logits_at("moe", params, m, tokens, slice(None))
    assert served.shape == want.shape == (BATCH, PROMPT + STEPS, m["vocab"])
    return _rel_l2(served, want)


def test_the_published_config_is_the_ports_own():
    cfg = get_config(ARCH)
    assert ARCH not in ARCHS and isinstance(cfg, PublishedConfig)
    assert (cfg.qk_norm, cfg.norm_topk_prob, cfg.moe_dropless) == (True, False, True)
    assert (cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k, cfg.rope_theta) == \
        (16, 2048, 128, 1024, 64, 8, 10000.0)
    assert round(cfg.param_count() / 1e9, 2) == 6.92 and round(cfg.active_param_count() / 1e9, 2) == 1.28
    assert isinstance(reduced(cfg), PublishedConfig) and reduced(cfg).qk_norm
    plain = PublishedConfig(**dataclasses.asdict(get_config("olmoe-1b-7b")))
    assert (plain.qk_norm, plain.norm_topk_prob, plain.moe_dropless) == (False, True, False)
    assert not hasattr(ModelConfig("x", "moe", 1, 8, 1, 1, 8, 8), "qk_norm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_plain_reference(dtype):
    cfg, m = _tiny()
    bar = FP32_REL_L2 if dtype == "float32" else BF16_REL_L2
    assert _gap(cfg, m, getattr(torch, dtype)) < bar


@pytest.mark.parametrize("mechanism", [("qk_norm", False), ("norm_topk_prob", True), ("moe_dropless", False)],
                         ids=lambda kv: kv[0])
def test_each_mechanism_moves_the_logits_past_the_bar(mechanism):
    cfg, m = _tiny()
    assert _gap(cfg, m, torch.float32) < FP32_REL_L2
    assert _gap(dataclasses.replace(cfg, **dict([mechanism])), m, torch.float32) > MECHANISM_REL_L2


def _skewed_block(seed: int = 4):
    """A block input whose rows share a direction the router favours for experts 0 and 1, so that
    nearly every token routes there: (cfg, m, x (B, S, D) bf16, the block's parameters)."""
    cfg, m = _tiny()
    g = torch.Generator().manual_seed(seed)
    p = weights.make("moe", m, seed, "cpu", torch.bfloat16)["layers"][0]["moe"]
    common = torch.randn(cfg.d_model, generator=g)
    x = (common + 0.5 * torch.randn(BATCH, 24, cfg.d_model, generator=g)).to(torch.bfloat16)
    favour = torch.zeros(cfg.moe_experts)
    favour[:2] = 4.0
    router = p["w_router"].float() + torch.outer(common / common.square().sum(), favour)
    return cfg, m, x, {**p, "w_router": router.to(torch.bfloat16)}


def test_a_skewed_router_drops_at_capacity_and_dropless_keeps_every_entry():
    cfg, m, x, p = _skewed_block()
    xf = x.reshape(-1, cfg.d_model)
    _, top_i, _ = M.route(xf, p["w_router"], cfg.moe_top_k, False)
    cap = M.capacity(xf.shape[0], cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
    _, _, keep = M.dispatch(xf, top_i, cfg.moe_experts, cap)
    assert int((~keep).sum()) > xf.shape[0] // 2  # most of the entries overflow experts 0 and 1
    with ref.fp32_matmuls():
        want = ref_moe.experts(x.float(), p, m)
    with torch.no_grad():
        dropless, _ = M.moe_block(x, p, cfg)
        capped, _ = M.moe_block(x, p, dataclasses.replace(cfg, moe_dropless=False))
    assert _rel_l2(dropless, want) < BF16_REL_L2
    assert _rel_l2(capped, want) > 10 * BF16_REL_L2


def _grouped_case(seed: int = 0, t: int = 40, d: int = 128, f: int = 64, e: int = 8, k: int = 2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, d, generator=g).to(torch.bfloat16)
    w_in, w_gate = ((torch.randn(e, d, f, generator=g) / d ** 0.5).to(torch.bfloat16) for _ in range(2))
    w_out = (torch.randn(e, f, d, generator=g) / f ** 0.5).to(torch.bfloat16)
    router = (torch.randn(d, e, generator=g) / d ** 0.5).to(torch.bfloat16)
    top_p, top_i, _ = M.route(x, router, k, False)
    return x, w_in, w_gate, w_out, top_p, top_i


def test_sorting_the_entries_groups_them_by_expert_token_major():
    x, *_, top_i = _grouped_case()
    src, dst, offsets = M.sort_entries(top_i, 8)
    assert src.dtype == dst.dtype == offsets.dtype == torch.int32
    flat = top_i.reshape(-1)
    assert offsets[0] == 0 and offsets[-1] == flat.numel() and bool((offsets[1:] >= offsets[:-1]).all())
    assert torch.equal(offsets[1:] - offsets[:-1], torch.bincount(flat, minlength=8).int())
    assert torch.equal(src.long(), dst.long() // 2)
    for e in range(8):
        rows = dst[offsets[e]:offsets[e + 1]].long()
        assert bool((flat[rows] == e).all()) and bool((rows[1:] > rows[:-1]).all())


def test_the_grouped_products_plain_version_is_the_per_expert_loop():
    x, w_in, w_gate, w_out, _, top_i = _grouped_case()
    src, dst, offsets = M.sort_entries(top_i, 8)
    y = moe_grouped_mm_ref(x, w_in, w_gate, w_out, src, dst, offsets)
    assert torch.equal(ops.moe_grouped_mm(x, w_in, w_gate, w_out, src, dst, offsets), y)  # the CPU's route
    buf, slot, keep = M.dispatch(x, top_i, 8, x.shape[0] * 2)  # a capacity that drops nothing
    assert bool(keep.all())
    batched = M.experts(buf, {"w_in": w_in, "w_gate": w_gate, "w_out": w_out})[top_i.reshape(-1), slot]
    assert torch.equal(y, batched)
    for i in range(0, top_i.numel(), 7):
        t, e = i // 2, int(top_i.reshape(-1)[i])
        row = x[t:t + 1]
        one = torch.matmul(torch.matmul(row, w_in[e]) * silu(torch.matmul(row, w_gate[e])), w_out[e])
        assert torch.equal(y[i:i + 1], one)


@pytest.mark.parametrize("bad", ["offsets", "w_out"])
def test_the_grouped_wrapper_refuses_mismatched_operands(bad):
    x, w_in, w_gate, w_out, _, top_i = _grouped_case()
    src, dst, offsets = M.sort_entries(top_i, 8)
    args = dict(x=x, w_in=w_in, w_gate=w_gate, w_out=w_out, src=src, dst=dst, offsets=offsets)
    args[bad] = offsets[:-1] if bad == "offsets" else w_out.transpose(1, 2)
    with pytest.raises(ValueError, match="do not match"):
        ops.moe_grouped_mm(**args)


def _sync_free_grouped(x, w_in, w_gate, w_out, src, dst, offsets):
    """The grouped products with no host read: every expert on every sorted row, each row's own
    expert's kept (the test's stand-in for the kernel, which reads the offsets on the device)."""
    rows = x[src.long()]
    expert = torch.searchsorted(offsets[1:], torch.arange(src.numel(), dtype=offsets.dtype), right=True)
    per = torch.stack([torch.matmul(torch.matmul(rows, w_in[e]) * silu(torch.matmul(rows, w_gate[e])), w_out[e])
                       for e in range(w_in.shape[0])])
    y_sorted = per.gather(0, expert.long()[None, :, None].expand(1, -1, x.shape[1]))[0]
    return torch.zeros_like(y_sorted).index_copy(0, dst.long(), y_sorted)


def test_the_decode_step_reads_no_tensor_value_on_the_host(monkeypatch):
    from repro_torch.train.steps import make_serve_step

    cfg, m = _tiny()
    x, w_in, w_gate, w_out, _, top_i = _grouped_case()
    src, dst, offsets = M.sort_entries(top_i, 8)
    want = moe_grouped_mm_ref(x, w_in, w_gate, w_out, src, dst, offsets)
    torch.testing.assert_close(_sync_free_grouped(x, w_in, w_gate, w_out, src, dst, offsets), want,
                               atol=2e-2, rtol=2e-2)
    params = weights.make("moe", m, 5, "cpu", torch.bfloat16)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, m["vocab"], size=(BATCH, PROMPT)))
    cache = kvcache.init_cache(cfg, BATCH, PROMPT + 2, "cpu")
    with torch.no_grad():
        logits, _, cache = T.forward(params, cfg, {"tokens": tokens}, cache)
    step = logits[:, -1].argmax(-1)[:, None]
    monkeypatch.setattr(ops, "moe_grouped_mm", _sync_free_grouped)

    def host_read(self, *args, **kwargs):
        raise AssertionError("a tensor's value was read on the host")

    for name in ("item", "tolist", "__bool__", "__int__", "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with torch.no_grad():
        next_token, _ = make_serve_step(cfg)(params, cache, {"tokens": step})
    assert next_token.shape == (BATCH,)


def test_each_block_records_its_phases_and_entries():
    cfg, m = _tiny()
    params = weights.make("moe", m, 6, "cpu", torch.bfloat16)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, m["vocab"], size=(BATCH, PROMPT)))
    registry = phases.counter("moe.entries")
    before = registry.value
    from repro_torch.obs.metrics import metrics

    seen = {n: metrics().histogram(n).count for n in ("moe.route.host_ms", "moe.experts.host_ms")}
    with torch.no_grad():
        T.forward(params, cfg, {"tokens": tokens})
    assert registry.value - before == cfg.n_layers * BATCH * PROMPT * cfg.moe_top_k
    for name, count in seen.items():
        assert metrics().histogram(name).count - count == cfg.n_layers


def test_autograd_takes_the_plain_grouped_products(monkeypatch):
    cfg, m = _tiny()
    params = weights.make("moe", m, 7, "cpu", torch.float32)
    ids = torch.as_tensor(np.random.default_rng(7).integers(0, m["vocab"], size=(BATCH, PROMPT + 1)))

    def refused(*args):
        raise AssertionError("the kernel's wrapper ran where autograd records")

    monkeypatch.setattr(ops, "moe_grouped_mm", refused)
    leaves = {k: p.requires_grad_() for k, p in weights.named_leaves(params)}
    loss, _ = T.loss_fn(weights.unflatten(leaves), cfg, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for name in ("w_in", "w_gate", "w_out", "w_router"):
        g = grads[f"layers.0.moe.{name}"]
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_dropless_routing_refuses_sharding_rules():
    from repro_torch.launch.dryrun import fake_world

    cfg, m = _tiny()
    p = weights.make("moe", m, 8, "cpu", torch.bfloat16)["layers"][0]["moe"]
    x = torch.zeros(BATCH, 4, cfg.d_model, dtype=torch.bfloat16)
    with fake_world(4, (2, 2), ("data", "model"), "cpu") as mesh:
        with D.use_rules(D.ShardingRules(mesh, dp_axes=("data",))):
            with pytest.raises(NotImplementedError, match=ARCH):
                M.moe_block(x, p, cfg)
