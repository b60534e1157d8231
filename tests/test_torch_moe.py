"""The port's MoE block against ``repro.models.moe``, on the CPU.

The reference's ``moe_block`` runs jitted under ``single_device_rules()``,
as ``tests/test_models.py`` runs it: one tp shard, so every expert is local.
Its parameters come from ``repro.models.transformer.init_params`` and are
carried across with ``from_jax_params``; the input is made from a seed with
numpy and rounded to bf16 once, so both blocks see the same bits.

Routing is held exactly: the same top-k experts in the same order, the same
kept and dropped entries and the same slots.  A routing decision is exact
only where no two probabilities lie within the two frameworks' fp32
rounding of each other, so every case first asserts that the gap between
each token's k-th and (k+1)-th probability is far above it.  Outputs: y
within the reference's bf16 bar (atol/rtol 2e-2), aux within rtol 1e-6
(fp32 means summed in another order).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import single_device_rules, use_rules  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.models.moe import moe_block as jmoe_block  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

BF16 = dict(atol=2e-2, rtol=2e-2)
AUX_RTOL = 1e-6
BATCH, SEQ = 2, 32
# (experts, top-k, capacity factor): reduced olmoe; olmoe's own routing at
# d_model 128; and a capacity at which half the entries overflow
ROUTING = [(8, 2, 1.25), (64, 8, 1.25), (8, 2, 0.5)]
# a routing decision is held exactly only if the k-th and (k+1)-th
# probabilities are this many fp32 steps apart (the two routers' logits
# differ by a few steps: fp32 sums in another order)
MARGIN_ULPS = 64


def _configs(n_exp, top_k, cf):
    kw = dict(moe_experts=n_exp, moe_top_k=top_k, capacity_factor=cf)
    jcfg = dataclasses.replace(jreduced(jget_config("olmoe-1b-7b")), **kw)
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")), **kw)
    assert (cfg.d_model, cfg.d_ff) == (128, 256)
    return jcfg, cfg


def _jax_routing(x, w_router, cfg):
    """The reference's routing and slot assignment (``_local_moe`` :45-73) on one shard."""
    t, k, n_exp = x.shape[0] * x.shape[1], cfg.moe_top_k, cfg.moe_experts
    xf = x.reshape(t, -1)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.bfloat16), w_router.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    ent_expert = top_i.reshape(-1)
    capacity = max(int(math.ceil(t * k / n_exp * cfg.capacity_factor)), 8)
    onehot = ent_expert[:, None] == jnp.arange(n_exp)[None, :]
    slot = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
    slot = jnp.take_along_axis(slot, ent_expert[:, None], axis=1)[:, 0]
    keep = slot < capacity
    return probs, top_i, jnp.where(keep, slot, capacity), keep, capacity


@pytest.fixture(scope="module", params=ROUTING, ids=lambda r: "E{}-k{}-cf{}".format(*r))
def case(request):
    jcfg, cfg = _configs(*request.param)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    p = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")["layers"][0]["moe"]
    rng = np.random.default_rng(0)
    xb = jnp.asarray(rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32), jnp.bfloat16)
    x = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    with use_rules(single_device_rules()):
        jy, jaux = jax.jit(lambda x, p: jmoe_block(x, p, jcfg))(xb, jp)
        routing = jax.jit(lambda x, w: _jax_routing(x, w, jcfg))(xb, jp["w_router"])
    jrouting = tuple(np.asarray(a) if not isinstance(a, int) else a for a in routing)
    return cfg, p, x, np.asarray(jy.astype(jnp.float32)), float(jaux), jrouting


def test_routing_margin_is_far_above_fp32_rounding(case):
    cfg, _, _, _, _, (probs, *_rest) = case
    srt = -np.sort(-probs, axis=-1)
    k = cfg.moe_top_k
    gap = srt[:, k - 1] - srt[:, k]
    assert gap.min() > MARGIN_ULPS * np.spacing(srt[:, k - 1]).max(), gap.min()


def test_routing_and_drops_match_the_reference(case):
    cfg, p, x, _, _, (_, jtop_i, jslot, jkeep, jcap) = case
    xf = x.reshape(-1, cfg.d_model)
    top_p, top_i, _ = M.route(xf, p["w_router"], cfg.moe_top_k)
    cap = M.capacity(xf.shape[0], cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
    _, slot, keep = M.dispatch(xf, top_i, cfg.moe_experts, cap)
    assert cap == jcap
    np.testing.assert_array_equal(top_i.numpy(), jtop_i)  # the same experts, in the same order
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    n_dropped = int((~jkeep).sum())
    assert n_dropped > 0, "the case must exercise the overflow path"
    if cfg.capacity_factor < 1:
        assert n_dropped >= jkeep.size - cfg.moe_experts * cap
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_dispatch_fills_kept_slots_and_leaves_the_scratch_slot_zero(case):
    cfg, p, x, _, _, _ = case
    xf = x.reshape(-1, cfg.d_model)
    k = cfg.moe_top_k
    _, top_i, _ = M.route(xf, p["w_router"], k)
    cap = M.capacity(xf.shape[0], k, cfg.moe_experts, cfg.capacity_factor)
    buf, slot, keep = M.dispatch(xf, top_i, cfg.moe_experts, cap)
    assert buf.shape == (cfg.moe_experts, cap + 1, cfg.d_model) and buf.dtype == torch.bfloat16
    assert torch.all(buf[:, cap] == 0)
    ent_e, token = top_i.reshape(-1), torch.arange(xf.shape[0]).repeat_interleave(k)
    assert torch.equal(buf[ent_e[keep], slot[keep]], xf[token[keep]])
    filled = torch.zeros((cfg.moe_experts, cap + 1), dtype=torch.bool)
    filled[ent_e[keep], slot[keep]] = True
    assert int(filled.sum()) == int(keep.sum())  # kept slots are unique
    assert torch.all(buf[~filled] == 0)


def test_moe_block_matches_the_reference(case):
    cfg, p, x, jy, jaux, _ = case
    y, aux = M.moe_block(x, p, cfg)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), jy, **BF16)
    np.testing.assert_allclose(float(aux), jaux, rtol=AUX_RTOL)


@pytest.mark.parametrize("tokens, top_k, n_exp, cf, want", [
    (2048, 8, 64, 1.25, 320),  # olmoe's prefill, batch 4 x 512
    (4, 8, 64, 1.25, 8),  # olmoe's decode step, batch 4: the floor of 8
    (64, 2, 8, 1.25, 20),
    (64, 2, 8, 0.5, 8),
    (3, 3, 7, 1.1, 8),
    (1000, 3, 7, 1.1, 472),  # ceil of 471.43
])
def test_capacity_is_the_references(tokens, top_k, n_exp, cf, want):
    assert M.capacity(tokens, top_k, n_exp, cf) == want
    assert want == max(int(math.ceil(tokens * top_k / n_exp * cf)), 8)
