"""The plain reference against the port's CPU path at tiny sizes.

The reference (``perfbench/reference``) is float32 throughout; the port runs
its products and most elementwise steps in bf16 and, on a CPU tensor, the
plain fp32 versions of its kernels.  With the port's compute dtype set to
float32 the two compute the same function, so logits, loss and gradients
agree to float32 rounding (``FP32_REL_L2``); as the port runs (bf16), within
``BF16_REL_L2``.  AdamW agrees to float32 rounding, and the SSD equals its
defining recurrence.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import lowp
from perfbench.reference import model as ref

FP32_REL_L2 = 1e-4
# bf16 steps at every product, silu and residual add: reduced mamba2 reads 1.1e-2 on
# three seeds and 1e-6 or less with the port in float32, so the gap is rounding
BF16_REL_L2 = 5e-2


def _rel_l2(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm())


def _tiny(tie: bool) -> tuple:
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    cfg = dataclasses.replace(reduced(get_config("mamba2-780m")), ssm_chunk=64, remat="full", tie_embeddings=tie)
    fields = ("n_layers", "d_model", "vocab", "tie_embeddings", "norm_eps", "ssm_state", "ssm_headdim",
              "ssm_expand", "ssm_conv", "ssm_chunk")
    return cfg, {f: getattr(cfg, f) for f in fields}


def test_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 300, 3, 4, 5
    x, bm, cm = (torch.randn(b, s, h, p, generator=g), torch.randn(b, s, n, generator=g),
                 torch.randn(b, s, n, generator=g))
    log_a = -0.3 * torch.rand(b, s, h, generator=g)
    state, ys = torch.zeros(b, h, p, n), []
    for t in range(s):
        state = state * torch.exp(log_a[:, t])[..., None, None] + torch.einsum("bhp,bn->bhpn", x[:, t], bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    want = torch.stack(ys, 1)
    for chunk in (64, 128):
        assert _rel_l2(ref.ssd(x, log_a, bm, cm, chunk), want) < 1e-5


@pytest.fixture(params=["float32", "bfloat16"])
def compute(request, monkeypatch):
    """(the port's compute dtype for this test, the relative L2 bar that goes with it)."""
    from repro_torch.models import layers

    dtype = getattr(torch, request.param)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", dtype)
    return dtype, FP32_REL_L2 if dtype == torch.float32 else BF16_REL_L2


@pytest.mark.parametrize("tie", [True, False])
def test_logits_match_the_ports_forward(tie, compute):
    from repro_torch.models import transformer as T

    dtype, bar = compute
    cfg, m = _tiny(tie)
    params = weights.make("ssm", m, 11, "cpu", dtype)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, m["vocab"], size=(2, 150)))
    with torch.no_grad():
        port, _, _ = T.forward(params, cfg, {"tokens": tokens})
    want = ref.logits_at("ssm", params, m, tokens, slice(None))
    assert want.dtype == torch.float32
    assert _rel_l2(port, want) < bar


@pytest.mark.parametrize("tie", [True, False])
def test_mamba2_loss_and_gradients_match_the_ports(tie, compute):
    from repro_torch.train.steps import value_and_grad

    cfg, m = _tiny(tie)
    params = weights.make("ssm", m, 5, "cpu", torch.float32)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, m["vocab"], size=(2, 161)))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    _, bar = compute
    loss, _, grads = value_and_grad(cfg, params, batch)
    leaves = {k: p.detach().requires_grad_() for k, p in weights.named_leaves(params)}
    want = ref.loss("ssm", weights.unflatten(leaves), m, batch["tokens"], batch["labels"])
    want_grads = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()))))
    assert abs(float(loss) - float(want.detach())) < bar * float(want.detach())
    for path, g in weights.named_leaves(grads):
        assert _rel_l2(g, want_grads[path]) < bar, path


def test_adamw_matches_the_ports():
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    h = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0,
         "warmup_steps": 2, "total_steps": 10, "min_lr_frac": 0.1}
    g = torch.Generator().manual_seed(2)
    params = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    port_p, port_s = params, adamw_init(params)
    ref_p, ref_s = params, ref_adamw.init(params)
    for _ in range(4):
        grads = {k: 3 * torch.randn(v.shape, generator=g) for k, v in params.items()}
        port_p, port_s, _ = adamw_update(port_p, grads, port_s, AdamWConfig(**h))
        ref_p, ref_s, clipped = ref_adamw.update(ref_p, grads, ref_s, h)
        for k in params:
            torch.testing.assert_close(port_p[k], ref_p[k], rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(port_s["m"][k], ref_s["m"][k], rtol=1e-6, atol=1e-7)


def test_the_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(3))
    q = lowp.quantize(x, torch.float8_e4m3fn, -1)
    rel = ((q - x).abs() / x.abs().clamp_min(1e-3)).max()
    assert 0 < rel <= 2**-4 + 1e-6
    a, b = torch.randn(16, 32).requires_grad_(), torch.randn(32, 8).requires_grad_()
    out = lowp.fp8_matmul(a, b)
    assert 1e-3 < _rel_l2(out, a @ b) < 0.1
    out.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
