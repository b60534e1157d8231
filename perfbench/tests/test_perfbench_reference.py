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
import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import lowp
from perfbench.reference import model as ref
from perfbench.reference import ssm
from perfbench.tests.test_perfbench_harness import copy_tree

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
        assert _rel_l2(ssm.ssd(x, log_a, bm, cm, chunk), want) < 1e-5


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


#: reduced mamba2's weights for seed 2147483999 (float32, then bfloat16) and the reference's loss and
#: gradients on them, as the tree before the ssm family moved into ``reference/ssm.py`` gave them
PINNED = {"weights": "401502c66a5d795a910eb9887c19d2c8cddd0de881540a131f0ebcb981ad9cff",
          "loss": "0x1.ae471c0000000p+2",
          "grads": "107f637fe7e84dca22972037a430dbd35d80f10852a49f2114b4f69bb4d4b951"}


def test_weights_and_the_references_loss_are_bit_for_bit_as_pinned():
    _, m = _tiny(False)
    digest = hashlib.sha256()
    for dtype in (torch.float32, torch.bfloat16):
        for path, t in weights.named_leaves(weights.make("ssm", m, 2147483999, "cpu", dtype)):
            digest.update(path.encode() + b"\0" + str(t.dtype).encode() + b"\0"
                          + t.contiguous().view(torch.uint8).numpy().tobytes())
    assert digest.hexdigest() == PINNED["weights"]
    params = weights.make("ssm", m, 2147483999, "cpu", torch.float32)
    ids = torch.as_tensor(np.random.default_rng(7).integers(0, m["vocab"], size=(2, 161)))
    leaves = {k: p.detach().requires_grad_() for k, p in weights.named_leaves(params)}
    with ref.fp32_matmuls():
        loss = ref.loss("ssm", weights.unflatten(leaves), m, ids[:, :-1], ids[:, 1:])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss.detach()).hex() == PINNED["loss"]
    digest = hashlib.sha256()
    for k, g in zip(leaves, grads):
        digest.update(k.encode() + b"\0" + g.numpy().tobytes())
    assert digest.hexdigest() == PINNED["grads"]


#: a family added as a file: one product a layer, and a kind of leaf of its own
TOY_FAMILY = '''
import torch

from .model import fp32_matmul, linear

KINDS = {"halves": lambda shape, **f32: torch.full(shape, 0.5, **f32)}


def layer_specs(m):
    return [(f"layers.{i}.{name}", shape, kind, scale) for i in range(m["n_layers"])
            for name, shape, kind, scale in (("w", (m["d_model"], m["d_model"]), "normal", 0.1),
                                             ("gate", (m["d_model"],), "halves", None))]


def layers(x, params, m, run, matmul=fp32_matmul):
    for p in params["layers"]:
        x = run(lambda x_, p_=p: x_ + linear(x_, p_["w"], matmul) * p_["gate"], x)
    return x
'''
TOY_RUN = """
import json, torch
from perfbench import weights
from perfbench.reference import model
m = {"d_model": 8, "vocab": 32, "n_layers": 2, "norm_eps": 1e-5, "tie_embeddings": True}
params = weights.make("toy", m, 5, "cpu", torch.float32)
tokens = torch.arange(12).reshape(2, 6)
x = model.hidden_states("toy", params, m, tokens)
print(json.dumps({"paths": [p for p, *_ in weights.leaf_specs("toy", m)], "shape": list(x.shape),
                  "gate": params["layers"][1]["gate"].tolist(), "module": model.family_module("toy").__file__}))
"""


def test_a_family_added_as_a_file_is_found_by_its_name(tmp_path):
    here = copy_tree(tmp_path)
    (here / "reference/toy.py").write_text(TOY_FAMILY)
    proc = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    found = json.loads(proc.stdout.strip().splitlines()[-1])
    assert found["paths"] == ["embed", "final_norm", "layers.0.w", "layers.0.gate", "layers.1.w", "layers.1.gate"]
    assert found["shape"] == [2, 6, 8] and found["gate"] == [0.5] * 8
    assert found["module"] == str(here / "reference/toy.py")


@pytest.mark.parametrize("family", ["absent_family", "no-such-family"])
def test_a_family_without_a_file_is_refused_naming_the_file(family):
    m = {"d_model": 8, "vocab": 32, "n_layers": 1, "tie_embeddings": True}
    for call in (lambda: weights.leaf_specs(family, m),
                 lambda: ref.hidden_states(family, {"embed": torch.zeros(32, 8)}, m, torch.zeros(1, 2).long())):
        with pytest.raises(ValueError, match=f"reference/{family}.py"):
            call()
