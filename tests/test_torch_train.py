"""The port's training path against ``repro``'s, on the CPU.

On a CPU tensor every kernel wrapper takes its plain version, so this file
holds the algebra and the training modules; ``chip_smoke.py`` (phases 3b and
8) holds the card's backward kernel against its plain version and trains
mamba2-780m and qwen2-1.5b at full width.

* The SSD scan's gradient: ``ops.ssd_scan`` under autograd runs an autograd
  function whose backward is ``ops.ssd_scan_bwd`` (on the CPU autograd of
  ``ref.ssd_scan_ref``), held against ``jax.grad`` of the reference's XLA
  twin ``ssd_chunked`` in fp32 at atol 2e-5 x max|g_ref| and rtol 2e-4: the
  twin's own bar (``tests/test_torch_ssm.py``) scaled to the gradient,
  since a gradient sums more terms than the scan's output.
* ``matmul_f32``'s backward (the card's route) against ``jax.vjp`` of the
  reference's ``einsum(..., preferred_element_type=float32)``: bitwise, as
  both take one fp32 product and round once to bf16.
* Remat ``"full"`` and ``"dots"`` against ``"none"``: the same loss and
  gradients, bitwise (the CPU recomputes each layer exactly).
* AdamW, clipping and the schedule against the reference on numpy-seeded
  fp32 trees (rtol 1e-6), and the reference's own optimizer tests.
* ``make_train_step`` with 2 microbatches against 1 and against the
  reference's, on a VLM batch with (3, B, S) positions: gradients (caught by
  the ``grad_transform`` hook) within relative L2 2e-2 per leaf, the bf16
  bar (the two packages round bf16 at other places, and a microbatch's
  products sum in another order).
* The trainer's crash and resume, as the reference's test runs it; the
  resumed history and parameters equal the uninterrupted run's exactly.
* ``python -m repro_torch.launch.train --reduced --device cpu``.

The loss and every gradient leaf of the six families against the
reference's are in ``test_torch_train_loss*.py``.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.distributed import single_device_rules, use_rules  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import InputShape as JShape  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train.steps import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import InputShape, reduced  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.train.steps import _split_microbatches, make_train_step, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCAN_GRAD_F32 = (2e-5, 2e-4)  # atol as a fraction of max|g_ref|, rtol
GRAD_REL_L2 = 2e-2


def _close(got, want, atol_frac, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max())


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ------------------------------------------------------------------ the scan's gradient
@pytest.mark.parametrize(
    "b,s,h,p,n,chunk,with_state",
    [
        (2, 256, 4, 64, 64, 128, False),  # the three shapes of tests/test_kernels.py
        (1, 300, 8, 64, 128, 128, False),
        (1, 128, 2, 32, 16, 128, False),
        (2, 200, 4, 32, 16, 128, True),  # ragged, a nonzero state0 and d(final state)
        (2, 300, 4, 32, 16, 64, True),  # chunk 64
    ],
)
def test_ssd_scan_gradient_matches_jax_grad_of_the_twin(b, s, h, p, n, chunk, with_state):
    rng = np.random.default_rng(s + n)
    arrs = [
        rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.2,
        -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.1,
        rng.standard_normal((b, s, n)).astype(np.float32) * 0.3,
        rng.standard_normal((b, s, n)).astype(np.float32) * 0.3,
        rng.standard_normal((b, h, p, n)).astype(np.float32),
    ]
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else np.zeros((b, h, p, n), np.float32)
    nargs = 5 if with_state else 4

    def jloss(*args):
        y, st = JS.ssd_chunked(*args[:4], chunk, args[4] if with_state else None)
        return jnp.sum(y * dy) + jnp.sum(st * dstate)

    jgrads = jax.grad(jloss, argnums=tuple(range(nargs)))(*[jnp.asarray(a) for a in arrs[:nargs]])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:nargs]]
    launches = ops.ssd_scan_bwd.launches
    y, st = ops.ssd_scan(*leaves[:4], chunk=chunk, state0=leaves[4] if with_state else None)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"  # the autograd function, not autograd of the plain scan
    ((y * torch.from_numpy(dy)).sum() + (st * torch.from_numpy(dstate)).sum()).backward()
    assert ops.ssd_scan_bwd.launches == launches  # a CPU tensor never counts a launch
    for name, t, g in zip(("dxbar", "dlog_da", "dB", "dC", "dstate0"), leaves, jgrads):
        _close(t.grad.numpy(), g, *SCAN_GRAD_F32)


def test_ssd_scan_bwd_wrapper_checks_its_inputs():
    x = torch.zeros((1, 8, 2, 8))
    la, bm = torch.zeros((1, 8, 2)), torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(x, la, bm, bm, torch.zeros((1, 8, 2, 4)), None)
    with pytest.raises(ValueError, match="dstate"):
        ops.ssd_scan_bwd(x, la, bm, bm, x, torch.zeros((1, 2, 8, 4)))
    dx, dla, db, dc, ds0 = ops.ssd_scan_bwd(x, la, bm, bm, x, None)
    assert dx.shape == x.shape and dla.shape == la.shape and db.shape == dc.shape == bm.shape
    assert ds0.shape == (1, 2, 8, 8) and ds0.dtype == torch.float32


def test_ssd_scan_without_grad_skips_the_autograd_function():
    x = torch.randn((1, 8, 2, 8), requires_grad=True)
    la, bm = -torch.rand((1, 8, 2)), torch.randn((1, 8, 8))
    with torch.no_grad():
        y, _ = ops.ssd_scan(x, la, bm, bm)
    assert y.grad_fn is None


# ------------------------------------------------------------------ matmul_f32, cross_entropy
def test_matmul_f32_backward_is_the_reference_transpose():
    """The card's ``_MatmulF32.backward`` (run here on CPU tensors) against
    ``jax.vjp`` of the reference's mixed-precision einsum: fp32 cotangent
    against the widened other operand, one rounding to bf16."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((24, 40)).astype(np.float32)
    b = (rng.standard_normal((40, 56)) * 0.2).astype(np.float32)
    g = (rng.standard_normal((24, 56)) * 1.2345).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, y: jnp.einsum("md,dv->mv", x, y, preferred_element_type=jnp.float32), ja, jb)
    jga, jgb = vjp(jnp.asarray(g))
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    ctx = types.SimpleNamespace(saved_tensors=(ta, tb), needs_input_grad=(True, True))
    ga, gb = L._MatmulF32.backward(ctx, torch.from_numpy(g))
    assert ga.dtype == gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(ga.float().numpy(), np.asarray(jga, np.float32))
    np.testing.assert_array_equal(gb.float().numpy(), np.asarray(jgb, np.float32))
    # the CPU route's autograd computes the same
    la, lb = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    L.matmul_f32(la, lb).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(la.grad.float().numpy(), np.asarray(jga, np.float32))
    np.testing.assert_array_equal(lb.grad.float().numpy(), np.asarray(jgb, np.float32))


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 9, 31)) * 3).astype(np.float32)
    labels = rng.integers(0, 31, (2, 9)).astype(np.int32)
    want, jg = jax.value_and_grad(JL.cross_entropy)(jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    got = L.cross_entropy(t, torch.from_numpy(labels).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ remat
def _batch_for(cfg, seq=40, seed=0):
    data = JData(cfg, JShape("t", seq, 2, "train"), seed=seed).batch(0)
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2-1.5b", "olmoe-1b-7b", "zamba2-2.7b",
                                  "qwen2-vl-2b", "whisper-medium"])
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", param_dtype=torch.float32)
    batch = _batch_for(cfg)
    out = {}
    for remat in ("none", "full", "dots"):
        loss, _, grads = value_and_grad(dataclasses.replace(cfg, remat=remat), params, batch)
        out[remat] = (float(loss), A.tree_leaves(grads))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        assert len(out[remat][1]) == len(out["none"][1])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def test_full_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    calls = []
    real = TS.mamba_block
    monkeypatch.setattr(TS, "mamba_block", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = reduced(get_config("mamba2-780m"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", param_dtype=torch.float32)
    batch = _batch_for(cfg)
    for remat, per_layer in (("none", 1), ("full", 2), ("dots", 2)):
        calls.clear()
        value_and_grad(dataclasses.replace(cfg, remat=remat), params, batch)
        assert len(calls) == per_layer * cfg.n_layers, remat
    calls.clear()
    with torch.no_grad():  # serving: no remat
        T.forward(params, dataclasses.replace(cfg, remat="full"), {"tokens": batch["tokens"]})
    assert len(calls) == cfg.n_layers


def test_fp32_masters_carry_the_reference_parameters_exactly():
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    jparams = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params = from_jax_params(jparams, reduced(get_config("qwen2-1.5b")), "cpu", param_dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in A.tree_leaves(params))
    np.testing.assert_array_equal(params["layers"][1]["attn"]["wq"].numpy(), jparams["layers"]["attn"]["wq"][1])
    serving = T.init_params(reduced(get_config("qwen2-1.5b")), torch.Generator().manual_seed(0), "cpu")
    assert serving["layers"][0]["attn"]["wq"].dtype == torch.bfloat16  # the default is unchanged


# ------------------------------------------------------------------ AdamW
def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {"b": [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)],
              "a": {"z": rng.standard_normal(5).astype(np.float32), "y": rng.standard_normal((2, 2)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32), params) for _ in range(4)]
    return params, grads


def test_adamw_clip_and_schedule_match_the_reference():
    params, grads = _trees(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jp, tp = jax.tree.map(jnp.asarray, params), A.tree_map(torch.from_numpy, params)
    jo, to = JA.adamw_init(jp), A.adamw_init(tp)
    for g in grads:
        jp, jo, jm = JA.adamw_update(jp, jax.tree.map(jnp.asarray, g), jo, JA.AdamWConfig(**kw))
        tp, to, tm = A.adamw_update(tp, A.tree_map(torch.from_numpy, g), to, A.AdamWConfig(**kw))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert to["step"].dtype == torch.int32 and to["step"].shape == () and int(to["step"]) == len(grads)
    for tree_j, tree_t in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
        for a, b in zip(jax.tree.leaves(tree_j), A.tree_leaves(tree_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    jc, jn = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[0]), 1.0)
    tc, tn = A.clip_by_global_norm(A.tree_map(torch.from_numpy, grads[0]), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), A.tree_leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for step in (0, 1, 2, 5, 10, 12):
        np.testing.assert_allclose(float(A.cosine_schedule(A.AdamWConfig(**kw), torch.tensor(step))),
                                   float(JA.cosine_schedule(JA.AdamWConfig(**kw), jnp.array(step))), rtol=1e-6)


def test_adamw_minimizes_a_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = A.adamw_init(params)
    cfg = A.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0, total_steps=100)
    for _ in range(60):
        params, opt, _ = A.adamw_update(params, {"w": 2 * params["w"]}, opt, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_clipping_and_schedule():
    clipped, norm = A.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(clipped["a"].norm()) == pytest.approx(1.0, rel=1e-5)
    cfg = A.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(A.cosine_schedule(cfg, torch.tensor(0))) == 0.0
    assert float(A.cosine_schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(A.cosine_schedule(cfg, torch.tensor(100))) == pytest.approx(0.1, rel=1e-3)


# ------------------------------------------------------------------ make_train_step
def _catch(into):
    def hook(grads):
        into.append(grads)
        return grads

    return hook


def test_microbatched_train_step_on_a_vlm_batch():
    """2 microbatches against 1, and against the reference's, with (3, B, S) M-RoPE positions."""
    jcfg = dataclasses.replace(jreduced(jget_config("qwen2-vl-2b")), scan_layers=False)
    cfg = reduced(get_config("qwen2-vl-2b"))
    data = JData(jcfg, JShape("t", 48, 4, "train"), seed=2).batch(0)
    assert data["positions"].shape == (3, 4, 48)
    micro = _split_microbatches({k: torch.from_numpy(v) for k, v in data.items()}, 2)
    assert micro["positions"].shape == (2, 3, 2, 48) and micro["tokens"].shape == (2, 2, data["tokens"].shape[1])
    np.testing.assert_array_equal(micro["positions"][1].numpy(), data["positions"][:, 2:])

    jparams = JT.init_params(jcfg, jax.random.PRNGKey(3))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu", param_dtype=torch.float32)
    batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in data.items()}
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=4)
    caught = {}
    for n in (1, 2):
        caught[n] = []
        step = make_train_step(cfg, A.AdamWConfig(**kw), n_microbatches=n, grad_transform=_catch(caught[n]))
        new_p, new_o, m = step(params, A.adamw_init(params), batch)
        assert int(new_o["step"]) == 1 and set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
        caught[n].append(m)
    jcaught = []
    with use_rules(single_device_rules()):
        jstep = jmake_train_step(jcfg, JA.AdamWConfig(**kw), n_microbatches=2, grad_transform=_catch(jcaught))
        _, _, jm = jstep(jparams, JA.adamw_init(jparams), {k: jnp.asarray(v) for k, v in data.items()})
    np.testing.assert_allclose(float(caught[2][1]["loss"]), float(caught[1][1]["loss"]), rtol=GRAD_REL_L2)
    np.testing.assert_allclose(float(caught[2][1]["loss"]), float(jm["loss"]), rtol=GRAD_REL_L2)
    two, one = A.tree_leaves(caught[2][0]), A.tree_leaves(caught[1][0])
    for a, b in zip(two, one):
        assert _rel_l2(a.numpy(), b.numpy()) <= GRAD_REL_L2
    jleaves = jax.tree.leaves(jcaught[0])
    assert len(jleaves) == len(jax.tree.leaves(jparams))
    # the port's per-layer leaves, stacked into the reference's (L, ...) leaves
    stacked = {**caught[2][0], "layers": jax.tree.map(lambda *xs: np.stack([x.numpy() for x in xs]),
                                                     *caught[2][0]["layers"])}
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jcaught[0])[0],
                             jax.tree.leaves(jax.tree.map(np.asarray, stacked))):
        assert _rel_l2(g, np.asarray(jg)) <= GRAD_REL_L2, jax.tree_util.keystr(path)


def test_split_microbatches_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="microbatches"):
        _split_microbatches({"tokens": torch.zeros((3, 4))}, 2)


# ------------------------------------------------------------------ the trainer
def test_crash_and_resume(tmp_path):
    """Injected failure at step 4 -> restart resumes from the checkpoint; the
    resumed run's history and parameters equal an uninterrupted run's."""
    cfg = reduced(get_config("qwen2-1.5b"))
    shape = InputShape("t", 16, 4, "train")
    tcfg = TrainerConfig(steps=6, checkpoint_every=2, checkpoint_dir=str(tmp_path / "a"), keep=2, log_every=100)

    class Boom(RuntimeError):
        pass

    failed = []

    def fail_once(step):
        if step == 4 and not failed:
            failed.append(step)
            raise Boom("injected node failure")

    t1 = Trainer(cfg, shape, None, tcfg, failure_hook=fail_once, device="cpu")
    with pytest.raises(Boom):
        t1.run()
    assert CheckpointManager(tcfg.checkpoint_dir).latest_step() == 4

    t2 = Trainer(cfg, shape, None, tcfg, failure_hook=fail_once, device="cpu")
    metrics = t2.run()  # resumes from step 4, finishes 6
    assert metrics["step"] == 5
    assert [h["step"] for h in t2.history] == [4, 5]
    assert np.isfinite(metrics["loss"])

    t3 = Trainer(cfg, shape, None, dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "b")), device="cpu")
    t3.run()
    drop = ("step_time_s",)
    strip = lambda hist: [{k: v for k, v in h.items() if k not in drop} for h in hist]  # noqa: E731
    assert strip(t1.history + t2.history) == strip(t3.history[:4] + t3.history[4:])
    for a, b in zip(A.tree_leaves(t2.params), A.tree_leaves(t3.params)):
        assert torch.equal(a, b)
    for a, b in zip(A.tree_leaves(t2.opt_state), A.tree_leaves(t3.opt_state)):
        assert torch.equal(a, b)


def test_trainer_refuses_sharding_rules_and_a_missing_card(tmp_path):
    """Since the sharding slice the trainer takes rules (the sharded runs are in
    tests/test_torch_sharded.py): rules of one device train as ``None`` does,
    to the same losses.  A missing card is still refused."""
    from repro_torch.distributed import single_device_rules

    cfg = reduced(get_config("qwen2-1.5b"))
    shape = InputShape("t", 16, 2, "train")
    losses = []
    for i, rules in enumerate((single_device_rules(), None)):
        tcfg = TrainerConfig(steps=1, checkpoint_dir=str(tmp_path / str(i)))
        trainer = Trainer(cfg, shape, rules, tcfg, device="cpu")
        trainer.run()
        losses.append([h["loss"] for h in trainer.history])
    assert losses[0] == losses[1] and len(losses[0]) == 1
    tcfg = TrainerConfig(steps=1, checkpoint_dir=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(cfg, shape, None, tcfg)


def test_launcher_trains_the_reduced_model_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-780m", "--reduced",
            "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "64", "--ckpt", str(tmp_path),
            "--ckpt-every", "2"]
    proc = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "final:" in proc.stdout and "'step': 2" in proc.stdout
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    proc = subprocess.run(args[:-4] + ["--production-mesh"], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and "needs a world of 256 ranks" in proc.stderr
