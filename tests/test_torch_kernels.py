"""The port's flash attention against the reference's, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs its plain
version; it is held against ``repro.kernels.ops.flash_attention`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it) on the same
inputs, made with numpy.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.

Bars are the reference's own kernel bars (``tests/test_kernels.py``): fp32
atol/rtol 2e-5 (both sides compute in fp32; only the order of the sums
differs) and bf16 2e-2 (outputs are rounded to bf16, whose step is 2^-8
relative, and may round to neighbouring values).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt):
    return dict(atol=2e-2, rtol=2e-2) if dt == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, sq, skv, h, kvh, d, dt):
    """The same q/k/v for both packages: numpy fp32, rounded to dt by each."""
    rng = np.random.default_rng(seed)
    arrs = [
        rng.standard_normal((b, sq, h, d)).astype(np.float32),
        rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
        rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
    ]
    jdt, tdt = DTYPES[dt]
    return [jnp.asarray(a).astype(jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize(
    "b,sq,h,kvh,d,dt",
    [
        (1, 128, 4, 4, 64, "float32"),  # MHA
        (2, 256, 8, 2, 80, "bfloat16"),  # GQA, zamba2-like head_dim
        (1, 200, 6, 1, 128, "float32"),  # MQA, ragged seq
        (1, 384, 12, 2, 96, "float32"),  # qwen2-like
    ],
)
def test_causal_matches_reference_kernel(b, sq, h, kvh, d, dt):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, b, sq, sq, h, kvh, d, dt)
    o_ref = jops.flash_attention(jq, jk, jv, causal=True)
    o = ops.flash_attention(tq, tk, tv, causal=True)
    assert o.dtype == tq.dtype and o.shape == tq.shape
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol(dt))


def test_non_causal_matches_reference_kernel():
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 1, 128, 256, 4, 4, 64, "float32")
    o_ref = jops.flash_attention(jq, jk, jv, causal=False)
    o = ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol("float32"))


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 256)])
def test_block_sweep_matches_reference_kernel(block_q, block_k):
    """The reference's tiles change nothing; the port has none to choose."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 1, 256, 256, 4, 2, 64, "float32")
    o_ref = jops.flash_attention(jq, jk, jv, causal=True, block_q=block_q, block_k=block_k)
    o = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol("float32"))


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_cached_prefill_shape_matches_reference_kernel(dt):
    """Sq < Skv as in generate's prefill: prompt 24 against a cache of 28."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(3, 2, 24, 28, 4, 2, 32, dt)
    o_ref = jops.flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64)
    o = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol(dt))


def test_non_causal_ragged_matches_oracle_reference_caveat():
    """Reference caveat: with non-causal attention and a ragged Skv the Pallas
    path attends to the zero-padded keys (``flash_attention.py:115`` passes the
    padded length as seq_kv), so the port, which masks at the true Skv, is
    held against ``repro.kernels.ref.flash_attention_ref`` here instead."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(4, 1, 128, 200, 4, 4, 64, "float32")
    o_ref = jref.flash_attention_ref(jq, jk, jv, causal=False)
    o = ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol("float32"))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle(dt):
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, 2, 96, 96, 6, 2, 64, dt)
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(ref.flash_attention_ref(tq, tk, tv, causal=causal)),
            _np(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
            **_tol(dt),
        )


def test_q_offset_matches_reference_full_attention():
    """A cached prefill at offset > 0: the port passes the offset to the kernel
    (the reference's flash route drops it), so it is held against the
    reference's materialised core, which honours it; fp32 keeps both exact."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(6, 2, 40, 100, 4, 2, 32, "float32")
    o_ref = jattn.full_attention(jq, jk, jv, causal=True, q_offset=37)
    o = ops.flash_attention(tq, tk, tv, causal=True, q_offset=37)
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol("float32"))


def test_cpu_tensors_never_count_launches():
    _, (tq, tk, tv) = _inputs(7, 1, 16, 16, 2, 1, 8, "float32")
    before = ops.flash_attention.launches
    ops.flash_attention(tq, tk, tv)
    assert ops.flash_attention.launches == before


def test_wrapper_rejects_bad_inputs():
    _, (tq, tk, tv) = _inputs(8, 1, 16, 16, 4, 2, 8, "float32")
    with pytest.raises(ValueError):
        ops.flash_attention(tq, tk[..., :4], tv[..., :4])
    with pytest.raises(ValueError):
        ops.flash_attention(tq, tk[:, :, :1].expand(1, 16, 3, 8), tv[:, :, :1].expand(1, 16, 3, 8))
    with pytest.raises(ValueError):
        ops.flash_attention(tq, tk, tv, q_offset=-1)


def _bf16_kernel_rounding(q, k, v, *, causal, block_k=64):
    """The rounding points of the card's bf16 flash kernel, in plain PyTorch.

    fp32 scores of the bf16 q and k, scaled by sm_scale * log2(e) after the
    product (q is never rounded scaled); 64-key tiles with an online softmax
    in base 2; P rounded to bf16 for P V while l sums the fp32 P.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale_log2 = d**-0.5 * math.log2(math.e)
    qg = q.float().reshape(b, sq, kvh, g, d)
    m = torch.full((b, kvh, g, sq), float("-inf"))
    l = torch.zeros((b, kvh, g, sq))
    acc = torch.zeros((b, kvh, g, sq, d))
    qpos = torch.arange(sq)
    for k0 in range(0, skv, block_k):
        kj, vj = k[:, k0 : k0 + block_k].float(), v[:, k0 : k0 + block_k].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj)
        if causal:
            kpos = k0 + torch.arange(kj.shape[1])
            s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        m_use = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        p = torch.exp2(s * scale_log2 - m_use[..., None])
        alpha = torch.exp2(m - m_use)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(), vj)
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-37)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).bfloat16()


@pytest.mark.parametrize(
    "b,sq,h,kvh,d",
    [
        (2, 200, 6, 2, 128),  # causal GQA, D 128, Skv 200: a ragged last key tile
        (1, 96, 4, 1, 40),  # causal MQA, D 40: lanes padded in the kernel
    ],
)
def test_bf16_kernel_rounding_matches_reference_kernel(b, sq, h, kvh, d):
    """The bf16 kernel's own rounding (unscaled q, P in bf16, l from fp32 P)
    stays inside the reference's bf16 bar against its Pallas kernel."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(9, b, sq, sq, h, kvh, d, "bfloat16")
    o_ref = jops.flash_attention(jq, jk, jv, causal=True)
    o = _bf16_kernel_rounding(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16 and o.shape == tq.shape
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol("bfloat16"))
