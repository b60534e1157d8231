"""The port's layers and attention against their ``repro`` twins, on the CPU.

Inputs and weights are made with numpy and handed to both packages.  Bars:

* fp32 in, fp32 math (norms of fp32 input, RoPE in fp32, attention cores on
  fp32 input): atol/rtol 2e-5, the reference's fp32 kernel bar; only the
  order of sums and the libm differ.
* bf16 results: atol/rtol 2e-2, the reference's bf16 bar.  The two packages
  round bf16 at different points: XLA's CPU ``logistic`` on bf16 rounds its
  inner steps, PyTorch's ``silu`` rounds once, so swiglu outputs differ by one
  or two bf16 steps (2^-8 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str = "float32"):
    return jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(np.array(a)).to(TDT[dt])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _w(rng, *shape):
    return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


@pytest.mark.parametrize("dt,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rms_norm(dt, tol):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 24, 128)).astype(np.float32) * 3, dt)
    js, ts = _pair(rng.uniform(0.5, 1.5, 128).astype(np.float32))
    out = TL.rms_norm(tx, ts, 1e-5)
    assert out.dtype == TDT[dt]
    np.testing.assert_allclose(_np(out), _np(JL.rms_norm(jx, js, 1e-5)), **tol)


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 24, 128)).astype(np.float32), "bfloat16")
    jw, tw = _pair(_w(rng, 128, 96))
    jb, tb = _pair(rng.standard_normal(96).astype(np.float32)) if bias else (None, None)
    out = TL.dense(tx, tw.to(torch.bfloat16), None if tb is None else tb.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(JL.dense(jx, jw, jb)), **BF16)


@pytest.mark.parametrize("dt,tol", [("float32", F32), ("bfloat16", BF16)])
def test_apply_rope(dt, tol):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 24, 4, 32)).astype(np.float32), dt)
    pos = np.tile(np.arange(24), (2, 1)).astype(np.int32) + np.array([[0], [517]], np.int32)
    out = TL.apply_rope(tx, torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(out), _np(JL.apply_rope(jx, jnp.asarray(pos), 1e6)), **tol)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_block(kind):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((2, 24, 128)).astype(np.float32), "bfloat16")
    p = {"w_in": _w(rng, 128, 256), "w_out": _w(rng, 256, 128)}
    if kind == "swiglu":
        p["w_gate"] = _w(rng, 128, 256)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(_np(TL.mlp_block(tx, tp, kind)), _np(JL.mlp_block(jx, jp, kind)), **BF16)


def test_embed_and_lm_head():
    rng = np.random.default_rng(4)
    emb = (rng.standard_normal((512, 128)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, 512, size=(2, 24))
    jx = JL.embed_tokens(jnp.asarray(tokens, jnp.int32), jnp.asarray(emb))
    tx = TL.embed_tokens(torch.from_numpy(tokens), torch.from_numpy(emb).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(tx), _np(jx))
    h = rng.standard_normal((2, 24, 128)).astype(np.float32)
    jl = JL.lm_head(jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(emb).T)
    tl = TL.lm_head(torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(emb).to(torch.bfloat16).t())
    assert tl.dtype == torch.float32
    # fp32 logits of exactly-representable bf16 products: only the sum order differs
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)


@pytest.mark.parametrize("causal,q_offset,sq,skv", [(True, 0, 40, 40), (True, 21, 12, 64), (False, 0, 40, 56)])
def test_full_attention(causal, q_offset, sq, skv):
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng.standard_normal((2, sq, 8, 32)).astype(np.float32))
    jk, tk = _pair(rng.standard_normal((2, skv, 2, 32)).astype(np.float32))
    jv, tv = _pair(rng.standard_normal((2, skv, 2, 32)).astype(np.float32))
    o = TA.full_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    o_ref = JA.full_attention(jq, jk, jv, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(o), _np(o_ref), **F32)


@pytest.mark.parametrize("block_k", [17, 32, 128])
@pytest.mark.parametrize("dt,tol", [("float32", F32), ("bfloat16", BF16)])
def test_chunked_attention(block_k, dt, tol):
    rng = np.random.default_rng(6)
    jq, tq = _pair(rng.standard_normal((2, 48, 8, 32)).astype(np.float32), dt)
    jk, tk = _pair(rng.standard_normal((2, 60, 2, 32)).astype(np.float32), dt)
    jv, tv = _pair(rng.standard_normal((2, 60, 2, 32)).astype(np.float32), dt)
    for causal, off in ((True, 0), (True, 12), (False, 0)):
        o = TA.chunked_attention(tq, tk, tv, causal=causal, q_offset=off, block_k=block_k)
        o_ref = JA.chunked_attention(jq, jk, jv, causal=causal, q_offset=off, block_k=block_k)
        np.testing.assert_allclose(_np(o), _np(o_ref), **tol)


def _attn_params(rng, d, h, kvh, hd):
    p = {
        "wq": _w(rng, d, h * hd), "wk": _w(rng, d, kvh * hd), "wv": _w(rng, d, kvh * hd),
        "wo": _w(rng, h * hd, d),
        "bq": rng.standard_normal(h * hd).astype(np.float32) * 0.1,
        "bk": rng.standard_normal(kvh * hd).astype(np.float32) * 0.1,
        "bv": rng.standard_normal(kvh * hd).astype(np.float32) * 0.1,
    }
    return {k: jnp.asarray(v) for k, v in p.items()}, {
        k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()
    }


@pytest.mark.parametrize("impl", ["xla_chunked", "xla_full", "flash_pallas"])
@pytest.mark.parametrize("idx,s", [(0, 24), (24, 1), (9, 6)])
def test_self_attention_with_cache(impl, idx, s):
    """A cache at idx 0 (prefill), at idx > 0 with one query (decode) and with
    several queries.  The reference's flash route drops the offset of a cached
    prefill at idx > 0, so there the port's flash route is held against the
    reference's chunked route, which honours it."""
    if impl == "flash_pallas" and idx > 0 and s > 1:
        ref_impl = "xla_chunked"
    else:
        ref_impl = impl
    kw = dict(name="t", family="dense", n_layers=1, d_model=128, n_heads=4, n_kv_heads=2,
              d_ff=256, vocab=64, head_dim=32, qkv_bias=True, attention_block_q=64,
              attention_block_k=16)
    jcfg, tcfg = JConfig(**kw, attention_impl=ref_impl), TConfig(**kw, attention_impl=impl)
    rng = np.random.default_rng(7)
    jp, tp = _attn_params(rng, 128, 4, 2, 32)
    jx, tx = _pair(rng.standard_normal((2, s, 128)).astype(np.float32), "bfloat16")
    s_max = 32
    ck = rng.standard_normal((2, s_max, 2, 32)).astype(np.float32)
    cv = rng.standard_normal((2, s_max, 2, 32)).astype(np.float32)
    ck[:, idx:] = 0.0
    cv[:, idx:] = 0.0
    jck, tck = _pair(ck, "bfloat16")
    jcv, tcv = _pair(cv, "bfloat16")
    pos = np.tile(np.arange(idx, idx + s), (2, 1)).astype(np.int32)
    jo, jc = JA.self_attention(
        jx, jp, jcfg, positions=jnp.asarray(pos),
        cache={"k": jck, "v": jcv, "len": jnp.asarray(idx, jnp.int32)},
    )
    to, tc = TA.self_attention(
        tx, tp, tcfg, positions=torch.from_numpy(pos).long(),
        cache={"k": tck, "v": tcv, "len": torch.tensor(idx, dtype=torch.int32)},
    )
    assert int(tc["len"]) == int(jc["len"]) == idx + s
    assert tc["k"] is tck  # updated in place
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **BF16)
    np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), **BF16)
    np.testing.assert_allclose(_np(to), _np(jo), **BF16)


def test_self_attention_without_cache():
    kw = dict(name="t", family="dense", n_layers=1, d_model=128, n_heads=4, n_kv_heads=2,
              d_ff=256, vocab=64, head_dim=32, qkv_bias=True, attention_block_k=16)
    rng = np.random.default_rng(8)
    jp, tp = _attn_params(rng, 128, 4, 2, 32)
    jx, tx = _pair(rng.standard_normal((2, 20, 128)).astype(np.float32), "bfloat16")
    pos = np.tile(np.arange(20), (2, 1)).astype(np.int32)
    for causal in (True, False):
        jo, _ = JA.self_attention(jx, jp, JConfig(**kw), positions=jnp.asarray(pos), causal=causal)
        to, tc = TA.self_attention(tx, tp, TConfig(**kw), positions=torch.from_numpy(pos).long(), causal=causal)
        assert tc is None
        np.testing.assert_allclose(_np(to), _np(jo), **BF16)
