"""The port's SSD scan and Mamba2 block against ``repro``'s, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.ssd_scan`` runs its plain version
(``ref.ssd_scan_ref``); it is held against ``repro.kernels.ops.ssd_scan`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
against the reference's XLA twin ``repro.models.ssm.ssd_chunked``, on the
same inputs made with numpy.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``.

The card's bf16 kernel computes the scan by Mamba2's chunk-parallel split
(chunks' local states, a serial pass over the chunks, then each chunk's
output) and rounds its operands to bf16; ``_split_scan`` below repeats its
phases and rounding points in plain PyTorch, and is held against the plain
scan in fp32 without rounding (the algebra of the split) and against the
reference's kernels in bf16 with the kernel's rounding.  ``_split_scan_bwd``
likewise repeats the phases of the card's backward kernel
(``csrc/ssd_scan_bwd.cu``): in fp32 against autograd of the plain scan, and
with the bf16 kernels' rounding points against autograd of the plain scan and
``jax.grad`` of the twin, within the bf16 bar.

Bars are the reference's own (``tests/test_kernels.py``): the Pallas kernel's
fp32 2e-5 and bf16 atol 2e-2 / rtol 5e-2; the twin's fp32 atol 2e-5 / rtol
2e-4; bf16 2e-2 for the block, whose bf16 roundings fall at other places in
the two packages.  The twin rounds its intra-chunk weights to bf16 before the
second product (``ssm.py:84``); the card's bf16 kernel feeds them as a bf16
pair hi + lo, and the Pallas kernel and the port's plain version keep them
in fp32, so on bf16 the block agrees to the bar, not bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TWIN = dict(atol=2e-5, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _scan_inputs(seed, b, s, h, p, n, dt="float32", state=False):
    """xbar, log_da, B, C (and state0) as numpy, scaled as tests/test_kernels.py scales them."""
    rng = np.random.default_rng(seed)
    arrs = [
        rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.2,
        -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.1,
        rng.standard_normal((b, s, n)).astype(np.float32) * 0.3,
        rng.standard_normal((b, s, n)).astype(np.float32) * 0.3,
    ]
    if state:
        arrs.append(rng.standard_normal((b, h, p, n)).astype(np.float32))
    jin = [jnp.asarray(a).astype(JDT[dt] if i in (0, 2, 3) else jnp.float32) for i, a in enumerate(arrs)]
    tin = [torch.from_numpy(a).to(TDT[dt] if i in (0, 2, 3) else torch.float32) for i, a in enumerate(arrs)]
    return jin, tin


@pytest.mark.parametrize(
    "b,s,h,p,n,dt",
    [
        (2, 256, 4, 64, 64, "float32"),
        (1, 300, 8, 64, 128, "bfloat16"),  # mamba2-780m-like, ragged seq
        (1, 128, 2, 32, 16, "float32"),
    ],
)
def test_ssd_scan_matches_the_pallas_kernel(b, s, h, p, n, dt):
    (jx, ja, jb, jc), (tx, ta, tb, tc) = _scan_inputs(0, b, s, h, p, n, dt)
    y_ref = jops.ssd_scan(jx, ja, jb, jc)
    y, state = ops.ssd_scan(tx, ta, tb, tc)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    tol = dict(atol=2e-2, rtol=5e-2) if dt == "bfloat16" else dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(y), _np(y_ref), **tol)


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_ref_matches_the_xla_twin(chunk, with_state):
    """y and the final state, S = 200 (ragged for every chunk), fp32."""
    jin, tin = _scan_inputs(1, 2, 200, 4, 8, 16, state=with_state)
    y_ref, st_ref = JS.ssd_chunked(*jin[:4], chunk, jin[4] if with_state else None)
    y, st = ref.ssd_scan_ref(*tin[:4], chunk=chunk, state0=tin[4] if with_state else None)
    np.testing.assert_allclose(_np(y), _np(y_ref), **TWIN)
    np.testing.assert_allclose(_np(st), _np(st_ref), **TWIN)


def test_ssd_scan_state_carries_across_calls():
    """Two calls chained through the state equal one call over the whole sequence."""
    _, (tx, ta, tb, tc) = _scan_inputs(2, 1, 300, 2, 16, 8)
    y, st = ops.ssd_scan(tx, ta, tb, tc, chunk=64)
    y1, st1 = ops.ssd_scan(tx[:, :200], ta[:, :200], tb[:, :200], tc[:, :200], chunk=64)
    y2, st2 = ops.ssd_scan(tx[:, 200:], ta[:, 200:], tb[:, 200:], tc[:, 200:], chunk=64, state0=st1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y), **TWIN)
    np.testing.assert_allclose(_np(st2), _np(st), **TWIN)


def test_cpu_tensors_never_count_a_launch():
    before = ops.ssd_scan.launches
    _, tin = _scan_inputs(3, 1, 40, 2, 8, 8, state=True)
    ops.ssd_scan(*tin[:4], chunk=16, state0=tin[4])
    assert ops.ssd_scan.launches == before == 0


def test_ssd_scan_rejects_bad_dtypes_and_shapes():
    x, a = torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2))
    bm = torch.zeros((1, 4, 8))
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x.bfloat16(), a, bm, bm)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.ssd_scan(x.half(), a, bm.half(), bm.half())
    with pytest.raises(TypeError, match="fp32 log_da"):
        ops.ssd_scan(x, a.bfloat16(), bm, bm)
    with pytest.raises(TypeError, match="fp32 log_da and state0"):
        ops.ssd_scan(x, a, bm, bm, state0=torch.zeros((1, 2, 8, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="expected xbar"):
        ops.ssd_scan(x[0], a, bm, bm)
    with pytest.raises(ValueError, match="do not match"):
        ops.ssd_scan(x, a[:, :3], bm, bm)
    with pytest.raises(ValueError, match="do not match"):
        ops.ssd_scan(x, a, bm, torch.zeros((1, 4, 16)))
    with pytest.raises(ValueError, match="state0"):
        ops.ssd_scan(x, a, bm, bm, state0=torch.zeros((1, 2, 8, 4)))
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, a, bm, bm, chunk=0)


def _split_scan(xbar, log_da, bmat, cmat, *, chunk, state0=None, rounded=False):
    """The card's bf16 SSD kernel (``csrc/ssd_scan.cu``), phase by phase, in plain PyTorch.

    1. S_loc[c] = x^T (B * dout), dout_j = exp(a_last - a_cum_j);
    2. S_in[0] = state0 (or 0), S_in[c+1] = exp(a_last_c) S_in[c] + S_loc[c];
    3. y = (L * C B^T) x + exp(a_cum) * (C S_in[c]^T).
    With ``rounded``, at the kernel's rounding points: B * dout and S_in
    rounded to bf16 as product operands, and W = L * C B^T split into a bf16
    pair hi + lo (two products); every sum and the carried state stay fp32,
    and y is rounded once to xbar's dtype.
    """
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    x, a, bm, cm = (torch.nn.functional.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
                    for t in (xbar, log_da, bmat, cmat))
    x = x.reshape(b, nc, chunk, h, p)
    a = a.reshape(b, nc, chunk, h)
    bm, cm = bm.reshape(b, nc, chunk, n), cm.reshape(b, nc, chunk, n)

    def rnd(t):
        return t.bfloat16().float() if rounded else t

    def pair(t):
        return rnd(t) + rnd(t - rnd(t))

    a_cum = a.cumsum(2)  # (B,nc,Q,H)
    a_last = a_cum[:, :, -1]  # (B,nc,H)
    dout = torch.exp(a_last[:, :, None] - a_cum)
    s_loc = torch.einsum("bcjhp,bcjhn->bchpn", x, rnd(bm[:, :, :, None, :] * dout[..., None]))
    st = torch.zeros((b, h, p, n)) if state0 is None else state0.float()
    s_in = []
    for c in range(nc):
        s_in.append(st)
        st = torch.exp(a_last[:, c])[..., None, None] * st + s_loc[:, c]
    s_in = torch.stack(s_in, 1)  # (B,nc,H,P,N)
    idx = torch.arange(chunk)
    upper = (idx[:, None] < idx[None, :])[:, :, None]  # (i, j, 1): j > i
    diff = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B,nc,i,j,H)
    w = torch.einsum("bcin,bcjn->bcij", cm, bm)[..., None] * torch.exp(diff.masked_fill(upper, float("-inf")))
    y = torch.einsum("bcijh,bcjhp->bcihp", pair(w), x)
    y = y + torch.exp(a_cum)[..., None] * torch.einsum("bcin,bchpn->bcihp", cm, rnd(s_in))
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(xbar.dtype), st


@pytest.mark.parametrize("s", [300, 128])  # ragged; one chunk
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("with_state", [False, True])
def test_chunk_parallel_split_equals_the_plain_scan(s, chunk, with_state):
    """The split's algebra (S_loc, S_in, state_out) in fp32 without rounding: the plain scan's
    y and final state within the fp32 kernel bar."""
    _, tin = _scan_inputs(6, 2, s, 4, 16, 32, state=with_state)
    state0 = tin[4] if with_state else None
    y, st = _split_scan(*tin[:4], chunk=chunk, state0=state0)
    y_ref, st_ref = ref.ssd_scan_ref(*tin[:4], chunk=chunk, state0=state0)
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(st), _np(st_ref), atol=2e-5, rtol=2e-5)


def _split_scan_bwd(xbar, log_da, bmat, cmat, dy, dstate, *, chunk, state0=None, rounded=False):
    """The card's backward kernel (``csrc/ssd_scan_bwd.cu``), phase by phase, in plain PyTorch.

    1. S_loc[c] = X^T diag(e^{A-a}) B and U_loc[c] = dY^T diag(e^{a}) C;
    2. S_in forward over the chunks from state0, dS_out backward from dstate,
       dstate0 = e^{A_0} dS_out[0] + U_loc[0];
    3. M = L * C B^T, E = L * dY X^T (L on and below the diagonal), G = M * dY X^T;
       dx = M^T dY + diag(e^{A-a}) B dS'^T, db = E^T C + diag(e^{A-a}) X dS',
       dc = E B + diag(e^a) dY S; R_i = c_i . dc_inter_i, T_j = x_j . dx_inter_j;
       da = rowsum G - colsum G + R - T, plus e^A <dS', S> + sum T at the
       chunk's last step, and dlog_da its reverse cumulative sum;
    4. dB and dC summed over heads.

    Without ``rounded`` every value is fp32 (the fp32 CUDA-core kernels).  With
    ``rounded``, at the bf16 tensor-core kernels' rounding points: the
    operands B * e^{A-a} and C * e^a of S_loc and U_loc, S_in and dS' of
    every product, M and E, and X * e^{A-a} and dY * e^a of dB's and dC's
    inter-chunk terms are rounded to bf16; <dS', S> takes S as a bf16 pair
    hi + lo; G's sums, R and T come from fp32 values; every sum and the
    carried states stay fp32, and dx, dB and dC are rounded once to the
    inputs' dtype.
    """
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    x, dyp, a, bm, cm = (torch.nn.functional.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
                         for t in (xbar, dy, log_da, bmat, cmat))
    x, dyp = x.reshape(b, nc, chunk, h, p), dyp.reshape(b, nc, chunk, h, p)
    bm, cm = bm.reshape(b, nc, chunk, n), cm.reshape(b, nc, chunk, n)
    a = a.reshape(b, nc, chunk, h).cumsum(2)
    a_last = a[:, :, -1]  # (B,nc,H)
    w_out, w_in = torch.exp(a_last[:, :, None] - a), torch.exp(a)  # (B,nc,Q,H)

    def rnd(t):
        return t.bfloat16().float() if rounded else t

    s_loc = torch.einsum("bcjhp,bcjhn->bchpn", x, rnd(w_out[..., None] * bm[:, :, :, None]))
    u_loc = torch.einsum("bcihp,bcihn->bchpn", dyp, rnd(w_in[..., None] * cm[:, :, :, None]))
    st = torch.zeros((b, h, p, n)) if state0 is None else state0.float()
    s_in = []
    for c in range(nc):
        s_in.append(st)
        st = torch.exp(a_last[:, c])[..., None, None] * st + s_loc[:, c]
    g = dstate.float()
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = g
        g = torch.exp(a_last[:, c])[..., None, None] * g + u_loc[:, c]
    s_in, ds_out = torch.stack(s_in, 1), torch.stack(ds_out, 1)  # (B,nc,H,P,N)
    s_op, ds_op = rnd(s_in), rnd(ds_out)
    idx = torch.arange(chunk)
    lower = idx[:, None] >= idx[None, :]
    at = a.permute(0, 1, 3, 2)  # (B,nc,H,Q)
    lmat = torch.exp((at[..., :, None] - at[..., None, :]).masked_fill(~lower, float("-inf")))
    m = lmat * torch.einsum("bcin,bcjn->bcij", cm, bm)[:, :, None]
    dx_t_x = torch.einsum("bcihp,bcjhp->bchij", dyp, x)
    e, gm = lmat * dx_t_x, m * dx_t_x
    dx_inter = w_out[..., None] * torch.einsum("bcjn,bchpn->bcjhp", bm, ds_op)
    dx = torch.einsum("bchij,bcihp->bcjhp", rnd(m), dyp) + dx_inter
    x_out = rnd(w_out.permute(0, 1, 3, 2)[..., None] * x.permute(0, 1, 3, 2, 4))  # (B,nc,H,Q,P)
    db = torch.einsum("bchij,bcin->bchjn", rnd(e), cm) + torch.einsum("bchjp,bchpn->bchjn", x_out, ds_op)
    dy_in = rnd(w_in.permute(0, 1, 3, 2)[..., None] * dyp.permute(0, 1, 3, 2, 4))
    dc = torch.einsum("bchij,bcjn->bchin", rnd(e), bm) + torch.einsum("bchip,bchpn->bchin", dy_in, s_op)
    r = w_in.permute(0, 1, 3, 2) * torch.einsum("bcihp,bcin,bchpn->bchi", dyp, cm, s_op)
    t = torch.einsum("bcjhp,bcjhp->bchj", x, dx_inter)
    s_dot = s_in
    if rounded:  # S as a bf16 pair hi + lo
        s_dot = rnd(s_in) + rnd(s_in - rnd(s_in))
    da = gm.sum(-1) - gm.sum(-2) + r - t
    da[..., -1] += torch.exp(a_last) * (ds_out * s_dot).sum((-1, -2)) + t.sum(-1)
    dla = da.flip(-1).cumsum(-1).flip(-1).permute(0, 1, 3, 2).reshape(b, nc * chunk, h)
    dx = dx.reshape(b, nc * chunk, h, p)[:, :s]
    db, dc = (v.sum(2).reshape(b, nc * chunk, n)[:, :s] for v in (db, dc))
    return dx.to(xbar.dtype), dla[:, :s], db.to(bmat.dtype), dc.to(cmat.dtype), g


@pytest.mark.parametrize("s", [300, 128])  # ragged; one chunk
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("with_state", [False, True])
def test_backward_split_equals_autograd_of_the_plain_scan(s, chunk, with_state):
    """The backward kernel's algebra in fp32 against autograd of the plain scan
    (``ssd_scan_bwd_ref``), each gradient within atol 2e-5 x max|g| and rtol
    2e-4, the backward kernel's fp32 bar (``chip_smoke.py``)."""
    _, tin = _scan_inputs(7, 2, s, 4, 16, 32, state=with_state)
    state0 = tin[4] if with_state else None
    rng = np.random.default_rng(8)
    dy = torch.from_numpy(rng.standard_normal((2, s, 4, 16)).astype(np.float32))
    dstate = torch.from_numpy(rng.standard_normal((2, 4, 16, 32)).astype(np.float32))
    got = _split_scan_bwd(*tin[:4], dy, dstate, chunk=chunk, state0=state0)
    want = ref.ssd_scan_bwd_ref(*tin[:4], dy, dstate, chunk=chunk, state0=state0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-5 * float(w.abs().max()))


@pytest.mark.parametrize("b,s,h,p,n", [(1, 300, 8, 64, 128), (2, 512, 4, 64, 128)])
def test_bf16_split_rounding_matches_reference_kernels(b, s, h, p, n):
    """The bf16 kernel's rounding (B * dout and S_in in bf16, W as hi + lo) stays inside the reference's
    bf16 SSD bar: y against the Pallas kernel (no initial state, which it does not take) and
    against the reference's recurrence ``ssd_ref`` from a unit-scale state0; the final state
    against the plain scan."""
    bar = dict(atol=2e-2, rtol=5e-2)
    jin, tin = _scan_inputs(7, b, s, h, p, n, "bfloat16", state=True)
    y, _ = _split_scan(*tin[:4], chunk=128, rounded=True)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(jops.ssd_scan(*jin[:4])), **bar)
    y, st = _split_scan(*tin[:4], chunk=128, state0=tin[4], rounded=True)
    y_ref, _ = jref.ssd_ref(*jin)
    np.testing.assert_allclose(_np(y), _np(y_ref), **bar)
    _, st_ref = ref.ssd_scan_ref(*tin[:4], chunk=128, state0=tin[4])
    np.testing.assert_allclose(_np(st), _np(st_ref), **bar)


@pytest.mark.parametrize("b,s,h,p,n,with_state", [(1, 300, 8, 64, 128, False), (2, 512, 4, 64, 128, True)])
def test_bf16_backward_split_rounding_meets_the_bf16_bar(b, s, h, p, n, with_state):
    """The bf16 backward kernel's rounding (``_split_scan_bwd(rounded=True)``) keeps every gradient
    within the kernel's bf16 bar, atol 2e-2 x max|g| and rtol 5e-2 (``chip_smoke.py``'s
    ``SSD_BWD_TOL``), of autograd of the plain scan (``ssd_scan_bwd_ref``) and of ``jax.grad`` of
    the reference's XLA twin ``ssd_chunked``, on the same bf16 inputs widened to fp32."""
    _, tin = _scan_inputs(7, b, s, h, p, n, "bfloat16", state=True)
    rng = np.random.default_rng(9)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)).bfloat16()
    dstate = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(np.float32) * with_state)
    state0 = tin[4] if with_state else None
    got = _split_scan_bwd(*tin[:4], dy, dstate, chunk=128, state0=state0, rounded=True)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16, torch.float32]
    want = ref.ssd_scan_bwd_ref(*tin[:4], dy, dstate, chunk=128, state0=state0)
    nargs = 5 if with_state else 4
    dy32, ds32 = jnp.asarray(_np(dy)), jnp.asarray(_np(dstate))

    def jloss(*args):
        y, st = JS.ssd_chunked(*args[:4], 128, args[4] if with_state else None)
        return jnp.sum(y * dy32) + jnp.sum(st * ds32)

    jgrads = jax.grad(jloss, argnums=tuple(range(nargs)))(*[jnp.asarray(_np(t)) for t in tin[:nargs]])
    for name, g, w, jg in zip(("dx", "dlog_da", "dB", "dC", "dstate0"), got, want, jgrads):
        for other in (_np(w), _np(jg)):
            np.testing.assert_allclose(_np(g), other, rtol=5e-2, atol=2e-2 * float(np.abs(other).max()), err_msg=name)


@pytest.mark.parametrize("with_state", [False, True])
def test_depthwise_conv1d_matches_the_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.5
    b = rng.standard_normal((24,)).astype(np.float32) * 0.1
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state else None
    bf = (jnp.bfloat16, torch.bfloat16)
    jy, jst = JS.depthwise_conv1d(*(jnp.asarray(a).astype(bf[0]) for a in (x, w, b)),
                                  None if st is None else jnp.asarray(st))
    ty, tst = TS.depthwise_conv1d(*(torch.from_numpy(a).to(bf[1]) for a in (x, w, b)),
                                  None if st is None else torch.from_numpy(st))
    assert ty.dtype == torch.bfloat16 and tst.shape == (2, 3, 24)
    # the same bf16 products summed in the same order: equal, not just close
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tst), _np(jst))


def _block_cfg(cls):
    return cls(name="ssm-t", family="ssm", n_layers=1, d_model=64, n_heads=0, n_kv_heads=0,
               d_ff=0, vocab=64, head_dim=1, ssm_state=16, ssm_headdim=16, ssm_chunk=64)


def test_mamba_block_prefill_then_decode_matches_the_reference():
    """Prefill of 100 tokens (two chunks of 64, ragged) with a cache, then a
    decode step: the output and all four cache entries."""
    jcfg, tcfg = _block_cfg(JConfig), _block_cfg(TConfig)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    di, n, h, k1 = tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_heads, tcfg.ssm_conv - 1
    d = tcfg.d_model
    rng = np.random.default_rng(5)

    def w(*shape, scale=None):
        return rng.standard_normal(shape).astype(np.float32) * (scale or 1.0 / np.sqrt(shape[0]))

    p = {
        "w_z": w(d, di), "w_x": w(d, di), "w_b": w(d, n), "w_c": w(d, n), "w_dt": w(d, h),
        "w_conv_x": w(4, di, scale=0.5), "b_conv_x": w(di, scale=0.1),
        "w_conv_b": w(4, n, scale=0.5), "b_conv_b": w(n, scale=0.1),
        "w_conv_c": w(4, n, scale=0.5), "b_conv_c": w(n, scale=0.1),
        "dt_bias": np.log(np.expm1(np.full((h,), 0.01, np.float32))) + w(h, scale=0.1),
        "a_log": np.log(np.linspace(1.0, 16.0, h, dtype=np.float32)),
        "d_skip": 1.0 + w(h, scale=0.1), "norm": 1.0 + w(di, scale=0.1), "w_out": w(di, d),
    }
    fp32 = ("dt_bias", "a_log", "d_skip", "norm")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k in fp32 else torch.bfloat16) for k, v in p.items()}
    jcache = {"conv_x": jnp.zeros((2, k1, di)), "conv_b": jnp.zeros((2, k1, n)),
              "conv_c": jnp.zeros((2, k1, n)), "state": jnp.zeros((2, h, tcfg.ssm_headdim, n))}
    tcache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    for s in (100, 1):
        x = rng.standard_normal((2, s, d)).astype(np.float32)
        jy, jcache = JS.mamba_block(jnp.asarray(x).astype(jnp.bfloat16), jp, jcfg, jcache)
        ty, tcache = TS.mamba_block(torch.from_numpy(x).bfloat16(), tp, tcfg, tcache)
        assert ty.dtype == torch.bfloat16 and ty.shape == (2, s, d)
        np.testing.assert_allclose(_np(ty), _np(jy), **BF16)
        for k in TS.CACHE_KEYS:
            assert tcache[k].dtype == torch.float32 and tcache[k].shape == jcache[k].shape
            np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]), **BF16, err_msg=k)
