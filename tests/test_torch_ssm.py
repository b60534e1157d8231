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

The mixer's elementwise chain around the scan runs, where autograd does not
record it, through ``ops.ssm_conv_gate_in`` and ``ops.ssm_gate_norm``: on a
CPU tensor their plain versions, held here bit for bit against the chain as
the block ran it before its kernels (``_old_mixer``), with and without
autograd; on the card two kernels (``csrc/ssm_mixer.cu``, held against the
plain versions by ``test_torch_ssm_card.py``), whose steps and roundings
``_front_emulated`` and ``_back_emulated`` repeat here.
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

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

from torch_ssm_mixer_cases import FRONT_ARGS, FRONT_OUTS, mixer_inputs, steps_apart  # noqa: E402

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
    ty, tst = ref.depthwise_conv1d(*(torch.from_numpy(a).to(bf[1]) for a in (x, w, b)),
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


# ------------------------------------------------------------ the mixer's chain around the scan

def _old_conv(x, w, b, state=None):
    """The block's causal depthwise conv before the mixer's kernels existed."""
    k, (bsz, s, c) = w.shape[0], x.shape
    pad = torch.zeros((bsz, k - 1, c), dtype=x.dtype) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i : i + s] * w[i]
    return y + b, xp[:, s:]


def _old_mixer(x, w_z, w_x, w_b, w_c, w_dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c,
               dt_bias, a_log, d_skip, conv_x, conv_b, conv_c, state0, cfg):
    """``models/ssm.py::_mixer`` as it was before the mixer's kernels, op for op."""
    bsz, s, _ = x.shape
    h, pd = dt_bias.shape[0], cfg.ssm_headdim
    z, xs, bmat, cmat, dt = (L.dense(x, w) for w in (w_z, w_x, w_b, w_c, w_dt))
    xs, new_conv_x = _old_conv(xs, L.cast(w_conv_x), L.cast(b_conv_x), conv_x)
    bmat, new_conv_b = _old_conv(bmat, L.cast(w_conv_b), L.cast(b_conv_b), conv_b)
    cmat, new_conv_c = _old_conv(cmat, L.cast(w_conv_c), L.cast(b_conv_c), conv_c)
    xs, bmat, cmat = L.silu(xs), L.silu(bmat), L.silu(cmat)
    dt = torch.nn.functional.softplus(dt.float() + dt_bias)
    log_da = dt * -torch.exp(a_log)
    xhp = xs.reshape(bsz, s, h, pd)
    xbar = xhp * dt[..., None].to(xhp.dtype)
    if s == 1 and state0 is not None:
        y, new_state = TS._decode_step(state0, log_da, bmat, xbar, cmat, x.dtype)
    else:
        y, new_state = TS.ssd_chunked(xbar, log_da, bmat, cmat, cfg.ssm_chunk, state0)
    y = y + xhp * d_skip.to(x.dtype)[None, None, :, None]
    return y.reshape(bsz, s, h * pd) * L.silu(z), new_conv_x, new_conv_b, new_conv_c, new_state


def _mixer_args(cfg, s: int, cache: bool, grad: bool, seed: int = 6):
    """``_mixer``'s arguments for a batch of 2: the block's fp32 masters (training) or bf16 weights
    (serving), fp32 caches (or None), and the norm's scale."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale=None, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=g) * (scale or shape[0] ** -0.5)
        return t.float().requires_grad_() if grad else t.to(dtype)

    f32 = torch.float32
    weights = [w(d, di), w(d, di), w(d, n), w(d, n), w(d, h), w(4, di, scale=0.5), w(di, scale=0.1),
               w(4, n, scale=0.5), w(n, scale=0.1), w(4, n, scale=0.5), w(n, scale=0.1),
               w(h, scale=0.1, dtype=f32), w(h, scale=0.3, dtype=f32), w(h, scale=0.1, dtype=f32)]
    caches = [None] * 4
    if cache:
        caches = [torch.randn(shape, generator=g).bfloat16().float()
                  for shape in ((2, 3, di), (2, 3, n), (2, 3, n), (2, h, cfg.ssm_headdim, n))]
    x = torch.randn((2, s, d), generator=g).bfloat16()
    return [x, *weights, *caches], w(di, scale=0.1, dtype=f32)


@pytest.mark.parametrize("s,cache", [(100, True), (70, False), (1, True)])  # prefill, no cache, decode
def test_mixer_wrappers_on_cpu_equal_the_old_chain(s, cache):
    """Serving (no autograd): the block's new route through the wrappers, on a CPU tensor their plain
    versions, gives the old chain's output, conv buffers and state bit for bit."""
    cfg = _block_cfg(TConfig)
    args, scale = _mixer_args(cfg, s, cache, grad=False)
    launches = ops.ssm_conv_gate_in.launches, ops.ssm_gate_norm.launches
    got = TS._mixer(*args, cfg=cfg, norm=scale)
    want = _old_mixer(*args, cfg=cfg)
    want = (L.rms_norm(want[0], scale, cfg.norm_eps), *want[1:])
    for name, g, w in zip(("y", "conv_x", "conv_b", "conv_c", "state"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert (ops.ssm_conv_gate_in.launches, ops.ssm_gate_norm.launches) == launches == (0, 0)


@pytest.mark.parametrize("s", [100, 70])
def test_mixer_under_autograd_computes_what_it_did_before(s):
    """Training (autograd records): the output and every gradient of the old chain, bit for bit."""
    cfg = _block_cfg(TConfig)
    args, scale = _mixer_args(cfg, s, False, grad=True)
    leaves = [t for t in (*args, scale) if t is not None and t.requires_grad]
    cot = torch.randn((2, s, cfg.d_inner), generator=torch.Generator().manual_seed(7))
    outs = []
    for run in (lambda: TS._mixer(*args, cfg=cfg, norm=scale)[0],
                lambda: L.rms_norm(_old_mixer(*args, cfg=cfg)[0], scale, cfg.norm_eps)):
        y = run()
        outs.append((y, torch.autograd.grad((y.float() * cot).sum(), leaves)))
    (y_new, g_new), (y_old, g_old) = outs
    assert torch.equal(y_new, y_old)
    for i, (a, b) in enumerate(zip(g_new, g_old)):
        assert torch.equal(a, b), f"gradient of leaf {i}"


def test_mixer_takes_the_wrappers_only_where_autograd_does_not_record(monkeypatch):
    calls = {"ssm_conv_gate_in": 0, "ssm_gate_norm": 0}
    for name in calls:
        def counted(*a, _real=getattr(ops, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    cfg = _block_cfg(TConfig)
    args, scale = _mixer_args(cfg, 70, False, grad=True)
    y = TS._mixer(*args, cfg=cfg, norm=scale)[0]
    y.float().sum().backward()
    assert calls == {"ssm_conv_gate_in": 0, "ssm_gate_norm": 0}  # training's graph: the plain chain
    with torch.no_grad():
        TS._mixer(*args, cfg=cfg, norm=scale)
    assert calls == {"ssm_conv_gate_in": 1, "ssm_gate_norm": 1}
    args, scale = _mixer_args(cfg, 70, True, grad=False)  # nothing requires grad, grad mode on
    TS._mixer(*args, cfg=cfg, norm=scale)
    assert calls == {"ssm_conv_gate_in": 2, "ssm_gate_norm": 2}


def _rb(t):
    """fp32 rounded to bf16 (nearest even) and back."""
    return t.bfloat16().float()


def _silu_emulated(x):
    return _rb(x * _rb(1 / _rb(1 + _rb(torch.exp(-x)))))


def _front_emulated(inp: dict) -> list:
    """The front kernel's steps in fp32 with its bf16 roundings (``csrc/ssm_mixer.cu``)."""
    def conv_silu(x, w, b, state):
        s = x.shape[1]
        pad = torch.zeros((x.shape[0], w.shape[0] - 1, x.shape[2])) if state is None else _rb(state)
        xp = torch.cat([pad, x.float()], dim=1)
        w = w.float()
        y = _rb(xp[:, 0:s] * w[0])
        for i in range(1, w.shape[0]):
            y = _rb(y + _rb(xp[:, i : i + s] * w[i]))
        return _silu_emulated(_rb(y + b.float())), xp[:, s:]

    xs, nx = conv_silu(inp["xs"], inp["w_conv_x"], inp["b_conv_x"], inp["conv_x"])
    bm, nb = conv_silu(inp["bmat"], inp["w_conv_b"], inp["b_conv_b"], inp["conv_b"])
    cm, nc = conv_silu(inp["cmat"], inp["w_conv_c"], inp["b_conv_c"], inp["conv_c"])
    # softplus is one fp32 step, v > 20 ? v : log1p(exp(v)) on the card as in PyTorch's CUDA kernel; on
    # the CPU F.softplus computes that with another exp and log1p, which differ in the last bits
    dsp = torch.nn.functional.softplus(inp["dt"].float() + inp["dt_bias"])
    b, s, h = dsp.shape
    xbar = _rb(xs.reshape(b, s, h, -1) * _rb(dsp)[..., None])
    log_da = dsp * -torch.exp(inp["a_log"])
    return [xs, bm, cm, xbar, log_da, nx, nb, nc]


def _back_emulated(y, xs, z, d_skip, scale, eps):
    """The back kernel's steps in fp32 with its bf16 roundings, and its row sum in its order:
    thread t of 128 holds channel groups t, t + 128, ... of 8 and sums their squares in channel
    order, a butterfly sums each warp's 32 lanes, then the 4 warps add in order."""
    b, s, h, p = y.shape
    c = h * p
    dd = _rb(d_skip).repeat_interleave(p)
    g = _rb(_rb(y.reshape(b, s, c).float() + _rb(xs.float() * dd)) * _silu_emulated(z.float()))
    if scale is None:
        return g.bfloat16()
    groups = -(-c // 1024)
    sq = torch.nn.functional.pad(g * g, (0, groups * 1024 - c)).reshape(b, s, groups, 128, 8)
    acc = torch.zeros((b, s, 128))
    for j in range(groups):
        for e in range(8):
            acc = acc + sq[..., j, :, e]
    lanes = acc.reshape(b, s, 4, 32)
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    ss = lanes[..., 0, 0] + lanes[..., 1, 0] + lanes[..., 2, 0] + lanes[..., 3, 0]
    inv = torch.rsqrt(ss * torch.tensor(1.0 / c, dtype=torch.float32) + eps)[..., None]
    return ((g * inv) * scale).bfloat16()


# (batch, seq, heads, head dim, state, conv state given): a prefill over two position tiles of the
# front kernel, zamba2's width over five channel groups a thread of the back kernel, a decode step
MIXER_SHAPES = [(2, 150, 8, 64, 32, True), (1, 40, 80, 64, 64, False), (3, 1, 8, 64, 32, True)]


@pytest.mark.parametrize("shape", MIXER_SHAPES)
def test_front_kernel_steps_equal_the_plain_chain(shape):
    inp = mixer_inputs("cpu", *shape)
    want = ref.ssm_conv_gate_in_ref(*(inp[k] for k in FRONT_ARGS))
    for name, g, w in zip(FRONT_OUTS, _front_emulated(inp), want):
        same, steps = steps_apart(g.to(w.dtype), w)
        assert same >= 0.999 and steps <= 1, f"{name}: {same:.6f} equal, {steps} steps apart at most"
        if name.startswith("conv_"):
            assert same == 1.0, name


@pytest.mark.parametrize("shape", MIXER_SHAPES)
@pytest.mark.parametrize("norm", [True, False])
def test_back_kernel_steps_within_one_bf16_step(shape, norm):
    inp = mixer_inputs("cpu", *shape, seed=1)
    args = (inp["y"], inp["xs"], inp["z"], inp["d_skip"], inp["norm"] if norm else None, 1e-5)
    same, steps = steps_apart(_back_emulated(*args), ref.ssm_gate_norm_ref(*args))
    assert steps <= 1, f"{same:.6f} equal, {steps} steps apart at most"
    if not norm:
        assert same == 1.0


def test_mixer_wrappers_fake_implementations():
    """The dry run traces the wrappers on fake CUDA tensors: their ops' fake implementations."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s, h, p, n = 2, 5, 4, 8, 16
    with FakeTensorMode():
        inp = {k: None if v is None else torch.empty(v.shape, dtype=v.dtype, device="cuda")
               for k, v in mixer_inputs("cpu", b, s, h, p, n, True).items()}
        front = ops.ssm_conv_gate_in(*(inp[k] for k in FRONT_ARGS))
        back = [ops.ssm_gate_norm(inp["y"], inp["xs"], inp["z"], inp["d_skip"], scale) for scale in (inp["norm"], None)]
    bf, f32 = torch.bfloat16, torch.float32
    want = [((b, s, h * p), bf), ((b, s, n), bf), ((b, s, n), bf), ((b, s, h, p), bf), ((b, s, h), f32),
            ((b, 3, h * p), bf), ((b, 3, n), bf), ((b, 3, n), bf)] + [((b, s, h * p), bf)] * 2
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in (*front, *back)] == [(*w, "cuda") for w in want]
    assert ops.ssm_conv_gate_in.launches == ops.ssm_gate_norm.launches == 0


def test_plain_versions_and_wrappers_import_no_model_code():
    """The kernels stand below the models: the chain's plain versions take ``silu`` and ``rms_norm``
    from ``kernels/ref.py``, and ``models.layers`` takes them from there, not the other way round."""
    code = ("import sys, repro_torch.kernels.ops; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.models')))")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True,
                         env={**os.environ, "PYTHONPATH": str(src)}).stdout
    assert out.strip() == "[]"
    assert L.silu is ref.silu


def test_mixer_wrappers_reject_bad_shapes():
    inp = mixer_inputs("cpu", 1, 6, 4, 8, 16, True)
    args = [inp[k] for k in FRONT_ARGS]
    with pytest.raises(ValueError, match="do not match xs"):
        ops.ssm_conv_gate_in(args[0], args[1][:, :5], *args[2:])
    with pytest.raises(ValueError, match="conv state of x"):
        ops.ssm_conv_gate_in(*args[:12], args[12][:, :2], *args[13:])
    with pytest.raises(ValueError, match="conv weight / bias of b"):
        ops.ssm_conv_gate_in(*args[:6], args[6][:3], *args[7:])
    with pytest.raises(ValueError, match="do not match y"):
        ops.ssm_gate_norm(inp["y"], inp["xs"][:, :, :16], inp["z"], inp["d_skip"])
    with pytest.raises(ValueError, match="expected y"):
        ops.ssm_gate_norm(inp["xs"], inp["xs"], inp["z"], inp["d_skip"])
