"""Plain PyTorch versions of the port's kernels (ported from ``repro.kernels.ref``).

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel against
its plain version on the card.  ``ssm_conv_gate_in_ref`` and
``ssm_gate_norm_ref`` are the Mamba2 mixer's elementwise chain as the model
ran it before its kernels existed; training still runs them (autograd
records them), and the kernels repeat their steps.  ``silu`` and ``rms_norm``
are the model's own steps for both (``models.layers`` takes them from here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialised-score GQA attention.  q: (B,Sq,H,D), k/v: (B,Skv,KVH,D).

    Computes in fp32 and returns q's dtype.  q-head h reads kv-head
    h * KVH // H.  With ``causal``, query row i sees keys at positions
    <= ``q_offset`` + i (``q_offset`` = 0 is ``repro``'s
    ``flash_attention_ref``).
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (d**-0.5)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = torch.arange(skv, device=q.device)[None, :] <= qpos[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def ssd_scan_ref(
    xbar: torch.Tensor,
    log_da: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    *,
    chunk: int = 128,
    state0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD scan in fp32: the algorithm of ``repro``'s Pallas ``_kernel``.

    xbar (B,S,H,P), log_da (B,S,H), bmat/cmat (B,S,N) (one group, shared by
    all heads), optional fp32 ``state0`` (B,H,P,N).  Per chunk of ``chunk``
    steps, with ``a_cum = cumsum(log_da)``:
    ``y = (C B^T * L) x + exp(a_cum) * (C S^T)`` where
    ``L[i,j] = exp(a_cum_i - a_cum_j)`` for i >= j and 0 above the diagonal
    (never exponentiated there), and
    ``S <- exp(a_last) S + x^T (B * exp(a_last - a_cum))``.
    A ragged S is zero-padded to a whole chunk: padded steps have log_da 0,
    so the state is kept through them.  Returns (y in xbar's dtype, final
    state (B,H,P,N) fp32).
    """
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    x, a, bm, cm = xbar.float(), log_da.float(), bmat.float(), cmat.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    if state0 is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xbar.device)
    else:
        state = state0.float()
    idx = torch.arange(chunk, device=xbar.device)
    upper = (idx[:, None] < idx[None, :])[None, :, :, None]  # (1, i, j, 1): j > i
    ys = []
    for c0 in range(0, s + pad, chunk):
        xj, aj = x[:, c0 : c0 + chunk], a[:, c0 : c0 + chunk]  # (B,Q,H,P), (B,Q,H)
        bj, cj = bm[:, c0 : c0 + chunk], cm[:, c0 : c0 + chunk]  # (B,Q,N)
        a_cum = aj.cumsum(dim=1)
        diff = a_cum[:, :, None, :] - a_cum[:, None, :, :]  # (B,i,j,H)
        lmat = torch.exp(diff.masked_fill(upper, float("-inf")))
        w = torch.einsum("bin,bjn->bij", cj, bj)[..., None] * lmat
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xj)
        y_inter = torch.einsum("bin,bhpn->bihp", cj, state) * torch.exp(a_cum)[..., None]
        a_last = a_cum[:, -1]  # (B,H)
        decay_out = torch.exp(a_last[:, None, :] - a_cum)  # (B,Q,H)
        upd = torch.einsum("bjn,bjhp->bhpn", bj, xj * decay_out[..., None])
        state = state * torch.exp(a_last)[..., None, None] + upd
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(xbar.dtype), state


def ssd_scan_bwd_ref(
    xbar: torch.Tensor,
    log_da: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    dy: torch.Tensor,
    dstate: torch.Tensor,
    *,
    chunk: int = 128,
    state0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD scan's gradient: autograd of ``ssd_scan_ref``.

    Given dy (B,S,H,P) and d(final state) ``dstate`` (B,H,P,N), returns
    (dxbar in xbar's dtype, dlog_da fp32, dB and dC in bmat's dtype, dstate0
    (B,H,P,N) fp32; the gradient for a zero initial state when ``state0`` is
    None).  The forward is recomputed in fp32 from leaves that require grad.
    """
    x = xbar.detach().float().requires_grad_()
    a = log_da.detach().float().requires_grad_()
    bm = bmat.detach().float().requires_grad_()
    cm = cmat.detach().float().requires_grad_()
    if state0 is None:
        b, _, h, p = xbar.shape
        s0 = torch.zeros((b, h, p, bmat.shape[-1]), dtype=torch.float32, device=xbar.device)
    else:
        s0 = state0.detach().float()
    s0.requires_grad_()
    with torch.enable_grad():
        y, state = ssd_scan_ref(x, a, bm, cm, chunk=chunk, state0=s0)
        dx, da, db, dc, ds0 = torch.autograd.grad((y, state), (x, a, bm, cm, s0),
                                                  (dy.float(), dstate.float()))
    return dx.to(xbar.dtype), da, db.to(bmat.dtype), dc.to(cmat.dtype), ds0


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s own steps, ``x * (1 / (1 + exp(-x)))``, each rounded to x's dtype.

    ``F.silu`` rounds once; on bf16 the two differ by one step in many
    elements, which the SSM's four silus a layer and the MoE's experts carry
    into the logits.
    """
    return x * (1 / (1 + torch.exp(-x)))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last dim in fp32, rounded back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: torch.Tensor | None = None):
    """Causal depthwise conv along seq.  x: (B,S,C); w: (K,C); b: (C,).

    With ``state`` (B, K-1, C) the last K-1 inputs of the previous step are
    prepended (decode).  The K shifted products are summed in x's dtype in
    the reference's order (``F.conv1d`` would accumulate in another order and
    type).  Returns (y, new_state).
    """
    k = w.shape[0]
    bsz, s, c = x.shape
    if state is None:
        pad = torch.zeros((bsz, k - 1, c), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i : i + s] * w[i]
    new_state = xp[:, s:] if k > 1 else torch.zeros_like(pad)
    return y + b, new_state


def ssm_conv_gate_in_ref(xs, bmat, cmat, dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c,
                         dt_bias, a_log, conv_x=None, conv_b=None, conv_c=None):
    """The mixer's chain before the scan (``ops.ssm_conv_gate_in``).

    xs (B,S,H*P), bmat/cmat (B,S,N) and dt (B,S,H) are the in-projection's
    outputs; conv weights (K, width) and biases; dt_bias, a_log (H,); the
    conv states (B, K-1, width) of a cache, or None.  Returns (xs, bmat, cmat
    after the conv and silu, xbar (B,S,H,P) = xs * dt in xs's dtype, log_da
    (B,S,H) fp32, and the new conv states of x, B and C).
    """
    bsz, s, _ = xs.shape
    h = dt_bias.shape[0]
    xs, new_conv_x = depthwise_conv1d(xs, w_conv_x, b_conv_x, conv_x)
    bmat, new_conv_b = depthwise_conv1d(bmat, w_conv_b, b_conv_b, conv_b)
    cmat, new_conv_c = depthwise_conv1d(cmat, w_conv_c, b_conv_c, conv_c)
    xs = silu(xs)
    bmat = silu(bmat)
    cmat = silu(cmat)

    dt = F.softplus(dt.float() + dt_bias)  # (B,S,H) fp32
    a = -torch.exp(a_log)  # (H,) negative
    log_da = dt * a
    xhp = xs.reshape(bsz, s, h, -1)
    xbar = xhp * dt[..., None].to(xhp.dtype)  # bf16, as the reference keeps it
    return xs, bmat, cmat, xbar, log_da, new_conv_x, new_conv_b, new_conv_c


def ssm_gate_norm_ref(y, xs, z, d_skip, scale=None, eps: float = 1e-5):
    """The mixer's chain after the scan (``ops.ssm_gate_norm``).

    y (B,S,H,P) is the scan's output, xs (B,S,H*P) its input before dt, z
    (B,S,H*P) the gate; returns (y + xs * D) * silu(z), (B,S,H*P), then
    RMS-normed by ``scale`` when it is given.
    """
    bsz, s, h, pd = y.shape
    y = y + xs.reshape(bsz, s, h, pd) * d_skip.to(xs.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, h * pd) * silu(z)
    return y if scale is None else rms_norm(y, scale, eps)
