"""Plain PyTorch versions of the port's kernels (ported from ``repro.kernels.ref``).

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel against
its plain version on the card.
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
