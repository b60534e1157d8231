"""Plain PyTorch versions of the port's kernels (ported from ``repro.kernels.ref``).

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel against
its plain version on the card.
"""

from __future__ import annotations

import torch


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
