"""Products in 8-bit floating point: the control that the comparison must fail.

The configurations state bfloat16 compute; the nearest lower precision is
fp8.  ``fp8_matmul`` rounds both operands of a product to e4m3 with a scale
per row of the left operand and per column of the right one (each row's or
column's largest magnitude maps to e4m3's largest finite value, 448), then
multiplies in float32: what an fp8 GEMM with those scales computes.  Its
gradient rounds the incoming gradient to e5m2 (largest 57,344) the same way
and multiplies it with the rounded operands, as fp8 training recipes do.
"""

from __future__ import annotations

import torch


def quantize(x: torch.Tensor, dtype: torch.dtype, dim: int) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a scale per slice along ``dim``, returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _FP8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq = quantize(a, torch.float8_e4m3fn, -1)
        bq = quantize(b, torch.float8_e4m3fn, 0)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        ga = quantize(g, torch.float8_e5m2, -1) @ bq.t()
        gb = aq.t() @ quantize(g, torch.float8_e5m2, 0)
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with both operands rounded to e4m3 (see the module's note)."""
    return _FP8Matmul.apply(a.float(), b.float())
