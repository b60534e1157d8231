"""The work of each hand-written kernel: bytes it must move and FLOPs it must do.

One count per kernel, read by the kernels' FLOP formulas (``ops.py``, which
the dry run's counter uses) and by ``chip_smoke.py``'s bounds, so both count
the same work.  Bytes: each input read once and each output written once;
FLOPs: 2 per multiply-add of the products the function needs, over what this
call's shapes need (the causal triangle, a ragged last chunk at its length).
Plain Python over shapes, so it imports nothing.
"""

from __future__ import annotations


def flash_cost(b: int, sq: int, skv: int, h: int, kvh: int, d: int, elt: int,
               causal: bool, q_offset: int = 0) -> tuple[float, float]:
    """(bytes, FLOPs) of flash attention: q, k, v, o once; QK^T and PV over the keys each query sees."""
    nbytes = (2 * b * sq * h * d + 2 * b * skv * kvh * d) * elt
    if causal:
        keys = sum(min(max(q_offset + i + 1, 0), skv) for i in range(sq))
    else:
        keys = sq * skv
    return float(nbytes), 4.0 * b * h * d * keys


def ssd_cost(b: int, s: int, h: int, p: int, n: int, elt: int, chunk: int,
             state0: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the SSD scan: x, log_da, B, C, state0 read and y, state written once.

    FLOPs per (batch row, head, chunk of Q steps): C B^T and W x over the
    lower triangle (Q(Q+1)/2 pairs, 2N + 2P), C S^T and the state update
    (4QNP).
    """
    state_bytes = b * h * p * n * 4
    nbytes = (2 * b * s * h * p * elt + b * s * h * 4 + 2 * b * s * n * elt
              + state_bytes * (2 if state0 else 1))
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        flops += b * h * (q * (q + 1) / 2 * 2 * (n + p) + 4 * q * n * p)
    return float(nbytes), flops


def ssd_bwd_cost(b: int, s: int, h: int, p: int, n: int, elt: int, chunk: int,
                 state0: bool, dstate: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the scan's gradient: x, log_da, B, C, dy (and state0,
    d(final state)) read and dx, dlog_da, dB, dC (and dstate0) written once.

    FLOPs per (batch row, chunk of q steps): C B^T over the lower triangle
    (q(q+1)/2 pairs, 2N); per head: dY X^T, M^T dY, E^T C and E B over the
    triangle (4P + 4N a pair) and five (q, P) x (P, N)-sized state products
    (the chunk's local state, its local dS, and the inter-chunk terms of dx,
    dB and dC: 10 qNP).
    """
    state_bytes = b * h * p * n * 4
    nbytes = (3 * b * s * h * p * elt + 2 * b * s * h * 4 + 4 * b * s * n * elt
              + state_bytes * (2 * state0 + dstate))
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        tri = q * (q + 1) / 2
        flops += b * tri * 2 * n + b * h * (tri * (4 * p + 4 * n) + 10 * q * n * p)
    return float(nbytes), flops


def ssm_conv_gate_in_cost(b: int, s: int, ci: int, n: int, h: int, k: int, state: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the Mamba2 mixer's chain before the scan (``ops.ssm_conv_gate_in``):
    x (b, s, ci), B and C (b, s, n), dt (b, s, h), the conv weights and biases, dt_bias and a_log
    (and the conv states) read, and xs, xbar, B, C, log_da and the new conv states written once,
    bf16 but for fp32 dt_bias, a_log, log_da and the conv states read.

    FLOPs: the depthwise convolution's products, 2 a tap.
    """
    width = ci + 2 * n
    nbytes = (2 * (b * s * (3 * ci + 4 * n + h) + (k + 1) * width) + 4 * (2 * h + b * s * h)
              + b * (k - 1) * width * (2 + (4 if state else 0)))
    return float(nbytes), 2.0 * k * width * b * s


def ssm_gate_norm_cost(b: int, s: int, c: int, h: int, norm: bool) -> tuple[float, float]:
    """(bytes, FLOPs) of the mixer's chain after the scan (``ops.ssm_gate_norm``): y, xs and z
    (b, s, c) bf16 and d_skip (h) fp32 (and the norm's fp32 scale (c)) read, the output written once.

    FLOPs: the norm's sum of squares, 2 an element (none without the norm).
    """
    nbytes = 2 * 4 * b * s * c + 4 * h + (4 * c if norm else 0)
    return float(nbytes), (2.0 * b * s * c if norm else 0.0)
