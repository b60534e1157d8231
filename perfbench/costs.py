"""The benchmark's yardstick: published H100 peaks, the kernels' work and the models' FLOPs.

A frozen copy, so a change to the program cannot move the yardstick.  The
three kernel formulas copy ``src/repro_torch/kernels/costs.py`` (``flash_cost``
:14, ``ssd_cost`` :25, ``ssd_bwd_cost`` :43); ``least_ms`` copies
``chip_smoke.py::_bound`` :435 (the larger of bytes over HBM bandwidth and
FLOPs over the peak).  ``perfbench/tests/test_perfbench_costs.py`` pins the
copies to the originals at the cells' shapes, so a drift there shows.

Bytes count each input once and each output once; FLOPs are 2 per
multiply-add of the products the function needs for these shapes (the causal
triangle, a ragged last chunk at its length), whatever implements it.
Plain Python over shapes: it imports nothing.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12

# The port's kernels: the base names of the device kernels one bf16 call of
# each wrapper launches (csrc/*.cu), and how many launches a call makes.
KERNELS = {
    "flash_attention": (("flash_fwd_bf16",), 1),
    "ssd_scan": (("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan"), 3),
    "ssd_scan_bwd": (("tc_chunk_state", "tc_state_pass", "tc_chunk_dx", "tc_chunk_dbdc", "bwd_head_sum"), 5),
}


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
    lower triangle (Q(Q+1)/2 pairs, 2N + 2P), C S^T and the state update (4QNP).
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
    triangle (4P + 4N a pair) and five (q, P) x (P, N)-sized state products (10 qNP).
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


def least_ms(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: bytes over HBM bandwidth or FLOPs over the peak, the larger."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]) * 1e3


def call_least_ms(kernel: str, args: tuple) -> float:
    """``least_ms`` of one recorded call of ``kernel`` (``perfbench.trace`` records the arguments)."""
    cost = {"flash_attention": flash_cost, "ssd_scan": ssd_cost, "ssd_scan_bwd": ssd_bwd_cost}[kernel]
    return least_ms(*cost(*args))


# ------------------------------------------------------------------ model FLOPs
def _mamba_dims(m: dict) -> tuple[int, int, int, int, int]:
    d_inner = m["ssm_expand"] * m["d_model"]
    return m["d_model"], d_inner, m["ssm_state"], d_inner // m["ssm_headdim"], m["ssm_headdim"]


def mamba_matmul_params(m: dict) -> int:
    """Weights of one mamba layer's products: in-projections to z, x, B, C, dt and the out-projection."""
    d, di, n, h, _ = _mamba_dims(m)
    return d * (2 * di + 2 * n + h) + di * d


def mamba_conv_flops(m: dict, tokens: int) -> float:
    """The depthwise causal convolution over x, B and C: 2 FLOPs a tap."""
    _, di, n, _, _ = _mamba_dims(m)
    return 2.0 * m["ssm_conv"] * (di + 2 * n) * tokens


def ssm_prefill_flops(m: dict, batch: int, prompt: int) -> float:
    """Model FLOPs of an ssm (mamba2) prefill of ``batch`` prompts of ``prompt`` tokens.

    Every product of every layer once (no recompute), the scans by the kernel
    formula above, and the head at the last position of each prompt only:
    that is all a generation needs, so logits the program computes at the
    other positions are not useful work.
    """
    d, di, n, h, p = _mamba_dims(m)
    tokens = batch * prompt
    flops = m["n_layers"] * (2.0 * mamba_matmul_params(m) * tokens + mamba_conv_flops(m, tokens)
                             + ssd_cost(batch, prompt, h, p, n, 2, m["ssm_chunk"], False)[1])
    return flops + 2.0 * batch * d * m["vocab"]


def ssm_train_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of an ssm (mamba2) model, no recompute.

    6 x the products' weights (every layer's and the head's; the embedding is
    a lookup) x tokens, plus 3 x the convolutions, plus each layer's scan
    forward and backward by the kernel formulas above.
    """
    d, di, n, h, p = _mamba_dims(m)
    tokens = batch * seq
    weights = m["n_layers"] * mamba_matmul_params(m) + d * m["vocab"]
    scan = (ssd_cost(batch, seq, h, p, n, 2, m["ssm_chunk"], False)[1]
            + ssd_bwd_cost(batch, seq, h, p, n, 2, m["ssm_chunk"], False, False)[1])
    return 6.0 * weights * tokens + m["n_layers"] * (3 * mamba_conv_flops(m, tokens) + scan)
