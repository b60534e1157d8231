"""Torch timing hooks of the three analytic platforms, the counterpart of the reference's ``jax_kernels``.

Each analytic platform's ``measure_batch`` calls its hook here first; a hook
returns ``None`` whenever the request belongs to the numpy path: the
``"numpy"`` backend (a platform's ``predict_backend`` attribute), noisy TPU
mode (its per-config hash seeding is scalar), a layer type the hook lacks,
or an empty batch.  The caller then continues on its numpy path unchanged.
Otherwise the hook runs the timing model as a float64 / int64 torch program
on the platform's ``device`` (``core.torch_predict.resolve_backend``: the
card unless it is ``"cpu"``, raising without a card).  These are plain
torch programs, not kernels: the reference jits them and writes no Pallas.

Parity is **bitwise** with the numpy models, on the CPU and on the card
(``tests/test_torch_platforms.py``, ``chip_smoke.py``):

* every int column enters as int64 and stays int64 wherever numpy's
  arithmetic does; integer tile padding is ``-(-v // m) * m``, where torch's
  ``//`` floors as numpy's does;
* torch turns ``python_float * int64_tensor`` into float32 where numpy gives
  float64, so a column is cast to float64 before its first float product,
  keeping numpy's left-to-right order (``2.0 * m * k * n``);
* CUDA turns a division by a host scalar into a multiplication by its
  reciprocal (one ulp off), so every float hardware constant (peak FLOP/s,
  bandwidth, clock, overheads, I/O lanes) enters as a 0-d float64 tensor on
  the device, as the reference passes traced scalars;
* no fused ops (``addcmul``, ``lerp``) and no ``torch.compile``, which could
  contract a product and a sum into one rounding.

Eager torch does not retrace, so the rows are not padded to buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.torch_predict import resolve_backend

F64 = torch.float64


def _device(platform) -> torch.device | None:
    """The torch device of the hook, or None for the numpy backend."""
    target = resolve_backend(getattr(platform, "predict_backend", None), platform.device)
    return None if target == "numpy" else target


class _Columns:
    """A batch's int64 columns on the device, moved there in one copy."""

    def __init__(self, batch, device: torch.device) -> None:
        self.params = batch.params
        self.values = torch.tensor(batch.values, dtype=torch.int64, device=device)

    def __call__(self, p: str) -> torch.Tensor:
        return self.values[:, self.params.index(p)]

    def get(self, p: str, default: int):
        """Column of ``p``, or the int ``default`` when absent (as ``ConfigBatch.get``)."""
        return self(p) if p in self.params else default


def _const(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=F64, device=device)


def _pad(v, m: int):
    return -(-v // m) * m


# ------------------------------------------------------------------ TPU v5e
def _tpu_terms(layer_type: str, col: _Columns, kv, chip):
    """(flops, bytes) per row: ``TPUv5eSim._terms_batch`` in torch."""
    mxu, sublane = chip.mxu, chip.sublane
    if layer_type == "dense":
        m = _pad(col("tokens"), sublane)
        k = _pad(col("d_in"), mxu)
        n = _pad(col("d_out"), mxu)
        return 2.0 * m.to(F64) * k * n, 2.0 * (m * k + m * n + k * n).to(F64)
    if layer_type == "attention_prefill":
        b, h, dh = col("B"), col("H"), _pad(col("Dh"), mxu)
        kvh = torch.clamp(h // kv, min=1)
        s = _pad(col("S"), mxu)
        flops = 2.0 * b.to(F64) * h * s * s * dh
        return flops, 2.0 * (b * h * s * dh + 2 * b * kvh * s * dh + b * h * s * dh).to(F64)
    if layer_type == "attention_decode":
        b = _pad(col("B"), sublane)
        h, dh = col("H"), _pad(col("Dh"), mxu)
        kvh = torch.clamp(h // kv, min=1)
        s = _pad(col("S_kv"), chip.kv_page)
        return 4.0 * b.to(F64) * h * s * dh, 2.0 * (2 * b * kvh * s * dh + 2 * b * h * dh).to(F64)
    if layer_type == "moe_gemm":
        e, topk = col("E"), col("topk")
        per_expert = _pad(-(-(col("tokens") * topk) // e), sublane)
        dm = _pad(col("d_model"), mxu)
        df = _pad(col("d_ff"), mxu)
        flops = 3.0 * 2.0 * e.to(F64) * per_expert * dm * df
        return flops, 2.0 * (3 * e * dm * df + e * per_expert * (2 * dm + 2 * df)).to(F64)
    if layer_type == "ssd_scan":
        b, h = col("B"), _pad(col("H"), sublane)
        p = _pad(col("P"), mxu)
        n = _pad(col("N"), mxu)
        s = _pad(col("S"), chip.ssd_chunk)
        q = chip.ssd_chunk
        nchunks = s // q
        nf, pf = n.to(F64), p.to(F64)
        per_chunk = 2.0 * q * q * nf + 2.0 * q * q * pf + 4.0 * q * nf * p
        flops = b * h * nchunks * per_chunk
        return flops, 2.0 * b.to(F64) * s * (h * p * 2 + 2 * n + h)
    if layer_type == "embed":
        t, dm = col("tokens"), col("d_model")
        tf = t.to(F64)
        return torch.zeros(t.shape, dtype=F64, device=t.device), 2.0 * tf * dm * 2 + 4.0 * tf
    raise KeyError(layer_type)


def tpu_measure_batch(platform, layer_type: str, batch) -> np.ndarray | None:
    """``TPUv5eSim.measure_batch`` in torch (noise-free mode only)."""
    if platform.noise > 0 or len(batch) == 0 or layer_type not in platform.layer_types():
        return None
    dev = _device(platform)
    if dev is None:
        return None
    c = platform.chip
    col = _Columns(batch, dev)
    flops, bytes_ = _tpu_terms(layer_type, col, col.get("kv_ratio", platform.kv_ratio), c)
    flop_s = flops / _const(c.peak_bf16_flops, dev)
    mem_s = bytes_ / _const(c.hbm_bandwidth, dev)
    t = torch.maximum(flop_s, mem_s) + _const(c.launch_overhead_s, dev)
    return t.cpu().numpy()


# --------------------------------------------------------------- UltraTrail
def ultratrail_measure_batch(platform, layer_type: str, batch) -> np.ndarray | None:
    """``UltraTrailSim.measure_batch`` in torch."""
    if layer_type != "conv1d" or len(batch) == 0:
        return None
    dev = _device(platform)
    if dev is None:
        return None
    col = _Columns(batch, dev)
    c_tiles = -(-col("C") // platform.ARRAY)
    k_tiles = -(-col("K") // platform.ARRAY)
    w_out = torch.clamp((col("C_w") + 2 * col("pad") - col("F")) // col("s") + 1, min=1)
    mac_cycles = c_tiles * k_tiles * w_out * col("F")
    post_cycles = k_tiles * w_out
    cycles = (mac_cycles + post_cycles).to(F64) + _const(platform.OVERHEAD_CYCLES, dev)
    return (cycles / _const(platform.CLOCK_HZ, dev)).cpu().numpy()


# ---------------------------------------------------------------------- VTA
def _vta_gemm_cycles(m, k, n, tile: int, io_lanes: torch.Tensor) -> torch.Tensor:
    kt = -(-k // tile)
    nt = -(-n // tile)
    compute = m * kt * nt
    io = (m * kt * tile + kt * nt * tile**2).to(F64) / io_lanes
    return torch.maximum(compute.to(F64), io)


def vta_measure_batch(platform, layer_type: str, batch) -> np.ndarray | None:
    """``VTASim.measure_batch`` in torch."""
    if layer_type not in ("conv2d", "fully_connected") or len(batch) == 0:
        return None
    dev = _device(platform)
    if dev is None:
        return None
    col = _Columns(batch, dev)
    tile, io_lanes = platform.GEMM_TILE, _const(platform.IO_LANES, dev)
    if layer_type == "conv2d":
        pad, s, f = col.get("pad", 1), col.get("s", 1), col("F")
        h_out = torch.clamp((col("C_h") + 2 * pad - f) // s + 1, min=1)
        w_out = torch.clamp((col("C_w") + 2 * pad - f) // s + 1, min=1)
        kt = -(-col("C") // tile) * tile
        cycles = _vta_gemm_cycles(h_out * w_out, kt * f**2, col("K"), tile, io_lanes)
    else:
        cycles = _vta_gemm_cycles(1, col("in"), col("out"), tile, io_lanes)
    cycles = cycles + _const(platform.OVERHEAD_CYCLES, dev)
    return (cycles / _const(platform.CLOCK_HZ, dev)).cpu().numpy()
