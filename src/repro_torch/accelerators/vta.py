"""Versatile Tensor Accelerator (VTA) simulator (gray-box, paper-faithful).

Per the paper's gray-box treatment we assume only: the GeMM core computes a
(1,16) x (16,16) matmul per cycle, and operands must be padded to multiples of
16.  Sweeps then *confirm* the PRs (Eq. 5/6):
  Conv2D_R(x_C*16, C_h, C_w, x_K*16, F_h, F_w, s, pad)
  FullyConnected_R(1, x_in*16, x_out*16)
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.registry import register_platform
from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.core.prs import Config, ParamSpace


class VTASim(Platform):
    name = "vta"
    knowledge = "gray"

    GEMM_TILE = 16
    CLOCK_HZ = 100e6  # PYNQ-class fabric clock
    #: instruction fetch / uop-kernel launch overhead per layer (cycles)
    OVERHEAD_CYCLES = 2048.0
    #: load/store throughput of the on-chip buffers, elements per cycle
    IO_LANES = 64

    def __init__(self, device: str | None = None) -> None:
        # Where the torch hook runs (``torch_kernels``): the card unless
        # "cpu".  It enters no name, cache key or number.
        self.device = device

    def spawn_spec(self) -> tuple[str, dict, str]:
        # The device is the constructor's one argument; spelled out so the
        # picklable-measure-entry-point contract is explicit per backend.
        return ("vta", {"device": self.device}, "repro_torch.accelerators.vta")

    def layer_types(self) -> tuple[str, ...]:
        return ("conv2d", "fully_connected")

    def param_space(self, layer_type: str) -> ParamSpace:
        if layer_type == "conv2d":
            return ParamSpace(
                ranges={
                    "C": (1, 256),
                    "C_h": (7, 64),
                    "C_w": (7, 64),
                    "K": (1, 256),
                    "F": (1, 5),
                },
                fixed={"s": 1, "pad": 1},
            )
        return ParamSpace(ranges={"in": (1, 1024), "out": (1, 1024)})

    def defaults(self, layer_type: str) -> Config:
        if layer_type == "conv2d":
            return {"C": 48, "C_h": 28, "C_w": 28, "K": 48, "F": 3, "s": 1, "pad": 1}
        return {"in": 384, "out": 384}

    def known_step_widths(self, layer_type: str) -> dict[str, int]:
        # Gray box: documentation only tells us the GeMM tile quantisation.
        if layer_type == "conv2d":
            return {"C": self.GEMM_TILE, "K": self.GEMM_TILE}
        return {"in": self.GEMM_TILE, "out": self.GEMM_TILE}

    def _gemm_cycles(self, m: int, k: int, n: int) -> float:
        # (1,16)x(16,16) per cycle -> m rows x ceil(k/16) x ceil(n/16) cycles.
        kt = math.ceil(k / self.GEMM_TILE)
        nt = math.ceil(n / self.GEMM_TILE)
        compute = m * kt * nt
        io = (m * kt * self.GEMM_TILE + kt * nt * self.GEMM_TILE**2) / self.IO_LANES
        # DMA of weights overlaps compute through double-buffering.
        return max(compute, io)

    def measure(self, layer_type: str, cfg: Config) -> float:
        if layer_type == "conv2d":
            h_out = (cfg["C_h"] + 2 * cfg.get("pad", 1) - cfg["F"]) // cfg.get("s", 1) + 1
            w_out = (cfg["C_w"] + 2 * cfg.get("pad", 1) - cfg["F"]) // cfg.get("s", 1) + 1
            h_out, w_out = max(1, h_out), max(1, w_out)
            # im2col GEMM: M = H_out*W_out, K = C*F*F (C padded), N = K (padded).
            # C padding enters through the contraction: model pads C itself.
            kt = math.ceil(cfg["C"] / self.GEMM_TILE) * self.GEMM_TILE
            cycles = self._gemm_cycles(h_out * w_out, kt * cfg["F"] ** 2, cfg["K"])
        else:
            cycles = self._gemm_cycles(1, cfg["in"], cfg["out"])
        return (cycles + self.OVERHEAD_CYCLES) / self.CLOCK_HZ

    def _gemm_cycles_batch(self, m, k, n) -> np.ndarray:
        kt = -(-k // self.GEMM_TILE)
        nt = -(-n // self.GEMM_TILE)
        compute = m * kt * nt
        io = (m * kt * self.GEMM_TILE + kt * nt * self.GEMM_TILE**2) / self.IO_LANES
        return np.maximum(compute, io)

    def measure_batch(self, layer_type: str, batch: ConfigBatch) -> np.ndarray:
        """Columnar cycle model, bitwise-identical to looping ``measure``."""
        from repro_torch.accelerators import torch_kernels

        t = torch_kernels.vta_measure_batch(self, layer_type, batch)
        if t is not None:
            return t
        if layer_type == "conv2d":
            pad = batch.get("pad", 1)
            s = batch.get("s", 1)
            f = batch.column("F")
            h_out = np.maximum(1, (batch.column("C_h") + 2 * pad - f) // s + 1)
            w_out = np.maximum(1, (batch.column("C_w") + 2 * pad - f) // s + 1)
            # C padding enters through the contraction: model pads C itself.
            kt = -(-batch.column("C") // self.GEMM_TILE) * self.GEMM_TILE
            cycles = self._gemm_cycles_batch(h_out * w_out, kt * f**2, batch.column("K"))
        else:
            cycles = self._gemm_cycles_batch(1, batch.column("in"), batch.column("out"))
        return (cycles + self.OVERHEAD_CYCLES) / self.CLOCK_HZ

    def measure_block_batch(self, batch: BlockBatch) -> np.ndarray:
        """Columnar block path: the GeMM core runs layers back to back (no
        fusion), so blocks sum their layers — vectorized per layer group,
        bitwise-identical to the scalar ``measure_block`` loop."""
        return self._summed_block_batch(batch)


register_platform("vta", VTASim)
