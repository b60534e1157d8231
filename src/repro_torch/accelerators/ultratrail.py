"""UltraTrail accelerator simulator (white-box, paper-faithful).

UltraTrail [Bernardo et al. 2020] has an 8x8 MAC array that always processes
8x8 (output x input) channels per activation, supporting Conv1D only.  The
paper derives the PRs analytically (Eq. 2): ``Conv1D_R(x_C*8, C_w, x_K*8, F,
s, pad)`` with ``x_C, x_K in {1..7}``.

The parameter space below reproduces the paper's counts exactly:
complete space = 56*56*254*8*3*5 = 95 585 280 configurations, PR set =
7*7*254*8*3*5 = 1 493 520 (both quoted in Sec. 3.3).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.registry import register_platform
from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.core.prs import Config, ParamSpace


class UltraTrailSim(Platform):
    name = "ultratrail"
    knowledge = "white"

    #: 8x8 MAC array, one activation per cycle once the pipeline is full.
    ARRAY = 8
    CLOCK_HZ = 50e6  # ultra-low-power keyword-spotting clock domain
    #: fixed per-layer control/configuration overhead (cycles)
    OVERHEAD_CYCLES = 96.0

    def __init__(self, device: str | None = None) -> None:
        # Where the torch hook runs (``torch_kernels``): the card unless
        # "cpu".  It enters no name, cache key or number.
        self.device = device

    def spawn_spec(self) -> tuple[str, dict, str]:
        # The device is the constructor's one argument; spelled out so the
        # picklable-measure-entry-point contract is explicit per backend.
        return ("ultratrail", {"device": self.device}, "repro_torch.accelerators.ultratrail")

    def layer_types(self) -> tuple[str, ...]:
        return ("conv1d",)

    def param_space(self, layer_type: str) -> ParamSpace:
        assert layer_type == "conv1d"
        return ParamSpace(
            ranges={
                "C": (1, 56),
                "K": (1, 56),
                "C_w": (3, 256),
                "F": (2, 9),
                "s": (1, 3),
                "pad": (0, 4),
            }
        )

    def defaults(self, layer_type: str) -> Config:
        return {"C": 24, "K": 24, "C_w": 101, "F": 3, "s": 1, "pad": 1}

    def known_step_widths(self, layer_type: str) -> dict[str, int]:
        # Derived from the hardware/mapping description:
        #   operation: Conv1D; dims: [8, 8]; mapping: [C, K]
        return {"C": self.ARRAY, "K": self.ARRAY, "C_w": 1, "F": 1, "s": 1, "pad": 1}

    # RTL-exact-style cycle model: the MAC array iterates over ceil(C/8) x
    # ceil(K/8) channel tiles; for each tile it streams the output feature map
    # (W_out positions x F taps).  Deterministic (RTL sims have no noise).
    def measure(self, layer_type: str, cfg: Config) -> float:
        assert layer_type == "conv1d"
        c_tiles = math.ceil(cfg["C"] / self.ARRAY)
        k_tiles = math.ceil(cfg["K"] / self.ARRAY)
        w_out = (cfg["C_w"] + 2 * cfg["pad"] - cfg["F"]) // cfg["s"] + 1
        w_out = max(1, w_out)
        mac_cycles = c_tiles * k_tiles * w_out * cfg["F"]
        # output writeback + bias/requant pass, once per output tile row
        post_cycles = k_tiles * w_out
        cycles = mac_cycles + post_cycles + self.OVERHEAD_CYCLES
        return cycles / self.CLOCK_HZ

    def measure_batch(self, layer_type: str, batch: ConfigBatch) -> np.ndarray:
        """Columnar cycle model, bitwise-identical to looping ``measure``."""
        assert layer_type == "conv1d"
        from repro_torch.accelerators import torch_kernels

        t = torch_kernels.ultratrail_measure_batch(self, layer_type, batch)
        if t is not None:
            return t
        c_tiles = -(-batch.column("C") // self.ARRAY)
        k_tiles = -(-batch.column("K") // self.ARRAY)
        w_out = (
            batch.column("C_w") + 2 * batch.column("pad") - batch.column("F")
        ) // batch.column("s") + 1
        w_out = np.maximum(1, w_out)
        mac_cycles = c_tiles * k_tiles * w_out * batch.column("F")
        post_cycles = k_tiles * w_out
        cycles = mac_cycles + post_cycles + self.OVERHEAD_CYCLES
        return cycles / self.CLOCK_HZ

    def measure_block_batch(self, batch: BlockBatch) -> np.ndarray:
        """Columnar block path: UltraTrail has no cross-layer fusion, so a
        block is the per-layer sum — computed through the vectorized cycle
        model, bitwise-identical to the scalar ``measure_block`` loop."""
        return self._summed_block_batch(batch)


register_platform("ultratrail", UltraTrailSim)
