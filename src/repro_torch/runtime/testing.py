"""Deterministic platform for runtime tests and benchmarks.

``stepped_sim`` is a tiny black-box staircase timing model with an optional
per-configuration wall-clock delay (``delay_s``) that emulates the cost of a
real benchmark without any device dependency.  It matters that this lives in
an importable, dependency-light module: process-pool workers rebuild their
platform from a spawn spec by importing this module in a fresh interpreter,
so runtime determinism tests and ``benchmarks/bench_runtime.py`` exercise the
exact same spawn path a real-hardware platform uses — minus jax.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.registry import register_platform
from repro_torch.core.batch import ConfigBatch
from repro_torch.core.prs import Config, ParamSpace


class SteppedSimPlatform(Platform):
    """Black-box staircase: ``t = 1e-6 * (ceil(a/8) * ceil(b/4) + 1)``."""

    name = "stepped_sim"
    knowledge = "black"

    A_WIDTH = 8
    B_WIDTH = 4

    def __init__(self, delay_s: float = 0.0) -> None:
        #: emulated wall-clock cost per measured configuration (time.sleep)
        self.delay_s = float(delay_s)

    def spawn_spec(self):
        return ("stepped_sim", {"delay_s": self.delay_s}, "repro_torch.runtime.testing")

    def layer_types(self) -> tuple[str, ...]:
        return ("toy",)

    def param_space(self, layer_type: str) -> ParamSpace:
        assert layer_type == "toy"
        return ParamSpace(ranges={"a": (1, 64), "b": (1, 32)})

    def defaults(self, layer_type: str) -> Config:
        return {"a": 16, "b": 8}

    def measure(self, layer_type: str, cfg: Config) -> float:
        if self.delay_s:
            time.sleep(self.delay_s)
        a, b = cfg["a"], cfg["b"]
        return 1e-6 * (-(-a // self.A_WIDTH) * -(-b // self.B_WIDTH) + 1)

    def measure_batch(self, layer_type: str, batch: ConfigBatch) -> np.ndarray:
        assert layer_type == "toy"
        if self.delay_s:
            time.sleep(self.delay_s * len(batch))
        a = batch.column("a")
        b = batch.column("b")
        tiles = -(-a // self.A_WIDTH) * -(-b // self.B_WIDTH)
        return 1e-6 * (tiles.astype(np.float64) + 1.0)


register_platform("stepped_sim", SteppedSimPlatform)
