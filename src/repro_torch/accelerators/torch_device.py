"""Torch-device platform: *real* wall-clock measurements on a GPU (the H100).

The black-box platform of the port, as the paper's Jetson AGX Xavier is of
the paper: a real, noisy computing device whose tiling nothing documents to
the methodology.  Dense layers (``tokens x d_in`` by ``d_in x d_out``) run as
``torch.matmul`` on the card, where cuBLAS picks the kernel, and are timed;
the paper's median-of-k protocol (it used 500 runs on the Jetson) tames the
noise.

Wall-clock protocol: inputs are ones; the output is allocated before timing
(``torch.matmul(a, b, out=c)``), so allocation is never timed; one warm-up
call; each of ``repeats`` samples is CUDA events around 10 back-to-back
launches, divided by 10; the value is the median, in seconds.  On
``device="cpu"`` (for tests) a sample is ``time.perf_counter`` around the
same calls.  fp32 is true fp32, never TF32.

``synthetic=True`` swaps the clock for a deterministic tile-quantised model,
the one the reference's XLA-CPU platform uses with the same constants,
computed in numpy on the host; it ignores the device and keeps that
platform's parameter space, so a synthetic campaign here can be compared bit
for bit with one of the reference.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.core.prs import Config, ParamSpace
from repro_torch.registry import register_platform

#: the torch dtypes a GEMM is timed in, by name (torch is imported where it runs)
_DTYPES = ("float32", "bfloat16", "float16")

#: launches per timed sample; the sample is their mean
LAUNCHES_PER_SAMPLE = 10


@contextlib.contextmanager
def _true_fp32():
    """fp32 GEMMs in true fp32 while timing, never TF32; the flag is restored after."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class TorchDevicePlatform(Platform):
    name = "torch_device"
    knowledge = "black"

    #: synthetic-mode model: row tile, contraction/output tile, GEMM rate
    #: (the reference XLA-CPU platform's constants)
    SYN_TILE_M = 8
    SYN_TILE_KN = 64
    SYN_FLOPS = 5e10
    SYN_OVERHEAD_S = 2e-6

    def __init__(
        self,
        repeats: int = 5,
        dtype="float32",
        synthetic: bool = False,
        device: str | torch.device | None = None,
    ) -> None:
        self.repeats = repeats
        name = str(dtype).removeprefix("torch.")
        if name not in _DTYPES:
            raise ValueError(f"unsupported dtype {dtype!r}; use one of {sorted(_DTYPES)}")
        self.dtype = name
        self.synthetic = bool(synthetic)
        # The synthetic model runs on the host and never needs a card (or torch).
        self.device = None
        if not self.synthetic:
            from repro_torch.device import resolve_device

            self.device = resolve_device(device)
        self._cache: dict[tuple, float] = {}

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def cache_key(self) -> str:
        if self.synthetic:
            return f"{self.name}|dtype={self.dtype}|repeats={self.repeats}|synthetic"
        import torch

        card = torch.cuda.get_device_name(self.device) if self._on_card() else "cpu"
        return f"{self.name}|device={card}|dtype={self.dtype}|repeats={self.repeats}"

    def spawn_spec(self) -> tuple[str, dict, str]:
        return (
            "torch_device",
            {
                "repeats": self.repeats,
                "dtype": self.dtype,
                "synthetic": self.synthetic,
                "device": None if self.device is None else str(self.device),
            },
            "repro_torch.accelerators.torch_device",
        )

    def layer_types(self) -> tuple[str, ...]:
        return ("dense",)

    def param_space(self, layer_type: str) -> ParamSpace:
        self._check(layer_type)
        if self._on_card():
            # Sized for the card and for the dense layers the port serves:
            # each 384-point sweep window crosses several tile boundaries.
            return ParamSpace(
                ranges={"tokens": (16, 4096), "d_in": (64, 8192), "d_out": (64, 8192)}
            )
        return ParamSpace(ranges={"tokens": (16, 256), "d_in": (32, 768), "d_out": (32, 768)})

    def defaults(self, layer_type: str) -> Config:
        self._check(layer_type)
        if self._on_card():
            return {"tokens": 1024, "d_in": 2048, "d_out": 2048}
        return {"tokens": 64, "d_in": 256, "d_out": 256}

    @staticmethod
    def _check(layer_type: str) -> None:
        if layer_type != "dense":
            raise ValueError(f"unknown layer type {layer_type!r}; torch_device times 'dense'")

    # ------------------------------------------------------------- measurement
    def measure(self, layer_type: str, cfg: Config) -> float:
        self._check(layer_type)
        key = (cfg["tokens"], cfg["d_in"], cfg["d_out"])
        if key in self._cache:
            return self._cache[key]
        m, k, n = (int(v) for v in key)
        t = self._synthetic_time(m, k, n) if self.synthetic else self._wallclock_time(m, k, n)
        self._cache[key] = t
        return t

    def _synthetic_time(self, m: int, k: int, n: int) -> float:
        """Deterministic stand-in: tile-padded GEMM time at a fixed rate."""
        em = math.ceil(m / self.SYN_TILE_M) * self.SYN_TILE_M
        ek = math.ceil(k / self.SYN_TILE_KN) * self.SYN_TILE_KN
        en = math.ceil(n / self.SYN_TILE_KN) * self.SYN_TILE_KN
        return 2.0 * em * ek * en / self.SYN_FLOPS + self.SYN_OVERHEAD_S

    def _wallclock_time(self, m: int, k: int, n: int) -> float:
        import torch

        dt = getattr(torch, self.dtype)
        a = torch.ones((m, k), dtype=dt, device=self.device)
        b = torch.ones((k, n), dtype=dt, device=self.device)
        c = torch.empty((m, n), dtype=dt, device=self.device)
        with _true_fp32():
            torch.matmul(a, b, out=c)  # warm-up
            samples = [self._sample(a, b, c) for _ in range(self.repeats)]
        return float(np.median(samples))

    def _sample(self, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> float:
        """Seconds per launch over ``LAUNCHES_PER_SAMPLE`` back-to-back launches."""
        import torch

        if not self._on_card():
            t0 = time.perf_counter()
            for _ in range(LAUNCHES_PER_SAMPLE):
                torch.matmul(a, b, out=c)
            return (time.perf_counter() - t0) / LAUNCHES_PER_SAMPLE
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES_PER_SAMPLE):
            torch.matmul(a, b, out=c)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / LAUNCHES_PER_SAMPLE

    def measure_batch(self, layer_type: str, batch: ConfigBatch) -> np.ndarray:
        """Wall-clock timing cannot vectorize; batch-level dedup is the win.

        Unique rows are timed once each, in first-occurrence order (so the
        warm-up and measurement sequence matches the scalar loop), and
        duplicates reuse the measured value.
        """
        unique, _, inverse = batch.dedup()
        y = np.array(
            [self.measure(layer_type, cfg) for cfg in unique.to_dicts()],
            dtype=np.float64,
        )
        return y[inverse]

    def measure_block_batch(self, batch: BlockBatch) -> np.ndarray:
        """Block path: sum of per-layer times, each unique layer shape timed once."""
        return self._summed_block_batch(batch)


register_platform("torch_device", TorchDevicePlatform)
