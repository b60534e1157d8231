"""Platform protocol: the "hardware under test" abstraction.

The paper benchmarks four platforms (UltraTrail RTL sim, VTA Verilator sim, an
NDA vendor timing simulator, and a Jetson AGX GPU).  Here a *Platform* is
anything that can measure the execution time of a parameterised layer, exposes
its parameter space, and declares how much architectural knowledge is public
(white / gray / black box).  Simulated platforms are analytical timing models
(the paper itself uses vendor timing simulators); the XLA-CPU platform performs
real wall-clock measurements.
"""

from __future__ import annotations

import abc
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.core.prs import Config, ParamSpace


class Platform(abc.ABC):
    """A benchmarkable accelerator platform."""

    name: str = "platform"
    #: "white" | "gray" | "black" -- drives how PRs are determined (Fig. 3).
    knowledge: str = "black"

    # ---- capability description -------------------------------------------------
    @abc.abstractmethod
    def layer_types(self) -> tuple[str, ...]:
        ...

    @abc.abstractmethod
    def param_space(self, layer_type: str) -> ParamSpace:
        ...

    @abc.abstractmethod
    def defaults(self, layer_type: str) -> Config:
        """Mid-range default config used as the sweep anchor point."""

    def known_step_widths(self, layer_type: str) -> dict[str, int] | None:
        """White-box: the full step-width map derivable from documentation.

        Gray-box platforms return a *partial* map (only the documented dims);
        black-box platforms return None.
        """
        return None

    def cache_key(self) -> str:
        """Identity under which measurements may be memoized/shared.

        Two platform instances with the same cache key MUST produce the same
        measurement for the same config.  Platforms whose timing model depends
        on constructor parameters not reflected in ``name`` must override
        this to include them.
        """
        return self.name

    def spawn_spec(self) -> tuple[str, dict, str | None]:
        """Picklable recipe for rebuilding this platform in a worker process.

        Returns ``(registry_name, ctor_kwargs, module)``: the measurement
        runtime's process-pool workers import ``module`` (which registers the
        platform) and instantiate ``registry_name`` with ``ctor_kwargs`` —
        platform *instances* are never pickled (jitted closures and device
        handles cannot cross process boundaries).

        The default covers platforms whose registry name equals ``name`` and
        whose constructor takes no arguments; parameterised platforms must
        override it and include every constructor argument that affects the
        timing model (everything returned must pickle).
        """
        return (self.name, {}, type(self).__module__)

    # ---- measurement ---------------------------------------------------------------
    @abc.abstractmethod
    def measure(self, layer_type: str, cfg: Config) -> float:
        """Execution time in seconds of a single layer configuration."""

    def measure_batch(self, layer_type: str, batch: ConfigBatch) -> np.ndarray:
        """Execution times (seconds) of a whole configuration batch.

        This is the extension point for vectorized timing models: the built-in
        analytical platforms override it with columnar array math.  The default
        is a scalar ``measure`` loop, so third-party platforms that only
        implement ``measure`` keep working on the batched pipeline.
        """
        return np.array(
            [self.measure(layer_type, cfg) for cfg in batch.to_dicts()],
            dtype=np.float64,
        )

    def measure_many(
        self, layer_type: str, configs: Sequence[Config] | ConfigBatch
    ) -> np.ndarray:
        """Batched measurement of dict configs (or a ready ConfigBatch).

        Homogeneous dict lists are columnarised and routed through
        ``measure_batch``; heterogeneous key sets degrade to a scalar loop.
        """
        if isinstance(configs, ConfigBatch):
            return self.measure_batch(layer_type, configs)
        configs = list(configs)
        if not configs:
            return np.zeros(0, dtype=np.float64)
        try:
            batch = ConfigBatch.from_dicts(configs)
        except ValueError:
            return np.array(
                [self.measure(layer_type, c) for c in configs], dtype=np.float64
            )
        return self.measure_batch(layer_type, batch)

    def measure_block(self, layers: Sequence[tuple[str, Config]], **kwargs) -> float:
        """Execution time of a multi-layer building block run as one unit.

        Default: no fusion/overlap -> sum of single-layer times.  Platforms
        with overlapping functional units / double buffering override this
        (``**kwargs`` carries platform-specific block context, e.g. the TPU's
        in-flight collective bytes).
        """
        return float(sum(self.measure(lt, cfg) for lt, cfg in layers))

    def measure_block_batch(self, batch: BlockBatch) -> np.ndarray:
        """Execution times (seconds) of a whole batch of building blocks.

        The block-path extension point (the analogue of ``measure_batch``):
        the built-in platforms override it with columnar timing models.  The
        default is a scalar ``measure_block`` loop, so third-party platforms
        that override only ``measure_block`` (with whatever fusion semantics
        they implement) keep working on the batched whole-network pipeline.
        """
        return np.array(
            [
                self.measure_block(list(b.layers), collective_bytes=b.collective_bytes)
                for b in batch.to_blocks()
            ],
            dtype=np.float64,
        )

    def _summed_block_batch(self, batch: BlockBatch) -> np.ndarray:
        """Columnar sum-of-layers block model (the ``measure_block`` default).

        Each layer group rides the platform's vectorized ``measure_batch``
        once; the per-block left-fold sum matches the scalar
        ``sum(measure(...))`` loop bit for bit (see
        :meth:`BlockBatch.sum_by_block`).
        """
        return batch.sum_by_block(batch.scatter_groups(self.measure_batch))

    # ---- bookkeeping ---------------------------------------------------------------
    def timed_measure_many(
        self, layer_type: str, configs: Sequence[Config] | ConfigBatch
    ) -> tuple[np.ndarray, float]:
        """(times, mean wall-clock seconds per benchmark point) -- Table 1 column."""
        t0 = time.perf_counter()
        y = self.measure_many(layer_type, configs)
        wall = time.perf_counter() - t0
        return y, wall / max(1, len(configs))


def sweep_values(lo: int, hi: int, max_points: int = 512) -> np.ndarray:
    """Integer sweep grid over [lo, hi] with stride 1 capped at ``max_points``."""
    stride = max(1, (hi - lo) // max_points)
    return np.arange(lo, hi + 1, stride)
