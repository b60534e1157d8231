"""Multi-layer building blocks and whole-network combination (Eq. 9-12).

A *building block* is a short sequence of layers that the platform executes as
one fused/overlapped unit (the paper's examples: depthwise-separable conv
blocks, ResNet blocks, pool+FC).  For the LM-transformer domain the blocks are
attention blocks, (gated-)MLP blocks, MoE blocks, SSD blocks, embedding and the
LM head (see core/network.py).

Combination rules:
  * Eq. 9 ("max")  -- overlapping functional units: t_b = max_l t_l.
  * Eq. 10/11      -- fused execution: t_b = sum_l t_l - f_beta(b) with the
    fusing factor f_beta(b) = #ops(b) * w_beta + c_beta fitted per block type
    from ~500 measured block configurations.
  * Eq. 12         -- whole network: t_DNN = sum_b t_b.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.core.batch import BlockBatch
from repro_torch.core.estimator import LayerEstimator
from repro_torch.core.prs import Config

Layer = tuple[str, Config]


@dataclasses.dataclass(frozen=True)
class Block:
    """One building-block instance."""

    kind: str  # block type beta (e.g. "attn", "mlp", "moe", "ssd", "embed")
    layers: tuple[Layer, ...]
    #: collective bytes this block moves on the interconnect (sharded exec)
    collective_bytes: float = 0.0
    #: how many times this block repeats in the network (layer stacking)
    repeat: int = 1


def op_count(layer_type: str, cfg: Config) -> float:
    """#ops(b) term of Eq. 11 -- *unpadded* multiply-accumulate count."""
    if layer_type == "dense":
        return 2.0 * cfg["tokens"] * cfg["d_in"] * cfg["d_out"]
    if layer_type == "attention_prefill":
        return 2.0 * cfg["B"] * cfg["H"] * cfg["S"] ** 2 * cfg["Dh"]
    if layer_type == "attention_decode":
        return 4.0 * cfg["B"] * cfg["H"] * cfg["S_kv"] * cfg["Dh"]
    if layer_type == "moe_gemm":
        return 6.0 * cfg["tokens"] * cfg["topk"] * cfg["d_model"] * cfg["d_ff"]
    if layer_type == "ssd_scan":
        return 2.0 * cfg["B"] * cfg["S"] * cfg["H"] * cfg["P"] * (2 * cfg["N"] + 128)
    if layer_type == "embed":
        return 2.0 * cfg["tokens"] * cfg["d_model"]
    if layer_type == "conv1d":
        w_out = (cfg["C_w"] + 2 * cfg.get("pad", 0) - cfg["F"]) // cfg.get("s", 1) + 1
        return 2.0 * cfg["C"] * cfg["K"] * max(1, w_out) * cfg["F"]
    if layer_type == "conv2d":
        h_out = (cfg["C_h"] + 2 * cfg.get("pad", 1) - cfg["F"]) // cfg.get("s", 1) + 1
        w_out = (cfg["C_w"] + 2 * cfg.get("pad", 1) - cfg["F"]) // cfg.get("s", 1) + 1
        return 2.0 * cfg["C"] * cfg["K"] * max(1, h_out) * max(1, w_out) * cfg["F"] ** 2
    if layer_type == "fully_connected":
        return 2.0 * cfg["in"] * cfg["out"]
    raise KeyError(layer_type)


def block_ops(block: Block) -> float:
    return float(sum(op_count(lt, cfg) for lt, cfg in block.layers))


def op_count_batch(layer_type: str, batch) -> np.ndarray:
    """Columnar :func:`op_count`: #ops per row of a ``ConfigBatch``.

    Every expression mirrors the scalar formula operation for operation (same
    evaluation order, same int/float promotion points), so the result is
    bitwise-identical to looping ``op_count`` over the rows.
    """
    col = batch.column
    get = batch.get
    if layer_type == "dense":
        return 2.0 * col("tokens") * col("d_in") * col("d_out")
    if layer_type == "attention_prefill":
        return 2.0 * col("B") * col("H") * col("S") ** 2 * col("Dh")
    if layer_type == "attention_decode":
        return 4.0 * col("B") * col("H") * col("S_kv") * col("Dh")
    if layer_type == "moe_gemm":
        return 6.0 * col("tokens") * col("topk") * col("d_model") * col("d_ff")
    if layer_type == "ssd_scan":
        return 2.0 * col("B") * col("S") * col("H") * col("P") * (2 * col("N") + 128)
    if layer_type == "embed":
        return 2.0 * col("tokens") * col("d_model")
    if layer_type == "conv1d":
        w_out = (col("C_w") + 2 * get("pad", 0) - col("F")) // get("s", 1) + 1
        return 2.0 * col("C") * col("K") * np.maximum(1, w_out) * col("F")
    if layer_type == "conv2d":
        h_out = (col("C_h") + 2 * get("pad", 1) - col("F")) // get("s", 1) + 1
        w_out = (col("C_w") + 2 * get("pad", 1) - col("F")) // get("s", 1) + 1
        return (
            2.0 * col("C") * col("K")
            * np.maximum(1, h_out) * np.maximum(1, w_out) * col("F") ** 2
        )
    if layer_type == "fully_connected":
        return 2.0 * col("in") * col("out")
    raise KeyError(layer_type)


def block_ops_batch(batch: BlockBatch) -> np.ndarray:
    """Columnar :func:`block_ops` over a whole block batch.

    Per-layer op counts come from one ``op_count_batch`` call per layer
    group; ``np.bincount`` accumulates each block's layers in table order —
    the same left fold as the scalar ``sum`` — so values are bitwise equal.
    """
    return batch.sum_by_block(batch.scatter_groups(op_count_batch))


def measure_block_many(platform: Platform, blocks: Sequence[Block]) -> np.ndarray:
    """Measured times of many blocks, through the columnar block path.

    Homogeneously-integer blocks columnarise into one :class:`BlockBatch` and
    ride ``measure_block_batch`` — the platform's vectorized timing model,
    plus the block cache and sharded runtime when ``platform`` is a
    :class:`~repro_torch.api.cache.CachedPlatform`.  Non-integer configs (or duck
    platforms exposing only ``measure_block``) degrade to the scalar loop,
    which produces bitwise-identical values.
    """
    batch_fn = getattr(platform, "measure_block_batch", None)
    if isinstance(blocks, BlockBatch):
        if batch_fn is not None:
            return np.asarray(batch_fn(blocks), dtype=np.float64)
        blocks = blocks.to_blocks()
    blocks = list(blocks)
    if not blocks:
        return np.zeros(0, dtype=np.float64)
    if batch_fn is not None:
        try:
            batch = BlockBatch.from_blocks(blocks)
        except ValueError:
            pass  # non-integer config values: below the columnar floor
        else:
            return np.asarray(batch_fn(batch), dtype=np.float64)
    return np.array(
        [
            platform.measure_block(list(b.layers), collective_bytes=b.collective_bytes)
            for b in blocks
        ],
        dtype=np.float64,
    )


@dataclasses.dataclass
class FusingModel:
    """Linear fusing-factor model per block type (Eq. 11)."""

    w: float = 0.0
    c: float = 0.0
    n_fit: int = 0

    def __call__(self, block: Block) -> float:
        return block_ops(block) * self.w + self.c


def fit_fusing_model(
    platform: Platform,
    estimators: Mapping[str, LayerEstimator],
    blocks: Sequence[Block] | BlockBatch,
) -> FusingModel:
    """Fit w_beta, c_beta from measured block configurations (Eq. 10/11).

    Measurements include each block's collective payload
    (``collective_bytes``), matching how ``simulate_network`` and
    ``evaluate_networks`` measure ground truth — fitting against
    collectives-free block times would mis-fit ``f_beta`` for blocks that
    move bytes on the interconnect.  Both sides of the fit are batched: the
    ground truth is one :func:`measure_block_many` call (one ``BlockBatch``
    through the platform's columnar block model, cache-partitioned and
    runtime-sharded under a ``CachedPlatform``), and the summed single-layer
    estimates come from one batched
    :meth:`~repro_torch.api.oracle.PerfOracle.predict` per layer type (via
    ``PerfOracle.layer_times``) — no per-block measure loop, one lstsq.
    """
    if not hasattr(platform, "measure_block"):
        raise TypeError(
            f"platform {getattr(platform, 'name', platform)!r} does not "
            "implement measure_block(); cannot measure fusing-model ground "
            "truth (Eq. 10/11)"
        )
    from repro_torch.api.oracle import PerfOracle

    oracle = PerfOracle(estimators=estimators)
    if isinstance(blocks, BlockBatch):
        # Columnar-native path: predictions, op counts and measurements all
        # stay on the batch — blocks never materialise as dicts.  Each stage
        # is bitwise-identical to its scalar twin (bincount left-folds match
        # the per-block sum loops; forest predictions are row-independent).
        batch = blocks
        sums = oracle.layer_time_sums(batch)
        t_meas = measure_block_many(platform, batch)
        f_targets = sums - t_meas
        ops = block_ops_batch(batch)
        n_fit = len(batch)
    else:
        blocks = list(blocks)
        layer_times = oracle.layer_times(blocks)
        t_meas = measure_block_many(platform, blocks)
        f_list, ops_list = [], []
        for b, times, t in zip(blocks, layer_times, t_meas.tolist()):
            f_list.append(sum(times) - t)
            ops_list.append(block_ops(b))
        f_targets = np.asarray(f_list)
        ops = np.asarray(ops_list)
        n_fit = len(blocks)
    A = np.stack([ops, np.ones(len(ops))], axis=1)
    coef, *_ = np.linalg.lstsq(A, f_targets, rcond=None)
    return FusingModel(w=float(coef[0]), c=float(coef[1]), n_fit=n_fit)


@dataclasses.dataclass
class NetworkEstimator:
    """Whole-network estimator: per-layer forests + per-block combination.

    .. deprecated::
        Thin shim kept for backward compatibility; prediction delegates to
        :class:`repro_torch.api.oracle.PerfOracle`, whose batched ``predict`` is the
        uniform query path (one forest pass per layer type, not per layer).
        New code should construct a ``PerfOracle`` directly (e.g. via
        ``Campaign.run()``).
    """

    estimators: Mapping[str, LayerEstimator]
    fusing: Mapping[str, FusingModel] = dataclasses.field(default_factory=dict)
    #: block kinds whose layers execute on overlapping FUs (Eq. 9 max rule)
    overlap_kinds: frozenset[str] = frozenset()
    #: documented per-launch overhead (gray-box knowledge): a fused block pays
    #: it once, but the summed single-layer estimates include it per layer
    launch_overhead_s: float = 0.0

    def _oracle(self):
        from repro_torch.api.oracle import PerfOracle

        return PerfOracle(
            estimators=self.estimators,
            fusing=self.fusing,
            overlap_kinds=self.overlap_kinds,
            launch_overhead_s=self.launch_overhead_s,
        )

    def predict_block(self, block: Block) -> float:
        return self._oracle().predict_block(block)

    def predict_network(self, blocks: Sequence[Block]) -> float:
        return self._oracle().predict_network(blocks)  # Eq. 9-12

    def evaluate_networks(
        self, platform: Platform, networks: Sequence[Sequence[Block]]
    ) -> dict[str, float]:
        """MAPE/RMSPE of whole-network estimates against measured ground truth.

        Delegates to :meth:`repro_torch.api.oracle.PerfOracle.evaluate_networks`:
        ground truth rides the columnar block path (each network measured as
        a batch) and predictions use one forest pass per layer type across
        the whole network set.  Raises ``TypeError`` when the platform cannot
        measure blocks (silent ``0.0`` ground truth would read as nan/inf
        error metrics instead of a broken setup).
        """
        return self._oracle().evaluate_networks(platform, networks)
