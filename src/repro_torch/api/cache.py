"""Measurement cache: memoize ``(platform, layer_type, config) -> time``.

Benchmarking is the expensive resource the whole PR methodology exists to
conserve (the paper quotes multi-minute RTL simulations per point).  Within a
campaign the same configuration is routinely requested several times — sweep
windows overlap PR samples, training sets overlap evaluation sets, and
``sampling_curve`` re-trains at growing budgets over the same PR grid — so the
cache guarantees every unique configuration is measured **at most once**.

Discovered step widths are memoized alongside (keyed by platform, layer type
and detection threshold) so size scans and repeated campaigns reuse the sweep
result instead of re-sweeping.

``CachedPlatform`` wraps any :class:`~repro_torch.accelerators.base.Platform` with
the cache transparently, so the sweep/training/evaluation code paths need no
changes to benefit.  Batched measurement goes through ``lookup_many`` /
``store_many``, which partition a whole :class:`~repro_torch.core.batch.ConfigBatch`
into hits and misses in one pass so only the miss sub-batch reaches the
platform's vectorized timing model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.core.prs import Config, ParamSpace
from repro_torch.obs.trace import span


def config_key(layer_type: str, cfg: Config) -> tuple:
    """Canonical hashable key for one layer configuration.

    Values are coerced to plain ``int`` so numpy integers (``np.int64(8)``)
    and Python ``8`` produce the same key — a config built from ``np.arange``
    values must hit the entry stored from plain ints.
    """
    return (layer_type, tuple(sorted((p, int(v)) for p, v in cfg.items())))


def batch_keys(layer_type: str, batch: ConfigBatch) -> list[tuple]:
    """Row-wise :func:`config_key` tuples for a whole batch, in one pass.

    Sorts the parameter axis once and materialises all row values with a
    single ``tolist()`` (plain Python ints), instead of building and sorting
    a dict per row.
    """
    order = sorted(range(len(batch.params)), key=lambda j: batch.params[j])
    sorted_params = tuple(batch.params[j] for j in order)
    rows = batch.values[:, order].tolist()
    return [(layer_type, tuple(zip(sorted_params, row))) for row in rows]


def block_key(
    layers: Sequence[tuple[str, Config]], collective_bytes: float = 0.0
) -> tuple:
    """Canonical hashable key for one building block's measurement.

    Matches :meth:`repro_torch.core.batch.BlockBatch.fingerprints` exactly:
    ``("block", structure, values_bytes, coll)`` — the layer sequence (order
    preserved) as a structure string plus the concatenated sorted-by-param
    int64 values.  ``kind``/``repeat`` are excluded — they affect how a
    block's time is combined, not what a platform measures.  Raises
    ``ValueError`` for non-integer config values instead of silently
    truncating them into a wrong key.
    """
    structs = []
    values: list[int] = []
    for lt, cfg in layers:
        params = tuple(sorted(cfg))
        structs.append(BlockBatch._layer_structure(lt, params))
        for p in params:
            v = cfg[p]
            iv = int(v)
            if iv != v:
                raise ValueError(f"block layer param {p!r}={v!r} is not an integer")
            values.append(iv)
    return (
        "block",
        "\x1e".join(structs),
        np.asarray(values, dtype=np.int64).tobytes(),
        float(collective_bytes),
    )


@dataclasses.dataclass(frozen=True)
class _MeasuredBlock:
    """Minimal duck block for wrapping a scalar measure_block call into a
    one-row :class:`BlockBatch` (avoids importing the heavier core.blocks)."""

    layers: tuple
    collective_bytes: float = 0.0
    kind: str = ""
    repeat: float = 1.0


class MeasurementCache:
    """Memoizes single-layer measurements and discovered step widths."""

    def __init__(self) -> None:
        #: (platform, layer_type, sorted cfg items) -> seconds
        self._times: dict[tuple, float] = {}
        #: platform -> {block fingerprint (see ``block_key``) -> seconds};
        #: nested so a batch lookup probes one inner dict without building a
        #: (platform,) + key tuple per block
        self._block_times: dict[str, dict[tuple, float]] = {}
        #: (platform, layer_type, threshold, n_points) -> (widths, n_meas)
        self._widths: dict[tuple, tuple[dict[str, int], int]] = {}
        #: (platform, layer_type, widths, snap, batch fingerprint) -> features
        self._feature_matrices: dict[tuple, np.ndarray] = {}
        self.hits = 0
        self.misses = 0
        #: measurements preloaded from a journal replay (not hits, not misses)
        self.replayed = 0
        #: block-level accounting, kept apart from the per-config counters so
        #: Table-1 per-point costs and campaign stats keep their meaning
        self.block_hits = 0
        self.block_misses = 0
        self.block_replayed = 0
        self.feature_hits = 0
        #: wall-clock seconds spent inside actual (miss) measurements
        self.measure_seconds = 0.0
        #: wall-clock seconds spent inside actual block (miss) measurements
        self.block_measure_seconds = 0.0

    # ------------------------------------------------------------- measurements
    def lookup(self, platform: str, layer_type: str, cfg: Config) -> float | None:
        t = self._times.get((platform,) + config_key(layer_type, cfg))
        if t is not None:
            self.hits += 1
        return t

    def store(self, platform: str, layer_type: str, cfg: Config, seconds: float) -> None:
        self._times[(platform,) + config_key(layer_type, cfg)] = seconds
        self.misses += 1

    # --------------------------------------------------------- batched interface
    def lookup_many(
        self, platform: str, layer_type: str, batch: ConfigBatch
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Partition a batch into cache hits and misses in one pass.

        Returns ``(times, miss_rows, miss_map)``:

        * ``times`` — (n,) float64, cached seconds with NaN at missing rows;
        * ``miss_rows`` — row indices of the *first occurrence* of each
          distinct missing key (the sub-batch that actually needs measuring);
        * ``miss_map`` — (n,) int64 mapping every missing row to its key's
          position in ``miss_rows`` (−1 for cached rows), so measured values
          can be scattered back to duplicates without re-probing.

        Hit accounting matches a scalar measure/store replay: rows that
        duplicate an in-batch miss count as hits, because the transaction
        stores the first occurrence before the duplicate would be probed.
        """
        keys = batch_keys(layer_type, batch)
        n = len(keys)
        times = np.full(n, np.nan, dtype=np.float64)
        miss_map = np.full(n, -1, dtype=np.int64)
        miss_rows: list[int] = []
        first_pos: dict[tuple, int] = {}
        for i, k in enumerate(keys):
            t = self._times.get((platform,) + k)
            if t is not None:
                times[i] = t
            else:
                pos = first_pos.get(k)
                if pos is None:
                    pos = len(miss_rows)
                    first_pos[k] = pos
                    miss_rows.append(i)
                miss_map[i] = pos
        self.hits += n - len(miss_rows)
        return times, np.array(miss_rows, dtype=np.int64), miss_map

    def store_many(
        self, platform: str, layer_type: str, batch: ConfigBatch, seconds: np.ndarray
    ) -> None:
        """Store one measured sub-batch (one key build pass, one miss each)."""
        seconds = np.asarray(seconds, dtype=np.float64)
        for k, t in zip(batch_keys(layer_type, batch), seconds.tolist()):
            self._times[(platform,) + k] = t
        self.misses += len(batch)

    def preload(
        self, platform: str, layer_type: str, batch: ConfigBatch, seconds: np.ndarray
    ) -> int:
        """Insert measurements without touching hit/miss accounting.

        This is the journal-replay entry point: replayed measurements were paid
        for by a *previous* run, so they must not count as this run's misses
        (and they are not hits either — nothing asked for them yet).

        Unlike the live first-measurement-wins cache, preload deliberately
        **overwrites** on duplicate keys: journals are chronological, and the
        scheduler appends a superseding record when a retried chunk's merged
        values replace a stale attempt's, so the *last* record for a key is
        the value the writing run actually trained on.  Returns the number of
        keys that were not already cached, so re-replaying the same journal is
        idempotent.
        """
        seconds = np.asarray(seconds, dtype=np.float64)
        new = 0
        for k, t in zip(batch_keys(layer_type, batch), seconds.tolist()):
            key = (platform,) + k
            if key not in self._times:
                new += 1
            self._times[key] = t
        self.replayed += new
        return new

    # ------------------------------------------------------------- block times
    def _blocks_for(self, platform: str) -> dict[tuple, float]:
        table = self._block_times.get(platform)
        if table is None:
            table = self._block_times[platform] = {}
        return table

    def lookup_block(
        self, platform: str, layers: Sequence[tuple[str, Config]], collective_bytes: float
    ) -> float | None:
        t = self._blocks_for(platform).get(block_key(layers, collective_bytes))
        if t is not None:
            self.block_hits += 1
        return t

    def store_block(
        self,
        platform: str,
        layers: Sequence[tuple[str, Config]],
        collective_bytes: float,
        seconds: float,
    ) -> None:
        self._blocks_for(platform)[block_key(layers, collective_bytes)] = seconds
        self.block_misses += 1

    def lookup_blocks(
        self, platform: str, batch: BlockBatch
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Partition a block batch into cache hits and misses in one pass.

        Same contract as :meth:`lookup_many`, over block fingerprints:
        ``(times, miss_rows, miss_map)`` where ``miss_rows`` holds the first
        occurrence of each distinct missing block and ``miss_map`` scatters
        measured values back to in-batch duplicates.  Duplicate misses count
        as hits, matching a scalar measure/store replay.
        """
        keys = batch.fingerprints()
        table = self._blocks_for(platform)
        n = len(keys)
        times = np.full(n, np.nan, dtype=np.float64)
        miss_map = np.full(n, -1, dtype=np.int64)
        miss_rows: list[int] = []
        first_pos: dict[tuple, int] = {}
        for i, k in enumerate(keys):
            t = table.get(k)
            if t is not None:
                times[i] = t
            else:
                pos = first_pos.get(k)
                if pos is None:
                    pos = len(miss_rows)
                    first_pos[k] = pos
                    miss_rows.append(i)
                miss_map[i] = pos
        self.block_hits += n - len(miss_rows)
        return times, np.array(miss_rows, dtype=np.int64), miss_map

    def store_blocks(
        self,
        platform: str,
        batch: BlockBatch,
        seconds: np.ndarray,
        keys: Sequence[tuple] | None = None,
    ) -> None:
        """Store one measured block sub-batch.

        ``keys`` short-circuits the fingerprint pass when the caller already
        holds them (``CachedPlatform`` reuses the lookup pass's keys for the
        miss rows); ``batch.fingerprints()`` memoizes anyway, so this is an
        allocation saving, not a correctness lever.
        """
        seconds = np.asarray(seconds, dtype=np.float64)
        if keys is None:
            keys = batch.fingerprints()
        table = self._blocks_for(platform)
        for k, t in zip(keys, seconds.tolist()):
            table[k] = t
        self.block_misses += len(batch)

    def preload_blocks(
        self, platform: str, batch: BlockBatch, seconds: np.ndarray
    ) -> int:
        """Journal-replay insert for block measurements (see :meth:`preload`).

        Last-writer-wins on duplicate keys, does not disturb hit/miss
        accounting, returns the number of keys that were new.
        """
        seconds = np.asarray(seconds, dtype=np.float64)
        table = self._blocks_for(platform)
        new = 0
        for k, t in zip(batch.fingerprints(), seconds.tolist()):
            if k not in table:
                new += 1
            table[k] = t
        self.block_replayed += new
        return new

    @property
    def n_unique(self) -> int:
        return len(self._times)

    @property
    def n_unique_blocks(self) -> int:
        return sum(len(t) for t in self._block_times.values())

    @property
    def mean_measure_seconds(self) -> float:
        """Mean wall-clock cost per *actual* measurement (cache misses only)."""
        return self.measure_seconds / max(1, self.misses)

    # ------------------------------------------------------------- step widths
    def lookup_widths(
        self, platform: str, layer_type: str, threshold: float, n_points: int
    ) -> tuple[dict[str, int], int] | None:
        return self._widths.get((platform, layer_type, threshold, n_points))

    def store_widths(
        self,
        platform: str,
        layer_type: str,
        threshold: float,
        n_points: int,
        widths: Mapping[str, int],
        n_meas: int,
    ) -> None:
        self._widths[(platform, layer_type, threshold, n_points)] = (dict(widths), n_meas)

    # --------------------------------------------------------- feature matrices
    @staticmethod
    def _feature_key(
        platform: str,
        layer_type: str,
        widths: Mapping[str, int],
        snap: bool,
        batch: ConfigBatch,
    ) -> tuple:
        """Key for a snapped feature matrix: widths + a batch fingerprint.

        The snapped features of a fixed test set depend only on the step
        widths (which a campaign discovers once per layer type) and the batch
        itself, so ``sampling_curve`` can re-evaluate at every training size
        without re-featurizing.  The batch is fingerprinted by content hash —
        cheap next to one featurization pass.
        """
        digest = hashlib.sha1(batch.values.tobytes()).hexdigest()
        widths_key = tuple(sorted((p, int(w)) for p, w in widths.items()))
        return (platform, layer_type, widths_key, bool(snap), batch.params,
                batch.values.shape, digest)

    def lookup_features(
        self,
        platform: str,
        layer_type: str,
        widths: Mapping[str, int],
        snap: bool,
        batch: ConfigBatch,
    ) -> np.ndarray | None:
        X = self._feature_matrices.get(
            self._feature_key(platform, layer_type, widths, snap, batch)
        )
        if X is not None:
            self.feature_hits += 1
        return X

    def store_features(
        self,
        platform: str,
        layer_type: str,
        widths: Mapping[str, int],
        snap: bool,
        batch: ConfigBatch,
        X: np.ndarray,
    ) -> None:
        key = self._feature_key(platform, layer_type, widths, snap, batch)
        self._feature_matrices[key] = np.asarray(X, dtype=np.float64)

    # ------------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Persist the cache as JSON (times + widths + blocks) for cross-run reuse."""
        payload = {
            "times": [[list(k[:2]) + [list(k[2])], v] for k, v in self._times.items()],
            "widths": [[list(k), [w, n]] for k, (w, n) in self._widths.items()],
            # block entry: [platform, structure_str, values, coll, seconds]
            "blocks": [
                [plat, k[1], np.frombuffer(k[2], dtype=np.int64).tolist(), k[3], v]
                for plat, table in self._block_times.items()
                for k, v in table.items()
            ],
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "MeasurementCache":
        cache = cls()
        with open(path) as f:
            payload = json.load(f)
        for (plat, lt, items), v in payload["times"]:
            cache._times[(plat, lt, tuple((p, int(x)) for p, x in items))] = float(v)
        for (plat, lt, thr, npts), (w, n) in payload["widths"]:
            cache._widths[(plat, lt, float(thr), int(npts))] = (
                {p: int(x) for p, x in w.items()},
                int(n),
            )
        for plat, structure, vals, coll, v in payload.get("blocks", ()):
            key = (
                "block",
                structure,
                np.asarray(vals, dtype=np.int64).tobytes(),
                float(coll),
            )
            cache._blocks_for(plat)[key] = float(v)
        return cache

    def stats(self) -> dict[str, float]:
        return {
            "unique_measurements": self.n_unique,
            "hits": self.hits,
            "misses": self.misses,
            "replayed": self.replayed,
            "unique_blocks": self.n_unique_blocks,
            "block_hits": self.block_hits,
            "block_misses": self.block_misses,
            "block_replayed": self.block_replayed,
            "feature_hits": self.feature_hits,
            "measure_seconds": self.measure_seconds,
            "block_measure_seconds": self.block_measure_seconds,
        }


class CachedPlatform(Platform):
    """Transparent caching proxy around a real :class:`Platform`.

    Delegates capability description to the inner platform and routes every
    ``measure`` through the shared :class:`MeasurementCache`, so all pipeline
    stages (sweeps, PR-sample benchmarking, evaluation) share one pool of
    measurements.

    When a :class:`~repro_torch.runtime.MeasurementRuntime` is attached (``runtime``
    attribute; ``Campaign.run(runtime=...)`` manages this), the miss sub-batch
    is executed through the runtime's scheduler — sharded across workers,
    journaled, retried — instead of calling the inner platform directly.
    """

    def __init__(
        self,
        inner: Platform,
        cache: MeasurementCache | None = None,
        runtime=None,
    ) -> None:
        self.inner = inner
        self.cache = cache if cache is not None else MeasurementCache()
        #: optional MeasurementRuntime executing the misses (duck-typed to
        #: avoid importing repro_torch.runtime from this lower layer)
        self.runtime = runtime

    # ---- capability description (delegated) ----------------------------------
    @property
    def name(self) -> str:  # type: ignore[override]
        return self.inner.name

    @property
    def knowledge(self) -> str:  # type: ignore[override]
        return self.inner.knowledge

    def layer_types(self) -> tuple[str, ...]:
        return self.inner.layer_types()

    def param_space(self, layer_type: str) -> ParamSpace:
        return self.inner.param_space(layer_type)

    def defaults(self, layer_type: str) -> Config:
        return self.inner.defaults(layer_type)

    def known_step_widths(self, layer_type: str) -> dict[str, int] | None:
        return self.inner.known_step_widths(layer_type)

    def cache_key(self) -> str:
        return self.inner.cache_key()

    # ---- measurement (cached) ------------------------------------------------
    def measure(self, layer_type: str, cfg: Config) -> float:
        t = self.cache.lookup(self.inner.cache_key(), layer_type, cfg)
        if t is not None:
            if self.runtime is not None:
                self.runtime.stats.cached += 1
            return t
        t0 = time.perf_counter()
        t = self._measure_miss(layer_type, cfg)
        self.cache.measure_seconds += time.perf_counter() - t0
        self.cache.store(self.inner.cache_key(), layer_type, cfg, t)
        return t

    def _measure_miss(self, layer_type: str, cfg: Config) -> float:
        """One uncached measurement, through the runtime when attached."""
        if self.runtime is not None:
            try:
                batch = ConfigBatch.from_dicts([cfg])
            except ValueError:
                pass  # non-integer config: below the runtime's columnar floor
            else:
                return float(self.runtime.measure(layer_type, batch)[0])
        return self.inner.measure(layer_type, cfg)

    def measure_batch(self, layer_type: str, batch: ConfigBatch) -> np.ndarray:
        """Cache-partitioned batch measurement.

        One ``lookup_many`` pass splits the batch; only the sub-batch of
        distinct misses reaches ``inner.measure_batch``; duplicates and hits
        are filled from the cache, so every unique config is still measured
        at most once and hit/miss totals match the scalar replay exactly.
        """
        key = self.inner.cache_key()
        times, miss_rows, miss_map = self.cache.lookup_many(key, layer_type, batch)
        if self.runtime is not None:
            self.runtime.stats.cached += len(batch) - int(miss_rows.size)
        if miss_rows.size:
            sub = batch.take(miss_rows)
            t0 = time.perf_counter()
            sp = span("cache.measure_batch", cat="cache")
            if sp:
                sp.set(layer_type=layer_type, misses=int(miss_rows.size),
                       hits=len(batch) - int(miss_rows.size))
            with sp:
                if self.runtime is not None:
                    y = self.runtime.measure(layer_type, sub)
                else:
                    y = self.inner.measure_batch(layer_type, sub)
            self.cache.measure_seconds += time.perf_counter() - t0
            self.cache.store_many(key, layer_type, sub, y)
            missing = miss_map >= 0
            times[missing] = y[miss_map[missing]]
        return times

    def measure_block(
        self, layers: Sequence[tuple[str, Config]], collective_bytes: float = 0.0, **kwargs
    ) -> float:
        """Cached block measurement (own key space: fused/overlapped execution
        is semantically distinct from the sum of single-layer times, so block
        times never mix with the single-layer cache).

        Unknown platform-specific kwargs cannot be fingerprinted and bypass
        the cache, as do non-integer layer configs.
        """
        if kwargs:
            return self.inner.measure_block(
                layers, collective_bytes=collective_bytes, **kwargs
            )
        key = self.inner.cache_key()
        try:
            t = self.cache.lookup_block(key, layers, collective_bytes)
        except (ValueError, TypeError):
            # Unfingerprintable config (fractional value -> ValueError,
            # non-numeric like None/tuples -> TypeError from int()): bypass
            # the cache like the pre-cache path did.
            return self.inner.measure_block(layers, collective_bytes=collective_bytes)
        if t is not None:
            if self.runtime is not None:
                self.runtime.stats.cached += 1
            return t
        t0 = time.perf_counter()
        if self.runtime is not None:
            batch = BlockBatch.from_blocks(
                [_MeasuredBlock(layers=tuple(layers), collective_bytes=collective_bytes)]
            )
            t = float(self.runtime.measure_blocks(batch)[0])
        else:
            t = self.inner.measure_block(layers, collective_bytes=collective_bytes)
        self.cache.block_measure_seconds += time.perf_counter() - t0
        self.cache.store_block(key, layers, collective_bytes, t)
        return t

    def measure_block_batch(self, batch: BlockBatch) -> np.ndarray:
        """Cache-partitioned block-batch measurement.

        Mirror of :meth:`measure_batch` over block fingerprints: one
        ``lookup_blocks`` pass splits the batch, only distinct misses reach
        the platform's columnar block model (or the measurement runtime's
        scheduler when attached), and duplicates/hits fill from the cache —
        every unique block is measured at most once across calibration,
        evaluation and autotuning.
        """
        key = self.inner.cache_key()
        times, miss_rows, miss_map = self.cache.lookup_blocks(key, batch)
        if self.runtime is not None:
            self.runtime.stats.cached += len(batch) - int(miss_rows.size)
        if miss_rows.size:
            sub = batch.take(miss_rows)  # carries the parent's fingerprints
            t0 = time.perf_counter()
            sp = span("cache.measure_block_batch", cat="cache")
            if sp:
                sp.set(misses=int(miss_rows.size),
                       hits=len(batch) - int(miss_rows.size))
            with sp:
                if self.runtime is not None:
                    y = self.runtime.measure_blocks(sub)
                else:
                    y = self.inner.measure_block_batch(sub)
            self.cache.block_measure_seconds += time.perf_counter() - t0
            fps = batch.fingerprints()
            self.cache.store_blocks(
                key, sub, y, keys=[fps[i] for i in miss_rows.tolist()]
            )
            missing = miss_map >= 0
            times[missing] = y[miss_map[missing]]
        return times

    def timed_measure_many(
        self, layer_type: str, configs: Sequence[Config]
    ) -> tuple[np.ndarray, float]:
        """Like the base class, but the per-point cost counts misses only."""
        misses_before = self.cache.misses
        spent_before = self.cache.measure_seconds
        y = self.measure_many(layer_type, configs)
        new_misses = self.cache.misses - misses_before
        mean = (self.cache.measure_seconds - spent_before) / max(1, new_misses)
        return y, mean
