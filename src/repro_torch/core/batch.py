"""Columnar batches of layer configurations.

The pipeline's unit of work used to be one ``dict[str, int]`` config moving
through Python loops; :class:`ConfigBatch` is the columnar replacement — a
``(n, n_params)`` int64 matrix plus an ordered parameter tuple — that lets
every stage (sampling, sweeps, measurement, caching, feature building, forest
traversal) operate on whole batches with numpy array ops.

Dict-based entry points remain as one-row / row-loop wrappers around the
batch path, so external code keeps working unchanged.  A batch is immutable;
"mutating" helpers (:meth:`replace`, :meth:`take`, :meth:`with_fixed`) return
new batches and never alias caller-visible state destructively.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

#: One layer configuration, e.g. ``{"C": 40, "K": 16, "F": 3}``.
Config = dict[str, int]


@dataclasses.dataclass(frozen=True)
class ConfigBatch:
    """``n`` configurations over a fixed parameter tuple, stored columnarly."""

    params: tuple[str, ...]
    values: np.ndarray  # (n, len(params)) int64

    def __post_init__(self) -> None:
        vals = np.asarray(self.values, dtype=np.int64)
        if vals.ndim != 2 or vals.shape[1] != len(self.params):
            raise ValueError(
                f"values shape {vals.shape} does not match params {self.params}"
            )
        object.__setattr__(self, "params", tuple(self.params))
        object.__setattr__(self, "values", vals)

    # ------------------------------------------------------------- construction
    @classmethod
    def from_dicts(
        cls, configs: Sequence[Config], params: tuple[str, ...] | None = None
    ) -> "ConfigBatch":
        """Columnarise a list of dict configs (all must share one key set).

        Rows are gathered with plain key lookups and validated in one numpy
        pass (a ``KeyError``/length mismatch means differing key sets, a
        non-integral cast means a fractional value) — same ``ValueError``
        contract as the original per-cell loop, an order of magnitude less
        Python per config.
        """
        if params is None:
            params = tuple(configs[0].keys()) if configs else ()
        n_params = len(params)
        rows = []
        for i, cfg in enumerate(configs):
            if len(cfg) != n_params:
                raise ValueError(
                    f"config {i} keys {sorted(cfg)} != batch params {sorted(params)}"
                )
            try:
                rows.append([cfg[p] for p in params])
            except KeyError:
                raise ValueError(
                    f"config {i} keys {sorted(cfg)} != batch params {sorted(params)}"
                ) from None
        vals = np.asarray(rows)
        if len(configs) == 0:
            vals = np.empty((0, n_params), dtype=np.int64)
        elif not np.issubdtype(vals.dtype, np.number) or np.issubdtype(
            vals.dtype, np.complexfloating
        ):
            raise ValueError(f"non-numeric config value in batch params {params}")
        elif not np.issubdtype(vals.dtype, np.integer):
            cast = vals.astype(np.int64)
            if not np.array_equal(cast, vals):
                # Refuse to silently truncate (e.g. 7.5 -> 7); callers at the
                # dict boundary catch ValueError and fall back to the scalar
                # path, which handles non-integer values as before.
                raise ValueError(f"non-integer config value in batch params {params}")
            vals = cast
        return cls(params=params, values=vals.reshape(len(configs), n_params))

    @classmethod
    def from_columns(cls, columns: Mapping[str, np.ndarray]) -> "ConfigBatch":
        """Build from per-parameter value columns (all the same length)."""
        params = tuple(columns.keys())
        if not params:
            return cls(params=(), values=np.empty((0, 0), dtype=np.int64))
        cols = [np.asarray(columns[p], dtype=np.int64) for p in params]
        n = len(cols[0])
        if any(c.shape != (n,) for c in cols):
            raise ValueError("columns must be 1-D and of equal length")
        return cls(params=params, values=np.stack(cols, axis=1))

    @classmethod
    def from_anchor(cls, cfg: Config, n: int) -> "ConfigBatch":
        """``n`` identical rows of one anchor configuration."""
        params = tuple(cfg.keys())
        row = np.array([cfg[p] for p in params], dtype=np.int64)
        return cls(params=params, values=np.tile(row, (n, 1)))

    @classmethod
    def concat(cls, batches: Iterable["ConfigBatch"]) -> "ConfigBatch":
        """Stack batches over the same parameter tuple."""
        batches = list(batches)
        if not batches:
            return cls(params=(), values=np.empty((0, 0), dtype=np.int64))
        params = batches[0].params
        if any(b.params != params for b in batches):
            raise ValueError("cannot concat batches with differing params")
        return cls(params=params, values=np.concatenate([b.values for b in batches]))

    # ------------------------------------------------------------- inspection
    def __len__(self) -> int:
        return self.values.shape[0]

    def _index(self, p: str) -> int:
        try:
            return self.params.index(p)
        except ValueError:
            raise KeyError(p) from None

    def column(self, p: str) -> np.ndarray:
        """The (n,) int64 value column of one parameter."""
        return self.values[:, self._index(p)]

    def get(self, p: str, default: int | None = None):
        """Column of ``p``, or the scalar ``default`` when absent (broadcasts)."""
        if p in self.params:
            return self.column(p)
        return default

    def row(self, i: int) -> Config:
        return {p: int(v) for p, v in zip(self.params, self.values[i])}

    def to_dicts(self) -> list[Config]:
        """Back to row dicts (plain Python ints)."""
        rows = self.values.tolist()
        return [dict(zip(self.params, row)) for row in rows]

    def matrix(self, params: Sequence[str]) -> np.ndarray:
        """Float64 matrix of the given columns in the given order."""
        idx = [self._index(p) for p in params]
        return self.values[:, idx].astype(np.float64)

    # ------------------------------------------------------------- derivation
    def take(self, rows: np.ndarray) -> "ConfigBatch":
        """Row sub-batch (fancy-indexed copy)."""
        return ConfigBatch(params=self.params, values=self.values[rows])

    def replace(self, p: str, column: np.ndarray) -> "ConfigBatch":
        """New batch with one column replaced."""
        vals = self.values.copy()
        vals[:, self._index(p)] = np.asarray(column, dtype=np.int64)
        return ConfigBatch(params=self.params, values=vals)

    def with_fixed(self, fixed: Mapping[str, int]) -> "ConfigBatch":
        """Append constant columns for parameters not already present.

        Mirrors :meth:`repro_torch.core.prs.ParamSpace.with_fixed`: existing columns
        win over the fixed values.
        """
        extra = [p for p in fixed if p not in self.params]
        if not extra:
            return self
        n = len(self)
        cols = np.empty((n, len(extra)), dtype=np.int64)
        for j, p in enumerate(extra):
            cols[:, j] = int(fixed[p])
        return ConfigBatch(
            params=self.params + tuple(extra),
            values=np.concatenate([self.values, cols], axis=1),
        )

    def dedup(self) -> tuple["ConfigBatch", np.ndarray, np.ndarray]:
        """Unique rows in first-occurrence order.

        Returns ``(unique, first_rows, inverse)`` with
        ``unique.values == self.values[first_rows]`` and
        ``self.values == unique.values[inverse]``.
        """
        if len(self) == 0:
            return self, np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        _, first, inv = np.unique(
            self.values, axis=0, return_index=True, return_inverse=True
        )
        inv = inv.reshape(-1)  # numpy >= 2.0 returns (n, 1) for axis=0
        order = np.argsort(first, kind="stable")  # sorted-unique -> first-seen order
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        return self.take(first[order]), first[order], rank[inv]


class BlockBatchBuilder:
    """Incremental columnar constructor for :class:`BlockBatch`.

    The producer-side twin of :meth:`BlockBatch.from_blocks` for callers that
    never materialise ``Block`` objects (columnar-native ``decompose``):
    ``add`` appends one block straight into the per-group columns, keyed on
    the same ``(layer_type, insertion-order key tuple)`` group identity, so
    ``build()`` is field-for-field identical to
    ``BlockBatch.from_blocks(blocks)`` over the same walk (asserted in
    tests/test_jax_predict.py).  Raises the same ``ValueError`` on
    non-integer config values.
    """

    def __init__(self) -> None:
        self._kinds: list[str] = []
        self._coll: list[float] = []
        self._rep: list[float] = []
        self._block_id: list[int] = []
        self._group_of: list[int] = []
        self._row_of: list[int] = []
        self._key_to_group: dict[tuple, int] = {}
        self._group_types: list[str] = []
        self._group_params: list[tuple[str, ...]] = []
        self._group_rows: list[list[list]] = []

    def add(
        self,
        kind: str,
        layers: Sequence[tuple[str, Config]],
        collective_bytes: float = 0.0,
        repeat: float = 1.0,
    ) -> None:
        bid = len(self._kinds)
        self._kinds.append(str(kind))
        self._coll.append(float(collective_bytes))
        self._rep.append(float(repeat))
        for lt, cfg in layers:
            key = (lt, tuple(cfg))
            g = self._key_to_group.get(key)
            if g is None:
                g = len(self._group_types)
                self._key_to_group[key] = g
                self._group_types.append(lt)
                self._group_params.append(key[1])
                self._group_rows.append([])
            rows = self._group_rows[g]
            self._block_id.append(bid)
            self._group_of.append(g)
            self._row_of.append(len(rows))
            rows.append(list(cfg.values()))

    def build(self) -> "BlockBatch":
        configs = []
        for params, rows in zip(self._group_params, self._group_rows):
            arr = np.asarray(rows)
            if not np.issubdtype(arr.dtype, np.number):
                raise ValueError(f"non-numeric config value in layer params {params}")
            if not np.issubdtype(arr.dtype, np.integer):
                cast = arr.astype(np.int64)
                if not np.array_equal(cast, arr):
                    raise ValueError(
                        f"non-integer config value in layer params {params}"
                    )
                arr = cast
            configs.append(
                ConfigBatch(
                    params=params,
                    values=arr.astype(np.int64).reshape(len(rows), len(params)),
                )
            )
        return BlockBatch(
            kinds=tuple(self._kinds),
            collective_bytes=np.asarray(self._coll, dtype=np.float64),
            repeat=np.asarray(self._rep, dtype=np.float64),
            block_id=np.asarray(self._block_id, dtype=np.int64),
            group_of=np.asarray(self._group_of, dtype=np.int64),
            row_of=np.asarray(self._row_of, dtype=np.int64),
            group_types=tuple(self._group_types),
            group_configs=tuple(configs),
        )


@dataclasses.dataclass(frozen=True)
class BlockBatch:
    """``n`` multi-layer building blocks, stored as a ragged columnar table.

    The block analogue of :class:`ConfigBatch` (the whole-network path's unit
    of work, Eq. 9-12): per-block columns (``kinds``/``collective_bytes``/
    ``repeat``) plus a flat per-layer table in block-major order.  Each layer
    row carries its owning ``block_id`` and a ``(group_of, row_of)`` reference
    into one of the per-group :class:`ConfigBatch` columns — a *group* is one
    ``(layer_type, parameter key set)`` combination, so every group's configs
    columnarise into a single int64 matrix and a whole batch of blocks reaches
    a platform's vectorized timing model as a handful of ``ConfigBatch``es.

    Invariants: ``block_id`` is non-decreasing (layers stay in block order,
    and in layer order within a block), and group ``g``'s ConfigBatch holds
    exactly one row per layer of that group, in layer-table order (``row_of``
    is the running per-group index).  Like ConfigBatch, a batch is immutable;
    ``take``/``concat``/``dedup`` return new batches.
    """

    kinds: tuple[str, ...]
    collective_bytes: np.ndarray  # (n_blocks,) float64
    repeat: np.ndarray  # (n_blocks,) float64
    block_id: np.ndarray  # (n_layers,) int64, non-decreasing
    group_of: np.ndarray  # (n_layers,) int64 -> index into group_types/configs
    row_of: np.ndarray  # (n_layers,) int64 -> row in the group's ConfigBatch
    group_types: tuple[str, ...]  # layer type per group
    group_configs: tuple[ConfigBatch, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "kinds", tuple(str(k) for k in self.kinds))
        object.__setattr__(self, "group_types", tuple(self.group_types))
        object.__setattr__(self, "group_configs", tuple(self.group_configs))
        coll = np.asarray(self.collective_bytes, dtype=np.float64)
        rep = np.asarray(self.repeat, dtype=np.float64)
        bid = np.asarray(self.block_id, dtype=np.int64)
        gof = np.asarray(self.group_of, dtype=np.int64)
        rof = np.asarray(self.row_of, dtype=np.int64)
        n = len(self.kinds)
        if coll.shape != (n,) or rep.shape != (n,):
            raise ValueError("per-block columns must match the number of kinds")
        if not (bid.shape == gof.shape == rof.shape) or bid.ndim != 1:
            raise ValueError("per-layer columns must be 1-D and of equal length")
        if len(self.group_types) != len(self.group_configs):
            raise ValueError("group_types/group_configs length mismatch")
        if bid.size:
            if np.any(np.diff(bid) < 0):
                raise ValueError("block_id must be non-decreasing (block-major order)")
            if bid.min() < 0 or bid.max() >= n:
                raise ValueError("block_id out of range")
            if gof.min() < 0 or gof.max() >= len(self.group_types):
                raise ValueError("group_of out of range")
        for g, cfgs in enumerate(self.group_configs):
            rows = rof[gof == g]
            # Strict invariant (not just a range check): group g's ConfigBatch
            # holds exactly one row per layer, in layer-table order — which is
            # what lets scatter_groups hand a group's whole batch to a
            # vectorized timing model without a permutation copy.
            if rows.size != len(cfgs) or not np.array_equal(
                rows, np.arange(len(cfgs))
            ):
                raise ValueError(
                    f"row_of for group {g} must be the running per-group index"
                )
        object.__setattr__(self, "collective_bytes", coll)
        object.__setattr__(self, "repeat", rep)
        object.__setattr__(self, "block_id", bid)
        object.__setattr__(self, "group_of", gof)
        object.__setattr__(self, "row_of", rof)

    # ------------------------------------------------------------- construction
    @classmethod
    def from_blocks(cls, blocks: Sequence) -> "BlockBatch":
        """Columnarise block instances (anything with ``kind``/``layers``/
        ``collective_bytes``/``repeat`` attributes, canonically
        :class:`repro_torch.core.blocks.Block`).

        Groups key on the layer type plus the config's *insertion-order* key
        tuple (no per-layer sort: two orderings of the same key set land in
        separate groups, which measure identically and share canonical
        fingerprints), so the per-layer work is a couple of C-level tuple
        builds; each group's value matrix is validated and built in one numpy
        pass.  Raises ``ValueError`` when a layer config has non-integer
        values — callers at the block boundary catch it and fall back to the
        scalar ``measure_block`` path, which handles such configs as before.
        """
        kinds: list[str] = []
        coll: list[float] = []
        rep: list[float] = []
        key_to_group: dict[tuple, int] = {}
        group_types: list[str] = []
        group_params: list[tuple[str, ...]] = []
        group_rows: list[list[list]] = []
        block_id: list[int] = []
        group_of: list[int] = []
        row_of: list[int] = []
        for i, b in enumerate(blocks):
            kinds.append(str(b.kind))
            coll.append(float(getattr(b, "collective_bytes", 0.0)))
            rep.append(float(getattr(b, "repeat", 1)))
            for lt, cfg in b.layers:
                key = (lt, tuple(cfg))
                g = key_to_group.get(key)
                if g is None:
                    g = len(group_types)
                    key_to_group[key] = g
                    group_types.append(lt)
                    group_params.append(key[1])
                    group_rows.append([])
                rows = group_rows[g]
                block_id.append(i)
                group_of.append(g)
                row_of.append(len(rows))
                rows.append(list(cfg.values()))
        configs = []
        for params, rows in zip(group_params, group_rows):
            arr = np.asarray(rows)
            if not np.issubdtype(arr.dtype, np.number):
                raise ValueError(f"non-numeric config value in layer params {params}")
            if not np.issubdtype(arr.dtype, np.integer):
                cast = arr.astype(np.int64)
                if not np.array_equal(cast, arr):
                    # Refuse to silently truncate (e.g. 7.5 -> 7); callers fall
                    # back to the scalar path, which handles such configs.
                    raise ValueError(
                        f"non-integer config value in layer params {params}"
                    )
                arr = cast
            configs.append(
                ConfigBatch(
                    params=params,
                    values=arr.astype(np.int64).reshape(len(rows), len(params)),
                )
            )
        return cls(
            kinds=tuple(kinds),
            collective_bytes=np.asarray(coll, dtype=np.float64),
            repeat=np.asarray(rep, dtype=np.float64),
            block_id=np.asarray(block_id, dtype=np.int64),
            group_of=np.asarray(group_of, dtype=np.int64),
            row_of=np.asarray(row_of, dtype=np.int64),
            group_types=tuple(group_types),
            group_configs=tuple(configs),
        )

    @classmethod
    def from_template(
        cls,
        kind: str,
        layers: Sequence[tuple[str, ConfigBatch]],
        collective_bytes: np.ndarray | float = 0.0,
        repeat: np.ndarray | float = 1.0,
    ) -> "BlockBatch":
        """``n`` same-shaped blocks from per-slot config batches (columnar-native).

        The paper's calibration sets are exactly this: one block template
        (e.g. dense->dense->dense for an MLP block) instantiated with ~500
        sampled configurations per layer slot.  Block ``i`` takes row ``i``
        of every slot's :class:`ConfigBatch`, so the whole set is built with
        O(slots) Python work — blocks never exist as dicts on this path.
        """
        layers = list(layers)
        if not layers:
            raise ValueError("a block template needs at least one layer slot")
        n = len(layers[0][1])
        if any(len(cb) != n for _, cb in layers):
            raise ValueError("all layer slots must hold the same number of rows")
        n_slots = len(layers)
        batch = cls(
            kinds=(kind,) * n,
            collective_bytes=np.broadcast_to(
                np.asarray(collective_bytes, dtype=np.float64), (n,)
            ).copy(),
            repeat=np.broadcast_to(np.asarray(repeat, dtype=np.float64), (n,)).copy(),
            block_id=np.repeat(np.arange(n, dtype=np.int64), n_slots),
            group_of=np.tile(np.arange(n_slots, dtype=np.int64), n),
            row_of=np.repeat(np.arange(n, dtype=np.int64), n_slots),
            group_types=tuple(lt for lt, _ in layers),
            group_configs=tuple(cb for _, cb in layers),
        )
        # Every block shares one structure: fingerprints take the O(1)-slice
        # fast path (one canonical matrix tobytes, one slice per block).
        object.__setattr__(batch, "_template_slots", n_slots)
        return batch

    @classmethod
    def concat(cls, batches: Iterable["BlockBatch"]) -> "BlockBatch":
        """Stack block batches (group tables are re-merged by first occurrence).

        Columnar-native: groups keyed by ``(layer_type, params)`` are merged
        across batches with one :meth:`ConfigBatch.concat` per merged group —
        blocks never round-trip through ``Block`` objects.  For inputs whose
        groups are in first-occurrence order (every constructor produces
        this), the result is field-for-field identical to rebuilding via
        ``from_blocks(a.to_blocks() + b.to_blocks() + ...)``, fingerprints
        included (asserted in tests/test_block_batch.py).
        """
        batches = [b for b in batches if len(b)]
        if not batches:
            return cls(
                kinds=(),
                collective_bytes=np.zeros(0, dtype=np.float64),
                repeat=np.zeros(0, dtype=np.float64),
                block_id=np.empty(0, dtype=np.int64),
                group_of=np.empty(0, dtype=np.int64),
                row_of=np.empty(0, dtype=np.int64),
                group_types=(),
                group_configs=(),
            )
        if len(batches) == 1:
            return batches[0]
        key_to_group: dict[tuple, int] = {}
        group_types: list[str] = []
        #: per merged group: member ConfigBatches in append order
        members: list[list[ConfigBatch]] = []
        #: per merged group: rows accumulated so far (row_of offset)
        row_counts: list[int] = []
        group_of_parts: list[np.ndarray] = []
        row_of_parts: list[np.ndarray] = []
        block_id_parts: list[np.ndarray] = []
        block_offset = 0
        for b in batches:
            remap = np.empty(max(1, len(b.group_types)), dtype=np.int64)
            offsets = np.empty(max(1, len(b.group_types)), dtype=np.int64)
            for lg, (lt, cb) in enumerate(zip(b.group_types, b.group_configs)):
                key = (lt, cb.params)
                g = key_to_group.get(key)
                if g is None:
                    g = len(group_types)
                    key_to_group[key] = g
                    group_types.append(lt)
                    members.append([])
                    row_counts.append(0)
                remap[lg] = g
                offsets[lg] = row_counts[g]
                members[g].append(cb)
                row_counts[g] += len(cb)
            group_of_parts.append(remap[b.group_of])
            row_of_parts.append(b.row_of + offsets[b.group_of])
            block_id_parts.append(b.block_id + block_offset)
            block_offset += len(b)
        out = cls(
            kinds=tuple(k for b in batches for k in b.kinds),
            collective_bytes=np.concatenate([b.collective_bytes for b in batches]),
            repeat=np.concatenate([b.repeat for b in batches]),
            block_id=np.concatenate(block_id_parts),
            group_of=np.concatenate(group_of_parts),
            row_of=np.concatenate(row_of_parts),
            group_types=tuple(group_types),
            group_configs=tuple(ConfigBatch.concat(m) for m in members),
        )
        memos = [b.__dict__.get("_fingerprints") for b in batches]
        if all(m is not None for m in memos):
            # fingerprints are per-block and order-preserving: stitch, don't
            # recompute
            object.__setattr__(out, "_fingerprints", [fp for m in memos for fp in m])
        return out

    # ------------------------------------------------------------- inspection
    def __len__(self) -> int:
        return len(self.kinds)

    @property
    def n_layers(self) -> int:
        return int(self.block_id.shape[0])

    def _indptr(self) -> np.ndarray:
        """(n_blocks + 1,) layer-table offsets per block (block_id is sorted)."""
        return np.searchsorted(self.block_id, np.arange(len(self) + 1))

    def layer_counts(self) -> np.ndarray:
        """(n_blocks,) number of layers per block."""
        return np.bincount(self.block_id, minlength=len(self))

    def scatter_groups(self, fn) -> np.ndarray:
        """(n_layers,) float64: ``fn(layer_type, ConfigBatch)`` per group,
        scattered back to layer-table order.

        The shared walk of the block engine's consumers (timing models,
        predictions, op counts): each group's whole ConfigBatch goes to one
        vectorized call — no per-layer work, no permutation copies (the
        ``row_of`` running-index invariant guarantees group rows are already
        in layer-table order).
        """
        out = np.zeros(self.n_layers, dtype=np.float64)
        for g, (lt, cfgs) in enumerate(zip(self.group_types, self.group_configs)):
            out[self.group_of == g] = np.asarray(fn(lt, cfgs), dtype=np.float64)
        return out

    def sum_by_block(self, per_layer: np.ndarray) -> np.ndarray:
        """(n_blocks,) sums of a per-layer column, accumulated in layer order.

        ``np.bincount`` adds weights in array order, i.e. each block's layers
        fold left exactly like a scalar ``sum`` loop — bitwise identical.
        """
        return np.bincount(
            self.block_id, weights=per_layer, minlength=len(self)
        ).astype(np.float64, copy=False)

    def to_blocks(self) -> list:
        """Back to :class:`repro_torch.core.blocks.Block` instances (exact values)."""
        from repro_torch.core.blocks import Block  # deferred: blocks.py is a heavier layer

        group_rows = [cb.to_dicts() for cb in self.group_configs]
        layers: list[list] = [[] for _ in range(len(self))]
        for bi, g, r in zip(
            self.block_id.tolist(), self.group_of.tolist(), self.row_of.tolist()
        ):
            layers[bi].append((self.group_types[g], group_rows[g][r]))
        coll = self.collective_bytes.tolist()
        rep = self.repeat.tolist()
        return [
            Block(
                kind=self.kinds[i],
                layers=tuple(layers[i]),
                collective_bytes=coll[i],
                repeat=rep[i],
            )
            for i in range(len(self))
        ]

    @staticmethod
    def _layer_structure(layer_type: str, sorted_params: Sequence[str]) -> str:
        """Canonical string for one layer's shape: type + sorted param names.

        ``\\x1f`` separates fields and ``\\x1e`` separates layers in a block's
        structure string — control characters that cannot appear in sane
        layer-type/parameter identifiers, so structures cannot collide.
        """
        return layer_type + "\x1f" + "\x1f".join(sorted_params)

    def fingerprints(self) -> list[tuple]:
        """Canonical measurement key per block (memoized: batches are immutable).

        Two blocks share a fingerprint iff a platform must time them
        identically: same layer sequence (type + config, order preserved) and
        same collective payload.  ``kind`` and ``repeat`` are deliberately
        excluded — they change how a block's time is *combined* (Eq. 9/12),
        not what is measured.

        A fingerprint is ``("block", structure, values_bytes, coll)`` where
        ``structure`` joins each layer's :meth:`_layer_structure` with
        ``\\x1e`` and ``values_bytes`` concatenates each layer's
        sorted-by-param int64 values — a string and a bytes object, both of
        which cache their hashes, so building and probing a million-layer
        cache costs one ``tobytes`` per group plus one slice/join per block.
        Template batches (``from_template``) share one structure string and
        one canonical matrix, making the per-block cost a single bytes
        slice.  The scalar twin is :func:`repro_torch.api.cache.block_key`.
        """
        memo = self.__dict__.get("_fingerprints")
        if memo is not None:
            return memo
        coll = self.collective_bytes.tolist()
        sorted_cols = []
        for lt, cb in zip(self.group_types, self.group_configs):
            order = sorted(range(len(cb.params)), key=lambda j: cb.params[j])
            sorted_cols.append((tuple(cb.params[j] for j in order), order))
        n_slots = self.__dict__.get("_template_slots")
        if n_slots is not None:
            # Template fast path: one structure, one (n, total_width) matrix.
            structure = "\x1e".join(
                self._layer_structure(lt, sp)
                for lt, (sp, _) in zip(self.group_types, sorted_cols)
            )
            mats = [
                np.ascontiguousarray(cb.values[:, order])
                for cb, (_, order) in zip(self.group_configs, sorted_cols)
            ]
            blob = (
                np.concatenate(mats, axis=1).tobytes() if mats else b""
            )
            stride = sum(m.shape[1] for m in mats) * 8
            if stride == 0:
                memo = [("block", structure, b"", c) for c in coll]
            else:
                memo = [
                    ("block", structure, blob[i * stride : (i + 1) * stride], c)
                    for i, c in enumerate(coll)
                ]
            object.__setattr__(self, "_fingerprints", memo)
            return memo
        # General (ragged) path: per-layer slices, joined per block.
        group_structs: list[str] = []
        group_bytes: list[list[bytes]] = []
        for (lt, cb), (sp, order) in zip(
            zip(self.group_types, self.group_configs), sorted_cols
        ):
            group_structs.append(self._layer_structure(lt, sp))
            blob = np.ascontiguousarray(cb.values[:, order]).tobytes()
            width = len(cb.params) * 8
            stride = max(1, width)
            group_bytes.append(
                [blob[k * stride : k * stride + width] for k in range(len(cb))]
            )
        gof = self.group_of.tolist()
        layer_structs = [group_structs[g] for g in gof]
        layer_bytes = [group_bytes[g][r] for g, r in zip(gof, self.row_of.tolist())]
        indptr = self._indptr().tolist()
        memo = [
            (
                "block",
                "\x1e".join(layer_structs[indptr[i] : indptr[i + 1]]),
                b"".join(layer_bytes[indptr[i] : indptr[i + 1]]),
                coll[i],
            )
            for i in range(len(self))
        ]
        object.__setattr__(self, "_fingerprints", memo)
        return memo

    # ------------------------------------------------------------- derivation
    def take(self, rows: np.ndarray) -> "BlockBatch":
        """Block sub-batch in the given order (layer/group tables rebuilt)."""
        rows = np.asarray(rows, dtype=np.int64)
        n_slots = self.__dict__.get("_template_slots")
        if n_slots is not None and rows.size:
            # Template batches stay templates: one fancy-index per slot.
            sub = BlockBatch.from_template(
                self.kinds[0],
                [
                    (lt, cb.take(rows))
                    for lt, cb in zip(self.group_types, self.group_configs)
                ],
                collective_bytes=self.collective_bytes[rows],
                repeat=self.repeat[rows],
            )
            memo = self.__dict__.get("_fingerprints")
            if memo is not None:
                object.__setattr__(
                    sub, "_fingerprints", [memo[i] for i in rows.tolist()]
                )
            return sub
        indptr = self._indptr()
        counts = indptr[rows + 1] - indptr[rows]
        total = int(counts.sum())
        # concatenated per-block layer ranges, without a Python loop
        out_start = np.repeat(np.cumsum(counts) - counts, counts)
        layer_idx = np.repeat(indptr[rows], counts) + (np.arange(total) - out_start)
        old_group = self.group_of[layer_idx]
        old_row = self.row_of[layer_idx]
        # groups kept in first-occurrence order of the new layer table
        group_of = np.empty(total, dtype=np.int64)
        row_of = np.empty(total, dtype=np.int64)
        group_types: list[str] = []
        group_configs: list[ConfigBatch] = []
        if total:
            uniq, first = np.unique(old_group, return_index=True)
            for g in uniq[np.argsort(first, kind="stable")].tolist():
                mask = old_group == g
                group_of[mask] = len(group_types)
                row_of[mask] = np.arange(int(mask.sum()))
                group_types.append(self.group_types[g])
                group_configs.append(self.group_configs[g].take(old_row[mask]))
        sub = BlockBatch(
            kinds=tuple(self.kinds[i] for i in rows.tolist()),
            collective_bytes=self.collective_bytes[rows],
            repeat=self.repeat[rows],
            block_id=np.repeat(np.arange(len(rows), dtype=np.int64), counts),
            group_of=group_of,
            row_of=row_of,
            group_types=tuple(group_types),
            group_configs=tuple(group_configs),
        )
        memo = self.__dict__.get("_fingerprints")
        if memo is not None:  # fingerprints are per-block: reuse, don't recompute
            object.__setattr__(
                sub, "_fingerprints", [memo[i] for i in rows.tolist()]
            )
        return sub

    def dedup(self) -> tuple["BlockBatch", np.ndarray, np.ndarray]:
        """Unique blocks (by measurement fingerprint) in first-occurrence order.

        Returns ``(unique, first_rows, inverse)`` analogous to
        :meth:`ConfigBatch.dedup`; duplicates are judged by
        :meth:`fingerprints`, so two blocks differing only in ``kind`` or
        ``repeat`` collapse onto one measurement.
        """
        if len(self) == 0:
            return self, np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        first_pos: dict[tuple, int] = {}
        first_rows: list[int] = []
        inverse = np.empty(len(self), dtype=np.int64)
        for i, key in enumerate(self.fingerprints()):
            pos = first_pos.get(key)
            if pos is None:
                pos = len(first_rows)
                first_pos[key] = pos
                first_rows.append(i)
            inverse[i] = pos
        rows = np.asarray(first_rows, dtype=np.int64)
        return self.take(rows), rows, inverse

    # ------------------------------------------------------------- serialization
    def to_payload(self) -> dict:
        """Plain JSON-able structure (journal records, cross-host transport)."""
        return {
            "kinds": list(self.kinds),
            "collective_bytes": self.collective_bytes.tolist(),
            "repeat": self.repeat.tolist(),
            "block_id": self.block_id.tolist(),
            "group_of": self.group_of.tolist(),
            "row_of": self.row_of.tolist(),
            "groups": [
                {"layer_type": lt, "params": list(cb.params), "values": cb.values.tolist()}
                for lt, cb in zip(self.group_types, self.group_configs)
            ],
        }

    @classmethod
    def from_payload(cls, payload: Mapping) -> "BlockBatch":
        """Inverse of :meth:`to_payload`; raises on malformed payloads."""
        groups = payload["groups"]
        return cls(
            kinds=tuple(payload["kinds"]),
            collective_bytes=np.asarray(payload["collective_bytes"], dtype=np.float64),
            repeat=np.asarray(payload["repeat"], dtype=np.float64),
            block_id=np.asarray(payload["block_id"], dtype=np.int64),
            group_of=np.asarray(payload["group_of"], dtype=np.int64),
            row_of=np.asarray(payload["row_of"], dtype=np.int64),
            group_types=tuple(g["layer_type"] for g in groups),
            group_configs=tuple(
                ConfigBatch(
                    params=tuple(g["params"]),
                    values=np.asarray(g["values"], dtype=np.int64).reshape(
                        -1, len(g["params"])
                    ),
                )
                for g in groups
            ),
        )
