"""PerfOracle: the uniform query surface over trained layer estimators.

Every consumer of trained estimators — whole-network estimation
(:mod:`repro_torch.core.blocks`), the distribution advisor
(:mod:`repro_torch.core.advisor`), serving (:mod:`repro_torch.launch.serve`) — queries
through the same object and the same batched entry point,
``predict(layer_type, configs)``.

Network prediction is batch-vectorized: all layer instances across all blocks
are grouped by layer type and pushed through each forest in **one**
``predict`` call per type, instead of one call per layer.  A 40-layer network
with 3 layer types costs 3 forest traversal batches, not 120 single-row calls.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.core.batch import ConfigBatch
from repro_torch.core.blocks import Block, FusingModel
from repro_torch.core.estimator import LayerEstimator
from repro_torch.core.forest import mape, rmspe
from repro_torch.core.network import simulate_networks
from repro_torch.core.prs import Config
from repro_torch.obs.trace import span


@dataclasses.dataclass
class PerfOracle:
    """Batched query surface over per-layer-type estimators (Eq. 7-12)."""

    estimators: Mapping[str, LayerEstimator]
    fusing: Mapping[str, FusingModel] = dataclasses.field(default_factory=dict)
    #: block kinds whose layers execute on overlapping FUs (Eq. 9 max rule)
    overlap_kinds: frozenset[str] = frozenset()
    #: documented per-launch overhead (gray-box knowledge)
    launch_overhead_s: float = 0.0
    platform_name: str = ""
    #: provenance: RunStats snapshot of the campaign run that trained this
    #: oracle (measured/cached/replayed counts, throughput); None when the
    #: campaign ran without a measurement runtime or the oracle was reloaded.
    run_stats: Mapping[str, float] | None = None
    #: default predict backend for this oracle ("torch" | "numpy"); None
    #: means "torch" (see repro_torch.core.torch_predict).  A runtime knob,
    #: not part of the persisted estimator format.
    predict_backend: str | None = None
    #: where the "torch" backend runs: "cuda" unless this is "cpu"; without a
    #: card it raises.  A runtime knob, like ``predict_backend``.
    device: str | None = None

    # ------------------------------------------------------------ single layer
    def layer_types(self) -> tuple[str, ...]:
        return tuple(self.estimators)

    def predict(
        self,
        layer_type: str,
        configs: Sequence[Config] | ConfigBatch,
        backend: str | None = None,
    ) -> np.ndarray:
        """Batched Eq. 7/8 prediction for one layer type.

        Accepts dict lists or a :class:`ConfigBatch`; either way the snap,
        feature build and forest traversal run columnarly end to end.

        ``backend`` (or the oracle's ``predict_backend`` default) selects the
        traversal engine; layer predictions are bitwise-identical across
        backends.  Only real :class:`LayerEstimator` instances see the
        parameter — duck-typed estimator stubs are called as before.
        """
        est = self.estimators[layer_type]
        if isinstance(est, LayerEstimator):
            b = self._backend(backend)
            return np.asarray(est.predict(configs, backend=b), dtype=np.float64)
        if hasattr(est, "predict"):
            return np.asarray(est.predict(configs), dtype=np.float64)
        # Minimal estimator stubs (tests, analytical models) may expose only
        # predict_one; degrade to a per-config loop.
        if isinstance(configs, ConfigBatch):
            configs = configs.to_dicts()
        return np.array([est.predict_one(c) for c in configs], dtype=np.float64)

    def _backend(self, backend):
        """``"numpy"`` or the resolved ``torch.device`` for one call."""
        from repro_torch.core import torch_predict

        b = backend if backend is not None else self.predict_backend
        return torch_predict.resolve_backend(b, self.device)

    def predict_one(self, layer_type: str, cfg: Config) -> float:
        return float(self.predict(layer_type, [cfg])[0])

    def predict_many(
        self,
        items: Sequence[tuple[str, Sequence[Config] | ConfigBatch]],
        backend: str | None = None,
    ) -> list[np.ndarray]:
        """Batch-entry hook for coalesced serving: many ``(layer_type, configs)``
        requests through **one** forest pass per ``(layer_type, params)`` group.

        This is what the serving layer's admission batcher calls: concurrent
        ``predict`` requests for the same layer type are concatenated into a
        single :meth:`predict` call and each requester is answered from its
        slice.  Forest predictions are row-independent, so every slice is
        bitwise identical to a standalone ``predict`` call (asserted in
        tests/test_serving.py).  Heterogeneous/dict-list items predict
        standalone, identically.
        """
        items = [
            (
                lt,
                cfgs
                if isinstance(cfgs, ConfigBatch)
                else ConfigBatch.from_dicts(list(cfgs)),
            )
            for lt, cfgs in items
        ]
        groups: dict[tuple, list[int]] = {}
        for i, (lt, batch) in enumerate(items):
            groups.setdefault((lt, batch.params), []).append(i)
        out: list[np.ndarray | None] = [None] * len(items)
        sp = span("oracle.predict_many", cat="oracle")
        if sp:
            sp.set(items=len(items), groups=len(groups))
        with sp:
            for (lt, _params), idxs in groups.items():
                merged = ConfigBatch.concat([items[i][1] for i in idxs])
                y = self.predict(lt, merged, backend=backend)
                a = 0
                for i in idxs:
                    n = len(items[i][1])
                    out[i] = y[a : a + n]
                    a += n
        return out  # type: ignore[return-value]

    def evaluate(
        self, platform: Platform, layer_type: str, test_configs: Sequence[Config]
    ) -> dict[str, float]:
        y_true = platform.measure_many(layer_type, list(test_configs))
        y_pred = self.predict(layer_type, test_configs)
        return {"mape": mape(y_true, y_pred), "rmspe": rmspe(y_true, y_pred)}

    # ------------------------------------------------------------ whole network
    def layer_times(
        self, blocks: Sequence[Block], backend: str | None = None
    ) -> list[list[float]]:
        """Per-block per-layer times via one batched predict per layer type.

        Public building block for whole-network combination: callers that
        need raw per-layer estimates grouped by block (e.g.
        :func:`repro_torch.core.blocks.fit_fusing_model`) use this instead of a
        ``predict_one`` loop — a 40-layer network with 3 layer types costs 3
        forest passes, not 120 single-row calls.  Each layer type's configs
        are columnarised into one :class:`ConfigBatch` (snap, features and
        forest traversal all run columnar); ragged or non-integer key sets
        stay on the dict-list path, which predicts identically.
        """
        by_type: dict[str, list[Config]] = {}
        slots: list[list[tuple[str, int]]] = []
        for block in blocks:
            block_slots = []
            for lt, cfg in block.layers:
                batch = by_type.setdefault(lt, [])
                block_slots.append((lt, len(batch)))
                batch.append(cfg)
            slots.append(block_slots)
        preds = {}
        for lt, cfgs in by_type.items():
            try:
                configs: Sequence[Config] | ConfigBatch = ConfigBatch.from_dicts(cfgs)
            except ValueError:
                configs = cfgs  # heterogeneous keys / non-integer values
            preds[lt] = self.predict(lt, configs, backend=backend)
        return [[float(preds[lt][i]) for lt, i in block_slots] for block_slots in slots]

    def layer_time_sums(self, batch, backend: str | None = None) -> np.ndarray:
        """Per-block summed layer estimates for a whole :class:`BlockBatch`.

        The columnar-native sibling of :meth:`layer_times` for consumers that
        only need each block's layer-time sum (Eq. 10's first term): one
        batched ``predict`` per layer group, then a ``bincount`` left fold
        per block — bitwise-identical to summing :meth:`layer_times` rows.
        """
        return batch.sum_by_block(
            batch.scatter_groups(lambda lt, cfgs: self.predict(lt, cfgs, backend=backend))
        )

    def _combine(self, block: Block, times: Sequence[float]) -> float:
        if block.kind in self.overlap_kinds:
            t = max(times)  # Eq. 9
        else:
            t = sum(times) - self.launch_overhead_s * max(0, len(times) - 1)
            if block.kind in self.fusing:
                t = t - self.fusing[block.kind](block)  # Eq. 10/11
        return max(t, self.launch_overhead_s if times else 0.0)

    def predict_block(self, block: Block) -> float:
        return self._combine(block, self.layer_times([block])[0])

    def predict_network(self, blocks: Sequence[Block]) -> float:
        """Eq. 12 with one batched forest pass per layer type."""
        return float(self.predict_networks([blocks])[0])

    def predict_network_batch(
        self,
        batch,
        net_id: np.ndarray | None = None,
        n_nets: int | None = None,
        backend: str | None = None,
    ) -> np.ndarray:
        """Eq. 9-12 over a :class:`~repro_torch.core.batch.BlockBatch`, columnarly.

        ``net_id`` assigns each block to a network (default: one block per
        network); returns the ``(n_nets,)`` step-time estimates.  The whole
        combination is array arithmetic mirroring :meth:`_combine` operation
        for operation — per-block ``bincount`` sums / ``maximum.at`` maxes
        accumulate in layer-table order, so results are bitwise identical to
        the scalar block loop.  Under the torch backend the forest traversal
        *and* this combination run on the oracle's device
        (:func:`repro_torch.core.torch_predict.predict_network_batch_torch`),
        with the log-target ``exp`` there too: torch network results are
        within rtol 1e-12 of numpy, and bitwise on the CPU when no estimator
        is log-target — see that module's parity contract.
        """
        n_blocks = len(batch)
        if net_id is None:
            net_id = np.arange(n_blocks, dtype=np.int64)
            if n_nets is None:
                n_nets = n_blocks
        net_id = np.asarray(net_id, dtype=np.int64)
        if n_nets is None:
            n_nets = int(net_id.max()) + 1 if net_id.size else 0
        b = backend if backend is not None else self.predict_backend
        counts = batch.layer_counts()
        overlap = np.array([k in self.overlap_kinds for k in batch.kinds], dtype=bool)
        if bool(np.any(overlap & (counts == 0))):
            # Scalar semantics: _combine runs max() on an empty sequence.
            raise ValueError(
                "overlap block with zero layers: Eq. 9 needs at least one layer"
            )
        if n_blocks:
            from repro_torch.core import torch_predict

            device = self._backend(b)
            if device != "numpy":
                y = torch_predict.predict_network_batch_torch(
                    self, batch, net_id, n_nets, device
                )
                if y is not None:
                    return y
        times = batch.scatter_groups(
            lambda lt, cfgs: self.predict(lt, cfgs, backend=b)
        )
        sums = batch.sum_by_block(times)
        t = sums - self.launch_overhead_s * np.maximum(0, counts - 1)
        fused = np.zeros(n_blocks, dtype=bool)
        w = np.zeros(n_blocks, dtype=np.float64)
        c = np.zeros(n_blocks, dtype=np.float64)
        for i, kind in enumerate(batch.kinds):
            fm = self.fusing.get(kind)
            if fm is not None and kind not in self.overlap_kinds:
                fused[i] = True
                w[i] = fm.w
                c[i] = fm.c
        if fused.any():
            from repro_torch.core.blocks import block_ops_batch

            t = np.where(fused, t - (block_ops_batch(batch) * w + c), t)
        if overlap.any():
            maxs = np.full(n_blocks, -np.inf)
            np.maximum.at(maxs, batch.block_id, times)
            t = np.where(overlap, maxs, t)
        t = np.maximum(t, np.where(counts > 0, self.launch_overhead_s, 0.0))
        return np.bincount(
            net_id, weights=t * batch.repeat, minlength=int(n_nets)
        ).astype(np.float64, copy=False)

    def predict_networks(
        self, networks: Sequence[Sequence[Block]], backend: str | None = None
    ) -> np.ndarray:
        """Eq. 12 over many networks, one forest pass per layer type *total*.

        All networks' blocks flatten into one :class:`BlockBatch` and ride
        :meth:`predict_network_batch` (columnar, on the device under the
        torch backend), so estimating 24 candidate meshes with 3 layer types costs
        3 forest traversal batches, not 72.  Forest predictions are
        row-independent and the combination accumulates in block order, so
        every network's estimate is bitwise identical to a standalone
        ``predict_network`` call (on the numpy backend; see
        :meth:`predict_network_batch` for the torch tolerance).  Networks whose
        configs cannot columnarise (ragged keys, non-integer values) fall
        back to the per-row combination with identical results.
        """
        from repro_torch.core.batch import BlockBatch

        networks = [list(net) for net in networks]
        flat = [b for net in networks for b in net]
        if not flat:
            return np.zeros(len(networks), dtype=np.float64)
        sp = span("oracle.predict_networks", cat="oracle")
        if sp:
            sp.set(networks=len(networks), blocks=len(flat))
        with sp:
            try:
                batch = BlockBatch.from_blocks(flat)
            except (ValueError, TypeError):
                return self._predict_networks_rows(networks, backend)
            sizes = [len(net) for net in networks]
            net_id = np.repeat(np.arange(len(networks), dtype=np.int64), sizes)
            return self.predict_network_batch(
                batch, net_id, len(networks), backend=backend
            )

    def _predict_networks_rows(
        self, networks: Sequence[list[Block]], backend: str | None = None
    ) -> np.ndarray:
        """Per-row Eq. 9-12 fallback for networks that cannot columnarise."""
        flat = [b for net in networks for b in net]
        all_times = self.layer_times(flat, backend=backend)
        out = np.empty(len(networks), dtype=np.float64)
        i = 0
        for j, net in enumerate(networks):
            t = 0.0
            for b in net:
                t += self._combine(b, all_times[i]) * b.repeat
                i += 1
            out[j] = t
        return out

    def network_keys(
        self, networks: Sequence[Sequence[Block]]
    ) -> list[tuple | None]:
        """Canonical result-cache key per network (the serving layer's LRU key).

        Built from the blocks' measurement fingerprints
        (:meth:`repro_torch.core.batch.BlockBatch.fingerprints`) **plus** each
        block's ``kind`` and ``repeat`` — the fingerprint deliberately
        excludes those because they don't change what a platform measures,
        but they *do* change how this oracle combines layer times (Eq. 9/12),
        so a prediction cache must key on them.  Networks whose configs can't
        be fingerprinted (non-integer values) get ``None`` — callers skip
        caching and predict directly.
        """
        from repro_torch.core.batch import BlockBatch

        out: list[tuple | None] = []
        for net in networks:
            net = list(net)
            if not net:
                out.append(("net",))
                continue
            try:
                bb = BlockBatch.from_blocks(net)
            except (ValueError, TypeError):
                out.append(None)
                continue
            out.append(
                (
                    "net",
                    tuple(
                        (fp, kind, rep)
                        for fp, kind, rep in zip(
                            bb.fingerprints(), bb.kinds, bb.repeat.tolist()
                        )
                    ),
                )
            )
        return out

    def evaluate_networks(
        self, platform: Platform, networks: Sequence[Sequence[Block]]
    ) -> dict[str, float]:
        """MAPE/RMSPE of whole-network estimates against measured ground truth.

        Ground truth rides the columnar block path (all networks measured as
        one block batch, see :func:`repro_torch.core.network.simulate_networks`);
        predictions use :meth:`predict_networks`.  Raises ``TypeError`` when
        the platform cannot measure blocks: silently accumulating ``0.0``
        ground truth would return nan/inf error metrics that read like a
        result instead of a broken setup.
        """
        if not hasattr(platform, "measure_block"):
            raise TypeError(
                f"platform {getattr(platform, 'name', platform)!r} does not "
                "implement measure_block(); cannot measure whole-network "
                "ground truth for evaluation"
            )
        networks = [list(net) for net in networks]
        y_true = np.asarray(simulate_networks(platform, networks), dtype=np.float64)
        y_pred = self.predict_networks(networks)
        return {"mape": mape(y_true, y_pred), "rmspe": rmspe(y_true, y_pred)}

    # ------------------------------------------------------------ persistence
    def save(self, hub, platform_name: str | None = None) -> None:
        """Persist every layer estimator and the combination params (Eq. 9-11)."""
        name = platform_name or self.platform_name or "default"
        for est in self.estimators.values():
            hub.save(name, est)
        hub.save_oracle_meta(
            name,
            {
                "fusing": {
                    kind: {"w": fm.w, "c": fm.c, "n_fit": fm.n_fit}
                    for kind, fm in self.fusing.items()
                },
                "overlap_kinds": sorted(self.overlap_kinds),
                "launch_overhead_s": self.launch_overhead_s,
            },
        )

    @classmethod
    def load(
        cls,
        hub,
        platform_name: str,
        layer_types: Sequence[str] | None = None,
        **kwargs,
    ) -> "PerfOracle":
        """Reload a persisted oracle; inverse of :meth:`save`.

        Combination params (fusing models, overlap kinds, launch overhead)
        come back from the hub's oracle meta; explicit ``kwargs`` win, and
        take the runtime knobs too (``predict_backend``, ``device``).
        """
        if layer_types is None:
            ests = hub.load_all(platform_name)
        else:
            ests = {lt: hub.load(platform_name, lt) for lt in layer_types}
        if not ests:
            raise FileNotFoundError(
                f"no persisted estimators for platform {platform_name!r} in {hub.directory}"
            )
        meta = hub.load_oracle_meta(platform_name)
        restored = {
            "fusing": {
                kind: FusingModel(w=fm["w"], c=fm["c"], n_fit=fm.get("n_fit", 0))
                for kind, fm in meta.get("fusing", {}).items()
            },
            "overlap_kinds": frozenset(meta.get("overlap_kinds", ())),
            "launch_overhead_s": meta.get("launch_overhead_s", 0.0),
        }
        restored.update(kwargs)
        return cls(estimators=ests, platform_name=platform_name, **restored)
