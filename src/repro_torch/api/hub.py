"""EstimatorHub: persist and reload trained ``LayerEstimator``s.

A trained estimator is (forest trees + step widths + parameter space + a
little bookkeeping).  The hub stores each one through the repo's atomic
:class:`~repro_torch.checkpoint.manager.CheckpointManager` (tmp-staging + rename, so
a crash mid-save never corrupts the latest copy) under::

    <dir>/<platform>/<layer_type>/step_000000001/
        arrays.npz      -- per-tree node arrays + a JSON meta blob
        manifest.json   -- key/shape/dtype manifest

Loading reconstructs a bitwise-identical estimator: tree arrays round-trip
exactly through ``npz`` so predictions after ``save -> load`` match the
original to the last bit (asserted in tests/test_api.py).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.estimator import LayerEstimator
from repro_torch.core.forest import RandomForestRegressor, _Tree
from repro_torch.core.prs import ParamSpace

_TREE_FIELDS = ("feature", "threshold", "left", "right", "value")


def _safe(name: str) -> str:
    """Filesystem-safe directory component (``tpu_v5e[gray]`` -> ``tpu_v5e_gray``)."""
    return re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("_")


def _estimator_to_tree(est: LayerEstimator) -> dict:
    meta = {
        "layer_type": est.layer_type,
        "params": list(est.params),
        "widths": {p: int(w) for p, w in est.widths.items()},
        "space": {
            "ranges": {p: [int(lo), int(hi)] for p, (lo, hi) in est.space.ranges.items()},
            "fixed": {p: int(v) for p, v in est.space.fixed.items()},
        },
        "n_train": est.n_train,
        "n_sweep": est.n_sweep,
        "mean_measure_seconds": est.mean_measure_seconds,
        "sampling": est.sampling,
        "log_target": est.log_target,
        "forest": {
            "n_estimators": est.forest.n_estimators,
            "max_depth": est.forest.max_depth,
            "min_samples_leaf": est.forest.min_samples_leaf,
            "max_features": est.forest.max_features,
            "bootstrap": est.forest.bootstrap,
            "seed": est.forest.seed,
        },
    }
    tree = {
        "meta": np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        "trees": {
            str(i): {f: getattr(t, f) for f in _TREE_FIELDS}
            for i, t in enumerate(est.forest._trees)
        },
    }
    return tree


def _estimator_from_tree(tree: dict) -> LayerEstimator:
    meta = json.loads(bytes(np.asarray(tree["meta"], dtype=np.uint8)).decode("utf-8"))
    fk = meta["forest"]
    forest = RandomForestRegressor(
        n_estimators=fk["n_estimators"],
        max_depth=fk["max_depth"],
        min_samples_leaf=fk["min_samples_leaf"],
        max_features=fk["max_features"],
        bootstrap=fk["bootstrap"],
        seed=fk["seed"],
    )
    forest._trees = [
        _Tree(
            feature=np.asarray(t["feature"], dtype=np.int32),
            threshold=np.asarray(t["threshold"], dtype=np.float64),
            left=np.asarray(t["left"], dtype=np.int32),
            right=np.asarray(t["right"], dtype=np.int32),
            value=np.asarray(t["value"], dtype=np.float64),
        )
        for _, t in sorted(tree["trees"].items(), key=lambda kv: int(kv[0]))
    ]
    space = ParamSpace(
        ranges={p: (lo, hi) for p, (lo, hi) in meta["space"]["ranges"].items()},
        fixed=dict(meta["space"]["fixed"]),
    )
    return LayerEstimator(
        layer_type=meta["layer_type"],
        params=tuple(meta["params"]),
        widths=dict(meta["widths"]),
        space=space,
        forest=forest,
        n_train=meta["n_train"],
        n_sweep=meta["n_sweep"],
        mean_measure_seconds=meta["mean_measure_seconds"],
        sampling=meta["sampling"],
        log_target=meta["log_target"],
    )


def _skeleton_from_keys(keys: list[str]) -> dict:
    """Nested-dict skeleton matching CheckpointManager's flat key paths."""
    root: dict = {}
    for key in keys:
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = None
    return root


class EstimatorHub:
    """Directory of persisted estimators, one CheckpointManager per slot."""

    def __init__(self, directory: str, keep: int = 2) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _manager(self, platform_name: str, layer_type: str) -> CheckpointManager:
        path = os.path.join(self.directory, _safe(platform_name), _safe(layer_type))
        return CheckpointManager(path, keep=self.keep)

    # ----------------------------------------------------------------- save
    def save(self, platform_name: str, est: LayerEstimator) -> str:
        mgr = self._manager(platform_name, est.layer_type)
        step = (mgr.latest_step() or 0) + 1
        return mgr.save(step, _estimator_to_tree(est))

    # ----------------------------------------------------------------- load
    def has(self, platform_name: str, layer_type: str) -> bool:
        path = os.path.join(self.directory, _safe(platform_name), _safe(layer_type))
        return os.path.isdir(path) and bool(CheckpointManager(path, keep=self.keep).all_steps())

    def load(self, platform_name: str, layer_type: str) -> LayerEstimator:
        mgr = self._manager(platform_name, layer_type)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no persisted estimator for {platform_name}/{layer_type} in {self.directory}"
            )
        path = os.path.join(mgr.directory, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        skeleton = _skeleton_from_keys(manifest["keys"])
        tree, _ = mgr.restore(skeleton, step=step)
        return _estimator_from_tree(tree)

    def load_all(self, platform_name: str) -> dict[str, LayerEstimator]:
        out = {}
        for lt in self.layer_types(platform_name):
            est = self.load(platform_name, lt)
            out[est.layer_type] = est  # true layer type, not the dir name
        return out

    # ------------------------------------------------------------- oracle meta
    def save_oracle_meta(self, platform_name: str, meta: dict) -> str:
        """Persist oracle-level combination params (fusing, overlap, overhead)."""
        root = os.path.join(self.directory, _safe(platform_name))
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, "oracle.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)
        return path

    def load_oracle_meta(self, platform_name: str) -> dict:
        path = os.path.join(self.directory, _safe(platform_name), "oracle.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    # --------------------------------------------------------------------- gc
    def gc(self, keep: int | None = None, compact_journal: bool = True) -> dict:
        """Drop superseded artifacts: old estimator steps, stale staging dirs,
        and (optionally) duplicate journal records.

        ``CheckpointManager`` already garbage-collects on *save*, but a hub
        that only ever loads (a long-lived oracle server) never saves — its
        directory keeps whatever the last campaign left: superseded
        ``step_*`` dirs beyond ``keep``, ``.tmp`` staging dirs from crashed
        saves, and an append-only measurement journal full of duplicate
        records.  This is the explicit GC hook (the serving layer's ``gc``
        op calls it).  The latest checkpoint per slot is never touched, so
        reloads after ``gc`` are bitwise identical.

        Returns ``{"steps_removed", "tmp_removed", "journal": compact stats
        or None}``.
        """
        import shutil

        keep = self.keep if keep is None else keep
        steps_removed = tmp_removed = 0
        for platform in self.platforms():
            for layer_type in self.layer_types(platform):
                slot = os.path.join(self.directory, platform, layer_type)
                mgr = CheckpointManager(slot, keep=max(1, keep))
                steps = mgr.all_steps()
                for step in steps[: -max(1, keep)]:
                    shutil.rmtree(
                        os.path.join(slot, f"step_{step:09d}"), ignore_errors=True
                    )
                    steps_removed += 1
                for entry in os.listdir(slot):
                    if entry.endswith(".tmp"):
                        shutil.rmtree(os.path.join(slot, entry), ignore_errors=True)
                        tmp_removed += 1
        journal_stats = None
        if compact_journal:
            from repro_torch.checkpoint.manager import journal_path
            from repro_torch.runtime.journal import MeasurementJournal

            path = journal_path(self.directory)
            if os.path.exists(path):
                journal_stats = MeasurementJournal(path).compact()
        return {
            "steps_removed": steps_removed,
            "tmp_removed": tmp_removed,
            "journal": journal_stats,
        }

    # ----------------------------------------------------------------- listing
    def platforms(self) -> tuple[str, ...]:
        return tuple(
            sorted(
                d
                for d in os.listdir(self.directory)
                if os.path.isdir(os.path.join(self.directory, d))
            )
        )

    def layer_types(self, platform_name: str) -> tuple[str, ...]:
        root = os.path.join(self.directory, _safe(platform_name))
        if not os.path.isdir(root):
            return ()
        return tuple(
            sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        )
