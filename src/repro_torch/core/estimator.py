"""Single-layer execution-time estimators (Sec. 3.3 of the paper).

:class:`LayerEstimator` is the trained artifact: forest + step widths +
parameter space.  At query time a configuration is first snapped to its PR
(Eq. 7/8) and then predicted.

.. deprecated::
    ``build_estimator`` and ``sampling_curve`` are kept as thin shims for
    backward compatibility.  New code should go through :mod:`repro_torch.api`
    (``CampaignSpec`` / ``Campaign`` / ``PerfOracle``), which adds measurement
    caching, step-width reuse, and estimator persistence on top of the same
    pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.core import prs
from repro_torch.core.batch import ConfigBatch
from repro_torch.core.features import derived_features, derived_features_batch
from repro_torch.core.forest import RandomForestRegressor, mape, rmspe


@dataclasses.dataclass
class LayerEstimator:
    layer_type: str
    params: tuple[str, ...]
    widths: Mapping[str, int]
    space: prs.ParamSpace
    forest: RandomForestRegressor
    #: bookkeeping for Table-1-style reporting
    n_train: int = 0
    n_sweep: int = 0
    mean_measure_seconds: float = 0.0
    sampling: str = "pr"
    log_target: bool = True

    def _features(
        self, configs: Sequence[prs.Config] | ConfigBatch, snap: bool = True
    ) -> np.ndarray:
        """Columnar feature matrix: base params + derived descriptors.

        Accepts a :class:`ConfigBatch` directly or any homogeneous dict list
        (columnarised on the fly); heterogeneous key sets fall back to the
        per-row dict path.
        """
        if not isinstance(configs, ConfigBatch):
            configs = list(configs)
            if not configs:
                # An empty list carries no key set to columnarise from.
                return self._features_rows(configs, snap)
            try:
                configs = ConfigBatch.from_dicts(configs)
            except ValueError:
                return self._features_rows(configs, snap)
        if snap:
            configs = prs.map_to_pr_batch(configs, self.widths, self.space)
        base = configs.matrix(self.params)
        extra = derived_features_batch(self.layer_type, configs)
        if extra.size == 0:
            return base
        return np.concatenate([base, extra], axis=1)

    def _features_rows(self, configs: Sequence[prs.Config], snap: bool) -> np.ndarray:
        """Row-at-a-time fallback for ragged (mixed-key) config lists."""
        if snap:
            configs = [prs.map_to_pr(c, self.widths, self.space) for c in configs]
        base = prs.configs_to_matrix(configs, self.params)
        extra = np.array(
            [list(derived_features(self.layer_type, c).values()) for c in configs],
            dtype=np.float64,
        )
        if extra.size == 0:
            return base
        return np.concatenate([base, extra], axis=1)

    def predict_features(
        self, X: np.ndarray, backend: str | None = None
    ) -> np.ndarray:
        """Predict from a pre-built (already snapped) feature matrix.

        Lets callers that evaluate one test set against many trained forests
        (``Campaign.sampling_curve``) reuse a memoized feature matrix instead
        of re-snapping and re-featurizing per evaluation.

        ``backend`` selects the traversal engine (numpy / jax, see
        :mod:`repro_torch.core.jax_predict`); the log-target inversion stays
        ``np.exp`` on both, so predictions are bitwise-identical across
        backends.  ``None`` defers to the environment default — and is not
        forwarded, so duck-typed forest stubs without the parameter keep
        working.
        """
        X = np.asarray(X, dtype=np.float64)
        if backend is None:
            y = self.forest.predict(X)
        else:
            y = self.forest.predict(X, backend=backend)
        return np.exp(y) if self.log_target else y

    def predict(
        self, configs: Sequence[prs.Config] | ConfigBatch, backend: str | None = None
    ) -> np.ndarray:
        """Eq. 7/8: map to PR, then predict with the forest."""
        return self.predict_features(self._features(configs, snap=True), backend)

    def predict_one(self, cfg: prs.Config) -> float:
        return float(self.predict([cfg])[0])

    def evaluate(
        self, platform: Platform, test_configs: Sequence[prs.Config] | ConfigBatch
    ) -> dict[str, float]:
        y_true = platform.measure_many(
            self.layer_type,
            test_configs if isinstance(test_configs, ConfigBatch) else list(test_configs),
        )
        y_pred = self.predict(test_configs)
        return {"mape": mape(y_true, y_pred), "rmspe": rmspe(y_true, y_pred)}


def build_estimator(
    platform: Platform,
    layer_type: str,
    n_samples: int,
    sampling: str = "pr",
    seed: int = 0,
    threshold_linear: float = 0.02,
    forest_kwargs: dict | None = None,
    widths: Mapping[str, int] | None = None,
) -> LayerEstimator:
    """Deprecated shim -- delegates to :func:`repro_torch.api.train_layer_estimator`.

    sampling:
      * "pr"          -- sample from the PR set (the paper's method),
      * "random"      -- sample uniformly from the complete parameter space
                         (the paper's baseline comparison),
      * "random_pr"   -- random sampling *of PR points* (ablation).
    """
    from repro_torch.api.campaign import train_layer_estimator

    return train_layer_estimator(
        platform,
        layer_type,
        n_samples,
        sampling=sampling,
        seed=seed,
        threshold_linear=threshold_linear,
        forest_kwargs=forest_kwargs,
        widths=widths,
    )


def sampling_curve(
    platform: Platform,
    layer_type: str,
    sizes: Sequence[int],
    test_configs: Sequence[prs.Config],
    sampling: str = "pr",
    seed: int = 0,
) -> list[dict[str, float]]:
    """MAPE/RMSPE as a function of training-set size (Figs. 4-7).

    Deprecated shim -- delegates to :meth:`repro_torch.api.Campaign.sampling_curve`,
    which discovers step widths once and reuses them for every size (the old
    implementation re-swept the platform at each size).
    """
    from repro_torch.api.campaign import Campaign, CampaignSpec

    spec = CampaignSpec(platform=platform.name, sampling=sampling, seed=seed)
    campaign = Campaign(spec, platform=platform)
    return campaign.sampling_curve(layer_type, sizes, test_configs, sampling=sampling, seed=seed)
