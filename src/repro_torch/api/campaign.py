"""Campaigns: the declarative front door to the paper's Fig.-1 pipeline.

A :class:`CampaignSpec` names *what* to benchmark (platform, layer types,
sampling policy, budget); a :class:`Campaign` runs the pipeline — sweeps ->
Algorithm-1 step widths -> PR set -> sample + benchmark -> Random-Forest —
and returns a :class:`~repro_torch.api.oracle.PerfOracle`.

Two invariants the campaign enforces that the old free-function pipeline
could not:

* every unique ``(layer_type, config)`` is **measured at most once** per
  campaign (all stages share one :class:`~repro_torch.api.cache.MeasurementCache`);
* step widths are **discovered at most once** per ``(platform, layer_type)``
  — size scans (:meth:`Campaign.sampling_curve`) and repeated trainings reuse
  the first sweep instead of re-sweeping.

Trained estimators are persisted through an
:class:`~repro_torch.api.hub.EstimatorHub` when the spec names a ``hub_dir``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.api.cache import CachedPlatform, MeasurementCache
from repro_torch.api.hub import EstimatorHub
from repro_torch.api.oracle import PerfOracle
from repro_torch.api.registry import get_platform
from repro_torch.core import prs, sweeps
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.obs.trace import span, tracing
from repro_torch.core.batch import ConfigBatch
from repro_torch.core.blocks import Block, FusingModel, fit_fusing_model
from repro_torch.core.estimator import LayerEstimator
from repro_torch.core.forest import RandomForestRegressor, mape, rmspe


def train_layer_estimator(
    platform: Platform,
    layer_type: str,
    n_samples: int,
    sampling: str = "pr",
    seed: int = 0,
    threshold_linear: float = 0.02,
    forest_kwargs: dict | None = None,
    widths: Mapping[str, int] | None = None,
    n_sweep: int = 0,
) -> LayerEstimator:
    """Train a single-layer estimator (the Fig.-1 pipeline for one layer type).

    sampling:
      * "pr"          -- sample from the PR set (the paper's method),
      * "random"      -- sample uniformly from the complete parameter space
                         (the paper's baseline comparison),
      * "random_pr"   -- random sampling *of PR points* (ablation).

    ``widths``: pass pre-discovered step widths to skip the sweep phase;
    ``n_sweep`` then records how many sweep measurements their discovery cost
    (0 when they came for free, e.g. from a cache hit or documentation).
    """
    rng = np.random.default_rng(seed)
    space = platform.param_space(layer_type)
    if widths is None:
        if sampling == "random":
            widths = {p: 1 for p in space.params}
        else:
            widths, _, n_sweep = sweeps.discover_step_widths(
                platform, layer_type, threshold_linear
            )
    # The whole training set is one columnar batch: sampled, measured,
    # cache-partitioned and featurized without per-config Python loops.
    sp = span("phase.pr_sampling", cat="campaign")
    if sp:
        sp.set(layer_type=layer_type, sampling=sampling, n_samples=n_samples)
    with sp:
        if sampling in ("pr", "random_pr"):
            configs = prs.sample_pr_batch(space, widths, n_samples, rng)
        elif sampling == "random":
            configs = prs.sample_random_batch(space, n_samples, rng)
        else:
            raise ValueError(sampling)

    sp = span("phase.measurement", cat="campaign")
    if sp:
        sp.set(layer_type=layer_type, n=len(configs))
    with sp:
        y, mean_t = platform.timed_measure_many(layer_type, configs)
    fk = dict(n_estimators=32, max_depth=30, min_samples_leaf=1, seed=seed)
    fk.update(forest_kwargs or {})
    forest = RandomForestRegressor(**fk)
    est = LayerEstimator(
        layer_type=layer_type,
        params=space.params,
        widths=widths,
        space=space,
        forest=forest,
        n_train=n_samples,
        n_sweep=n_sweep,
        mean_measure_seconds=mean_t,
        sampling=sampling,
    )
    sp = span("phase.fit", cat="campaign")
    if sp:
        sp.set(layer_type=layer_type, n=len(configs),
               n_estimators=fk["n_estimators"])
    with sp:
        X = est._features(configs, snap=(sampling != "random"))
        target = np.log(np.asarray(y)) if est.log_target else np.asarray(y)
        forest.fit(X, target)
    return est


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """Declarative description of one benchmarking campaign."""

    #: registered platform name (see repro_torch.api.registry), e.g. "ultratrail"
    platform: str
    #: layer types to train; () means every type the platform supports
    layer_types: tuple[str, ...] = ()
    #: "pr" | "random" | "random_pr"
    sampling: str = "pr"
    #: benchmark points per layer type
    n_samples: int = 1000
    seed: int = 0
    threshold_linear: float = 0.02
    forest_kwargs: Mapping | None = None
    #: constructor kwargs for the registry factory, e.g. {"knowledge": "gray"}
    platform_kwargs: Mapping | None = None
    #: persist trained estimators here (EstimatorHub directory)
    hub_dir: str | None = None


class Campaign:
    """Runs a :class:`CampaignSpec` end to end with shared measurement cache."""

    def __init__(
        self,
        spec: CampaignSpec,
        platform: Platform | None = None,
        cache: MeasurementCache | None = None,
        hub: EstimatorHub | None = None,
    ) -> None:
        self.spec = spec
        inner = platform if platform is not None else get_platform(
            spec.platform, **dict(spec.platform_kwargs or {})
        )
        self.platform = (
            inner if isinstance(inner, CachedPlatform) else CachedPlatform(inner, cache)
        )
        self.cache = self.platform.cache
        if hub is not None:
            self.hub = hub
        elif spec.hub_dir:
            self.hub = EstimatorHub(spec.hub_dir)
        else:
            self.hub = None
        self.estimators: dict[str, LayerEstimator] = {}
        #: RunStats snapshot of the last ``run(runtime=...)`` (None otherwise)
        self.last_run_stats: dict[str, float] | None = None
        # Cache hit/miss accounting surfaces as a pull-based gauge: evaluated
        # only when someone snapshots the metrics, never on the measure path.
        obs_metrics().register_gauge("campaign.cache", self.cache.stats)

    # ------------------------------------------------------------- step widths
    def discover_widths(
        self, layer_type: str, n_points: int = 384
    ) -> tuple[dict[str, int], int]:
        """Memoized Algorithm-1 width discovery.

        Returns ``(widths, n_sweep_spent_now)`` — the second element is 0 on a
        cache hit, i.e. when this campaign (or a shared cache) already paid
        for the sweeps.
        """
        thr = self.spec.threshold_linear
        hit = self.cache.lookup_widths(self.platform.cache_key(), layer_type, thr, n_points)
        if hit is not None:
            return dict(hit[0]), 0
        sp = span("phase.step_widths", cat="campaign")
        if sp:
            sp.set(layer_type=layer_type)
        with sp:
            widths, _, n_meas = sweeps.discover_step_widths(
                self.platform, layer_type, thr, n_points=n_points
            )
        self.cache.store_widths(self.platform.cache_key(), layer_type, thr, n_points, widths, n_meas)
        return dict(widths), n_meas

    # ------------------------------------------------------------- training
    def train(
        self,
        layer_type: str,
        n_samples: int | None = None,
        sampling: str | None = None,
        seed: int | None = None,
    ) -> LayerEstimator:
        """Train (and register) the estimator for one layer type."""
        sampling = sampling if sampling is not None else self.spec.sampling
        if sampling == "random":
            widths, n_sweep = None, 0
        else:
            widths, n_sweep = self.discover_widths(layer_type)
        sp = span("campaign.train", cat="campaign")
        if sp:
            sp.set(layer_type=layer_type)
        with sp:
            est = train_layer_estimator(
                self.platform,
                layer_type,
                n_samples if n_samples is not None else self.spec.n_samples,
                sampling=sampling,
                seed=seed if seed is not None else self.spec.seed,
                threshold_linear=self.spec.threshold_linear,
                forest_kwargs=dict(self.spec.forest_kwargs) if self.spec.forest_kwargs else None,
                widths=widths,
                n_sweep=n_sweep,
            )
        self.estimators[layer_type] = est
        if self.hub is not None:
            self.hub.save(self.platform.name, est)
        return est

    def _resolve_runtime(self, runtime):
        """Normalize ``run``'s runtime argument to (runtime, owned-by-us)."""
        if runtime is None:
            return None, False
        from repro_torch.runtime import MeasurementRuntime, RuntimeSpec

        if isinstance(runtime, RuntimeSpec):
            if runtime.journal_path is None and self.hub is not None:
                # Campaigns that persist estimators get crash-safe resume by
                # default: the journal lives alongside the hub checkpoints.
                # (journal_path="" opts out of journaling explicitly.)
                from repro_torch.checkpoint.manager import journal_path

                runtime = dataclasses.replace(
                    runtime, journal_path=journal_path(self.hub.directory)
                )
            return MeasurementRuntime(runtime, self.platform.inner), True
        return runtime, False

    @contextlib.contextmanager
    def runtime_session(self, runtime):
        """Attach a measurement runtime to the cached platform for one stage.

        Every cache miss inside the ``with`` block — config batches *and*
        block batches — flows through the runtime's sharded scheduler (worker
        pool, retries, crash-safe journal).  The journal is replayed into the
        measurement cache on entry, so an interrupted stage resumes with zero
        duplicate measurements; ``last_run_stats`` is snapshotted on exit.
        Accepts a :class:`repro_torch.runtime.RuntimeSpec` (runtime owned and torn
        down here), a ready :class:`~repro_torch.runtime.MeasurementRuntime`, or
        ``None`` (no-op).
        """
        rt, owned = self._resolve_runtime(runtime)
        # Always reset: a runtime-less stage after a runtime-backed one must
        # not stamp the previous stage's stats onto the new result.
        self.last_run_stats = None
        if rt is None:
            yield None
            return
        self.platform.runtime = rt
        try:
            # Inside the try: an unreadable/corrupt-beyond-salvage journal
            # must still tear down the freshly spawned worker pool.
            rt.replay_into(self.cache)
            yield rt
        finally:
            self.platform.runtime = None
            self.last_run_stats = rt.stats.snapshot()
            if owned:
                rt.close()

    def run(self, runtime=None, trace=None, **oracle_kwargs) -> PerfOracle:
        """Train every layer type in the spec and return the oracle.

        ``runtime``: a :class:`repro_torch.runtime.RuntimeSpec` (or a ready
        :class:`~repro_torch.runtime.MeasurementRuntime`) executing all cache misses
        through the sharded scheduler — worker pool, retries, crash-safe
        journal.  The journal is replayed into the measurement cache first, so
        an interrupted run resumes with zero duplicate measurements.  Results
        are bitwise-identical to the serial path for any worker count.

        ``trace``: record a span trace of this run — a path (JSONL trace file,
        opened and closed here), a ready :class:`repro_torch.obs.Tracer`, or ``None``
        (trace only if a tracer is already installed globally).  Tracing never
        changes results: the oracle is bitwise identical with it on or off.
        """
        layer_types = tuple(self.spec.layer_types or self.platform.layer_types())
        with tracing(trace):
            # The span is created *inside* the tracing block (it must see the
            # tracer `trace` just installed), but its args still go through
            # the if-sp gate so the trace=None fast path allocates nothing.
            sp = span("campaign.run", cat="campaign")
            if sp:
                sp.set(platform=self.platform.name,
                       layer_types=list(layer_types),
                       sampling=self.spec.sampling,
                       n_samples=self.spec.n_samples)
            with sp, self.runtime_session(runtime):
                for lt in layer_types:
                    if lt not in self.estimators:
                        self.train(lt)
        oracle_kwargs.setdefault("run_stats", self.last_run_stats)
        return PerfOracle(
            estimators=dict(self.estimators),
            platform_name=self.platform.name,
            **oracle_kwargs,
        )

    # ------------------------------------------------------- whole-network path
    def calibrate_fusing(
        self,
        blocks_by_kind: Mapping[str, Sequence[Block]],
        runtime=None,
    ) -> dict[str, FusingModel]:
        """Fit Eq. 10/11 fusing models per block type, on the columnar path.

        Each kind's ~500 calibration blocks are measured as one
        :class:`~repro_torch.core.batch.BlockBatch` through the block cache (and
        the runtime's scheduler/journal when given), then fitted with one
        lstsq — the whole-network analogue of ``run()``'s per-layer training.
        Requires the relevant layer estimators to be trained already.
        """
        sp = span("phase.calibrate", cat="campaign")
        if sp:
            sp.set(kinds=sorted(blocks_by_kind))
        with sp:
            with self.runtime_session(runtime):
                return {
                    kind: fit_fusing_model(self.platform, self.estimators, blocks)
                    for kind, blocks in blocks_by_kind.items()
                }

    def evaluate_networks(
        self,
        oracle: PerfOracle,
        networks: Sequence[Sequence[Block]],
        runtime=None,
    ) -> dict[str, float]:
        """Whole-network MAPE/RMSPE against block-path ground truth.

        Ground truth is measured through the campaign's block cache (one
        batch over all networks; repeated blocks are measured once, also
        across a preceding ``calibrate_fusing``), optionally sharded/
        journaled through a runtime.
        """
        sp = span("phase.eval", cat="campaign")
        if sp:
            sp.set(n_networks=len(networks))
        with sp:
            with self.runtime_session(runtime):
                return oracle.evaluate_networks(self.platform, networks)

    # ------------------------------------------------------------- size scans
    def sampling_curve(
        self,
        layer_type: str,
        sizes: Sequence[int],
        test_configs: Sequence[prs.Config],
        sampling: str | None = None,
        seed: int | None = None,
    ) -> list[dict[str, float]]:
        """MAPE/RMSPE vs training-set size (Figs. 4-7).

        Step widths are discovered once and reused for every size; each entry
        reports ``sweeps_saved`` — the sweep measurements the old
        re-sweep-per-size pipeline would have spent by that point.

        The shared test set is measured and featurized **once**: its snapped
        feature matrix is memoized in the measurement cache (keyed by platform,
        layer type, step widths and batch fingerprint), so every size after the
        first skips the snap/featurize pass entirely.
        """
        sampling = sampling if sampling is not None else self.spec.sampling
        snap = sampling != "random"
        try:
            test_batch = (
                test_configs
                if isinstance(test_configs, ConfigBatch)
                else ConfigBatch.from_dicts(list(test_configs))
            )
        except ValueError:
            test_batch = None  # ragged/non-integer test set: per-size evaluate
        y_true: np.ndarray | None = None
        out = []
        sweep_cost = 0
        saved = 0
        for i, n in enumerate(sizes):
            t0 = time.perf_counter()
            est = self.train(layer_type, n_samples=n, sampling=sampling, seed=seed)
            if test_batch is None:
                metrics = est.evaluate(self.platform, test_configs)
            else:
                if y_true is None:
                    y_true = self.platform.measure_many(layer_type, test_batch)
                X = self.cache.lookup_features(
                    self.platform.cache_key(), layer_type, est.widths, snap, test_batch
                )
                if X is None:
                    X = est._features(test_batch, snap=snap)
                    self.cache.store_features(
                        self.platform.cache_key(), layer_type, est.widths, snap,
                        test_batch, X,
                    )
                y_pred = est.predict_features(X)
                metrics = {"mape": mape(y_true, y_pred), "rmspe": rmspe(y_true, y_pred)}
            if sampling != "random":
                if i == 0:
                    # The widths cache has no entry when the widths never cost
                    # a sweep (e.g. white-box platforms, est.n_sweep == 0):
                    # nothing was spent, so nothing is saved by reuse.
                    hit = self.cache.lookup_widths(
                        self.platform.cache_key(), layer_type, self.spec.threshold_linear, 384
                    )
                    sweep_cost = est.n_sweep or (hit[1] if hit is not None else 0)
                else:
                    saved += sweep_cost
            metrics.update(
                n=n,
                sampling=sampling,
                train_wall_s=time.perf_counter() - t0,
                n_sweep=est.n_sweep,
                sweeps_saved=saved,
            )
            out.append(metrics)
        return out

    # ------------------------------------------------------------- bookkeeping
    def stats(self) -> dict[str, float]:
        return self.cache.stats()
