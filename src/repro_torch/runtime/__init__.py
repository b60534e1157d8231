"""repro_torch.runtime — the measurement-execution subsystem.

Sits between the measurement cache (:class:`repro_torch.api.cache.CachedPlatform`)
and the platforms: the cache decides *what* still needs measuring (the miss
sub-batch), the runtime decides *how* it gets measured — sharded into chunks,
dispatched across a worker pool, retried on failure, journaled for crash-safe
resume, and merged back in first-occurrence order so campaigns stay bitwise
reproducible regardless of worker count.

Typical use, through a campaign::

    from repro_torch.api import Campaign, CampaignSpec
    from repro_torch.runtime import RuntimeSpec

    spec = CampaignSpec(platform="xla_cpu", n_samples=500, hub_dir="hub/")
    oracle = Campaign(spec).run(
        runtime=RuntimeSpec(workers=4, journal_path="hub/measurements.jsonl")
    )

Killing that run and re-running it resumes from the journal: every completed
chunk is replayed into the cache before the first new measurement is taken.
"""

from __future__ import annotations

import dataclasses

from repro_torch.runtime.faults import (
    FaultEvent,
    FaultPlan,
    FaultyExecutor,
    InjectedFault,
    InjectedWorkerCrash,
    TornWrite,
)
from repro_torch.runtime.health import (
    DegradationReport,
    HealthPolicy,
    HealthTracker,
    WorkerHealth,
)
from repro_torch.runtime.journal import JournalCorruptionWarning, MeasurementJournal
from repro_torch.runtime.scheduler import (
    MeasurementError,
    MeasurementScheduler,
    ResultIntegrityError,
)
from repro_torch.runtime.stats import RunStats
from repro_torch.runtime.workers import SerialExecutor, WorkerPool


@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """Declarative description of how a campaign's measurements execute."""

    #: 1 => in-process serial executor; >1 => process pool of this size
    workers: int = 1
    #: rows per scheduler chunk (the unit of dispatch, retry and journaling);
    #: None derives the size adaptively from the platform's measured per-item
    #: cost so one chunk lands near ``target_chunk_s`` of wall time
    chunk_size: int | None = None
    #: adaptive chunk sizing's wall-time target per chunk
    target_chunk_s: float = 1.0
    #: resubmissions allowed per chunk before the run fails
    max_retries: int = 2
    #: base backoff before a resubmit (doubles per attempt)
    retry_backoff_s: float = 0.05
    #: gather timeout per chunk attempt; None waits forever
    chunk_timeout_s: float | None = None
    #: JSONL journal for crash-safe resume.  None = no journal, except that a
    #: campaign with a hub supplies its default (hub_dir/measurements.jsonl);
    #: "" disables journaling unconditionally
    journal_path: str | None = None
    #: multiprocessing start method for the pool ("spawn" is device-safe)
    mp_context: str = "spawn"
    #: worker-health / quarantine policy; None disables health tracking
    health: HealthPolicy | None = HealthPolicy()
    #: deterministic fault schedule (chaos testing); None = no injection.
    #: The plan wraps the executor in a :class:`FaultyExecutor` and is
    #: consulted by the journal's append path — production runs never set it
    fault_plan: FaultPlan | None = None


class MeasurementRuntime:
    """One runtime session: executor + scheduler + journal + stats.

    Built from a :class:`RuntimeSpec` and the *inner* (uncached) platform.
    ``Campaign.run(runtime=...)`` attaches it to the campaign's
    ``CachedPlatform`` so every cache miss — sweeps, PR samples, evaluation —
    flows through the scheduler; use it as a context manager (or call
    :meth:`close`) to tear the pool down.
    """

    def __init__(self, spec: RuntimeSpec, platform) -> None:
        # The runtime sits *below* the cache: unwrap caching proxies so pool
        # workers rebuild the raw platform and journal keys match cache keys.
        while hasattr(platform, "inner"):
            platform = platform.inner
        self.spec = spec
        self.platform = platform
        self.stats = RunStats()
        self.journal = (
            MeasurementJournal(spec.journal_path, fault_plan=spec.fault_plan)
            if spec.journal_path
            else None
        )
        if spec.workers > 1:
            self.executor = WorkerPool(
                platform.spawn_spec(), spec.workers, mp_context=spec.mp_context
            )
        else:
            self.executor = SerialExecutor(platform)
        if spec.fault_plan is not None:
            self.executor = FaultyExecutor(
                self.executor, spec.fault_plan, report=self.stats.degradation
            )
        self.health = HealthTracker(spec.health) if spec.health is not None else None
        self.scheduler = MeasurementScheduler(
            self.executor,
            journal=self.journal,
            chunk_size=spec.chunk_size,
            max_retries=spec.max_retries,
            retry_backoff_s=spec.retry_backoff_s,
            chunk_timeout_s=spec.chunk_timeout_s,
            target_chunk_s=spec.target_chunk_s,
            stats=self.stats,
            health=self.health,
        )

    # ----------------------------------------------------------------- measure
    def measure(self, layer_type: str, batch) -> "np.ndarray":  # noqa: F821
        """Measure one (already cache-missed) batch through the scheduler."""
        return self.scheduler.measure_batch(self.platform.cache_key(), layer_type, batch)

    def measure_blocks(self, batch) -> "np.ndarray":  # noqa: F821
        """Measure one (already cache-missed) block batch through the scheduler."""
        return self.scheduler.measure_block_batch(self.platform.cache_key(), batch)

    # ------------------------------------------------------------------ resume
    def replay_into(self, cache) -> int:
        """Preload the journal into a cache; returns the number of *new* keys.

        Counts match ``cache.replayed``: rows the cache already held (a
        re-replay, or overlapping journals) are not re-counted.
        """
        if self.journal is None:
            return 0
        replay = self.journal.replay_into(cache)
        self.stats.replayed += replay["new"]
        return replay["new"]

    # ---------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.executor.close()
        if self.journal is not None:
            self.journal.close()

    def __enter__(self) -> "MeasurementRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "DegradationReport",
    "FaultEvent",
    "FaultPlan",
    "FaultyExecutor",
    "HealthPolicy",
    "HealthTracker",
    "InjectedFault",
    "InjectedWorkerCrash",
    "JournalCorruptionWarning",
    "MeasurementError",
    "MeasurementJournal",
    "MeasurementRuntime",
    "MeasurementScheduler",
    "ResultIntegrityError",
    "RunStats",
    "RuntimeSpec",
    "SerialExecutor",
    "TornWrite",
    "WorkerHealth",
    "WorkerPool",
]
