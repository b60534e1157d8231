"""Worker health tracking, quarantine policy, and the degradation report.

The scheduler survives individual chunk failures with retries; this module
adds the *memory* between failures.  A :class:`HealthTracker` keeps per-worker
records (consecutive failures, EWMA chunk latency) keyed by worker pid — the
chunk meta every built-in executor returns carries the pid, so failures that
can be attributed (a corrupt payload whose integrity envelope names the
worker) build a per-worker streak, while anonymous failures (a timeout on a
future that never reported back) build a pool-level streak.  When a streak
reaches ``HealthPolicy.quarantine_after`` the tracker advises quarantine and
the scheduler asks the executor to shrink-and-respawn
(:meth:`repro_torch.runtime.workers.WorkerPool.quarantine`): a repeat offender —
a worker on a flaky device, a thermally-throttled core — stops eating the
retry budget of every chunk it touches.

Every fault a run survives is recorded on :class:`DegradationReport`, which
rides on :class:`repro_torch.runtime.stats.RunStats` and therefore surfaces through
``Campaign.last_run_stats`` / ``PerfOracle.run_stats``: a campaign that
completed *despite* crashes is distinguishable from one that ran clean, even
though both produce bitwise-identical results.
"""

from __future__ import annotations

import dataclasses
import threading

#: cap on the per-run event log so a pathological fault storm cannot grow
#: the report without bound (counters keep exact totals regardless)
MAX_EVENTS = 256

#: DegradationReport counter attribute per recorded fault kind
_KIND_COUNTERS = {
    "crash": "crashes",
    "hang": "hangs",
    "corrupt": "corrupt_results",
    "error": "errors",
    "slow": "slow_chunks",
    "torn_write": "torn_writes",
    "quarantine": "quarantines",
    "injected": "injected",
    "overload": "overloads",
}


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Knobs for worker-health tracking and quarantine."""

    #: consecutive failures (per worker when attributable, pool-wide when
    #: not) before the tracker advises quarantining the offender
    quarantine_after: int = 3
    #: smoothing factor for the per-worker EWMA of chunk execution seconds
    ewma_alpha: float = 0.25
    #: a successful chunk slower than ``slow_factor`` x the worker's EWMA is
    #: recorded as a survived "slow" degradation event
    slow_factor: float = 4.0
    #: chunks faster than this are never "slow": at microsecond scale the
    #: EWMA ratio measures scheduler jitter, not worker health, and every
    #: false positive pays a degradation-event record on the merge hot path
    slow_floor_s: float = 0.05


@dataclasses.dataclass(slots=True)
class WorkerHealth:
    """Health record for one worker process (or the anonymous pool)."""

    pid: int | None
    chunks: int = 0
    failures: int = 0
    consecutive_failures: int = 0
    ewma_chunk_s: float | None = None
    quarantined: bool = False

    def snapshot(self) -> dict:
        return {
            "pid": self.pid,
            "chunks": self.chunks,
            "failures": self.failures,
            "consecutive_failures": self.consecutive_failures,
            "ewma_chunk_s": self.ewma_chunk_s,
            "quarantined": self.quarantined,
        }


@dataclasses.dataclass
class DegradationReport:
    """Tally of every fault a run survived (or died recording).

    Part of :class:`~repro_torch.runtime.stats.RunStats`; ``snapshot()`` embeds it
    in the run-stats dict.  ``injected`` counts faults a
    :class:`~repro_torch.runtime.faults.FaultPlan` deliberately fired, so chaos
    tests can assert the plan actually exercised the run.
    """

    crashes: int = 0
    hangs: int = 0
    corrupt_results: int = 0
    errors: int = 0
    slow_chunks: int = 0
    torn_writes: int = 0
    quarantines: int = 0
    injected: int = 0
    overloads: int = 0
    events: list = dataclasses.field(default_factory=list)

    def record(self, kind: str, **detail) -> None:
        attr = _KIND_COUNTERS.get(kind)
        if attr is None:
            raise ValueError(f"unknown degradation kind {kind!r}")
        setattr(self, attr, getattr(self, attr) + 1)
        if len(self.events) < MAX_EVENTS:
            self.events.append({"kind": kind, **detail})

    def survived(self) -> int:
        """Faults the run absorbed (excludes bookkeeping-only ``injected``)."""
        return (
            self.crashes
            + self.hangs
            + self.corrupt_results
            + self.errors
            + self.slow_chunks
            + self.torn_writes
            + self.quarantines
            + self.overloads
        )

    def snapshot(self) -> dict:
        return {
            "crashes": self.crashes,
            "hangs": self.hangs,
            "corrupt_results": self.corrupt_results,
            "errors": self.errors,
            "slow_chunks": self.slow_chunks,
            "torn_writes": self.torn_writes,
            "quarantines": self.quarantines,
            "injected": self.injected,
            "overloads": self.overloads,
            "survived": self.survived(),
            "events": list(self.events),
        }


class HealthTracker:
    """Per-worker failure streaks and latency EWMAs, with quarantine advice.

    Thread-safe: the scheduler's retry machinery records failures from timer
    threads while successes merge on the dispatch thread.
    """

    def __init__(self, policy: HealthPolicy | None = None) -> None:
        self.policy = policy if policy is not None else HealthPolicy()
        self._lock = threading.Lock()
        self._workers: dict[int, WorkerHealth] = {}
        #: pool-level streak for failures that cannot name a worker
        self._anonymous_streak = 0
        # policy knobs cached as plain attributes: record_success runs once
        # per merged chunk on the dispatch hot path
        self._alpha = float(self.policy.ewma_alpha)
        self._slow_factor = float(self.policy.slow_factor)
        self._slow_floor = float(self.policy.slow_floor_s)
        self._quarantine_after = int(self.policy.quarantine_after)

    def _worker_locked(self, pid: int) -> WorkerHealth:
        worker = self._workers.get(pid)
        if worker is None:
            worker = self._workers[pid] = WorkerHealth(pid=pid)
        return worker

    def record_success(self, pid: int | None, exec_s: float | None) -> str | None:
        """Record a merged chunk; returns ``"slow"`` for a latency outlier."""
        with self._lock:
            self._anonymous_streak = 0
            if pid is None:
                return None
            worker = self._workers.get(pid)
            if worker is None:
                worker = self._workers[pid] = WorkerHealth(pid=pid)
            worker.chunks += 1
            worker.consecutive_failures = 0
            if exec_s is None:
                return None
            previous = worker.ewma_chunk_s
            if previous is None:
                worker.ewma_chunk_s = float(exec_s)
                return None
            alpha = self._alpha
            worker.ewma_chunk_s = alpha * float(exec_s) + (1.0 - alpha) * previous
            if exec_s >= self._slow_floor and exec_s > self._slow_factor * previous:
                return "slow"
            return None

    def record_failure(self, pid: int | None = None) -> bool:
        """Record a failed attempt; True advises quarantining the offender."""
        with self._lock:
            self._anonymous_streak += 1
            if pid is None:
                if self._anonymous_streak >= self._quarantine_after:
                    self._anonymous_streak = 0
                    return True
                return False
            worker = self._worker_locked(pid)
            worker.failures += 1
            worker.consecutive_failures += 1
            if worker.consecutive_failures >= self._quarantine_after:
                worker.quarantined = True
                worker.consecutive_failures = 0
                self._anonymous_streak = 0
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "workers": [w.snapshot() for w in self._workers.values()],
                "anonymous_streak": self._anonymous_streak,
            }


__all__ = [
    "DegradationReport",
    "HealthPolicy",
    "HealthTracker",
    "WorkerHealth",
    "MAX_EVENTS",
]
