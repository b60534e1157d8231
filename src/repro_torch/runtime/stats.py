"""RunStats: the live progress surface of a measurement run.

One mutable stats object is shared by the scheduler, the cache proxy and the
journal replay, so a campaign (or ``launch/serve.py --estimate``) can report
how benchmarking time is being spent: how many configurations were actually
measured, how many came for free from the cache or a journal replay, how many
chunks are in flight, and the effective measurement throughput.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.runtime.health import DegradationReport


@dataclasses.dataclass
class RunStats:
    """Counters for one measurement run (all updated in the dispatching process)."""

    #: configurations actually measured by the executor this run
    measured: int = 0
    #: configurations answered from the in-memory MeasurementCache
    cached: int = 0
    #: configurations preloaded into the cache from a journal replay
    replayed: int = 0
    #: chunks submitted to the executor but not yet merged back
    in_flight: int = 0
    #: chunks completed (after any retries)
    chunks: int = 0
    #: chunk attempts that failed and were resubmitted
    retries: int = 0
    #: chunks abandoned after exhausting their retry budget
    failures: int = 0
    #: wall-clock seconds spent inside scheduler dispatch+gather
    measure_seconds: float = 0.0
    #: executor-side seconds spent inside platform measurement calls (summed
    #: across workers; reported per chunk by the worker that executed it)
    exec_seconds: float = 0.0
    #: every fault this run survived (crashes, hangs, corrupt payloads,
    #: quarantines, ...) — see :class:`repro_torch.runtime.health.DegradationReport`
    degradation: DegradationReport = dataclasses.field(default_factory=DegradationReport)
    started_at: float = dataclasses.field(default_factory=time.perf_counter)

    def elapsed(self) -> float:
        return max(time.perf_counter() - self.started_at, 1e-9)

    def throughput(self) -> float:
        """Measured configurations per wall-clock second since construction."""
        return self.measured / self.elapsed()

    def snapshot(self) -> dict[str, float]:
        """Plain-dict view for reports, logs and ``PerfOracle.run_stats``."""
        return {
            "measured": self.measured,
            "cached": self.cached,
            "replayed": self.replayed,
            "in_flight": self.in_flight,
            "chunks": self.chunks,
            "retries": self.retries,
            "failures": self.failures,
            "measure_seconds": self.measure_seconds,
            "exec_seconds": self.exec_seconds,
            "elapsed_s": self.elapsed(),
            "throughput_cfg_s": self.throughput(),
            "degradation": self.degradation.snapshot(),
        }

    def render(self) -> str:
        """One-line human-readable progress summary."""
        parts = [f"{self.measured} measured", f"{self.cached} cached"]
        if self.replayed:
            parts.append(f"{self.replayed} replayed")
        if self.in_flight:
            parts.append(f"{self.in_flight} in flight")
        if self.retries:
            parts.append(f"{self.retries} retries")
        if self.failures:
            parts.append(f"{self.failures} failed")
        survived = self.degradation.survived()
        if survived:
            parts.append(f"{survived} faults survived")
        return ", ".join(parts) + f" | {self.throughput():.0f} cfg/s"
