"""Unified metrics: counters, gauges, histograms and endpoint latencies.

This registry absorbs and supersedes the PR-6 serving ``MetricsRegistry``
(``repro_torch.serving.metrics`` re-exports it for back-compat) and extends it into
the instrumentation substrate the whole pipeline reports through:

* **endpoint latencies** — the serving surface: per-endpoint request/error/
  item counts, a sliding window of end-to-end latencies -> p50/p95/p99,
  throughput, and the admission batch-size histogram (unchanged API:
  :meth:`MetricsRegistry.observe` / :meth:`~MetricsRegistry.observe_batch`);
* **counters** — monotonically increasing event counts: scheduler
  retries/failures, journaled corruption skips, jax compile/retrace events
  (``jax.forest.traces`` growing under live traffic is a bug the serving
  layer previously could not see);
* **gauges** — *pull-based* callbacks evaluated at snapshot time, so cache
  hit/miss accounting (``MeasurementCache.stats``, the serving
  ``ResultCache``) costs literally nothing on the hot path;
* **value histograms** — sliding-window distributions (per-chunk executor
  cost, per-tree fit time) with well-defined p50/p95/p99.

A process-global default registry (:func:`metrics`) collects pipeline-level
counters/histograms; the serving layer keeps constructing its own instances
per server, exactly as before.

Percentile semantics (the PR-8 satellite fix): a window of ``n == 0``
observations reports ``None`` for every percentile (never an exception or a
stale value), and ``n == 1`` reports that single sample for all percentiles
— pinned in tests/test_obs.py.

Observation cost is a deque append (histograms/latencies) or an int add
(counters) under one registry lock; snapshots copy under the same lock, so
concurrent snapshot readers never disturb writers (or results — the parity
contract in tests/test_obs.py covers snapshotting mid-campaign).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Mapping

#: latency percentiles reported by :meth:`MetricsRegistry.snapshot`
PERCENTILES = (50.0, 95.0, 99.0)


def percentile_summary(
    values, suffix: str = "", scale: float = 1.0
) -> dict[str, float | None]:
    """p50/p95/p99 of ``values`` with well-defined tiny-sample behaviour.

    ``n == 0`` -> every percentile is ``None``; ``n == 1`` -> every percentile
    is that sample.  ``scale`` converts units (1e3 for seconds -> ms keys).
    """
    # Deferred so that importing repro_torch.obs stays stdlib-only (the module is
    # on the bare-Python report/analysis path); numpy is only needed at
    # snapshot time, never on the observation hot path.
    import numpy as np

    arr = np.asarray(values, dtype=np.float64)
    keys = [f"p{int(p)}{suffix}" for p in PERCENTILES]
    if arr.size == 0:
        return {k: None for k in keys}
    if arr.size == 1:
        v = float(arr[0]) * scale
        return {k: v for k in keys}
    return {
        k: float(np.percentile(arr, p)) * scale for k, p in zip(keys, PERCENTILES)
    }


class Counter:
    """A monotonically increasing event count (int add under the GIL)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


class Histogram:
    """Sliding-window value distribution with running count/total."""

    __slots__ = ("name", "_values", "count", "total")

    def __init__(self, name: str, window: int) -> None:
        self.name = name
        self._values: deque[float] = deque(maxlen=window)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self._values.append(value)
        self.count += 1
        self.total += value

    def values(self) -> list[float]:
        """A copy of the window's observations, oldest first."""
        return list(self._values)

    def snapshot(self) -> dict:
        pcts = percentile_summary(self._values)
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.total / self.count if self.count else None,
            **pcts,
        }


class _Endpoint:
    __slots__ = ("count", "errors", "items", "latencies")

    def __init__(self, window: int) -> None:
        self.count = 0
        self.errors = 0
        self.items = 0
        self.latencies: deque[float] = deque(maxlen=window)


class MetricsRegistry:
    """Thread-safe unified metrics: endpoints + counters + gauges + histograms."""

    def __init__(self, window: int = 4096) -> None:
        self.window = int(window)
        self._lock = threading.Lock()
        self._endpoints: dict[str, _Endpoint] = {}
        #: power-of-two bucket -> number of dispatched admission batches
        self._batch_hist: dict[int, int] = {}
        self._batches = 0
        self._batched_items = 0
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Callable[[], object]] = {}
        self._histograms: dict[str, Histogram] = {}
        self._started_at = time.perf_counter()

    # ------------------------------------------------------------- recording
    def observe(
        self, endpoint: str, latency_s: float, items: int = 1, error: bool = False
    ) -> None:
        """Record one served request (end-to-end wall latency, item count)."""
        with self._lock:
            ep = self._endpoints.get(endpoint)
            if ep is None:
                ep = self._endpoints[endpoint] = _Endpoint(self.window)
            ep.count += 1
            ep.items += int(items)
            if error:
                ep.errors += 1
            else:
                ep.latencies.append(float(latency_s))

    def observe_batch(self, size: int) -> None:
        """Record one dispatched admission batch (for the size histogram)."""
        if size <= 0:
            return
        bucket = 1 << (int(size) - 1).bit_length()  # 1,2,4,8,...
        with self._lock:
            self._batch_hist[bucket] = self._batch_hist.get(bucket, 0) + 1
            self._batches += 1
            self._batched_items += int(size)

    # ----------------------------------------------- counters / gauges / hists
    def counter(self, name: str) -> Counter:
        """Get-or-create a named counter (hold the handle on hot paths)."""
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def register_gauge(self, name: str, fn: Callable[[], object]) -> None:
        """Register a pull-based gauge: ``fn`` (scalar- or dict-valued) is
        evaluated only at snapshot time — zero hot-path cost.  Re-registering
        a name replaces the callback (campaigns come and go)."""
        with self._lock:
            self._gauges[name] = fn

    def unregister_gauge(self, name: str) -> None:
        with self._lock:
            self._gauges.pop(name, None)

    def histogram(self, name: str, window: int | None = None) -> Histogram:
        """Get-or-create a named sliding-window histogram."""
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, window or self.window)
                )
        return h

    def observe_value(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, self.window)
            h.observe(value)

    # ------------------------------------------------------------- reporting
    def elapsed(self) -> float:
        return max(time.perf_counter() - self._started_at, 1e-9)

    def snapshot(self) -> dict:
        """Plain-dict view for the stats endpoint / BENCH_*.json files."""
        with self._lock:
            elapsed = self.elapsed()
            endpoints = {}
            for name, ep in self._endpoints.items():
                endpoints[name] = {
                    "requests": ep.count,
                    "errors": ep.errors,
                    "items": ep.items,
                    "requests_per_s": ep.count / elapsed,
                    "items_per_s": ep.items / elapsed,
                    **percentile_summary(ep.latencies, suffix="_ms", scale=1e3),
                }
            mean_batch = self._batched_items / self._batches if self._batches else 0.0
            counters = {name: c.value for name, c in self._counters.items()}
            histograms = {
                name: h.snapshot() for name, h in self._histograms.items()
            }
            gauges = dict(self._gauges)
        # Gauge callbacks run outside the lock: they may take other locks
        # (cache internals) and must never deadlock a metrics reader.
        gauge_values = {}
        for name, fn in gauges.items():
            try:
                value = fn()
            except Exception as exc:  # noqa: BLE001 - a gauge must not kill stats
                value = f"<gauge error: {type(exc).__name__}: {exc}>"
            gauge_values[name] = dict(value) if isinstance(value, Mapping) else value
        return {
            "elapsed_s": elapsed,
            "endpoints": endpoints,
            "batches": self._batches,
            "mean_batch_size": mean_batch,
            "batch_size_hist": {
                str(k): v for k, v in sorted(self._batch_hist.items())
            },
            "counters": counters,
            "gauges": gauge_values,
            "histograms": histograms,
        }


#: process-global default registry (pipeline counters/histograms land here)
_GLOBAL: MetricsRegistry | None = None
_GLOBAL_LOCK = threading.Lock()


def metrics() -> MetricsRegistry:
    """The process-global default registry (created on first use)."""
    global _GLOBAL
    reg = _GLOBAL
    if reg is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = MetricsRegistry()
            reg = _GLOBAL
    return reg


def set_metrics(registry: MetricsRegistry | None) -> MetricsRegistry | None:
    """Replace the process-global registry (tests); returns the previous one.

    Modules that cached counter/histogram handles from the old registry keep
    writing to it — swap the registry before the instrumented code runs.
    """
    global _GLOBAL
    previous = _GLOBAL
    _GLOBAL = registry
    return previous
