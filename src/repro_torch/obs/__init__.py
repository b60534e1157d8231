"""Observability substrate: tracing spans + unified metrics (jax-free).

Two halves, one import:

* :mod:`repro_torch.obs.trace` — nested spans to an append-only JSONL trace with a
  Chrome/Perfetto exporter.  Disabled (the default) a span is the shared
  :data:`NULL_SPAN` singleton: no allocation, no clock read, nanoseconds of
  overhead — cheap enough to leave on the measurement hot path.
* :mod:`repro_torch.obs.metrics` — counters, pull-based gauges, and p50/p95/p99
  histograms in one :class:`MetricsRegistry`; supersedes the old
  ``repro_torch.serving.metrics`` (which now re-exports from here).

Hard invariant (pinned by tests/test_obs.py): instrumentation never touches
the RNG stream, measurement order, or any numeric result — campaigns and
served answers are bitwise identical with tracing on, off, and under
concurrent metric snapshots.

Well-known process-wide counters (all under the global :func:`metrics`
registry; every one is best-effort and zero-cost when nothing increments it):

* ``runtime.retries`` / ``runtime.failures`` — scheduler retry/abort counts
* ``runtime.faults.{crash,hang,corrupt,slow,error}`` — failures the
  scheduler classified and survived (chaos or organic)
* ``runtime.quarantines`` — repeat-offender workers evicted from the pool
* ``journal.corrupt_lines`` — journal lines dropped at replay
* ``journal.torn_tails_sealed`` — torn write fragments sealed before append
* ``serve.overload`` / ``serve.deadline_exceeded`` — requests answered with
  explicit backpressure / deadline errors (never silent drops)

Typical use::

    import repro_torch.obs as obs

    with obs.tracing("runs/trace.jsonl"):
        oracle = campaign.run()          # phase/runtime/fit spans recorded
    print(obs.metrics().snapshot()["counters"])

then ``python -m repro_torch.obs.report runs/trace.jsonl`` for the phase table, or
``--chrome out.json`` to open the timeline in https://ui.perfetto.dev.
"""

from repro_torch.obs.metrics import (
    PERCENTILES,
    Counter,
    Histogram,
    MetricsRegistry,
    metrics,
    percentile_summary,
    set_metrics,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    Tracer,
    disable_tracing,
    enable_tracing,
    export_chrome,
    get_tracer,
    instant,
    load_events,
    set_tracer,
    span,
    traced,
    tracing,
)

__all__ = [
    "NULL_SPAN",
    "PERCENTILES",
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "export_chrome",
    "get_tracer",
    "instant",
    "load_events",
    "metrics",
    "percentile_summary",
    "set_metrics",
    "set_tracer",
    "span",
    "traced",
    "tracing",
]
