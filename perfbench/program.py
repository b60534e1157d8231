"""The program's own phases and counters, as the per-layer metrics read them.

``repro_torch.phases`` records, inside the port, each phase's host time
and (on the card) device time into histograms of the process's
``obs.metrics()`` registry, and the caching allocator's calls per
``generate``.  A traced run's metrics are read in the same process after its
driver has run, so a reader takes the histogram's last N observations, N
the window's batches or steps as the benchmark's own spans count them, which
leaves out set-up and warm-up.  A checkout whose program has no such
histogram (an older one) reads nothing.
"""

from __future__ import annotations

from perfbench import harness


def window(ctx: dict, histogram: str, span: str) -> list[float] | None:
    """The last ``len(ctx["spans"][span])`` observations of the program's ``histogram``, after the
    program has resolved its pending device times; None untraced, or when it has fewer."""
    n = len(ctx.get("spans", {}).get(span, []))
    if not n:
        return None
    try:
        from repro_torch import phases
        from repro_torch.obs.metrics import metrics
    except ImportError:
        return None
    phases.flush()
    values = metrics().histogram(histogram).values()
    return values[-n:] if len(values) >= n else None


def window_median(ctx: dict, histogram: str, span: str) -> float | None:
    values = window(ctx, histogram, span)
    return None if values is None else harness.median(values)
