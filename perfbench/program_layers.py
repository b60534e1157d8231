"""The program's per-layer phases, summed over each call of the window, as per-layer metrics read them.

``program.py`` takes one observation of a phase per batch; a phase inside a
layer (``moe.route``, ``moe.experts``) is observed once a layer of every
prefill.  Its device times are observed only in a prefill (the program times
a decode step on the host alone), so the window's last N prefills hold the
histogram's last N x layers device observations, N the window's batches as
the benchmark's own ``prefill`` spans count them.  A checkout whose program
has no such phase reads nothing.
"""

from __future__ import annotations

from perfbench import harness


def prefill_sums(ctx: dict, histogram: str) -> list[float] | None:
    """Per prefill of the window, the sum of ``histogram``'s observations over its layers; None
    untraced, or when the program observed fewer."""
    batches = len(ctx.get("spans", {}).get("prefill", []))
    layers = ctx.get("model", {}).get("n_layers", 0)
    if not batches or not layers:
        return None
    try:
        from repro_torch import phases
        from repro_torch.obs.metrics import metrics
    except ImportError:
        return None
    phases.flush()
    values = metrics().histogram(histogram).values()
    if len(values) < batches * layers:
        return None
    values = values[-batches * layers:]
    return [sum(values[i * layers:(i + 1) * layers]) for i in range(batches)]


def prefill_median(ctx: dict, histogram: str) -> float | None:
    sums = prefill_sums(ctx, histogram)
    return None if sums is None else harness.median(sums)
