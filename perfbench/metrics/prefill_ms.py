"""prefill_ms: the prefill's time (host clock around ``transformer.forward`` as ``generate``
calls it first, the device synchronised on both sides), median over the window's batches."""

from perfbench import harness


def read(ctx):
    value = harness.median(ctx.get("spans", {}).get("prefill", []))
    return None if value is None else 1e3 * value
