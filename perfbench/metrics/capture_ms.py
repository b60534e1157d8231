"""capture_ms: ``capture_serve_step`` as ``generate`` calls it (one eager decode step, then the
capture of the next as a CUDA graph; host clock, the device synchronised on both sides), median."""

from perfbench import harness


def read(ctx):
    value = harness.median(ctx.get("spans", {}).get("capture", []))
    return None if value is None else 1e3 * value
