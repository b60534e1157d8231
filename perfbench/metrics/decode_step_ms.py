"""decode_step_ms: per batch, CUDA events from before its first graph replay to after its last,
over the replays; the median over the window's batches."""

from perfbench import harness


def read(ctx):
    return harness.median(ctx.get("decode_ms", []))
