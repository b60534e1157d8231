"""idle_share.serve: percent of the profiled stretch of a batch in which no operation ran on the
device (the union of the profiler's kernel, copy and fill intervals); nothing when its records are
incomplete."""

from perfbench import trace


def read(ctx):
    return trace.idle_percent(ctx.get("profile"))
