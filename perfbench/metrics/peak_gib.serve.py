"""peak_gib.serve: ``torch.cuda.max_memory_allocated`` over the window (stats reset at its start), GiB."""


def read(ctx):
    peak = ctx.get("peak_bytes_window")
    return peak / 2**30 if peak else None
