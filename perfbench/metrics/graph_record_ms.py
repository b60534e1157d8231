"""graph_record_ms: the program's ``serve.capture.record`` phase (the ``torch.cuda.graph``
block of ``capture_serve_step``: a wait for the device, the allocator's cache emptied, the decode step
recorded while the device idles) on the host's clock, median over the window's batches."""

from perfbench import program


def read(ctx):
    return program.window_median(ctx, "serve.capture.record.host_ms", "prefill")
