"""first_token_ms: the program's ``serve.first_token`` phase on the device's clock (CUDA
events from ``generate``'s call to the first token's ``argmax``), median over the window's batches."""

from perfbench import program


def read(ctx):
    return program.window_median(ctx, "serve.first_token.device_ms", "prefill")
