"""device_allocs.serve: the caching allocator's device allocations and frees (``cudaMalloc`` +
``cudaFree``) from one ``generate``'s return to the next one's, as the program counts them, median
over the window's batches."""

from perfbench import program


def read(ctx):
    return program.window_median(ctx, "serve.device_allocs", "prefill")
