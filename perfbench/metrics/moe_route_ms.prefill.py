"""moe_route_ms.prefill: the program's ``moe.route`` phase (router product, softmax, top-k, the
entries' sort by expert and the offsets) on the device's clock, summed over a prefill's MoE layers,
median over the window's batches."""

from perfbench import program_layers


def read(ctx):
    return program_layers.prefill_median(ctx, "moe.route.device_ms")
