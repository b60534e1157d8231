"""moe_experts_ms.prefill: the program's ``moe.experts`` phase (the grouped expert products and the
combine) on the device's clock, summed over a prefill's MoE layers, median over the window's batches."""

from perfbench import program_layers


def read(ctx):
    return program_layers.prefill_median(ctx, "moe.experts.device_ms")
