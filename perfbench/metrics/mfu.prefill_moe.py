"""mfu.prefill_moe: an OLMoE prefill's model FLOPs (``costs_moe.moe_prefill_flops``: the active
products once, causal attention, the head at every prompt position as the program computes it) over
the median prefill time (host clock around ``transformer.forward``, the device synchronised) times
the card's bf16 peak, in percent."""

from perfbench import costs, costs_moe, harness


def read(ctx):
    seconds = harness.median(ctx.get("spans", {}).get("prefill", []))
    if not seconds:
        return None
    t = ctx["traffic"]
    flops = costs_moe.moe_prefill_flops(ctx["model"], t["batch"], t["prompt"])
    return 100.0 * flops / (seconds * costs.PEAK_FLOPS["bfloat16"])
