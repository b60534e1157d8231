"""mfu.prefill: the prefill's model FLOPs (``costs.ssm_prefill_flops``: every product once, the
scans by the kernel formula, the head at the last position) over the median prefill time times the
card's bf16 peak, in percent."""

from perfbench import costs, harness


def read(ctx):
    seconds = harness.median(ctx.get("spans", {}).get("prefill", []))
    if not seconds:
        return None
    t = ctx["traffic"]
    flops = costs.ssm_prefill_flops(ctx["model"], t["batch"], t["prompt"])
    return 100.0 * flops / (seconds * costs.PEAK_FLOPS["bfloat16"])
