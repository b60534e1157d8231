"""mfu.train: one training step's model FLOPs (``costs.ssm_train_flops``: 6 x the products'
weights x tokens, the convolutions, the scan's forward and backward, no recompute) over the median
step time (host clock around the step, the device synchronised) times the card's bf16 peak, in percent."""

from perfbench import costs, harness


def read(ctx):
    seconds = harness.median(ctx.get("spans", {}).get("train_step", []))
    if not seconds:
        return None
    t = ctx["traffic"]
    return 100.0 * costs.ssm_train_flops(ctx["model"], t["batch"], t["seq"]) / (seconds * costs.PEAK_FLOPS["bfloat16"])
