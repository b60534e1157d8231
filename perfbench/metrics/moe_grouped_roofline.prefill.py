"""moe_grouped_roofline.prefill: percent of the prefill's grouped expert products' least time
(``costs_moe.prefill_grouped_least_ms``: every layer's call over the traffic's T x k rows and all the
layer's experts) in the device time of the kernel's prefill entry point over the profiled batch;
nothing without that kernel or when the batch's records of the counted kernels are incomplete."""

from perfbench import costs_moe


def read(ctx):
    profile = ctx.get("profile")
    if not profile or not all(profile["complete"].values()):
        return None
    device_s = profile["kernel_s"].get(costs_moe.PREFILL_KERNEL, 0.0)
    if device_s <= 0:
        return None
    t = ctx["traffic"]
    least_ms = costs_moe.prefill_grouped_least_ms(ctx["model"], t["batch"], t["prompt"])
    return 100.0 * least_ms / 1e3 / device_s
