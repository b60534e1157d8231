"""ssd_scan_roofline.prefill: percent of the SSD scan's least time (``costs.ssd_cost`` per call)
in the device time of its three kernels, over the profiled stretch of a prefill."""

from perfbench import trace


def read(ctx):
    return trace.kernel_roofline(ctx.get("profile"), "ssd_scan")
