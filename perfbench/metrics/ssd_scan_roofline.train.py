"""ssd_scan_roofline.train: percent of the SSD scan's least time (``costs.ssd_cost`` per call, the
remat's recompute included) in the device time of its three kernels, over one profiled training step."""

from perfbench import trace


def read(ctx):
    return trace.kernel_roofline(ctx.get("profile"), "ssd_scan")
