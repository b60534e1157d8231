"""ssd_scan_bwd_roofline: percent of the scan gradient's least time (``costs.ssd_bwd_cost`` per
call) in the device time of its five kernels, over one profiled training step."""

from perfbench import trace


def read(ctx):
    return trace.kernel_roofline(ctx.get("profile"), "ssd_scan_bwd")
