"""backward_ms.train: the program's ``train.backward`` phase (``autograd.grad``, the remat's
recompute included) on the device's clock, median over the window's steps."""

from perfbench import program


def read(ctx):
    return program.window_median(ctx, "train.backward.device_ms", "train_step")
