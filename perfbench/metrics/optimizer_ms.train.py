"""optimizer_ms.train: the program's ``train.optimizer`` phase (``adamw_update`` on the fp32
masters) on the device's clock, median over the window's steps."""

from perfbench import program


def read(ctx):
    return program.window_median(ctx, "train.optimizer.device_ms", "train_step")
