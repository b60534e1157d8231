"""forward_ms.train: the program's ``train.forward`` phase (``transformer.loss_fn``) on the device's
clock, median over the window's steps."""

from perfbench import program


def read(ctx):
    return program.window_median(ctx, "train.forward.device_ms", "train_step")
