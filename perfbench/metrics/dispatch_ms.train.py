"""dispatch_ms.train: the program's ``train.step`` phase on the host's clock: from the step's call to
its return, which waits for nothing on the device, so the host's dispatch of the step; median over
the window's steps."""

from perfbench import program


def read(ctx):
    return program.window_median(ctx, "train.step.host_ms", "train_step")
