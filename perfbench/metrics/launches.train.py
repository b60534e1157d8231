"""launches.train: device kernels in one profiled training step (the profiler's kernel records);
nothing when the step's records of the port's kernels are incomplete."""


def read(ctx):
    profile = ctx.get("profile")
    if not profile or not all(profile["complete"].values()):
        return None
    return float(profile["kernels"])
