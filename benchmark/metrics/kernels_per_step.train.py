"""kernels_per_step.train: device kernels launched per training step in the
traced window (copies and sets left out): the host's dispatch work."""


def read(ctx):
    return len(ctx.trace.kernels()) / ctx.trace.units
