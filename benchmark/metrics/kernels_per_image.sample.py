"""kernels_per_image.sample: device kernels launched per sampled image in
the traced window (copies and sets left out): the host's dispatch work."""


def read(ctx):
    return len(ctx.trace.kernels()) / (ctx.trace.units * ctx.work.images_per_unit)
