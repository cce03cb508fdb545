"""device_idle.sample: the share of the traced sampling window in which no
operation ran on the device, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
