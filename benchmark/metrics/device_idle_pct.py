"""The share of the traced window in which no operation of this process
ran on the card: one minus the union of the profiler's device
operation intervals (kernels, copies, sets) over the window's length."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
