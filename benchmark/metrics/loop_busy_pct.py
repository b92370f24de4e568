"""The brokers' event loop's busy share of the window: time outside the
selector's wait, one observation a loop iteration (resource_mgmt.py
LoopMonitor, process-wide, so in one broker's registry): 100 x the
change in the sum of reactor_busy_seconds over window_s, in %."""

FAMILY = "reactor_busy_seconds"


def read(ctx):
    total, count = ctx.hist(FAMILY)
    return 100.0 * total / ctx.window_s if count else None
