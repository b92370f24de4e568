"""The share of the window the brokers' event loop spent in stalls:
iterations that held it at least blocked_reactor_notify_ms (25 ms;
resource_mgmt.py LoopMonitor): 100 x the change in the sum of
reactor_stall_seconds over window_s, in %. 0 where the loop was
measured (reactor_busy_seconds counted iterations) and none stalled."""

FAMILY, LOOP = "reactor_stall_seconds", "reactor_busy_seconds"


def read(ctx):
    if not ctx.hist(LOOP)[1]:
        return None
    return 100.0 * ctx.hist(FAMILY)[0] / ctx.window_s
