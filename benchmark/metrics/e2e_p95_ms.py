"""The 95th percentile, over every batch due in the window, of the time
from when it was due to a consumer's receipt of the fetch response
holding it (OMB's end-to-end latency), on the load generator's clock,
in ms. A per-layer metric for the same reason as publish_p95_ms."""


def read(ctx):
    return ctx.client["e2e_p95_ms"]
