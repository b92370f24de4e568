"""The 95th percentile, over every produce request due in the window,
of the time from when it was due to its acks=all reply, on the load
generator's clock (a request never answered counts to the end of the
run's drain), in ms. A per-layer metric: its spread between runs is
wider than an end-to-end bound may be (PERF.md §2)."""


def read(ctx):
    return ctx.client["publish_p95_ms"]
