"""Read passes a fetch's long-poll made, on average over the fetches
answered in the window (kafka/server.py handle_fetch, a pass every 5 ms
until min_bytes or max_wait): the change in the sum of kafka_fetch_polls
over the change in its count, all three brokers."""

FAMILY = "kafka_fetch_polls"


def read(ctx):
    total, count = ctx.hist(FAMILY)
    return total / count if count else None
