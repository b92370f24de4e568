"""Mean time of a fetch request in the brokers' Kafka front end
(kafka/server.py), long-poll wait included: kafka_request_stage_seconds
{api=fetch,stage=done} over the window, all three brokers, in ms."""

FAMILY, LABELS = "kafka_request_stage_seconds", {"api": "fetch", "stage": "done"}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 1e3 * total / count if count else None
