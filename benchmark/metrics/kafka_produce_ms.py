"""Mean time of a produce request in the brokers' Kafka front end
(kafka/server.py), frame arrival to response encoded after its acks:
the change in sum over the change in count of
kafka_request_stage_seconds{api=produce,stage=done} over the window,
every path label and all three brokers, in ms."""

FAMILY, LABELS = "kafka_request_stage_seconds", {"api": "produce", "stage": "done"}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 1e3 * total / count if count else None
