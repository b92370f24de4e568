"""Mean fsync wait of a log flush, coalescer queueing included
(storage/log.py): storage_flush_wait_seconds over the window, all three
brokers, in ms."""

FAMILY, LABELS = "storage_flush_wait_seconds", {}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 1e3 * total / count if count else None
