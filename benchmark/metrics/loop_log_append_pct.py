"""The share of the window the brokers' event loop spent writing to
the log (the leader's append loop in raft/replicate_batcher.py
_flush_round, the follower's native append and the Python route's
write and flush in raft/consensus.py): 100 x the change in the sum of
loop_section_seconds{section=log_append} over window_s, all three brokers,
in %."""

FAMILY, LABELS = "loop_section_seconds", {"section": "log_append"}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 100.0 * total / ctx.window_s if count else None
