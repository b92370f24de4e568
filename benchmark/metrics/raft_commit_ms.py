"""Mean time from a batch's replicate enqueue to its quorum commit
(raft/consensus.py, replicate_batcher.py): raft_commit_seconds over the
window, all three brokers, in ms."""

FAMILY, LABELS = "raft_commit_seconds", {}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 1e3 * total / count if count else None
