"""Mean time of one node's heartbeat tick, build, send and fold
(raft/heartbeat_manager.py over tick_frame.py and shard_state.py, the
card's heartbeat_tick kernel inside): raft_heartbeat_tick_seconds over
the window, all three brokers, in ms."""

FAMILY, LABELS = "raft_heartbeat_tick_seconds", {}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 1e3 * total / count if count else None
