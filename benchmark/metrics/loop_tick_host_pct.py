"""The share of the window the brokers' event loop spent in the
heartbeat tick's host work (raft/heartbeat_manager.py: the frames'
build, the replies' fold with the card's tick kernel, the lag scan;
not the send's wait): 100 x the change in the sum of
loop_section_seconds{section=tick_host} over window_s, all three brokers,
in %."""

FAMILY, LABELS = "loop_section_seconds", {"section": "tick_host"}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 100.0 * total / ctx.window_s if count else None
