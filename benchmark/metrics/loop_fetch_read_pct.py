"""The share of the window the brokers' event loop spent reading fetch
responses (kafka/server.py handle_fetch, every pass of read_all() in
the long-poll): 100 x the change in the sum of
loop_section_seconds{section=fetch_read} over window_s, all three brokers,
in %."""

FAMILY, LABELS = "loop_section_seconds", {"section": "fetch_read"}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 100.0 * total / ctx.window_s if count else None
