"""The share of the window the brokers' event loop spent recompressing
produced batches (kafka/server.py handle_produce, every
RecordBatch.recompressed() call: staging, copies, the card's kernel and
its readback): 100 x the change in the sum of
loop_section_seconds{section=recompress} over window_s, all three brokers,
in %."""

FAMILY, LABELS = "loop_section_seconds", {"section": "recompress"}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 100.0 * total / ctx.window_s if count else None
