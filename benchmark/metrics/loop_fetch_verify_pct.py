"""The share of the window the brokers' event loop spent verifying
fetch responses' CRCs (kafka/server.py _verify_fetch_response, the
card's CRC kernel inside): 100 x the change in the sum of
loop_section_seconds{section=fetch_verify} over window_s, all three brokers,
in %."""

FAMILY, LABELS = "loop_section_seconds", {"section": "fetch_verify"}


def read(ctx):
    total, count = ctx.hist(FAMILY, **LABELS)
    return 100.0 * total / ctx.window_s if count else None
