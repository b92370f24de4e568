"""The share of the window the collector's pauses held the brokers'
event loop (resource_mgmt.py MemoryGovernor, the `gc` loop section,
process-wide): 100 x the change in the sum of
loop_section_seconds{section=gc} over window_s, in %. 0 where the loop
was measured (reactor_busy_seconds counted iterations) and no pause
fell in the window."""

FAMILY, LABELS, LOOP = "loop_section_seconds", {"section": "gc"}, "reactor_busy_seconds"


def read(ctx):
    if not ctx.hist(LOOP)[1]:
        return None
    return 100.0 * ctx.hist(FAMILY, **LABELS)[0] / ctx.window_s
