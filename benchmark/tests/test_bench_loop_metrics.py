"""The event loop's readers (metrics/loop_*.py, fetch_polls_per_fetch.py)
on hand-made histogram snapshots of three brokers: the arithmetic, and
None where the run gave them nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import run
from harness import cell

P = "redpanda_tpu_"
SECTIONS = ("recompress", "fetch_read", "fetch_verify", "tick_host", "log_append")


def _broker(sections: dict, loop=None, polls=None) -> dict:
    """One broker's families: {section: (sum, count)}, the loop
    monitor's (busy, stall) (sum, count) pairs where it owns them."""
    fams = {P + "loop_section_seconds": [({"section": k}, s, n) for k, (s, n) in sections.items()]}
    if loop is not None:
        fams[P + "reactor_busy_seconds"] = [({}, *loop[0])]
        fams[P + "reactor_stall_seconds"] = [({}, *loop[1])]
    if polls is not None:
        fams[P + "kafka_fetch_polls"] = [({}, *polls)]
    return fams


def _ctx(h0, h1, window_s=10.0):
    return SimpleNamespace(hist=run.hist_delta(h0, h1), window_s=window_s)


def test_shares_of_the_window_over_three_brokers():
    zero = {k: (0.0, 0) for k in SECTIONS}
    h0 = [_broker({**zero, "gc": (0.5, 3)}, loop=((1.0, 100), (0.1, 1)), polls=(10, 5)),
          _broker(zero, polls=(0, 0)), _broker(zero, polls=(4, 2))]
    per = {"recompress": (0.30, 120), "fetch_read": (0.20, 900), "fetch_verify": (0.05, 40),
           "tick_host": (0.10, 60), "log_append": (0.15, 360)}
    h1 = [_broker({**per, "gc": (0.7, 9)}, loop=((6.0, 5100), (1.1, 11)), polls=(210, 15)),
          _broker(per, polls=(100, 20)), _broker(per, polls=(84, 22))]
    ctx = _ctx(h0, h1)
    assert cell.reader("loop_busy_pct")(ctx) == pytest.approx(100 * 5.0 / 10.0)
    assert cell.reader("loop_stall_pct")(ctx) == pytest.approx(100 * 1.0 / 10.0)
    assert cell.reader("loop_gc_pct")(ctx) == pytest.approx(100 * 0.2 / 10.0)
    for k, (s, _) in per.items():
        assert cell.reader(f"loop_{k}_pct")(ctx) == pytest.approx(100 * 3 * s / 10.0)
    # (200 + 100 + 80) passes over (10 + 20 + 20) fetches
    assert cell.reader("fetch_polls_per_fetch")(ctx) == pytest.approx(380 / 50)


def test_a_measured_loop_without_stalls_or_pauses_reads_zero():
    h0 = [_broker({"gc": (0.5, 3)}, loop=((1.0, 100), (0.1, 1)))]
    h1 = [_broker({"gc": (0.5, 3)}, loop=((2.0, 900), (0.1, 1)))]
    ctx = _ctx(h0, h1)
    assert cell.reader("loop_stall_pct")(ctx) == 0.0
    assert cell.reader("loop_gc_pct")(ctx) == 0.0
    assert cell.reader("loop_busy_pct")(ctx) == pytest.approx(10.0)


@pytest.mark.parametrize("metric", ["loop_busy_pct", "loop_stall_pct", "loop_gc_pct", "fetch_polls_per_fetch",
                                    *(f"loop_{k}_pct" for k in SECTIONS)])
def test_none_where_nothing_was_counted(metric):
    # a program without the loop's families (the parent of the change
    # that added them), and one whose counts did not move
    assert cell.reader(metric)(_ctx([{}] * 3, [{}] * 3)) is None
    same = [_broker({k: (1.0, 4) for k in (*SECTIONS, "gc")}, loop=((1.0, 10), (0.0, 0)), polls=(8, 4))]
    assert cell.reader(metric)(_ctx(same, same)) is None
