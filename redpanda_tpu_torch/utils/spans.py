"""Featherweight span accounting for hot-path attribution.

`cProfile` on this 1-core box distorts the 3-broker in-process cluster
by an order of magnitude (the r4 replicated-path investigation: a 4 s
window ran >10 CPU-minutes under cProfile), so perf work uses explicit
spans instead: RP_SPANS=1 arms them, `add(name, dt)` is a dict update,
and `report()` prints count/total/mean/max per span. Disarmed (the
default) the cost is one bool check at each site.
"""

from __future__ import annotations

import os
import time

ENABLED = os.environ.get("RP_SPANS", "0") == "1"

_acc: dict[str, list] = {}


def add(name: str, dt: float) -> None:
    if not ENABLED:
        return
    e = _acc.get(name)
    if e is None:
        _acc[name] = [1, dt, dt]
    else:
        e[0] += 1
        e[1] += dt
        if dt > e[2]:
            e[2] = dt


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        add(self.name, time.perf_counter() - self.t0)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str):
    """with span("x"): ... — disarmed, returns a shared no-op context
    (no per-call allocation on hot paths)."""
    if not ENABLED:
        return _NOOP
    return _Span(name)


def reset() -> None:
    _acc.clear()


def report() -> str:
    if not _acc:
        return ""
    rows = sorted(_acc.items(), key=lambda kv: -kv[1][1])
    out = [
        f"{'span':<40} {'count':>9} {'total_ms':>10} {'mean_us':>9} {'max_ms':>8}"
    ]
    for name, (count, total, mx) in rows:
        out.append(
            f"{name:<40} {count:>9} {total*1e3:>10.1f} "
            f"{total/count*1e6:>9.1f} {mx*1e3:>8.2f}"
        )
    return "\n".join(out)
