"""What the profiler saw on the card in the traced window: every device
operation (kernels, copies, sets) as (name, start s, end s), read from
the Kineto results of `torch.profiler`, and what follows from them:
the union of their intervals (the device busy), its gaps (idle), and
seconds by operation name."""

from __future__ import annotations

from torch.autograd import DeviceType


def device_ops(prof) -> list:
    """[(name, start s, end s)] of the device's operations, by start."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = ev.start_ns() * 1e-9
        out.append((ev.name(), start, start + ev.duration_ns() * 1e-9))
    out.sort(key=lambda e: e[1])
    return out


def busy(ops: list, lo: float, hi: float) -> tuple:
    """(seconds covered by the union of `ops` within [lo, hi], the gaps
    as [(seconds, name before, name after)])."""
    covered, gaps = 0.0, []
    cur_end, prev = lo, "window start"
    for name, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur_end:
            gaps.append((s - cur_end, prev, name))
        if e > cur_end:
            covered += e - max(s, cur_end)
            cur_end = e
            prev = name
    if hi > cur_end:
        gaps.append((hi - cur_end, prev, "window end"))
    return covered, gaps


def by_name(ops: list) -> dict:
    out: dict = {}
    for name, s, e in ops:
        out[name] = out.get(name, 0.0) + (e - s)
    return out
