"""The end-to-end metrics from the generator's record of a run, on its
clock. A rate is all the work over the whole window; a tail is the tail
of every batch due in the window, timed from when it was due, a missing
one counted as taking until the end of the run's drain."""

from __future__ import annotations

import math


def p95(values: list) -> float:
    """Nearest-rank 95th percentile."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(gen: dict, pool: list) -> dict:
    """{metric: value}, with `attempted` (produce requests due in the
    window), `failed` (of those, never acknowledged) and `late_ms` (how
    late the generator sent its latest request)."""
    t0, t1 = gen["t0"], gen["t1"]
    end = max([a[3] for a in gen["attempts"] if a[3] is not None] + [r[2] for r in gen["receipts"]] + [t1])
    acked = {(p, k): (t_ack, base) for p, k, _, _, t_ack, base in gen["acks"]}
    seen = {}
    for p, b, t, *_ in gen["receipts"]:
        seen.setdefault((p, b), t)
    due = [(p, k, t) for p, k, _, t, _ in gen["sent"] if t0 <= t < t1]
    publish, e2e = [], []
    for p, k, t in due:
        t_ack, base = acked.get((p, k), (None, None))
        publish.append((end if t_ack is None else t_ack) - t)
        t_recv = None if base is None else seen.get((p, base))
        e2e.append((end if t_recv is None else t_recv) - t)
    acked_bytes = sum(sum(len(k) + len(v) for k, v in pool[idx]["records"])
                      for _, _, idx, _, t_ack, _ in gen["acks"] if t0 <= t_ack < t1)
    return {"produce_mb_s": acked_bytes / (t1 - t0) / 1e6, "publish_p95_ms": 1e3 * p95(publish),
            "e2e_p95_ms": 1e3 * p95(e2e), "attempted": len(due),
            "failed": sum(1 for p, k, _ in due if (p, k) not in acked),
            "late_ms": 1e3 * max([s - t for _, _, _, t, s in gen["sent"] if t0 <= t < t1], default=0.0)}
