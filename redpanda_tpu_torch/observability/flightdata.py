"""Flight-data plane, part 1: on-broker metrics history.

Every `/metrics` scrape is a point in time; SLO verdicts need windows.
This module keeps a fixed-size ring of periodic registry samples —
counters as cumulative values, histograms as raw bucket arrays — so
windowed queries are *exact*, not approximations over pre-reduced
quantiles (the same ship-the-buckets argument as the PR 6 fleet
merge):

  rate / delta    counter over [now - window, now] is the difference
                  of two cumulative samples; a series born inside the
                  window starts from zero, which is exactly its value
                  at window start (counters are monotone from 0).
  quantile        the windowed distribution is the bucket-wise
                  difference of two cumulative bucket arrays; any
                  quantile of the window falls out of the diff child.
  gauge stats     min/max/avg/last over the samples in the window.

Served at `GET /v1/metrics/history` and fleet-merged over `invoke_on`
("obs"/"history") with serde envelopes (RPL009: nothing pickled
crosses the shard boundary). Stand-down: `RP_FLIGHTDATA=0` disables
the sampling task (queries answer with no data, never an error).

Gauge callbacks may be expensive (the health exporter re-reduces every
raft lane), so gauges refresh every `RP_FLIGHTDATA_GAUGE_EVERY` ticks
(default 5) and sample-and-hold in between; counters and histograms —
the exact-math surfaces the alert rules and rate cross-checks read —
are captured on every tick.
"""

from __future__ import annotations

import asyncio
import os
import time
from collections import deque
from typing import Callable, Optional

from ..metrics import (
    _NBUCKETS,
    Counter,
    Gauge,
    Histogram,
    HistogramChild,
    MetricsRegistry,
)
from ..utils.serde import (
    Envelope,
    envelope,
    f64,
    i32,
    mapping,
    string,
    u64,
    vector,
)
from .fleet import HistSeries
from ..utils.tasks import cancel_and_wait

ENABLED = os.environ.get("RP_FLIGHTDATA", "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# 1 Hz ring covering 11 min: the slow burn-rate window (10 min) plus
# margin, ~20 histogram children x 176-int buckets per sample
DEFAULT_INTERVAL_S = _env_float("RP_FLIGHTDATA_INTERVAL_S", 1.0)
DEFAULT_CAPACITY = int(_env_float("RP_FLIGHTDATA_RING", 660))
# Counters and histograms are plain in-memory copies (microseconds);
# gauges run callbacks that may do real work per read — the health
# exporter's gauges rebuild the vectorized lag reduction over every
# raft lane. Re-running those at the full sampling rate measurably
# taxes the broker (~5% replicated throughput at 1k partitions on one
# core), so gauges refresh every Nth tick and hold in between.
DEFAULT_GAUGE_EVERY = max(1, int(_env_float("RP_FLIGHTDATA_GAUGE_EVERY", 5)))


class _Sample:
    """One ring slot: cumulative counters, sampled gauges, raw
    histogram buckets, stamped with both clocks (monotonic for window
    math, wall only for display)."""

    __slots__ = ("mono", "wall", "counters", "gauges", "hists")

    def __init__(self, mono: float, wall: float):
        self.mono = mono
        self.wall = wall
        # family -> {labels_key_tuple: value}
        self.counters: dict[str, dict[tuple, float]] = {}
        self.gauges: dict[str, dict[tuple, float]] = {}
        # family -> {labels_key_tuple: (buckets, overflow, sum, count)}
        self.hists: dict[str, dict[tuple, tuple]] = {}


def capture_sample(
    reg: MetricsRegistry,
    mono: float,
    wall: float,
    hold_gauges: Optional[dict] = None,
) -> _Sample:
    """Snapshot the registry. When `hold_gauges` is given, gauge
    callbacks are NOT invoked — the previous sample's gauge snapshot is
    aliased instead (samples are immutable once captured, so sharing
    the dicts is safe). Sample-and-hold: gauge window stats then weight
    the held value once per tick, which is exactly what a slower gauge
    sampler interleaved with the fast ring would report."""
    s = _Sample(mono, wall)
    for name, m in reg.families().items():
        if isinstance(m, Histogram):
            series: dict[tuple, tuple] = {}
            if m._default is not None:
                c = m._default
                series[()] = (list(c._buckets), c._overflow, c._sum, c._count)
            for key, c in m._children.items():
                series[key] = (list(c._buckets), c._overflow, c._sum, c._count)
            s.hists[name] = series
        elif isinstance(m, Counter):
            s.counters[name] = dict(m._values)
        elif isinstance(m, Gauge):
            if hold_gauges is None:
                s.gauges[name] = {
                    tuple(sorted(labels.items())): v
                    for labels, v in m.samples()
                }
    if hold_gauges is not None:
        s.gauges = hold_gauges
    return s


def _labels_match(key: tuple, want: Optional[dict]) -> bool:
    if not want:
        return True
    have = dict(key)
    return all(have.get(k) == v for k, v in want.items())


def _diff_child(new: tuple, old: Optional[tuple]) -> HistogramChild:
    nb, nov, nsum, ncnt = new
    if old is None:
        return HistogramChild.from_counts(list(nb), nov, nsum, ncnt)
    ob, oov, osum, ocnt = old
    if ncnt < ocnt:
        # counter reset: the shard restarted mid-window and its
        # cumulative histogram restarted from zero — the new counts
        # ARE the in-window observations (clamping each bucket to 0
        # would erase every post-restart sample instead)
        return HistogramChild.from_counts(list(nb), nov, nsum, ncnt)
    buckets = [max(0, nb[i] - ob[i]) for i in range(_NBUCKETS)]
    return HistogramChild.from_counts(
        buckets, max(0, nov - oov), max(0.0, nsum - osum), max(0, ncnt - ocnt)
    )


class MetricsHistory:
    """The ring plus its periodic sampling task. One instance per
    process shard; the admin handler merges shard rings over the obs
    service (`window_reply` / `merge_window_replies`)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        interval_s: Optional[float] = None,
        capacity: Optional[int] = None,
        gauge_every: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.registry = registry
        self.interval_s = (
            DEFAULT_INTERVAL_S if interval_s is None else float(interval_s)
        )
        self.capacity = max(3, DEFAULT_CAPACITY if capacity is None else int(capacity))
        self.gauge_every = max(
            1, DEFAULT_GAUGE_EVERY if gauge_every is None else int(gauge_every)
        )
        self._clock = clock
        self._wall = wall_clock
        self._ring: deque[_Sample] = deque(maxlen=self.capacity)
        self.samples_total = 0
        self._task: Optional[asyncio.Task] = None

    # -- lifecycle ----------------------------------------------------
    def sample(self) -> None:
        hold = None
        if (
            self.gauge_every > 1
            and self._ring
            and self.samples_total % self.gauge_every
        ):
            hold = self._ring[-1].gauges
        self._ring.append(
            capture_sample(
                self.registry, self._clock(), self._wall(), hold_gauges=hold
            )
        )
        self.samples_total += 1

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            self.sample()

    def start(self) -> None:
        if self._task is None:
            self.sample()  # seed the ring so windows answer immediately
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        task, self._task = self._task, None
        await cancel_and_wait(task)

    # -- introspection ------------------------------------------------
    def span_s(self) -> float:
        if len(self._ring) < 2:
            return 0.0
        return self._ring[-1].mono - self._ring[0].mono

    def kind_of(self, family: str) -> Optional[str]:
        if not self._ring:
            return None
        s = self._ring[-1]
        if family in s.counters:
            return "counter"
        if family in s.hists:
            return "histogram"
        if family in s.gauges:
            return "gauge"
        return None

    def families(self) -> dict:
        """Catalog for the no-family form of /v1/metrics/history."""
        fams: dict[str, dict] = {}
        if self._ring:
            s = self._ring[-1]
            for name, d in s.counters.items():
                fams[name] = {"kind": "counter", "series": len(d)}
            for name, d in s.gauges.items():
                fams[name] = {"kind": "gauge", "series": len(d)}
            for name, d in s.hists.items():
                fams[name] = {"kind": "histogram", "series": len(d)}
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "depth": len(self._ring),
            "span_s": self.span_s(),
            "families": {k: fams[k] for k in sorted(fams)},
        }

    # -- window selection ---------------------------------------------
    def _window(self, window_s: float):
        """(old, new) ring samples bracketing [now - window_s, now]:
        the newest sample at-or-before the cutoff, clamped to the
        oldest slot when the ring (or its wraparound) no longer
        reaches that far back, and to one interval minimum."""
        if len(self._ring) < 2:
            return None
        new = self._ring[-1]
        cutoff = new.mono - max(0.0, float(window_s))
        old = self._ring[0]
        for s in reversed(self._ring):
            if s is new:
                continue
            if s.mono <= cutoff:
                old = s
                break
        return old, new

    # -- reducers -----------------------------------------------------
    def counter_window(
        self, family: str, window_s: float, labels: Optional[dict] = None
    ) -> Optional[dict]:
        w = self._window(window_s)
        if w is None:
            return None
        old, new = w
        new_vals = new.counters.get(family)
        if new_vals is None:
            return None
        old_vals = old.counters.get(family, {})
        dt = max(new.mono - old.mono, 1e-9)
        series = []
        total = 0.0
        for key, v in sorted(new_vals.items()):
            if not _labels_match(key, labels):
                continue
            # absent at window start == exactly zero then: counters are
            # cumulative-from-zero, so a series born mid-window (or
            # re-entering after ring wraparound dropped its zero) still
            # yields the exact in-window delta. v < old is a COUNTER
            # RESET — a shard died and its reborn child restarted from
            # zero mid-window — and the new cumulative value IS the
            # in-window delta (the Prometheus rate() convention); the
            # old clamp-to-zero swallowed all post-restart traffic
            # until the window slid past the crash
            ov = old_vals.get(key, 0.0)
            d = v if v < ov else v - ov
            total += d
            series.append({"labels": dict(key), "delta": d, "rate": d / dt})
        return {
            "kind": "counter",
            "window_s": dt,
            "series": series,
            "total_delta": total,
            "total_rate": total / dt,
        }

    def rate(
        self, family: str, window_s: float, labels: Optional[dict] = None
    ) -> Optional[float]:
        w = self.counter_window(family, window_s, labels)
        return None if w is None else w["total_rate"]

    def delta(
        self, family: str, window_s: float, labels: Optional[dict] = None
    ) -> Optional[float]:
        w = self.counter_window(family, window_s, labels)
        return None if w is None else w["total_delta"]

    def hist_window(
        self, family: str, window_s: float, labels: Optional[dict] = None
    ):
        """(dt, {labels_key: windowed HistogramChild}) or None."""
        w = self._window(window_s)
        if w is None:
            return None
        old, new = w
        new_series = new.hists.get(family)
        if new_series is None:
            return None
        old_series = old.hists.get(family, {})
        dt = max(new.mono - old.mono, 1e-9)
        out = {
            key: _diff_child(counts, old_series.get(key))
            for key, counts in new_series.items()
            if _labels_match(key, labels)
        }
        return dt, out

    def quantile(
        self,
        family: str,
        window_s: float,
        q: float,
        labels: Optional[dict] = None,
    ) -> Optional[dict]:
        w = self.hist_window(family, window_s, labels)
        if w is None:
            return None
        dt, children = w
        merged = HistogramChild()
        for c in children.values():
            merged.merge_from(c)
        return {
            "kind": "histogram",
            "window_s": dt,
            "q": q,
            "value": merged.quantile(q),
            "count": merged._count,
            "sum": merged._sum,
        }

    def gauge_window(
        self, family: str, window_s: float, labels: Optional[dict] = None
    ) -> Optional[dict]:
        w = self._window(window_s)
        if w is None:
            return None
        old, new = w
        if family not in new.gauges:
            return None
        cutoff = old.mono
        series: dict[tuple, dict] = {}
        n_in = 0
        for s in self._ring:
            if s.mono < cutoff or family not in s.gauges:
                continue
            n_in += 1
            for key, v in s.gauges[family].items():
                if not _labels_match(key, labels):
                    continue
                st = series.get(key)
                if st is None:
                    series[key] = {
                        "labels": dict(key),
                        "min": v, "max": v, "last": v, "_sum": v, "_n": 1,
                    }
                else:
                    st["min"] = min(st["min"], v)
                    st["max"] = max(st["max"], v)
                    st["last"] = v
                    st["_sum"] += v
                    st["_n"] += 1
        rows = []
        for key in sorted(series):
            st = series[key]
            st["avg"] = st.pop("_sum") / st.pop("_n")
            rows.append(st)
        return {
            "kind": "gauge",
            "window_s": new.mono - old.mono,
            "samples": n_in,
            "series": rows,
        }

    def query(
        self,
        family: str,
        window_s: float,
        reduce: Optional[str] = None,
        q: float = 0.99,
        labels: Optional[dict] = None,
    ) -> Optional[dict]:
        """Admin-route dispatch: pick the reducer by family kind when
        the caller didn't name one."""
        kind = self.kind_of(family)
        if kind is None:
            return None
        if reduce in (None, "", "auto"):
            reduce = {
                "counter": "rate",
                "histogram": "quantile",
                "gauge": "stats",
            }[kind]
        if reduce in ("rate", "delta"):
            out = self.counter_window(family, window_s, labels)
        elif reduce == "quantile":
            out = self.quantile(family, window_s, q, labels)
        elif reduce == "stats":
            out = self.gauge_window(family, window_s, labels)
        else:
            raise ValueError(f"unknown reducer {reduce!r}")
        if out is not None:
            out["family"] = family
            out["reduce"] = reduce
        return out


# ------------------------------------------------------------- wire
class WindowQuery(Envelope):
    """Shard-0 -> worker: one windowed family query."""

    SERDE_FIELDS = [
        ("family", string),
        ("window_s", f64),
        ("labels", mapping(string, string)),
    ]


class WindowRow(Envelope):
    """One counter/gauge series of a windowed reply (counter: delta
    over the window; gauge: last sampled value)."""

    SERDE_FIELDS = [
        ("labels", mapping(string, string)),
        ("value", f64),
    ]


class WindowReply(Envelope):
    """One shard's windowed view of a family. kind "" means the family
    does not exist (yet) on that shard — merged as empty, not an
    error. Histograms ship the windowed *diff* buckets so the fleet
    quantile merge stays exact."""

    SERDE_FIELDS = [
        ("shard", i32),
        ("kind", string),
        ("dt", f64),
        ("samples", u64),
        ("rows", vector(envelope(WindowRow))),
        ("hist", vector(envelope(HistSeries))),
    ]


def window_reply(
    history: MetricsHistory, shard: int, query: WindowQuery
) -> WindowReply:
    """Worker-side handler for the obs "history" method."""
    family = query.family
    labels = dict(query.labels) if query.labels else None
    window_s = query.window_s
    kind = history.kind_of(family)
    empty = WindowReply(
        shard=shard, kind="", dt=0.0, samples=0, rows=[], hist=[]
    )
    if kind is None:
        return empty
    if kind == "counter":
        w = history.counter_window(family, window_s, labels)
        if w is None:
            return empty
        return WindowReply(
            shard=shard,
            kind="counter",
            dt=w["window_s"],
            samples=len(w["series"]),
            rows=[
                WindowRow(labels=r["labels"], value=r["delta"])
                for r in w["series"]
            ],
            hist=[],
        )
    if kind == "histogram":
        w = history.hist_window(family, window_s, labels)
        if w is None:
            return empty
        dt, children = w
        return WindowReply(
            shard=shard,
            kind="histogram",
            dt=dt,
            samples=sum(c._count for c in children.values()),
            rows=[],
            hist=[
                HistSeries(
                    labels=dict(key),
                    buckets=c._buckets,
                    overflow=c._overflow,
                    sum=c._sum,
                    count=c._count,
                )
                for key, c in sorted(children.items())
            ],
        )
    w = history.gauge_window(family, window_s, labels)
    if w is None:
        return empty
    return WindowReply(
        shard=shard,
        kind="gauge",
        dt=w["window_s"],
        samples=w["samples"],
        rows=[
            WindowRow(labels=r["labels"], value=r["last"])
            for r in w["series"]
        ],
        hist=[],
    )


def merge_window_replies(
    replies: list[WindowReply], q: float = 0.99
) -> dict:
    """Shard-0 merge: counter deltas sum by label set (each shard's
    rate uses its own dt, so per-shard clock skew cannot smear the
    math); histogram diff buckets merge then answer the quantile;
    gauges keep per-shard rows with a shard label injected (summing
    last-values across shards has no single meaning)."""
    live = [r for r in replies if r.kind]
    if not live:
        return {"kind": None, "shards": len(replies), "series": []}
    kind = live[0].kind
    if kind == "counter":
        by_labels: dict[tuple, dict] = {}
        total_delta = 0.0
        total_rate = 0.0
        for r in live:
            dt = max(r.dt, 1e-9)
            for row in r.rows:
                key = tuple(sorted(row.labels.items()))
                st = by_labels.setdefault(
                    key, {"labels": dict(row.labels), "delta": 0.0, "rate": 0.0}
                )
                st["delta"] += row.value
                st["rate"] += row.value / dt
                total_delta += row.value
                total_rate += row.value / dt
        return {
            "kind": "counter",
            "shards": len(replies),
            "window_s": max(r.dt for r in live),
            "series": [by_labels[k] for k in sorted(by_labels)],
            "total_delta": total_delta,
            "total_rate": total_rate,
        }
    if kind == "histogram":
        merged = HistogramChild()
        per_series: dict[tuple, HistogramChild] = {}
        for r in live:
            for hs in r.hist:
                c = hs.to_child()
                merged.merge_from(c)
                key = tuple(sorted(hs.labels.items()))
                have = per_series.get(key)
                if have is None:
                    per_series[key] = c
                else:
                    have.merge_from(c)
        return {
            "kind": "histogram",
            "shards": len(replies),
            "window_s": max(r.dt for r in live),
            "q": q,
            "value": merged.quantile(q),
            "count": merged._count,
            "sum": merged._sum,
            "series": [
                {
                    "labels": dict(key),
                    "count": c._count,
                    "value": c.quantile(q),
                }
                for key, c in sorted(per_series.items())
            ],
        }
    rows = []
    for r in live:
        for row in r.rows:
            labels = dict(row.labels)
            labels["shard"] = str(r.shard)
            rows.append({"labels": labels, "last": row.value})
    return {
        "kind": "gauge",
        "shards": len(replies),
        "window_s": max(r.dt for r in live),
        "series": rows,
    }
