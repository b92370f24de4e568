"""Prometheus-format metrics registry.

Reference: the reference exposes two Prometheus endpoints
(redpanda/application.cc:460-520, /metrics + /public_metrics) fed by
per-subsystem probes (raft/probe.cc:47-101, kafka latency_probe.h,
storage probes). Here one registry holds counters (incremented on hot
paths — a dict bump, no locks needed on one event loop), gauges
(callables sampled at scrape time, so idle brokers pay nothing), and
log2-bucketed histograms (the utils/hdr_hist.h analog: observe() is
one frexp + list bump; quantiles come from the buckets at read time).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Optional


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    __slots__ = ("name", "help", "_values")

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, **labels: str) -> None:
        self._values[tuple(sorted(labels.items()))] += value

    def samples(self) -> list[tuple[dict[str, str], float]]:
        """(labels, value) pairs for the fleet snapshot protocol."""
        return [(dict(key), v) for key, v in sorted(self._values.items())]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        if not self._values:
            out.append(f"{self.name} 0")
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v:g}")
        return out


class Gauge:
    """Sampled at scrape time: `fn` returns either a number or a
    list[(labels_dict, value)] for labeled families."""

    __slots__ = ("name", "help", "fn", "_errs")

    def __init__(self, name: str, help_: str, fn: Callable, errs: Optional[Counter] = None):
        self.name = name
        self.help = help_
        self.fn = fn
        self._errs = errs

    def samples(self) -> list[tuple[dict[str, str], float]]:
        """Sample `fn` now; a raising gauge yields no samples (and
        counts in scrape_errors), same contract as render()."""
        try:
            v = self.fn()
        except Exception:
            if self._errs is not None:
                self._errs.inc(gauge=self.name)
            return []
        if isinstance(v, (int, float)):
            return [({}, float(v))]
        return [(dict(labels), float(value)) for labels, value in v]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for labels, value in self.samples():
            out.append(f"{self.name}{_fmt_labels(labels)} {value:g}")
        return out


# log2 bucketing with 8 linear sub-buckets per octave (hdr_hist with
# one significant-figure precision): worst-case relative quantile
# error is half a sub-bucket width, ~6%, well inside the 15% window
# bench --probes cross-checks against wall-clock timers.
_SUBBUCKETS = 8
_MIN_EXP = -16  # first bucket upper bound 2^-16 * 9/16 ≈ 8.6 us
_MAX_EXP = 5    # last octave tops out at 2^5 = 32 s
_NOCTAVES = _MAX_EXP - _MIN_EXP + 1
_NBUCKETS = _NOCTAVES * _SUBBUCKETS

# precomputed upper bound of each bucket, in seconds
_BOUNDS = [
    (2.0 ** (_MIN_EXP + i // _SUBBUCKETS)) * (0.5 + (i % _SUBBUCKETS + 1) / 16.0)
    for i in range(_NBUCKETS)
]


class HistogramChild:
    """One bucket array — either a histogram's sole (unlabeled) series
    or one labeled series. Probes hold direct refs so the hot path is
    a single bound-method call."""

    __slots__ = ("_buckets", "_overflow", "_sum", "_count")

    def __init__(self) -> None:
        self._buckets = [0] * _NBUCKETS
        self._overflow = 0
        self._sum = 0.0
        self._count = 0

    def observe(self, seconds: float) -> None:
        self._sum += seconds
        self._count += 1
        if seconds <= 0.0:
            self._buckets[0] += 1
            return
        # seconds = m * 2**e with m in [0.5, 1), i.e. the octave whose
        # upper bound is 2**(e) ... so octave index = e - _MIN_EXP
        m, e = math.frexp(seconds)
        i = (e - _MIN_EXP) * _SUBBUCKETS + int((m - 0.5) * 16.0)
        if i < 0:
            self._buckets[0] += 1
        elif i >= _NBUCKETS:
            self._overflow += 1
        else:
            self._buckets[i] += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0..1) in seconds. HdrHistogram
        percentile convention (utils/hdr_hist.h): the highest value
        equivalent to the containing bucket — every recorded sample at
        this rank is <= the returned value. 0.0 when empty."""
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0
        for i, n in enumerate(self._buckets):
            if n == 0:
                continue
            if cum + n >= rank:
                return _BOUNDS[i]
            cum += n
        return _BOUNDS[-1]

    def snapshot(self) -> dict:
        return {
            "count": self._count,
            "sum": self._sum,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
        }

    def counts(self) -> tuple[list[int], int, float, int]:
        """(buckets, overflow, sum, count) — the raw state the fleet
        snapshot envelopes carry across the shard boundary."""
        return list(self._buckets), self._overflow, self._sum, self._count

    @classmethod
    def from_counts(
        cls, buckets: list[int], overflow: int, sum_: float, count: int
    ) -> "HistogramChild":
        c = cls()
        n = min(len(buckets), _NBUCKETS)
        c._buckets[:n] = [int(b) for b in buckets[:n]]
        c._overflow = int(overflow) + sum(int(b) for b in buckets[n:])
        c._sum = sum_
        c._count = count
        return c

    def merge_from(self, other: "HistogramChild") -> None:
        ob = other._buckets
        b = self._buckets
        for i in range(_NBUCKETS):
            b[i] += ob[i]
        self._overflow += other._overflow
        self._sum += other._sum
        self._count += other._count

    def render_into(self, out: list[str], name: str, labels: dict[str, str]) -> None:
        # sparse exposition: only boundaries where the cumulative count
        # advances (plus +Inf) — Prometheus semantics only require the
        # emitted series to be cumulative
        cum = 0
        for i, n in enumerate(self._buckets):
            if n == 0:
                continue
            cum += n
            lab = dict(labels)
            lab["le"] = f"{_BOUNDS[i]:g}"
            out.append(f"{name}_bucket{_fmt_labels(lab)} {cum}")
        cum += self._overflow
        lab = dict(labels)
        lab["le"] = "+Inf"
        out.append(f"{name}_bucket{_fmt_labels(lab)} {cum}")
        out.append(f"{name}_sum{_fmt_labels(labels)} {self._sum:g}")
        out.append(f"{name}_count{_fmt_labels(labels)} {self._count}")


class Histogram:
    """Log2-bucketed latency histogram (observations in seconds).

    Unlabeled use: `h.observe(s)` hits the default child. Labeled use:
    resolve a child once (`c = h.labels(path="native")`) at probe init
    and call `c.observe(s)` on the hot path — label resolution never
    happens per event.
    """

    __slots__ = ("name", "help", "_default", "_children")

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._default: Optional[HistogramChild] = None
        self._children: dict[tuple, HistogramChild] = {}

    def labels(self, **labels: str) -> HistogramChild:
        key = tuple(sorted(labels.items()))
        c = self._children.get(key)
        if c is None:
            c = HistogramChild()
            self._children[key] = c
        return c

    def observe(self, seconds: float) -> None:
        c = self._default
        if c is None:
            c = self._default = HistogramChild()
        c.observe(seconds)

    def quantile(self, q: float) -> float:
        """q-quantile across all series (merged)."""
        merged = self._merged()
        return merged.quantile(q)

    def series(self) -> list[tuple[dict[str, str], HistogramChild]]:
        """(labels, child) pairs in render order (default series first)."""
        out: list[tuple[dict[str, str], HistogramChild]] = []
        if self._default is not None:
            out.append(({}, self._default))
        out.extend((dict(key), c) for key, c in sorted(self._children.items()))
        return out

    def _merged(self) -> HistogramChild:
        series = list(self._children.values())
        if self._default is not None:
            series.append(self._default)
        if len(series) == 1:
            return series[0]
        m = HistogramChild()
        for s in series:
            m.merge_from(s)
        return m

    def snapshot(self) -> dict:
        """JSON-friendly quantile summary (per-series + merged)."""
        snap = self._merged().snapshot()
        if self._children:
            snap["series"] = {
                _fmt_labels(dict(key)) or "{}": c.snapshot()
                for key, c in sorted(self._children.items())
            }
        return snap

    def render(self) -> list[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        if self._default is not None or not self._children:
            (self._default or HistogramChild()).render_into(out, self.name, {})
        for key, c in sorted(self._children.items()):
            c.render_into(out, self.name, dict(key))
        return out


class MetricsRegistry:
    def __init__(self, prefix: str = "redpanda_tpu"):
        self.prefix = prefix
        self._metrics: dict[str, object] = {}
        # gauges that raise at sample time count here instead of
        # silently dropping out of the scrape
        self.scrape_errors = self.counter(
            "metrics_scrape_errors_total",
            "gauge sample functions that raised during render",
        )

    def counter(self, name: str, help_: str = "") -> Counter:
        full = f"{self.prefix}_{name}"
        m = self._metrics.get(full)
        if m is None:
            m = Counter(full, help_)
            self._metrics[full] = m
        return m

    def gauge(self, name: str, fn: Callable, help_: str = "") -> Gauge:
        full = f"{self.prefix}_{name}"
        m = Gauge(full, help_, fn, errs=self.scrape_errors)
        self._metrics[full] = m
        return m

    def histogram(self, name: str, help_: str = "") -> Histogram:
        full = f"{self.prefix}_{name}"
        m = self._metrics.get(full)
        if m is None:
            m = Histogram(full, help_)
            self._metrics[full] = m
        return m

    def adopt(self, other: "MetricsRegistry") -> None:
        """Alias every family of `other` into this registry (shared
        objects, not copies) so process-global planes — the devplane
        registry is the one user: the device is process-global while
        brokers are per-instance — ride this registry's scrape, fleet
        snapshot, and flightdata ring. Names already present here win
        (each registry keeps its own scrape_errors)."""
        for name, m in other.families().items():
            self._metrics.setdefault(name, m)

    def families(self) -> dict[str, object]:
        """name -> Counter | Gauge | Histogram, for the fleet snapshot."""
        return dict(self._metrics)

    def histograms(self) -> dict[str, Histogram]:
        return {
            name: m
            for name, m in self._metrics.items()
            if isinstance(m, Histogram)
        }

    def render(self) -> str:
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"
