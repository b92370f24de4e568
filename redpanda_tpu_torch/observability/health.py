"""Bounded-cardinality partition-health surfacing.

This module is the ONE sanctioned place where per-NTP values become
metric labels (rplint RPL012 exempts it): everything it exports is
top-k truncated or a fixed-width distribution, so a 100k-partition
broker scrapes the same number of samples as a 100-partition one.

Three surfaces share the code here:

  * `HealthSampler` — refresh-once-per-scrape cache over the raft
    health lanes + load ledger (group_manager.health_report and
    ledger.top/skew are not free at 100k rows; one snapshot serves the
    whole gauge family and the admin endpoint).
  * `register_exporter` — the bounded gauge family on a
    MetricsRegistry: scalar aggregates, top-k per-NTP lag/load
    samples, and the whole-fleet lag distribution as fixed log2
    buckets (`le` labels, cumulative like a histogram).
  * `merge_reports` — fold per-shard health reports (local dicts or
    decoded fleet envelopes) into one fleet view: counts sum, max-lag
    maxes, top-k lists re-rank and truncate, lag buckets add, and the
    shard skew index is max/mean over per-shard total byte rates.
"""

from __future__ import annotations

import math

import numpy as np

from .load_ledger import skew_of

# fixed lag distribution: bucket 0 counts lag == 0, bucket i>=1 counts
# lag <= 2^(i-1), last bucket is +Inf — 22 labels at any fleet size
LAG_BUCKETS = 22
_LAG_EDGES = [0] + [1 << i for i in range(LAG_BUCKETS - 2)]


def lag_bucket_edges() -> list[str]:
    """`le` label values, aligned with lag_histogram's buckets."""
    return [str(e) for e in _LAG_EDGES] + ["+Inf"]


def lag_histogram(lags: np.ndarray) -> list[int]:
    """Cumulative bucket counts of a lag vector (leader rows)."""
    counts = [0] * LAG_BUCKETS
    if len(lags):
        lags = np.asarray(lags, np.int64)
        for i, edge in enumerate(_LAG_EDGES):
            counts[i] = int(np.count_nonzero(lags <= edge))
        counts[-1] = int(len(lags))
    return counts


READ_PATH_KEYS = (
    "cache_hits",
    "cache_misses",
    "wire_hits",
    "wire_misses",
    "reader_hits",
    "reader_misses",
)


def empty_report() -> dict:
    return {
        "active": 0,
        "max_follower_lag": 0,
        "under_replicated": 0,
        "leaderless": 0,
        "skew": 1.0,
        "rates": {
            "produce_bps": 0.0,
            "fetch_bps": 0.0,
            "append_bps": 0.0,
            "total_bps": 0.0,
        },
        "top_laggy": [],
        "top_hot": [],
        "lag_histogram": [0] * LAG_BUCKETS,
        "read_path": dict.fromkeys(READ_PATH_KEYS, 0),
    }


def read_path_stats(storage) -> dict:
    """Fetch/read-plane counters off a StorageApi: batch-cache planes
    (decoded + wire) and the positioned-reader hint hits summed over
    the shard's logs. Mirrors the probe's storage_read gauge family in
    report form so the fleet merge can sum them."""
    cache = storage.cache
    reader_hits = reader_misses = 0
    for log in storage.log_mgr.logs().values():
        reader_hits += log.reader_hits
        reader_misses += log.reader_misses
    return {
        "cache_hits": cache.hits,
        "cache_misses": cache.misses,
        "wire_hits": cache.wire_hits,
        "wire_misses": cache.wire_misses,
        "reader_hits": reader_hits,
        "reader_misses": reader_misses,
    }


def build_report(group_manager, ledger, top_k: int = 10, storage=None) -> dict:
    """One shard's full health report: raft lanes + load ledger, plus
    the read-path cache counters when the caller hands its StorageApi."""
    rep = group_manager.health_report(top_k=top_k)
    rep["top_hot"] = ledger.top(top_k)
    rep["skew"] = ledger.skew()
    rep["rates"] = ledger.totals()
    if storage is not None:
        rep["read_path"] = read_path_stats(storage)
    return rep


def merge_reports(reports: list[dict], top_k: int = 10) -> dict:
    """Fold shard reports into one fleet view (see module docstring).
    `shard_skew` is the cross-shard load imbalance — the signal the
    placement layer consumes; per-NTP `skew` merges as the max (a hot
    key on any shard is a hot key of the fleet)."""
    out = empty_report()
    laggy: list[dict] = []
    hot: list[dict] = []
    shard_loads: list[float] = []
    for rep in reports:
        out["active"] += rep.get("active", 0)
        out["max_follower_lag"] = max(
            out["max_follower_lag"], rep.get("max_follower_lag", 0)
        )
        out["under_replicated"] += rep.get("under_replicated", 0)
        out["leaderless"] += rep.get("leaderless", 0)
        out["skew"] = max(out["skew"], rep.get("skew", 1.0))
        rates = rep.get("rates") or {}
        for k in out["rates"]:
            out["rates"][k] += rates.get(k, 0.0)
        shard_loads.append(rates.get("total_bps", 0.0))
        laggy.extend(rep.get("top_laggy", []))
        hot.extend(rep.get("top_hot", []))
        hist = rep.get("lag_histogram")
        if hist:
            out["lag_histogram"] = [
                a + b for a, b in zip(out["lag_histogram"], hist)
            ]
        rp = rep.get("read_path") or {}
        for k in READ_PATH_KEYS:
            out["read_path"][k] += rp.get(k, 0)
    laggy.sort(key=lambda r: r.get("lag", 0), reverse=True)
    hot.sort(key=lambda r: r.get("total_bps", 0.0), reverse=True)
    out["top_laggy"] = laggy[:top_k]
    out["top_hot"] = hot[:top_k]
    out["shard_skew"] = skew_of(shard_loads)
    out["shards"] = len(reports)
    return out


class HealthSampler:
    """Refresh-once cache over (group_manager, ledger): every gauge in
    the exporter family reads one snapshot per scrape instead of
    re-reducing 100k rows per sample line."""

    def __init__(self, group_manager, ledger, top_k: int = 10,
                 max_age_s: float = 0.25, clock=None):
        import time

        self._gm = group_manager
        self._ledger = ledger
        self.top_k = top_k
        self._max_age = max_age_s
        self._clock = clock or time.monotonic
        self._at = -math.inf
        self._rep: dict = empty_report()

    def report(self, fresh: bool = False) -> dict:
        now = self._clock()
        if fresh or now - self._at > self._max_age:
            self._rep = build_report(self._gm, self._ledger, self.top_k)
            self._at = now
        return self._rep


def register_exporter(metrics, sampler: HealthSampler,
                      prefix: str = "partition_health") -> None:
    """The bounded /metrics surface: 4 scalars + <=2k labeled top-k
    samples + LAG_BUCKETS distribution lines, independent of fleet
    size. Labeled families use the Gauge list-valued fn convention."""
    metrics.gauge(
        f"{prefix}_max_follower_lag",
        lambda: sampler.report()["max_follower_lag"],
        "worst follower lag (entries) over leader partitions",
    )
    metrics.gauge(
        f"{prefix}_under_replicated",
        lambda: sampler.report()["under_replicated"],
        "leader partitions with a voter behind the commit index",
    )
    metrics.gauge(
        f"{prefix}_leaderless",
        lambda: sampler.report()["leaderless"],
        "active partitions with no known leader",
    )
    metrics.gauge(
        "partition_load_skew_index",
        lambda: sampler.report()["skew"],
        "max/mean per-NTP load ratio (1.0 = balanced)",
    )

    def _top_lag():
        return [
            ({"ntp": r["key"]}, float(r["lag"]))
            for r in sampler.report()["top_laggy"]
        ]

    metrics.gauge(
        f"{prefix}_top_lag",
        _top_lag,
        "follower lag of the top-k laggiest partitions (top-k only)",
    )

    def _top_load():
        return [
            ({"ntp": r["key"]}, r["total_bps"])
            for r in sampler.report()["top_hot"]
        ]

    metrics.gauge(
        "partition_load_top_bps",
        _top_load,
        "total byte rate of the top-k hottest partitions (top-k only)",
    )

    edges = lag_bucket_edges()

    def _lag_dist():
        hist = sampler.report()["lag_histogram"]
        return [({"le": e}, float(c)) for e, c in zip(edges, hist)]

    metrics.gauge(
        f"{prefix}_lag_bucket",
        _lag_dist,
        "cumulative lag distribution over leader partitions "
        "(fixed log2 buckets)",
    )
