"""Storage probe (reference: src/v/storage probes feeding
disk_log_impl / segment appender metrics).

One probe per broker (StorageApi), threaded LogManager -> Log so every
log on the shard shares the same histogram families.

Wired sites:
  segment append   Log.append — the active segment write (header fix
                   + disk write), per batch
  flush wait       Log.flush_async — executor fsync including the
                   flush-coalescer queueing delay it rides on
  compaction       Log.compact — one key-based compaction pass
"""

from __future__ import annotations

from typing import Optional

from ..metrics import MetricsRegistry


class StorageProbe:
    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        m = metrics if metrics is not None else MetricsRegistry()
        self.registry = m
        self.segment_append_hist = m.histogram(
            "storage_segment_append_seconds",
            "Active-segment batch append (disk write path)",
        )
        self.flush_wait_hist = m.histogram(
            "storage_flush_wait_seconds",
            "fsync wait including flush-coalescer queueing",
        )
        self.compaction_hist = m.histogram(
            "storage_compaction_seconds",
            "One key-based log compaction pass",
        )
        # hot-path pre-resolved observers
        self.observe_append = self.segment_append_hist.observe
        self.observe_flush_wait = self.flush_wait_hist.observe

    def register_read_metrics(self, cache, log_mgr) -> None:
        """Export the read-path counters as the `storage_read` family.

        Registered as one labelled gauge over live counters (no hot-path
        instrumentation cost) so they ride everything the registry rides:
        `/metrics`, the fleet snapshot merge, and the flightdata history
        ring. `cache` is the shard's BatchCache, `log_mgr` the LogManager
        whose logs carry the positioned-reader counters."""

        def _read_stats():
            reader_hits = reader_misses = 0
            for log in log_mgr.logs().values():
                reader_hits += log.reader_hits
                reader_misses += log.reader_misses
            return [
                ({"counter": "cache_hits"}, cache.hits),
                ({"counter": "cache_misses"}, cache.misses),
                ({"counter": "wire_cache_hits"}, cache.wire_hits),
                ({"counter": "wire_cache_misses"}, cache.wire_misses),
                ({"counter": "reader_hits"}, reader_hits),
                ({"counter": "reader_misses"}, reader_misses),
                ({"counter": "cache_bytes"}, cache.size_bytes),
            ]

        self.registry.gauge(
            "storage_read",
            _read_stats,
            "Read-path cache and positioned-reader counters",
        )


_fixture_probe: Optional[StorageProbe] = None


def fixture_probe() -> StorageProbe:
    """Shared standalone probe for Logs built without a Broker."""
    global _fixture_probe
    if _fixture_probe is None:
        _fixture_probe = StorageProbe()
    return _fixture_probe
