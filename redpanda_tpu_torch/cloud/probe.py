"""Tiered-storage probe: the cloud path's /metrics surface.

Reference: the reference's cloud_storage probe families (upload/
download counters, cache hit ratios) trimmed to the consumers this
module tree actually runs. Cardinality discipline (rplint RPL012):
every label value here is a closed enum — op names from the
ObjectStore protocol, degradation kinds from a fixed set, warm/cold —
never an ntp or key, so the family size is bounded regardless of
topic count.

Wiring is callback-based: RetryingStore.on_retry, NtpArchiver /
RemoteReader .on_degraded and RemoteReader.on_read are plain callables
set once at broker boot; the hot paths call pre-bound methods and
never resolve label children per event.
"""

from __future__ import annotations

from ..metrics import MetricsRegistry

# closed set of degradation kinds (bounded label values)
DEGRADATION_KINDS = (
    "torn_manifest",
    "partial_upload",
    "crc_mismatch",
    "cloud_unavailable",
    "partial_remote_read",
)


class CloudProbe:
    def __init__(
        self,
        metrics: MetricsRegistry,
        archival=None,
        cache=None,
        reader=None,
    ):
        self.registry = metrics
        self._retries = metrics.counter(
            "cloud_op_retries_total",
            "Object-store op retries (RetryingStore backoff loop)",
        )
        self._degraded = metrics.counter(
            "cloud_degradation_events_total",
            "Detected/repaired cloud-path faults by kind",
        )
        h = metrics.histogram(
            "cloud_read_seconds",
            "Archived-range read latency (warm = fully cached, "
            "cold = hydrated from the object store)",
        )
        self._obs_warm = h.labels(path="warm").observe
        self._obs_cold = h.labels(path="cold").observe

        if archival is not None:
            archival.store.on_retry = self.note_retry
            archival.on_degraded = self.note_degraded
        if reader is not None:
            reader.store.on_retry = self.note_retry
            reader.on_degraded = self.note_degraded
            reader.on_read = self.note_read
            metrics.gauge(
                "cloud_hydrations_total",
                lambda: reader.hydrations,
                "Object-store range fetches issued by remote reads",
            )
        if cache is not None:
            metrics.gauge(
                "cloud_cache_bytes",
                lambda: cache.cached_bytes,
                "Disk chunk cache resident bytes",
            )
            metrics.gauge(
                "cloud_cache_hits_total",
                lambda: cache.hits,
                "Chunk cache hits",
            )
            metrics.gauge(
                "cloud_cache_misses_total",
                lambda: cache.misses,
                "Chunk cache misses",
            )
            metrics.gauge(
                "cloud_cache_evictions_total",
                lambda: cache.evictions,
                "Chunk cache evictions",
            )

    # -- hooks (hot-path safe: no label-child resolution) -------------
    def note_retry(self, op: str) -> None:
        self._retries.inc(op=op)

    def note_degraded(self, kind: str) -> None:
        self._degraded.inc(kind=kind)

    def note_read(self, seconds: float, hydrated: bool) -> None:
        (self._obs_cold if hydrated else self._obs_warm)(seconds)
