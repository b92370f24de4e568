"""Per-shard LRU record-batch cache (reference: src/v/storage/batch_cache.h:45-94).

The read-hot-path accelerator: fetches served from memory never touch
a segment file. Keyed by batch base offset per log; lookup by any
contained offset via bisect. Byte-budgeted LRU eviction stands in for
the reference's integration with the Seastar memory reclaimer.

Two planes share one byte budget:

* decoded plane — RecordBatch objects, serving raft-internal readers
  (Log.read: replay, recovery, followers, compaction)
* wire plane — WireSpan rows (Kafka wire form, raft base offset in
  the first 8 bytes), serving the zero-copy fetch path (Log.read_wire):
  a hot-tail fetch is a base-offset patch on cached bytes, never a
  decode or a re-encode

Both planes are invalidated together by truncation / prefix truncation
/ compaction eviction — anything that rewrites the offset range.
"""

from __future__ import annotations

import bisect
from collections import OrderedDict

from ..models.record import RecordBatch, WireSpan

_DECODED = 0
_WIRE = 1


class BatchCacheIndex:
    """Per-log view into the shared cache (batch_cache_index analog)."""

    def __init__(self, cache: "BatchCache", log_id: int):
        self._cache = cache
        self._log_id = log_id
        self._offsets: list[int] = []  # sorted base offsets (decoded)
        self._wire_offsets: list[int] = []  # sorted base offsets (wire)

    def put(self, batch: RecordBatch) -> None:
        base = batch.header.base_offset
        i = bisect.bisect_left(self._offsets, base)
        if i == len(self._offsets) or self._offsets[i] != base:
            self._offsets.insert(i, base)
        self._cache._put(
            (self._log_id, base, _DECODED), batch, batch.size_bytes(), self
        )

    def get(self, offset: int) -> RecordBatch | None:
        """Batch containing `offset`, if cached."""
        i = bisect.bisect_right(self._offsets, offset) - 1
        if i < 0:
            self._cache.misses += 1
            return None
        base = self._offsets[i]
        batch = self._cache._get((self._log_id, base, _DECODED))
        if batch is None:
            self._cache.misses += 1
            self._offsets.pop(i)
            return None
        if batch.header.last_offset < offset:
            self._cache.misses += 1
            return None
        self._cache.hits += 1
        return batch

    def put_wire(self, row: WireSpan) -> None:
        base = row.base_offset
        i = bisect.bisect_left(self._wire_offsets, base)
        if i == len(self._wire_offsets) or self._wire_offsets[i] != base:
            self._wire_offsets.insert(i, base)
        self._cache._put(
            (self._log_id, base, _WIRE), row, row.size_bytes(), self
        )

    def get_wire(self, offset: int) -> WireSpan | None:
        """WireSpan containing `offset`, if cached."""
        i = bisect.bisect_right(self._wire_offsets, offset) - 1
        if i < 0:
            self._cache.wire_misses += 1
            return None
        base = self._wire_offsets[i]
        row = self._cache._get((self._log_id, base, _WIRE))
        if row is None:
            self._cache.wire_misses += 1
            self._wire_offsets.pop(i)
            return None
        if row.last_offset < offset:
            self._cache.wire_misses += 1
            return None
        self._cache.wire_hits += 1
        return row

    def truncate(self, offset: int) -> None:
        """Drop cached batches at-or-after offset (log truncation)."""
        for offsets, plane in (
            (self._offsets, _DECODED),
            (self._wire_offsets, _WIRE),
        ):
            i = bisect.bisect_left(offsets, offset)
            for base in offsets[i:]:
                self._cache._evict_key((self._log_id, base, plane))
            del offsets[i:]

    def prefix_truncate(self, offset: int) -> None:
        """Drop cached batches entirely below offset (retention /
        snapshot prefix truncation): a read below the log's start must
        miss, not serve phantom pre-truncation data."""
        for offsets, plane in (
            (self._offsets, _DECODED),
            (self._wire_offsets, _WIRE),
        ):
            i = bisect.bisect_left(offsets, offset)
            for base in offsets[:i]:
                self._cache._evict_key((self._log_id, base, plane))
            del offsets[:i]

    def evict_range(self, first: int, last: int) -> None:
        """Drop cached batches whose base falls in [first, last] —
        compaction rewrote that range; the hot tail above stays cached."""
        for offsets, plane in (
            (self._offsets, _DECODED),
            (self._wire_offsets, _WIRE),
        ):
            i = bisect.bisect_left(offsets, first)
            j = bisect.bisect_right(offsets, last)
            for base in offsets[i:j]:
                self._cache._evict_key((self._log_id, base, plane))
            del offsets[i:j]

    def drop_wire(self) -> None:
        """Drop the wire plane only (verify-on-read CRC mismatch: a
        cached span may be the corrupt copy; the next fetch re-reads
        and re-converts from disk)."""
        for base in self._wire_offsets:
            self._cache._evict_key((self._log_id, base, _WIRE))
        del self._wire_offsets[:]

    def _forget(self, base: int, plane: int) -> None:
        offsets = self._offsets if plane == _DECODED else self._wire_offsets
        i = bisect.bisect_left(offsets, base)
        if i < len(offsets) and offsets[i] == base:
            offsets.pop(i)


class BatchCache:
    def __init__(self, max_bytes: int = 128 * 1024 * 1024):
        self._max_bytes = max_bytes
        self._bytes = 0
        # (log_id, base, plane) -> (entry, owning index, size)
        self._map: OrderedDict[tuple[int, int, int], tuple] = OrderedDict()
        self._next_log_id = 0
        self.hits = 0
        self.misses = 0
        self.wire_hits = 0
        self.wire_misses = 0

    def make_index(self) -> BatchCacheIndex:
        self._next_log_id += 1
        return BatchCacheIndex(self, self._next_log_id)

    def _put(self, key, entry, nbytes: int, index: BatchCacheIndex) -> None:
        old = self._map.pop(key, None)
        if old is not None:
            self._bytes -= old[2]
        self._map[key] = (entry, index, nbytes)
        self._bytes += nbytes
        while self._bytes > self._max_bytes and self._map:
            (evicted_key, (_evicted, owner, size)) = self._map.popitem(
                last=False
            )
            self._bytes -= size
            owner._forget(evicted_key[1], evicted_key[2])

    def _get(self, key):
        entry = self._map.get(key)
        if entry is None:
            return None
        self._map.move_to_end(key)
        return entry[0]

    def _evict_key(self, key) -> None:
        entry = self._map.pop(key, None)
        if entry is not None:
            self._bytes -= entry[2]

    @property
    def size_bytes(self) -> int:
        return self._bytes
