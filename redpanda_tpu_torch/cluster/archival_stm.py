"""Replicated archival metadata state.

Reference: src/v/archival/archival_metadata_stm.{h,cc} — Redpanda
replicates every "segment N is archived" fact through the partition's
own raft log, so ALL replicas agree on the archived boundary without
consulting the object store: retention gating on followers, leadership
failover, and log replay all read local replicated state.

Commands ride `RecordBatchType.archival_metadata` batches with one
record per command:

  key=b"add_segment"  value=SegmentMeta.encode()
      appends one uploaded segment (idempotent: entries at-or-below
      the archived boundary are ignored on replay/duplicate delivery)
  key=b"reset"        value=PartitionManifest.encode()
      replaces the whole state — used when the object store's manifest
      is AHEAD of the replicated state (crash after upload before the
      command committed, or a topic freshly recovered from a bucket)

The state snapshots into the partition's raft-snapshot contribution so
a follower healed via install_snapshot learns the archived range
without replaying the full log.
"""

from __future__ import annotations

import logging

from ..cloud.manifest import PartitionManifest, SegmentMeta
from ..utils import serde

logger = logging.getLogger("rp.archival_stm")

ADD_SEGMENT = b"add_segment"
RESET = b"reset"
# drop archived segments entirely below a raft offset (cloud retention:
# the bucket must not grow forever; value = 8-byte LE new start offset)
TRUNCATE = b"truncate"
# replace a contiguous run of archived segments with one merged segment
# (adjacent_segment_merger/segment_reupload); value = merged
# SegmentMeta.encode(). Applies ONLY when the merged range exactly
# spans existing entries — stale or replayed commands no-op.
REPLACE = b"replace"


class _ArchivalStateE(serde.Envelope):
    SERDE_FIELDS = [
        ("revision", serde.i64),
        ("segments", serde.vector(serde.bytes_t)),  # SegmentMeta.encode()s
    ]


class ArchivalState:
    """In-memory replicated archival metadata for one partition.

    Commands are staged at APPEND time and folded into the visible
    state only once their offset commits (`apply_committed`) — exactly
    the _dr_markers pattern: acting on an uncommitted archived-fact
    would let retention reclaim data raft never agreed was archived.
    Because committed entries can never be suffix-truncated (the
    append path crash-guards that), the applied state survives
    truncation untouched; only the staged tail is rebuilt from the
    surviving log."""

    __slots__ = ("segments", "revision", "pending")

    def __init__(self) -> None:
        from ..cloud.cstore import SegmentMetaStore

        # columnar (delta-for) store: ~13 B/segment vs ~350 for a list
        # of envelopes — 100k-segment manifests stay in memory
        # (ref segment_meta_cstore.h)
        self.segments: SegmentMetaStore = SegmentMetaStore()
        self.revision = 0
        # (command batch offset, key, value) staged at append time
        self.pending: list[tuple[int, bytes | None, bytes | None]] = []

    @property
    def archived_upto(self) -> int:
        """Last raft offset durably in the object store AND agreed by
        raft (-1 = none)."""
        return int(self.segments[-1].last_offset) if self.segments else -1

    def clear(self) -> None:
        self.segments.clear()
        self.revision = 0
        self.pending.clear()

    def drop_pending(self) -> None:
        """Suffix truncation hook: the replay that follows re-stages
        whatever survives in the log."""
        self.pending.clear()

    # -- command application (replay-safe, never raises) --------------
    def _apply(self, key: bytes | None, value: bytes | None) -> None:
        try:
            if key == ADD_SEGMENT and value:
                meta = SegmentMeta.decode(value)
                if int(meta.base_offset) > self.archived_upto:
                    self.segments.append(meta)
                    self.revision += 1
            elif key == RESET and value:
                m = PartitionManifest.decode(value)
                if m.archived_upto > self.archived_upto:
                    from ..cloud.cstore import SegmentMetaStore

                    self.segments = SegmentMetaStore(m.segments)
                    self.revision = int(m.revision)
            elif key == REPLACE and value:
                merged = SegmentMeta.decode(value)
                base = int(merged.base_offset)
                last = int(merged.last_offset)
                i = next(
                    (
                        k
                        for k, s_ in enumerate(self.segments)
                        if int(s_.base_offset) == base
                    ),
                    None,
                )
                if i is None:
                    return
                j = i
                while (
                    j < len(self.segments)
                    and int(self.segments[j].last_offset) < last
                ):
                    j += 1
                if (
                    j >= len(self.segments)
                    or int(self.segments[j].last_offset) != last
                ):
                    return  # range doesn't align with entry boundaries
                if j == i and self.segments[i].name == merged.name:
                    return  # replay: already replaced
                self.segments[i : j + 1] = [merged]
                self.revision += 1
            elif key == TRUNCATE and value:
                new_start = int.from_bytes(value, "little", signed=True)
                before = len(self.segments)
                from ..cloud.cstore import SegmentMetaStore

                self.segments = SegmentMetaStore(
                    s
                    for s in self.segments
                    if int(s.last_offset) >= new_start
                )
                if len(self.segments) != before:
                    self.revision += 1
        except Exception:
            # a malformed command from a newer/corrupt writer must not
            # wedge log replay; the archiver re-syncs from the store
            logger.exception("archival command %r failed to apply", key)

    def stage_batch(self, batch) -> None:
        off = int(batch.header.base_offset)
        for rec in batch.records():
            self.pending.append((off, rec.key, rec.value))

    def apply_committed(self, commit_index: int) -> None:
        """Fold staged commands whose offset has committed."""
        if not self.pending:
            return
        keep = []
        for off, key, value in self.pending:
            if off <= commit_index:
                self._apply(key, value)
            else:
                keep.append((off, key, value))
        self.pending = keep

    # -- manifest view / snapshot --------------------------------------
    def to_manifest(self, ns: str, topic: str, partition: int) -> PartitionManifest:
        return PartitionManifest(
            ns=ns,
            topic=topic,
            partition=partition,
            revision=self.revision,
            segments=list(self.segments),
        )

    def encode(self) -> bytes:
        return _ArchivalStateE(
            revision=self.revision,
            segments=[s.encode() for s in self.segments],
        ).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "ArchivalState":
        st = cls()
        if not raw:
            return st
        e = _ArchivalStateE.decode(raw)
        st.revision = int(e.revision)
        st.segments = [SegmentMeta.decode(b) for b in e.segments]
        return st
