"""Partition/topic manifests — the object-store index of a partition.

Reference: src/v/cloud_storage/partition_manifest.h (per-NTP sorted
segment map keyed by base offset, with per-segment delta_offset for
raft→kafka translation) and topic_manifest.h (topic config for
recovery). Serialized with the project serde (versioned envelopes)
rather than the reference's JSON/serde dual format.
"""

from __future__ import annotations

import bisect

from ..utils import serde


class SegmentMeta(serde.Envelope):
    """One uploaded segment (partition_manifest.h segment_meta)."""

    # v2 appends name_hint, v3 appends size_compressed; compat stays 1,
    # so older readers accept newer blobs and skip the tail via the
    # envelope size (decode fills SERDE_DEFAULTS for missing fields
    # when reading older blobs)
    SERDE_VERSION = 3

    SERDE_FIELDS = [
        ("base_offset", serde.i64),  # raft space
        ("last_offset", serde.i64),  # raft space, inclusive
        ("term", serde.i64),
        ("size_bytes", serde.i64),
        ("base_timestamp", serde.i64),
        ("max_timestamp", serde.i64),
        # raft→kafka delta at the segment's base (kafka = raft - delta);
        # remote readers re-derive the running delta batch by batch
        ("delta_offset", serde.i64),
        # delta through the segment's LAST offset — seeds the offset
        # translator when a partition is recovered from the manifest
        ("delta_offset_end", serde.i64),
        # merged segments carry an explicit object name so the merged
        # object NEVER collides with the key of a segment it replaced
        # (adjacent_segment_merger.cc); "" = derive from base/term
        ("name_hint", serde.string),
        # uploaded object size when the archiver compressed the segment
        # (RP_ARCHIVE_COMPRESSION=zstd): the remote reader hydrates the
        # whole object, length-checks against THIS, and decompresses;
        # size_bytes stays the logical/uncompressed size everywhere
        # (retention accounting, batch offsets). 0 = stored verbatim.
        ("size_compressed", serde.i64),
    ]

    SERDE_DEFAULTS = {"name_hint": "", "size_compressed": 0}

    @property
    def name(self) -> str:
        return self.name_hint or f"{self.base_offset}-{self.term}.seg"


def _segments_serde() -> serde.SerdeType:
    """Wire-compatible with vector(SegmentMeta): encodes any sequence
    of SegmentMeta/SegmentView, decodes into the columnar
    SegmentMetaStore (cstore.py) so 100k-segment manifests hold
    ~30 B/row instead of ~350."""
    inner = serde.vector(SegmentMeta.serde())

    def enc(out: bytearray, v) -> None:
        import struct as _struct

        out += _struct.pack("<I", len(v))
        for m in v:
            out += m.encode()  # SegmentMeta and SegmentView both encode

    def dec(p):
        from .cstore import SegmentMetaStore

        return SegmentMetaStore(inner.decode(p))

    return serde.SerdeType(enc, dec, inner.spec)


class PartitionManifest(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
        ("revision", serde.i64),
        ("segments", _segments_serde()),
    ]

    # -- key layout (remote paths) ------------------------------------
    @staticmethod
    def prefix(ns: str, topic: str, partition: int) -> str:
        return f"{ns}/{topic}/{partition}"

    def key(self) -> str:
        return f"{self.prefix(self.ns, self.topic, self.partition)}/manifest.bin"

    def segment_key(self, meta: SegmentMeta) -> str:
        return f"{self.prefix(self.ns, self.topic, self.partition)}/{meta.name}"

    # -- queries ------------------------------------------------------
    @property
    def archived_upto(self) -> int:
        """Last raft offset covered by uploads (-1 when empty)."""
        return int(self.segments[-1].last_offset) if self.segments else -1

    @property
    def start_offset(self) -> int:
        return int(self.segments[0].base_offset) if self.segments else 0

    def find(self, raft_offset: int):
        """Segment containing raft_offset (SegmentMeta or the
        columnar store's view — same attribute surface)."""
        segs = self.segments
        if not segs:
            return None
        find_c = getattr(segs, "find_containing", None)
        if find_c is not None:
            return find_c(raft_offset)
        bases = [int(s.base_offset) for s in segs]
        i = bisect.bisect_right(bases, raft_offset) - 1
        if i < 0:
            return None
        s = segs[i]
        return s if raft_offset <= int(s.last_offset) else None

    def add(self, meta: SegmentMeta) -> None:
        if self.segments and int(meta.base_offset) <= int(
            self.segments[-1].last_offset
        ):
            raise ValueError(
                f"segment {meta.base_offset} overlaps archived range "
                f"(upto {self.archived_upto})"
            )
        self.segments.append(meta)


class TopicManifest(serde.Envelope):
    """Topic-level recovery metadata (topic_manifest.h)."""

    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition_count", serde.i32),
        ("replication_factor", serde.i16),
        ("config", serde.mapping(serde.string, serde.optional(serde.string))),
    ]

    @staticmethod
    def key_for(ns: str, topic: str) -> str:
        return f"{ns}/{topic}/topic_manifest.bin"

    def key(self) -> str:
        return self.key_for(self.ns, self.topic)
