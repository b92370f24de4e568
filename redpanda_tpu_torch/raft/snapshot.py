"""Raft snapshot metadata + payload envelopes.

Reference: src/v/raft/consensus.cc install_snapshot handling and
raft/types.h install_snapshot_request; the on-disk container is the
shared snapshot format (storage/snapshot.py ↔ src/v/storage/snapshot.h).

A raft snapshot marks a prefix of the log as discarded: everything
at-or-below `last_included_index` is summarized by the metadata
(term, group configuration at that point) plus named state blobs
contributed by the state machines layered on the log (offset
translator + producer table for data partitions; reference rm_stm /
archival/controller snapshots ride the same container). A follower
that receives the snapshot via INSTALL_SNAPSHOT drops its entire log,
restores the blobs, and resumes appends at `last_included_index + 1`
(recovery_stm.cc install_snapshot fallback).
"""

from __future__ import annotations

from ..utils import serde


class RaftSnapshotMetadata(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("last_included_index", serde.i64),
        ("last_included_term", serde.i64),
        ("config", serde.bytes_t),  # GroupConfiguration.encode()
    ]


class SnapshotPayload(serde.Envelope):
    """Named state-machine blobs (parallel vectors)."""

    SERDE_FIELDS = [
        ("names", serde.vector(serde.string)),
        ("blobs", serde.vector(serde.bytes_t)),
    ]
