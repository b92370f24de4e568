"""Serde envelopes for the live partition-move protocol (RPL009: no
pickle crosses a shard boundary). One coordinator (the PartitionMover
on shard 0) drives freeze → ship → commit → retire against the
per-shard MoveHost endpoints, each of which speaks these frames.
"""

from __future__ import annotations

from ..utils.serde import (
    Envelope,
    boolean,
    bytes_t,
    i32,
    i64,
    optional,
    string,
    vector,
)


class MoveRef(Envelope):
    """Identifies the moving partition on a host."""

    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("group", i64),
    ]


class MoveManifest(Envelope):
    """Freeze reply: everything the target needs to adopt the group —
    raft hard state (term/voted_for/config), log bounds, the raft
    snapshot blob if one exists, and the log config to recreate the
    storage layer byte-compatibly."""

    SERDE_FIELDS = [
        ("ok", boolean),
        ("error", string),
        ("group", i64),
        ("term", i64),
        ("voted_for", i32),
        ("commit_index", i64),
        ("start_offset", i64),
        ("dirty_offset", i64),
        ("committed_offset", i64),
        ("snap_index", i64),
        ("snap_term", i64),
        ("snap_blob", bytes_t),
        ("config", bytes_t),
        ("replicas", vector(i32)),
        ("ledger_key", string),
        # log config (mirrors ssx PartitionCreate)
        ("segment_max_bytes", i64),
        ("retention_bytes", optional(i64)),
        ("retention_ms", optional(i64)),
        ("cleanup_policy", string),
        ("local_retention_bytes", optional(i64)),
        ("local_retention_ms", optional(i64)),
    ]


class MoveChunkRequest(Envelope):
    """Source: read raw record batches starting at `pos`."""

    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("group", i64),
        ("pos", i64),
        ("max_bytes", i64),
    ]


class MoveChunk(Envelope):
    """One shipped window of RecordBatch.serialize() frames; also the
    target-side write request (begin staged the identity already)."""

    SERDE_FIELDS = [
        ("group", i64),
        ("batches", vector(bytes_t)),
        ("next_pos", i64),
        ("done", boolean),
    ]


class MoveBegin(Envelope):
    """Target: stage the adoption — create the log, seed the raft hard
    state in the kvstore, install the snapshot blob."""

    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("manifest", bytes_t),  # MoveManifest.encode()
    ]


class MoveCommitReply(Envelope):
    """Target commit reply: the adopted group's new lane row and the
    recovered log bounds (differential check against the manifest)."""

    SERDE_FIELDS = [
        ("ok", boolean),
        ("error", string),
        ("row", i32),
        ("dirty_offset", i64),
        ("committed_offset", i64),
        ("chip", i32),  # mesh device holding the row (0 off-mesh)
    ]
    SERDE_DEFAULTS = {"chip": 0}


class MoveAck(Envelope):
    SERDE_FIELDS = [("ok", boolean), ("error", string)]


class LaneMove(Envelope):
    """Coordinator → owning shard: migrate `group`'s lane row into
    `dst_chip`'s block of the shard's device mesh (freeze → lane
    evacuate → lane adopt → rebind, all within one ShardGroupArrays —
    the (chip, lane) half of a placement move)."""

    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("group", i64),
        ("dst_chip", i32),
    ]


class LaneMoveReply(Envelope):
    """Lane-move reply: the rebound (chip, row) slot plus where the
    lane came from (src echo — the coordinator's idempotence check)."""

    SERDE_FIELDS = [
        ("ok", boolean),
        ("error", string),
        ("row", i32),
        ("chip", i32),
        ("src_row", i32),
        ("src_chip", i32),
    ]


class RaftForward(Envelope):
    """One raw raft RPC frame forwarded from the broker's RPC server
    (shard 0) to the worker shard that owns the group (RaftService
    shard seam — the follower half of retiring the shard-0 pin)."""

    SERDE_FIELDS = [("method", i32), ("payload", bytes_t)]


class LeaderHint(Envelope):
    """One worker-shard leadership observation relayed to shard 0 so
    the metadata plane (leaders table + cross-broker dissemination)
    covers worker-owned groups."""

    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("group", i64),
        ("term", i64),
        ("leader", i32),  # -1 = leaderless
        ("row", i32),     # lane row on the owning shard
        ("chip", i32),    # mesh device holding the row (0 off-mesh)
    ]
    SERDE_DEFAULTS = {"chip": 0}


class LeaderHintBatch(Envelope):
    SERDE_FIELDS = [("shard", i32), ("hints", vector(bytes_t))]
