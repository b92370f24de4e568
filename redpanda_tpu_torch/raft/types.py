"""Raft RPC wire types (reference: src/v/raft/types.h + raftgen.json).

Serde envelopes for the five raft RPCs: vote, append_entries,
node-batched heartbeat (heartbeat_manager.h:107-121 node_heartbeat),
install_snapshot, timeout_now. Record batches travel as their storage
wire encoding (models.record.RecordBatch.serialize), so the same CRC
checks guard the log and the wire.
"""

from __future__ import annotations

from ..utils import serde

# method ids on the raft service (rpc dispatch table)
VOTE = 100
APPEND_ENTRIES = 101
HEARTBEAT = 102
INSTALL_SNAPSHOT = 103
TIMEOUT_NOW = 104
TRANSFER_LEADERSHIP = 105
# many groups' append_entries multiplexed in one frame per peer node
# (append_entries_buffer.{h,cc} applied ACROSS groups: one RPC, one
# follower pass, one reply — per-call overhead O(1) in group count)
APPEND_ENTRIES_BATCH = 106
# quiesced steady-state heartbeat (no reference analog; an artifact of
# the node-batched vector design): when neither side's raft state has
# changed since the last full exchange, a fixed-size frame replaces
# the O(groups) vector batch. Bound to the armed full frame by a CRC
# of its bytes (minus the per-tick seq vector) so both sides agree on
# exactly which vectors "unchanged" refers to.
HEARTBEAT_SAME = 107

import struct as _struct

_SAME_REQ = _struct.Struct("<iiqI")  # node_id, n_groups, counter, frame_crc
_SAME_REPLY = _struct.Struct("<bq")  # status, echoed counter
SAME_OK = 0
SAME_NEED_FULL = 1


def encode_same_req(node_id: int, n: int, counter: int, crc: int) -> bytes:
    return _SAME_REQ.pack(node_id, n, counter, crc & 0xFFFFFFFF)


def decode_same_req(raw: bytes) -> tuple[int, int, int, int]:
    return _SAME_REQ.unpack(raw)


def encode_same_reply(status: int, counter: int) -> bytes:
    return _SAME_REPLY.pack(status, counter)


def decode_same_reply(raw: bytes) -> tuple[int, int]:
    return _SAME_REPLY.unpack(raw)


def encode_multi(payloads: list[bytes]) -> bytes:
    """Length-prefixed concatenation for APPEND_ENTRIES_BATCH: each
    item is an opaque AppendEntriesRequest/Reply frame."""
    parts = [len(payloads).to_bytes(4, "little")]
    for p in payloads:
        parts.append(len(p).to_bytes(4, "little"))
        parts.append(p)
    return b"".join(parts)


def decode_multi(raw: bytes) -> list[bytes]:
    n = int.from_bytes(raw[:4], "little")
    out: list[bytes] = []
    pos = 4
    for _ in range(n):
        ln = int.from_bytes(raw[pos : pos + 4], "little")
        pos += 4
        out.append(raw[pos : pos + ln])
        pos += ln
    if pos != len(raw):
        raise ValueError("trailing bytes in append batch frame")
    return out


class VoteRequest(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("node_id", serde.i32),
        ("term", serde.i64),
        ("prev_log_index", serde.i64),
        ("prev_log_term", serde.i64),
        ("leadership_transfer", serde.boolean),
        ("prevote", serde.boolean),
    ]


class VoteReply(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("term", serde.i64),
        ("granted", serde.boolean),
        ("log_ok", serde.boolean),
    ]


class AppendEntriesRequest(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("node_id", serde.i32),         # leader id
        ("target_node_id", serde.i32),
        ("term", serde.i64),
        ("prev_log_index", serde.i64),
        ("prev_log_term", serde.i64),
        ("commit_index", serde.i64),
        ("seq", serde.i64),             # reply-reordering guard
        ("flush", serde.boolean),       # acks=all: follower fsyncs before reply
        ("batches", serde.vector(serde.bytes_t)),  # RecordBatch.serialize()
    ]


class AppendEntriesReply(serde.Envelope):
    # reference: raft/types.h append_entries_reply status
    SUCCESS = 0
    FAILURE = 1           # log mismatch at prev → leader backs off
    GROUP_UNAVAILABLE = 2
    TIMEOUT = 3

    SERDE_FIELDS = [
        ("group", serde.i64),
        ("node_id", serde.i32),         # responder
        ("term", serde.i64),
        ("last_dirty_log_index", serde.i64),
        ("last_flushed_log_index", serde.i64),
        ("seq", serde.i64),
        ("status", serde.i8),
    ]


class HeartbeatRequest(serde.Envelope):
    """Node-level batch: one RPC carries the heartbeat vectors for all
    groups shared between two nodes (heartbeat_manager.h:54-83). The
    parallel arrays are produced by one device/numpy gather."""

    SERDE_FIELDS = [
        ("node_id", serde.i32),
        ("target_node_id", serde.i32),
        ("groups", serde.ndvector(serde.i64)),
        ("terms", serde.ndvector(serde.i64)),
        ("prev_log_indices", serde.ndvector(serde.i64)),
        ("prev_log_terms", serde.ndvector(serde.i64)),
        ("commit_indices", serde.ndvector(serde.i64)),
        ("seqs", serde.ndvector(serde.i64)),
    ]


class HeartbeatReply(serde.Envelope):
    SERDE_FIELDS = [
        ("node_id", serde.i32),
        ("groups", serde.ndvector(serde.i64)),
        ("terms", serde.ndvector(serde.i64)),
        ("last_dirty", serde.ndvector(serde.i64)),
        ("last_flushed", serde.ndvector(serde.i64)),
        ("seqs", serde.ndvector(serde.i64)),
        ("statuses", serde.ndvector(serde.i8)),
    ]


# The heartbeat steady-state fast paths splice frames at FIXED offsets
# from the end (heartbeat_manager frame/reply caches, service reply
# cache): sound only while `seqs` is the LAST request field and
# `seqs`, `statuses` (i8) are the last two reply fields. Appending a
# trailing field — normally legal envelope evolution — must relocate
# those splices first; these asserts make that impossible to miss.
assert [n for n, _ in HeartbeatRequest.SERDE_FIELDS][-1] == "seqs"
assert [n for n, _ in HeartbeatReply.SERDE_FIELDS][-2:] == [
    "seqs",
    "statuses",
]


class InstallSnapshotRequest(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("node_id", serde.i32),
        ("term", serde.i64),
        ("last_included_index", serde.i64),
        ("last_included_term", serde.i64),
        ("file_offset", serde.i64),
        ("chunk", serde.bytes_t),
        ("done", serde.boolean),
    ]


class InstallSnapshotReply(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("term", serde.i64),
        ("bytes_stored", serde.i64),
        ("success", serde.boolean),
    ]


class TimeoutNowRequest(serde.Envelope):
    """Leadership transfer: tell the target to start an election
    immediately (raft/consensus.cc transfer_leadership)."""

    SERDE_FIELDS = [
        ("group", serde.i64),
        ("node_id", serde.i32),
        ("term", serde.i64),
    ]


class TimeoutNowReply(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("term", serde.i64),
    ]


class TransferLeadershipRequest(serde.Envelope):
    """Operator/balancer-initiated transfer routed to whatever node
    currently LEADS the group (the leader then runs the timeout_now
    protocol against the target). -1 target = leader's choice."""

    SERDE_FIELDS = [
        ("group", serde.i64),
        ("target", serde.i32),
    ]


class TransferLeadershipReply(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.i64),
        ("success", serde.boolean),
        ("error", serde.string),
    ]
