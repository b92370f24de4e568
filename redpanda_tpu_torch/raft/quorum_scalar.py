"""Scalar (per-group) consensus decision math — the reference backend.

Implements exactly the semantics of the reference's per-group scalar
sweep (group_configuration.h:407-428 quorum_match;
consensus.cc:2704-2777 leader/follower commit rules) in plain Python.

This is the `consensus_backend=scalar` side of the plugin seam
(SURVEY.md §7 stage 5): raft.consensus can run entirely on it, and the
device backend (ops.quorum) is differential-tested against it —
keeping the batched kernels bit-identical to reference semantics is a
stated hard part (SURVEY.md §8b).
"""

from __future__ import annotations

import dataclasses

I64_MIN = -(2**63)


def quorum_match(values: list[int]) -> int:
    """Ascending (n-1)/2-th order statistic (nth_element semantics)."""
    if not values:
        return I64_MIN
    ordered = sorted(values)
    return ordered[(len(values) - 1) // 2]


def joint_quorum_match(cur_values: list[int], old_values: list[int]) -> int:
    """Joint consensus: min over both voter sets' quorums; old set
    ignored when empty (group_configuration.h:480-490)."""
    cur = quorum_match(cur_values)
    if not old_values:
        return cur
    return min(cur, quorum_match(old_values))


NO_OFFSET = -1  # shared sentinel (models.fundamental.NO_OFFSET)


@dataclasses.dataclass
class ReplicaState:
    """Per-replica tracking (follower_index_metadata, types.h:78-117)."""

    match_index: int = NO_OFFSET  # last_dirty_log_index acked
    flushed_index: int = NO_OFFSET  # last_flushed_log_index acked
    is_voter: bool = True
    is_voter_old: bool = False
    last_seq: int = 0

    def match_committed_index(self) -> int:
        return min(self.flushed_index, self.match_index)


def leader_commit_index(
    replicas: list[ReplicaState],
    leader_flushed: int,
    commit_index: int,
    term_start: int,
) -> int:
    """do_maybe_update_leader_commit_idx (consensus.cc:2704-2759)."""
    cur = [r.match_committed_index() for r in replicas if r.is_voter]
    old = [r.match_committed_index() for r in replicas if r.is_voter_old]
    if not cur:
        return commit_index
    majority = joint_quorum_match(cur, old)
    majority = min(majority, leader_flushed)
    if majority > commit_index and majority >= term_start:
        return majority
    return commit_index


def leader_majority_dirty(replicas: list[ReplicaState], leader_dirty: int) -> int:
    """majority-replicated dirty offset for relaxed-consistency
    visibility (consensus.cc:3262-3276)."""
    cur = [r.match_index for r in replicas if r.is_voter]
    old = [r.match_index for r in replicas if r.is_voter_old]
    if not cur:
        return I64_MIN
    return min(joint_quorum_match(cur, old), leader_dirty)


def follower_commit_index(
    commit_index: int, flushed: int, leader_commit: int
) -> int:
    """maybe_update_follower_commit_idx (consensus.cc:2760-2777)."""
    if leader_commit > commit_index:
        proposed = min(leader_commit, flushed)
        if proposed > commit_index:
            return proposed
    return commit_index


def apply_reply(
    replica: ReplicaState, last_dirty: int, last_flushed: int, seq: int
) -> None:
    """update_follower_index fast path with seq reordering guard
    (types.h:107-117): stale seqs dropped; updates monotone."""
    if seq <= replica.last_seq:
        return
    replica.last_seq = seq
    # ReplicaState is the per-replica scalar reference model, not the
    # SoA lanes — no mut_epoch to bump here
    replica.match_index = max(replica.match_index, last_dirty)  # rplint: disable=RPL001
    replica.flushed_index = max(replica.flushed_index, last_flushed)  # rplint: disable=RPL001
