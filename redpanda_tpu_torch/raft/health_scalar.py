"""Scalar (per-group) partition-health math — the reference oracle.

Mirrors `ops.health.health_reduce` one group at a time in plain
Python, the way the reference's health monitor walks partitions
(cluster/health_monitor.cc + partition_probe). The batched device
reduction is differential-tested against this module the same way
`ops.quorum` is tested against `quorum_scalar` — byte-equality on
randomized lane states is the acceptance bar.
"""

from __future__ import annotations

from .quorum_scalar import ReplicaState

SELF_SLOT = 0


def group_health(
    replicas: list[ReplicaState],
    commit_index: int,
    is_leader: bool,
    leader_known: bool,
    active: bool,
) -> tuple[int, bool, bool]:
    """Health triple for one group: (max_lag, under_replicated,
    leaderless).

    `replicas` is the full slot vector (slot 0 = self); tracked slots
    are voters of either configuration — learners and empty slots
    never count. Lag is the leader's dirty offset minus the slot's
    last known dirty offset, clamped at zero; under-replication is any
    tracked slot whose match trails the commit index; leaderless is an
    active row that neither leads nor knows a leader.
    """
    if not active:
        return 0, False, False
    leaderless = (not is_leader) and (not leader_known)
    if not is_leader:
        return 0, False, leaderless
    self_dirty = replicas[SELF_SLOT].match_index
    max_lag = 0
    under = False
    for r in replicas:
        if not (r.is_voter or r.is_voter_old):
            continue
        max_lag = max(max_lag, self_dirty - r.match_index)
        if r.match_index < commit_index:
            under = True
    return max_lag, under, False
