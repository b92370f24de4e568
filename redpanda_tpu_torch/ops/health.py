"""Batched partition-health reduction — lag / under-replication math
as one pass over the quorum lanes.

The reference computes follower lag and under-replication per
partition inside the health monitor's scalar walk
(cluster/health_monitor.cc + partition_probe); here the inputs already
live as `[G]`/`[G, R]` lanes (models.consensus_state), so the whole
fleet's health rolls up in one kernel launch (csrc/health.cu):

* per-slot follower lag  — leader dirty offset minus the follower's
  last known dirty offset (`match_index[:, SELF_SLOT] - match_index`),
  clamped at zero, masked to tracked (voter ∪ old-voter) slots so
  learners and empty slots never count;
* `max_lag[g]`           — worst tracked follower per leader row;
* `under_replicated[g]`  — any tracked slot's match < commit_index:
  a committed entry some voter still lacks;
* `leaderless[g]`        — an active row that neither leads nor knows
  a leader.

`tick_frame_health` runs this after `ops.quorum.tick_frame` on the
post-advance lanes, on the same stream. `health_reduce_np` is the
numpy mirror the host backend uses; the scalar oracle for
differential testing is `raft.health_scalar`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.consensus_state import SELF_SLOT, GroupState
from . import _build
from . import quorum as q

LAUNCHES = {"health_reduce": 0}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("health")
        _build.bind(lib, "rp_health_reduce", 10, 2)
        _LIB = lib
    return _LIB


def health_reduce_plain(
    match, commit, is_voter, is_voter_old, is_leader, leader_known, active
) -> dict:
    """Plain PyTorch version of `health_reduce`."""
    tracked = is_voter | is_voter_old
    self_dirty = match[:, SELF_SLOT]
    lag = torch.where(tracked, torch.clamp(self_dirty[:, None] - match, min=0), 0)
    lead = is_leader & active
    max_lag = torch.where(lead, lag.max(dim=-1).values, 0)
    under = lead & (tracked & (match < commit[:, None])).any(dim=-1)
    leaderless = active & ~is_leader & ~leader_known
    return {
        "max_lag": max_lag,
        "under_replicated": under,
        "leaderless": leaderless,
    }


def health_reduce(
    match: torch.Tensor,         # [G, R] i64 dirty offsets (slot 0 = self)
    commit: torch.Tensor,        # [G] i64 commit_index
    is_voter: torch.Tensor,      # [G, R] bool current voter mask
    is_voter_old: torch.Tensor,  # [G, R] bool joint-consensus old voters
    is_leader: torch.Tensor,     # [G] bool
    leader_known: torch.Tensor,  # [G] bool leader_id resolved for the row
    active: torch.Tensor,        # [G] bool row is allocated (not freed)
) -> dict:
    """One pass over the quorum lanes -> per-row health vectors
    (`max_lag` [G] i64, `under_replicated` / `leaderless` [G] bool)."""
    g, r = match.shape
    dev = match.device
    q.check_tensor(match, torch.int64, (g, r), dev, "match")
    q.check_tensor(commit, torch.int64, (g,), dev, "commit")
    for name, t in (("is_voter", is_voter), ("is_voter_old", is_voter_old)):
        q.check_tensor(t, torch.bool, (g, r), dev, name)
    for name, t in (
        ("is_leader", is_leader),
        ("leader_known", leader_known),
        ("active", active),
    ):
        q.check_tensor(t, torch.bool, (g,), dev, name)
    if r < 1:
        raise ValueError("health_reduce needs at least the SELF slot")
    if dev.type == "cpu":
        return health_reduce_plain(
            match, commit, is_voter, is_voter_old, is_leader, leader_known, active
        )
    if dev.type != "cuda":
        raise ValueError(f"health kernels run on cuda or cpu tensors, not {dev}")
    out = {
        "max_lag": torch.empty(g, dtype=torch.int64, device=dev),
        "under_replicated": torch.empty(g, dtype=torch.bool, device=dev),
        "leaderless": torch.empty(g, dtype=torch.bool, device=dev),
    }
    if g:
        lib = _lib()
        rc = lib.rp_health_reduce(
            match.data_ptr(),
            commit.data_ptr(),
            is_voter.data_ptr(),
            is_voter_old.data_ptr(),
            is_leader.data_ptr(),
            leader_known.data_ptr(),
            active.data_ptr(),
            out["max_lag"].data_ptr(),
            out["under_replicated"].data_ptr(),
            out["leaderless"].data_ptr(),
            g, r,
            _build.stream_of(match),
        )
        _build.check(lib, rc, "health_reduce")
        LAUNCHES["health_reduce"] += 1
    return out


def health_reduce_np(
    match: np.ndarray,
    commit: np.ndarray,
    is_voter: np.ndarray,
    is_voter_old: np.ndarray,
    is_leader: np.ndarray,
    leader_known: np.ndarray,
    active: np.ndarray,
) -> dict[str, np.ndarray]:
    """Numpy mirror of `health_reduce` for the host backend — identical
    math, identical dtypes, so host/device stay byte-equal."""
    tracked = is_voter | is_voter_old
    self_dirty = match[:, SELF_SLOT]
    lag = np.where(
        tracked, np.maximum(self_dirty[:, None] - match, 0), np.int64(0)
    )
    lead = is_leader & active
    max_lag = np.where(lead, lag.max(axis=-1), np.int64(0))
    under = lead & (tracked & (match < commit[:, None])).any(axis=-1)
    leaderless = active & ~is_leader & ~leader_known
    return {
        "max_lag": max_lag.astype(np.int64, copy=False),
        "under_replicated": under,
        "leaderless": leaderless,
    }


def tick_frame_health(
    state: GroupState,
    group_idx: torch.Tensor,
    replica_slot: torch.Tensor,
    last_dirty: torch.Tensor,
    last_flushed: torch.Tensor,
    seq: torch.Tensor,
    hb_idx: torch.Tensor,
    leader_known: torch.Tensor,  # [G] bool
    active: torch.Tensor,        # [G] bool
) -> tuple[GroupState, dict, dict]:
    """`ops.quorum.tick_frame` + health reduction over the POST-advance
    state, as one launch sequence on one stream."""
    state, hb = q.tick_frame(
        state, group_idx, replica_slot, last_dirty, last_flushed, seq, hb_idx
    )
    health = health_reduce(
        state.match_index,
        state.commit_index,
        state.is_voter,
        state.is_voter_old,
        state.is_leader,
        leader_known,
        active,
    )
    return state, hb, health
