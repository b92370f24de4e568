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

`tick_frame_health` is `ops.quorum.tick_frame` plus this reduction on
the post-advance lanes: on the card one cooperative launch
(`ops.quorum.launch_frame`, each row's health taken from the commit
sweep's registers), on the CPU the plain versions in order.
`health_totals` is the same
reduction over lanes laid out as D chip blocks of contiguous rows, fused
with the fleet totals (parallel/mesh_frame.py `mesh_health`, and the
CPU form of `mesh_tick_frame`): per-block partials, then one fold over
the blocks. On the card the mesh frame takes its health and totals
inside its sweep (`ops.quorum.launch_mesh_frame`). `health_reduce_np` is the
numpy mirror the host backend uses; the scalar oracle for
differential testing is `raft.health_scalar`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.consensus_state import SELF_SLOT, GroupState
from . import _build
from . import quorum as q

LAUNCHES = {"health_reduce": 0, "health_totals": 0}

# the fleet totals health_totals returns, in order (mesh_frame.py)
TOTALS = ("advanced", "max_follower_lag", "under_replicated", "leaderless", "active")

_LIB = None


def bind(lib):
    """Declare the argument lists of csrc/health.cu's entry points."""
    _build.bind(lib, "rp_health_reduce", 10, 2)
    _build.bind(lib, "rp_health_totals", 13, 3)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load("health"))
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


def _check_health_args(match, commit, is_voter, is_voter_old, is_leader, leader_known, active):
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"health kernels run on cuda or cpu tensors, not {dev}")


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
    _check_health_args(match, commit, is_voter, is_voter_old, is_leader, leader_known, active)
    g, r = match.shape
    dev = match.device
    if dev.type == "cpu":
        return health_reduce_plain(
            match, commit, is_voter, is_voter_old, is_leader, leader_known, active
        )
    out = q._health_lanes(g, dev)
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


def health_totals_plain(
    match, commit, is_voter, is_voter_old, is_leader, leader_known, active, n_blocks, before=None
) -> tuple[dict, torch.Tensor]:
    """Plain PyTorch version of `health_totals`."""
    health = health_reduce_plain(
        match, commit, is_voter, is_voter_old, is_leader, leader_known, active
    )
    advanced = commit > before if before is not None else torch.zeros_like(active)
    cols = torch.stack(
        [advanced.long(), health["max_lag"], health["under_replicated"].long(),
         health["leaderless"].long(), active.long()],
        dim=1,
    ).view(n_blocks, commit.shape[0] // n_blocks, len(TOTALS))
    # max_lag is never negative, so a max over no rows is the initial 0
    partials = cols.sum(dim=1)
    if cols.shape[1]:
        partials[:, 1] = cols[:, :, 1].amax(dim=1)
    totals = partials.sum(dim=0)
    totals[1] = partials[:, 1].amax()
    return health, totals


def health_totals(
    match: torch.Tensor,         # [G, R] i64, G = n_blocks * rows per block
    commit: torch.Tensor,        # [G] i64 commit_index
    is_voter: torch.Tensor,      # [G, R] bool
    is_voter_old: torch.Tensor,  # [G, R] bool
    is_leader: torch.Tensor,     # [G] bool
    leader_known: torch.Tensor,  # [G] bool
    active: torch.Tensor,        # [G] bool
    n_blocks: int,
    before: "torch.Tensor | None" = None,  # [G] i64 commit before the frame
) -> tuple[dict, torch.Tensor]:
    """`health_reduce` over lanes laid out as `n_blocks` chip blocks of
    equal contiguous row ranges, fused with the fleet totals: returns
    the health lanes and a [5] i64 tensor in `TOTALS` order — rows whose
    commit exceeds `before` (0 without it), the max of max_lag (initial
    0), the under-replicated, leaderless and active row counts. Each
    block's partials are reduced on its own, then folded over the blocks
    in one step: the frame's one cross-chip fold."""
    _check_health_args(match, commit, is_voter, is_voter_old, is_leader, leader_known, active)
    g, r = match.shape
    dev = match.device
    if n_blocks < 1 or g % n_blocks:
        raise ValueError(f"{g} rows do not split into {n_blocks} equal chip blocks")
    if before is not None:
        q.check_tensor(before, torch.int64, (g,), dev, "before")
    if dev.type == "cpu":
        return health_totals_plain(
            match, commit, is_voter, is_voter_old, is_leader, leader_known, active,
            n_blocks, before,
        )
    out = q._health_lanes(g, dev)
    partials = torch.zeros((n_blocks, len(TOTALS)), dtype=torch.int64, device=dev)
    totals = torch.zeros(len(TOTALS), dtype=torch.int64, device=dev)
    if g:
        lib = _lib()
        rc = lib.rp_health_totals(
            match.data_ptr(),
            commit.data_ptr(),
            is_voter.data_ptr(),
            is_voter_old.data_ptr(),
            is_leader.data_ptr(),
            leader_known.data_ptr(),
            active.data_ptr(),
            before.data_ptr() if before is not None else None,
            out["max_lag"].data_ptr(),
            out["under_replicated"].data_ptr(),
            out["leaderless"].data_ptr(),
            partials.data_ptr(),
            totals.data_ptr(),
            n_blocks, g // n_blocks, r,
            _build.stream_of(match),
        )
        _build.check(lib, rc, "health_totals")
        LAUNCHES["health_totals"] += 1
    return out, totals


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
    state: on the card one launch (`ops.quorum.launch_frame`)."""
    if q._on_card(state):
        return q.launch_frame(
            state, (group_idx, replica_slot, last_dirty, last_flushed, seq), hb_idx,
            leader_known, active,
        )
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
