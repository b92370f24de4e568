"""Batched quorum / commit-index kernels — the north-star sweep.

One launch sequence advances the consensus decision math for *all*
raft groups on a shard, replacing the reference's per-group scalar
loops:

* `quorum_commit_step` — the leader commit rule
  (reference: consensus.cc:2704-2759 do_maybe_update_leader_commit_idx
  + group_configuration.h:407-428 quorum_match): per-replica value is
  min(flushed, match) (types.h:97-99 match_committed_index); the
  majority value is the ascending (n-1)/2-th order statistic over
  voters; joint configs take min over both voter sets
  (group_configuration.h:487-490); result is clamped to the leader's
  own flushed offset and gated on the current-term check (Raft
  §5.4.2). Also computes the majority-replicated dirty offset used for
  relaxed-consistency visibility (consensus.cc:3262-3276).

* `fold_replies` — scatter a node-batch of append_entries/heartbeat
  replies back into the [G, R] match/flushed tensors with the
  monotone-seq reordering guard (types.h:107-117).

* `build_heartbeats` — gather per-target-node (group, term,
  commit_index, last_dirty, last_visible) vectors from state
  (heartbeat_manager.cc:203).

* `heartbeat_tick` / `tick_frame` — the fused tick as a launch
  sequence: fold, then commit (, then gather).

Each kernel wrapper launches its CUDA kernel (csrc/quorum.cu) for
tensors on the card and runs its plain PyTorch version (`*_plain`) for
tensors on the CPU; any other device raises. The fold and the commit
step update the state's lanes IN PLACE and return the same state —
the JAX program donates its buffers the same way (donate_argnums=0).
`LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from ..models.consensus_state import SELF_SLOT, GroupState
from . import _build

I64_MIN = -(2**63)
MAX_REPLICA_SLOTS = 32  # the commit kernel keeps a row in registers

LAUNCHES = {"fold_replies": 0, "quorum_commit_step": 0, "build_heartbeats": 0}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("quorum")
        _build.bind(lib, "rp_fold_replies", 9, 3)
        _build.bind(lib, "rp_commit_step", 8, 2)
        _build.bind(lib, "rp_build_heartbeats", 9, 3)
        _LIB = lib
    return _LIB


def _on_card(state: GroupState) -> bool:
    """True for CUDA state, False for CPU state; anything else raises."""
    dev = state.match_index.device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"quorum kernels run on cuda or cpu tensors, not {dev}")


def check_tensor(t: torch.Tensor, dtype, shape, device, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_state(state: GroupState) -> None:
    """Validate every lane's dtype, shape, device and contiguity."""
    g, r = state.match_index.shape
    dev = state.match_index.device
    for name in ("term", "commit_index", "term_start", "last_visible"):
        check_tensor(getattr(state, name), torch.int64, (g,), dev, name)
    check_tensor(state.is_leader, torch.bool, (g,), dev, "is_leader")
    for name in ("match_index", "flushed_index", "last_seq"):
        check_tensor(getattr(state, name), torch.int64, (g, r), dev, name)
    for name in ("is_voter", "is_voter_old"):
        check_tensor(getattr(state, name), torch.bool, (g, r), dev, name)


def _check_vec(t: torch.Tensor, n: int, device, name: str) -> None:
    check_tensor(t, torch.int64, (n,), device, name)


# ------------------------------------------------------------- fold
def fold_replies_plain(
    state, group_idx, replica_slot, last_dirty, last_flushed, seq
) -> GroupState:
    """Plain PyTorch fold, in place. `scatter_reduce_(amax)` resolves
    duplicate (g, r) pairs by max (index_put_ would keep an arbitrary
    writer); the seq guard reads the PRE-batch last_seq."""
    g, r = state.match_index.shape
    valid = (group_idx >= 0) & (group_idx < g) & (replica_slot >= 0) & (replica_slot < r)
    flat = torch.where(valid, group_idx * r + replica_slot, 0)
    fresh = valid & (seq > state.last_seq.view(-1)[flat])
    idx = flat[fresh]
    for lane, vals in (
        (state.match_index, last_dirty),
        (state.flushed_index, last_flushed),
        (state.last_seq, seq),
    ):
        lane.view(-1).scatter_reduce_(0, idx, vals[fresh], "amax", include_self=True)
    return state


def fold_replies(
    state: GroupState,
    group_idx: torch.Tensor,     # [M] i64 group row per reply
    replica_slot: torch.Tensor,  # [M] i64 slot of the responding peer
    last_dirty: torch.Tensor,    # [M] i64 follower's last dirty offset
    last_flushed: torch.Tensor,  # [M] i64 follower's last flushed offset
    seq: torch.Tensor,           # [M] i64 request sequence number
) -> GroupState:
    """Fold a node-batch of successful append/heartbeat replies into
    match/flushed/last_seq, in place. Replies with seq <= last_seq[g, r]
    (pre-batch) are dropped (reordered responses, types.h:107-117);
    duplicate (g, r) pairs resolve by per-target max; pairs outside
    [0, G) x [0, R) are skipped."""
    check_state(state)
    dev = state.match_index.device
    m = group_idx.shape[0]
    for name, t in (
        ("group_idx", group_idx),
        ("replica_slot", replica_slot),
        ("last_dirty", last_dirty),
        ("last_flushed", last_flushed),
        ("seq", seq),
    ):
        _check_vec(t, m, dev, name)
    if not _on_card(state):
        return fold_replies_plain(
            state, group_idx, replica_slot, last_dirty, last_flushed, seq
        )
    if m == 0:
        return state
    g, r = state.match_index.shape
    lib = _lib()
    fresh = torch.empty(m, dtype=torch.uint8, device=dev)
    rc = lib.rp_fold_replies(
        state.match_index.data_ptr(),
        state.flushed_index.data_ptr(),
        state.last_seq.data_ptr(),
        group_idx.data_ptr(),
        replica_slot.data_ptr(),
        last_dirty.data_ptr(),
        last_flushed.data_ptr(),
        seq.data_ptr(),
        fresh.data_ptr(),
        m, g, r,
        _build.stream_of(group_idx),
    )
    _build.check(lib, rc, "fold_replies")
    LAUNCHES["fold_replies"] += 1
    return state


# ----------------------------------------------------------- commit
def _masked_quorum_value(values: torch.Tensor, mask: torch.Tensor):
    """Per-row majority order statistic over masked entries (ascending
    index R - n + (n-1)//2 after filling masked-out slots with i64 min);
    rows with n == 0 return i64 min. Returns ([G] value, [G] n)."""
    r = values.shape[1]
    filled = torch.where(mask, values, I64_MIN)
    ordered = torch.sort(filled, dim=-1).values
    n = mask.sum(dim=-1, dtype=torch.int64)
    idx = torch.clamp(r - n + torch.div(n - 1, 2, rounding_mode="floor"), 0, r - 1)
    val = ordered.gather(-1, idx[:, None])[:, 0]
    return torch.where(n > 0, val, I64_MIN), n


def quorum_commit_step_plain(state: GroupState) -> GroupState:
    """Plain PyTorch commit sweep; writes commit_index and last_visible
    in place."""
    committed = torch.minimum(state.flushed_index, state.match_index)
    m_cur, n_cur = _masked_quorum_value(committed, state.is_voter)
    m_old, n_old = _masked_quorum_value(committed, state.is_voter_old)
    majority = torch.where(n_old > 0, torch.minimum(m_cur, m_old), m_cur)
    majority = torch.minimum(majority, state.flushed_index[:, SELF_SLOT])
    advance = (
        state.is_leader
        & (n_cur > 0)
        & (majority > state.commit_index)
        & (majority >= state.term_start)
    )
    new_commit = torch.where(advance, majority, state.commit_index)

    d_cur, dn_cur = _masked_quorum_value(state.match_index, state.is_voter)
    d_old, dn_old = _masked_quorum_value(state.match_index, state.is_voter_old)
    majority_dirty = torch.where(dn_old > 0, torch.minimum(d_cur, d_old), d_cur)
    majority_dirty = torch.minimum(majority_dirty, state.match_index[:, SELF_SLOT])
    new_visible = torch.where(
        state.is_leader & (dn_cur > 0),
        torch.maximum(state.last_visible, torch.maximum(new_commit, majority_dirty)),
        state.last_visible,
    )
    state.commit_index.copy_(new_commit)
    state.last_visible.copy_(new_visible)
    return state


def quorum_commit_step(state: GroupState) -> GroupState:
    """Advance commit_index and last_visible for every leader group, in
    place."""
    check_state(state)
    g, r = state.match_index.shape
    if not 1 <= r <= MAX_REPLICA_SLOTS:
        raise ValueError(f"replica_slots={r} outside [1, {MAX_REPLICA_SLOTS}]")
    if not _on_card(state):
        return quorum_commit_step_plain(state)
    if g == 0:
        return state
    lib = _lib()
    rc = lib.rp_commit_step(
        state.term_start.data_ptr(),
        state.is_leader.data_ptr(),
        state.commit_index.data_ptr(),
        state.last_visible.data_ptr(),
        state.match_index.data_ptr(),
        state.flushed_index.data_ptr(),
        state.is_voter.data_ptr(),
        state.is_voter_old.data_ptr(),
        g, r,
        _build.stream_of(state.match_index),
    )
    _build.check(lib, rc, "quorum_commit_step")
    LAUNCHES["quorum_commit_step"] += 1
    return state


# ------------------------------------------------------- heartbeats
def build_heartbeats_plain(state: GroupState, group_idx: torch.Tensor) -> dict:
    return {
        "group": group_idx,
        "term": state.term[group_idx],
        "commit_index": state.commit_index[group_idx],
        "last_dirty": state.match_index[group_idx, SELF_SLOT],
        "last_visible": state.last_visible[group_idx],
    }


def build_heartbeats(state: GroupState, group_idx: torch.Tensor) -> dict:
    """Gather heartbeat payload vectors for a set of groups (rows in
    [0, G), typically all leader groups targeting one peer node) in one
    gather — the batched analog of heartbeat_manager.cc:203's per-group
    loop. Returns [H] i64 tensors the RPC layer serializes into one
    node-level heartbeat request (heartbeat_manager.h:54-83)."""
    check_state(state)
    dev = state.match_index.device
    h = group_idx.shape[0]
    _check_vec(group_idx, h, dev, "group_idx")
    if not _on_card(state):
        return build_heartbeats_plain(state, group_idx)
    out = {
        k: torch.empty(h, dtype=torch.int64, device=dev)
        for k in ("term", "commit_index", "last_dirty", "last_visible")
    }
    g, r = state.match_index.shape
    if h and g:
        lib = _lib()
        rc = lib.rp_build_heartbeats(
            group_idx.data_ptr(),
            state.term.data_ptr(),
            state.commit_index.data_ptr(),
            state.match_index.data_ptr(),
            state.last_visible.data_ptr(),
            out["term"].data_ptr(),
            out["commit_index"].data_ptr(),
            out["last_dirty"].data_ptr(),
            out["last_visible"].data_ptr(),
            h, g, r,
            _build.stream_of(group_idx),
        )
        _build.check(lib, rc, "build_heartbeats")
        LAUNCHES["build_heartbeats"] += 1
    return {"group": group_idx, **out}


# ----------------------------------------------------- fused ticks
def heartbeat_tick(
    state: GroupState,
    group_idx: torch.Tensor,
    replica_slot: torch.Tensor,
    last_dirty: torch.Tensor,
    last_flushed: torch.Tensor,
    seq: torch.Tensor,
) -> GroupState:
    """One leader tick: fold a reply batch, then advance commit indices
    for all groups — the complete 50k-partition sweep as one launch
    sequence on one stream."""
    state = fold_replies(state, group_idx, replica_slot, last_dirty, last_flushed, seq)
    return quorum_commit_step(state)


def tick_frame(
    state: GroupState,
    group_idx: torch.Tensor,
    replica_slot: torch.Tensor,
    last_dirty: torch.Tensor,
    last_flushed: torch.Tensor,
    seq: torch.Tensor,
    hb_idx: torch.Tensor,
) -> tuple[GroupState, dict]:
    """One live tick frame: (b) fold the window's reply columns with
    the seq guard, (c) advance every group's commit/visible, then (a)
    gather the next frame's heartbeat payload for `hb_idx` from the
    POST-advance state (raft.tick_frame.TickFrame handles the residue
    in Python)."""
    state = fold_replies(state, group_idx, replica_slot, last_dirty, last_flushed, seq)
    state = quorum_commit_step(state)
    return state, build_heartbeats(state, hb_idx)
