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

* `heartbeat_tick` — the fused tick as a launch sequence: fold, then
  commit. `tick_frame` — fold, commit and gather in ONE cooperative
  launch (`launch_frame`, which also takes ops.health's row health).
  `launch_mesh_frame` — the mesh frame (parallel/mesh_frame.py): the
  fold, then one sweep that also takes each row's health and the fleet
  totals.

* `follower_commit_step` — the follower-side rule
  (consensus.cc:2760-2777): commit = min(leader_commit, flushed),
  monotone; `local_append_update` — scatter-max of local appends into
  the self slot (one launch; for a large batch in passes of a lane and a
  part of the rows each, so the slots the blocks in flight touch stay
  in L2). Neither has a caller on a main path (as in the
  reference); the ring cluster step (parallel/cluster_step.py) applies
  the same two rules, written once in csrc/quorum_rules.cuh.

Each kernel wrapper launches its CUDA kernel (csrc/quorum.cu) for
tensors on the card and runs its plain PyTorch version (`*_plain`) for
tensors on the CPU; any other device raises. The fold and the commit
step update the state's lanes IN PLACE and return the same state —
the JAX program donates its buffers the same way (donate_argnums=0).
`LAUNCHES` counts kernel launches per wrapper.

Row and slot indices follow JAX's rule everywhere: one in [-G, 0) (or
[-R, 0)) counts from the end, once; the scatters (fold, local append)
then drop what is still out of range and the gather clamps it to
[0, G - 1].
"""

from __future__ import annotations

import ctypes

import torch

from ..models.consensus_state import SELF_SLOT, GroupState
from . import _build

I64_MIN = -(2**63)
MAX_REPLICA_SLOTS = 32  # the commit kernel keeps a row in registers

LAUNCHES = {
    "fold_replies": 0,
    "quorum_commit_step": 0,
    "build_heartbeats": 0,
    "tick_frame": 0,
    "mesh_tick_frame": 0,
    "follower_commit_step": 0,
    "local_append_update": 0,
}

_LIB = None


def bind(lib):
    """Declare the argument lists of csrc/quorum.cu's entry points."""
    _build.bind(lib, "rp_fold_replies", 8, 3)
    lib.rp_fold_grid.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    lib.rp_fold_grid.restype = ctypes.c_int
    _build.bind(lib, "rp_commit_step", 8, 2)
    _build.bind(lib, "rp_build_heartbeats", 9, 3)
    _build.bind(lib, "rp_tick_frame", 25, 4)
    _build.bind(lib, "rp_mesh_sweep", 17, 2)
    lib.rp_frame_grid.argtypes = [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    lib.rp_frame_grid.restype = ctypes.c_int
    _build.bind(lib, "rp_follower_commit", 4, 2)
    _build.bind(lib, "rp_local_append", 5, 4)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load("quorum"))
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


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's index rule: an index in [-n, 0) counts from the end, once."""
    return torch.where(idx < 0, idx + n, idx)


# ------------------------------------------------------------- fold
def fold_replies_plain(
    state, group_idx, replica_slot, last_dirty, last_flushed, seq
) -> GroupState:
    """Plain PyTorch fold, in place. `scatter_reduce_(amax)` resolves
    duplicate (g, r) pairs by max (index_put_ would keep an arbitrary
    writer); the seq guard reads the PRE-batch last_seq."""
    g, r = state.match_index.shape
    rows, slots = _wrap(group_idx, g), _wrap(replica_slot, r)
    valid = (rows >= 0) & (rows < g) & (slots >= 0) & (slots < r)
    flat = torch.where(valid, rows * r + slots, 0)
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
    duplicate (g, r) pairs resolve by per-target max; a row in [-G, 0)
    or slot in [-R, 0) counts from the end, and pairs still outside
    [0, G) x [0, R) are dropped (JAX's scatter). On the card: one
    cooperative launch (`fold_grid`); a batch too large for a
    co-resident grid raises."""
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
    rc = lib.rp_fold_replies(
        state.match_index.data_ptr(),
        state.flushed_index.data_ptr(),
        state.last_seq.data_ptr(),
        group_idx.data_ptr(),
        replica_slot.data_ptr(),
        last_dirty.data_ptr(),
        last_flushed.data_ptr(),
        seq.data_ptr(),
        m, g, r,
        _build.stream_of(group_idx),
    )
    _build.check(lib, rc, "fold_replies")
    LAUNCHES["fold_replies"] += 1
    return state


def fold_grid(m: int) -> tuple[int, int, int]:
    """The fold kernel's cooperative grid on the current card for a batch
    of m replies: (blocks, threads a block, runs of replies a thread)."""
    lib = _lib()
    out = (ctypes.c_int64 * 3)()
    _build.check(lib, lib.rp_fold_grid(m, ctypes.addressof(out)), "fold_grid")
    return int(out[0]), int(out[1]), int(out[2])


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
    g = state.match_index.shape[0]
    rows = torch.clamp(_wrap(group_idx, g), 0, g - 1)
    return {
        "group": group_idx,
        "term": state.term[rows],
        "commit_index": state.commit_index[rows],
        "last_dirty": state.match_index[rows, SELF_SLOT],
        "last_visible": state.last_visible[rows],
    }


def build_heartbeats(state: GroupState, group_idx: torch.Tensor) -> dict:
    """Gather heartbeat payload vectors for a set of groups (typically
    all leader groups targeting one peer node) in one gather — the
    batched analog of heartbeat_manager.cc:203's per-group loop. A row
    in [-G, 0) counts from the end; a row still outside [0, G) reads
    the nearest row (JAX's gather clamps). Returns [H] i64 tensors the
    RPC layer serializes into one node-level heartbeat request
    (heartbeat_manager.h:54-83)."""
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


# --------------------------------------------------- follower rules
def follower_commit_step_plain(state: GroupState, leader_commit: torch.Tensor) -> GroupState:
    """Plain PyTorch follower commit; writes commit_index and
    last_visible in place."""
    proposed = torch.minimum(leader_commit, state.flushed_index[:, SELF_SLOT])
    new_commit = torch.where(
        (leader_commit > state.commit_index) & (proposed > state.commit_index),
        proposed,
        state.commit_index,
    )
    state.last_visible.copy_(torch.maximum(state.last_visible, new_commit))
    state.commit_index.copy_(new_commit)
    return state


def follower_commit_step(state: GroupState, leader_commit: torch.Tensor) -> GroupState:
    """Follower commit rule over all groups at once, in place: if
    leader_commit > commit, commit = min(leader_commit, flushed[self]);
    last_visible is the running max. leader_commit: [G] i64 (i64 min for
    groups with no update this tick)."""
    check_state(state)
    g, r = state.match_index.shape
    _check_vec(leader_commit, g, state.match_index.device, "leader_commit")
    if not _on_card(state):
        return follower_commit_step_plain(state, leader_commit)
    if g == 0:
        return state
    lib = _lib()
    rc = lib.rp_follower_commit(
        state.commit_index.data_ptr(),
        state.last_visible.data_ptr(),
        state.flushed_index.data_ptr(),
        leader_commit.data_ptr(),
        g, r,
        _build.stream_of(leader_commit),
    )
    _build.check(lib, rc, "follower_commit_step")
    LAUNCHES["follower_commit_step"] += 1
    return state


def local_append_update_plain(state, group_idx, dirty, flushed) -> GroupState:
    """Plain PyTorch local append, in place (duplicate rows resolve by
    max; rows still out of range after the wrap are dropped)."""
    g, r = state.match_index.shape
    rows = _wrap(group_idx, g)
    keep = (rows >= 0) & (rows < g)
    cell = rows[keep] * r + SELF_SLOT
    state.match_index.view(-1).scatter_reduce_(0, cell, dirty[keep], "amax", include_self=True)
    state.flushed_index.view(-1).scatter_reduce_(0, cell, flushed[keep], "amax", include_self=True)
    return state


# the local append's launch (measured on an H100 at G = 1M, PERF.md): one
# append a thread while the batch touches at most APPEND_ONE_PASS_ROWS rows
# (min(M, G)), else 2 * APPEND_PARTS passes, a lane and a part of the rows
# each
APPEND_ONE_PASS_ROWS = 131072
APPEND_PARTS = 4


def append_parts(m: int, g: int) -> int:
    """The row parts rp_local_append runs M appends into G rows in: 0 (one
    append a thread, both lanes) or APPEND_PARTS."""
    return 0 if min(m, g) <= APPEND_ONE_PASS_ROWS else APPEND_PARTS


def local_append_update(
    state: GroupState,
    group_idx: torch.Tensor,  # [M] i64 rows, [-G, 0) counting from the end
    dirty: torch.Tensor,      # [M] i64 local dirty offsets
    flushed: torch.Tensor,    # [M] i64 local flushed offsets
) -> GroupState:
    """Reflect local log appends / flushes into the self slot for a
    batch of groups, in place (the disk_append -> leader state
    hand-off). Rows outside [0, G) after the wrap are dropped, as JAX's
    scatter drops them."""
    check_state(state)
    dev = state.match_index.device
    g, r = state.match_index.shape
    m = group_idx.shape[0]
    for name, t in (("group_idx", group_idx), ("dirty", dirty), ("flushed", flushed)):
        _check_vec(t, m, dev, name)
    if not _on_card(state):
        return local_append_update_plain(state, group_idx, dirty, flushed)
    if m == 0 or g == 0:
        return state
    lib = _lib()
    rc = lib.rp_local_append(
        state.match_index.data_ptr(),
        state.flushed_index.data_ptr(),
        group_idx.data_ptr(),
        dirty.data_ptr(),
        flushed.data_ptr(),
        m, g, r, append_parts(m, g),
        _build.stream_of(group_idx),
    )
    _build.check(lib, rc, "local_append_update")
    LAUNCHES["local_append_update"] += 1
    return state


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
    in Python). On the card: one cooperative launch (`launch_frame`);
    on the CPU: the plain versions in that order."""
    if _on_card(state):
        state, hb, _ = launch_frame(
            state, (group_idx, replica_slot, last_dirty, last_flushed, seq), hb_idx
        )
        return state, hb
    state = fold_replies(state, group_idx, replica_slot, last_dirty, last_flushed, seq)
    state = quorum_commit_step(state)
    return state, build_heartbeats(state, hb_idx)


def frame_grid(m: int, g: int, r: int, h: int, aligned: bool = True) -> tuple[int, int, int]:
    """The frame kernel's cooperative grid on the current card for m
    replies, g rows of r slots and h heartbeat rows: (blocks, threads a
    block, runs of replies a thread)."""
    lib = _lib()
    out = (ctypes.c_int64 * 3)()
    _build.check(lib, lib.rp_frame_grid(m, g, r, h, int(aligned), ctypes.addressof(out)),
                 "frame_grid")
    return int(out[0]), int(out[1]), int(out[2])


# the frame kernels' argument orders: the state's lanes, the health lanes
LANE_ORDER = ("term", "is_leader", "commit_index", "term_start", "last_visible",
              "match_index", "flushed_index", "last_seq", "is_voter", "is_voter_old")
HEALTH_KEYS = ("max_lag", "under_replicated", "leaderless")


def _health_lanes(g: int, dev) -> dict:
    """Uninitialised health lanes for g rows (ops.health.health_reduce's)."""
    return {k: torch.empty(g, dtype=torch.int64 if k == "max_lag" else torch.bool, device=dev)
            for k in HEALTH_KEYS}


def launch_frame(
    state: GroupState,
    replies: tuple,  # (group_idx, replica_slot, last_dirty, last_flushed, seq)
    hb_idx: torch.Tensor,
    leader_known: "torch.Tensor | None" = None,  # [G] bool, with `active`: health
    active: "torch.Tensor | None" = None,        # [G] bool
) -> tuple[GroupState, dict, "dict | None"]:
    """The tick frame on the card in one cooperative launch: the fold
    (one grid barrier), the commit sweep and, given `leader_known` and
    `active`, each row's health from the sweep's registers
    (ops.health.health_reduce's outputs), a second grid barrier, then
    the heartbeat gather. Updates the state in place; returns it, the
    heartbeat vectors and the health lanes (None without health). A
    batch too large for one co-resident grid raises."""
    check_state(state)
    dev = state.match_index.device
    g, r = state.match_index.shape
    if (leader_known is None) != (active is None):
        raise ValueError("launch_frame: pass both leader_known and active, or neither")
    if not 1 <= r <= MAX_REPLICA_SLOTS:
        raise ValueError(f"replica_slots={r} outside [1, {MAX_REPLICA_SLOTS}]")
    if not _on_card(state):
        raise ValueError("launch_frame runs on CUDA tensors")
    m = replies[0].shape[0]
    for name, t in zip(("group_idx", "replica_slot", "last_dirty", "last_flushed", "seq"), replies):
        _check_vec(t, m, dev, name)
    h = hb_idx.shape[0]
    _check_vec(hb_idx, h, dev, "hb_idx")
    hb = {
        k: torch.empty(h, dtype=torch.int64, device=dev)
        for k in ("term", "commit_index", "last_dirty", "last_visible")
    }
    health = None
    if leader_known is not None:
        for name, t in (("leader_known", leader_known), ("active", active)):
            check_tensor(t, torch.bool, (g,), dev, name)
        health = _health_lanes(g, dev)
    if g:
        health_ptrs = [None] * 5
        if health is not None:
            health_ptrs = [leader_known.data_ptr(), active.data_ptr()] + [
                health[k].data_ptr() for k in HEALTH_KEYS
            ]
        lib = _lib()
        rc = lib.rp_tick_frame(
            *(getattr(state, k).data_ptr() for k in LANE_ORDER),
            *(t.data_ptr() for t in replies),
            hb_idx.data_ptr(),
            *(hb[k].data_ptr() for k in ("term", "commit_index", "last_dirty", "last_visible")),
            *health_ptrs,
            m, h, g, r,
            _build.stream_of(state.match_index),
        )
        _build.check(lib, rc, "tick_frame")
        LAUNCHES["tick_frame"] += 1
    return state, {"group": hb_idx, **hb}, health


# ----------------------------------------------------- the mesh frame
N_TOTALS = 5  # ops.health.TOTALS
# csrc/chip_blocks.cuh TOTALS_SCRATCH: 32 sets of accumulators, one
# 128-byte line each, then the last-block ticket
TOTALS_SCRATCH = 32 * 16 + 1

_TOTALS_SCRATCH: dict = {}


def _totals_scratch(dev, stream: int) -> torch.Tensor:
    """The fleet totals' accumulators and last-block ticket for launches
    on one stream: zeroed once, and every launch leaves them zero."""
    key = (dev.index, stream)
    t = _TOTALS_SCRATCH.get(key)
    if t is None:
        t = _TOTALS_SCRATCH[key] = torch.zeros(TOTALS_SCRATCH, dtype=torch.int64, device=dev)
    return t


def launch_mesh_frame(
    state: GroupState,
    replies: tuple,              # (group_idx, replica_slot, last_dirty, last_flushed, seq)
    leader_known: torch.Tensor,  # [G] bool
    active: torch.Tensor,        # [G] bool
) -> tuple[GroupState, dict, torch.Tensor]:
    """The mesh frame on the card, reading each row once: the fold
    kernel (one cooperative launch; every guard against the pre-batch
    last_seq), then the mesh sweep kernel, which sweeps every row, takes
    its health against the new commit from the same registers
    (ops.health.health_reduce's outputs) and counts it into the five fleet
    totals in ops.health.TOTALS order (`advanced`: new commit > old
    commit), folded over the blocks in the same launch. Updates the state
    in place; returns it, the health lanes and the [5] i64 totals."""
    check_state(state)
    dev = state.match_index.device
    g, r = state.match_index.shape
    if not 1 <= r <= MAX_REPLICA_SLOTS:
        raise ValueError(f"replica_slots={r} outside [1, {MAX_REPLICA_SLOTS}]")
    if not _on_card(state):
        raise ValueError("launch_mesh_frame runs on CUDA tensors")
    for name, t in (("leader_known", leader_known), ("active", active)):
        check_tensor(t, torch.bool, (g,), dev, name)
    fold_replies(state, *replies)  # checks the reply columns
    health = _health_lanes(g, dev)
    if g == 0:
        return state, health, torch.zeros(N_TOTALS, dtype=torch.int64, device=dev)
    totals = torch.empty(N_TOTALS, dtype=torch.int64, device=dev)
    stream = _build.stream_of(state.match_index)
    lib = _lib()
    rc = lib.rp_mesh_sweep(
        *(getattr(state, k).data_ptr() for k in LANE_ORDER),
        leader_known.data_ptr(),
        active.data_ptr(),
        *(health[k].data_ptr() for k in HEALTH_KEYS),
        _totals_scratch(dev, stream).data_ptr(),
        totals.data_ptr(),
        g, r, stream,
    )
    _build.check(lib, rc, "mesh_tick_frame")
    LAUNCHES["mesh_tick_frame"] += 1
    return state, health, totals
