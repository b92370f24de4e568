"""Struct-of-arrays consensus state — the flagship device model.

The key inversion vs the reference (SURVEY.md §7): where Redpanda keeps
one `raft::consensus` object per partition and loops over thousands of
them each heartbeat tick (heartbeat_manager.cc:203,
consensus.cc:2704-2759), we keep all per-group scalar state as
`[groups]`- and `[groups, replica_slots]`-indexed tensors on the card,
and step every group in one batched kernel launch (ops.quorum).
Per-group Python objects survive only for log I/O and membership
bookkeeping.

Layout convention (identical to redpanda_tpu.models.consensus_state):
  * `R` replica slots per group (default 8 ≥ any practical replication
    factor). Slot 0 is ALWAYS the local node (self); remaining slots
    hold peers in config order. Empty slots have is_voter=False.
  * match_index[g, r]   — highest appended ("dirty") offset known on
    replica r (reference: follower_index_metadata.last_dirty_log_index,
    raft/types.h:78-117). Slot 0 mirrors the local log's dirty offset.
  * flushed_index[g, r] — highest fsynced offset on replica r
    (last_flushed_log_index); the quorum value of a replica is
    min(match, flushed) (match_committed_index, types.h:97-99).
  * is_voter / is_voter_old — current and joint-consensus-old voter
    masks (group_configuration.h:487-490: joint quorum = min of both).
  * term_start[g] — first offset appended in the current term; offset
    o has the current term iff o >= term_start (consensus.cc:2738).
  * last_seq[g, r] — monotone reply sequence guard against reordered
    append_entries responses (types.h:107-117).

Every tensor is C-contiguous, int64 or bool (one byte, handed to the
kernels as uint8). The host mirror (raft.shard_state) keeps some lanes
Fortran-ordered; `group_state_from_numpy` is the one place they cross
over, and it always makes a row-major copy on the target device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fundamental import NO_OFFSET as _NO_OFFSET

DEFAULT_REPLICA_SLOTS = 8
SELF_SLOT = 0

# the one shared "no offset" sentinel (-1), as an int64 for tensor fills
NO_OFFSET = np.int64(_NO_OFFSET)


class GroupState(NamedTuple):
    """Per-shard consensus tensors, all on one device."""

    term: torch.Tensor          # [G] i64  current term
    is_leader: torch.Tensor     # [G] bool this node leads the group
    commit_index: torch.Tensor  # [G] i64
    term_start: torch.Tensor    # [G] i64  first offset of current term
    last_visible: torch.Tensor  # [G] i64  relaxed-consistency visible offset
    match_index: torch.Tensor   # [G, R] i64
    flushed_index: torch.Tensor  # [G, R] i64
    is_voter: torch.Tensor      # [G, R] bool
    is_voter_old: torch.Tensor  # [G, R] bool (all False unless joint config)
    last_seq: torch.Tensor      # [G, R] i64 reply-reordering guard

    @property
    def num_groups(self) -> int:
        return self.term.shape[0]

    @property
    def replica_slots(self) -> int:
        return self.match_index.shape[1]


# field -> numpy dtype; bool lanes are one byte on both sides
FIELD_DTYPES = {
    "term": np.int64,
    "is_leader": np.bool_,
    "commit_index": np.int64,
    "term_start": np.int64,
    "last_visible": np.int64,
    "match_index": np.int64,
    "flushed_index": np.int64,
    "is_voter": np.bool_,
    "is_voter_old": np.bool_,
    "last_seq": np.int64,
}


def check_device(device) -> torch.device:
    """Resolve `device`; a CUDA device on a machine without one raises
    here, before any lane is copied, instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def make_group_state(
    num_groups: int,
    replica_slots: int = DEFAULT_REPLICA_SLOTS,
    device="cuda",
) -> GroupState:
    dev = check_device(device)
    g, r = num_groups, replica_slots
    i64 = dict(dtype=torch.int64, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return GroupState(
        term=torch.zeros(g, **i64),
        is_leader=torch.zeros(g, **b),
        commit_index=torch.full((g,), int(NO_OFFSET), **i64),
        term_start=torch.zeros(g, **i64),
        last_visible=torch.full((g,), int(NO_OFFSET), **i64),
        match_index=torch.full((g, r), int(NO_OFFSET), **i64),
        flushed_index=torch.full((g, r), int(NO_OFFSET), **i64),
        is_voter=torch.zeros((g, r), **b),
        is_voter_old=torch.zeros((g, r), **b),
        last_seq=torch.zeros((g, r), **i64),
    )


def host_update(state: GroupState, group: int, **fields) -> GroupState:
    """Slow-path row rewrite (membership/leadership/truncation events).

    Host-side, per-group, infrequent — the analog of the reference's
    scalar control-plane mutations around the hot sweep. Returns a new
    state; the rewritten fields are copies, the input is untouched."""
    updates = {}
    for name, value in fields.items():
        arr = getattr(state, name).clone()
        arr[group] = torch.as_tensor(value, dtype=arr.dtype)
        updates[name] = arr
    return state._replace(**updates)


def group_state_from_numpy(fields: dict, device) -> GroupState:
    """Copy ten numpy lanes (any memory order) into a GroupState on
    `device`. Always a copy, always row-major: the kernels index
    `[G, R]` lanes as `g * R + r`, and a Fortran-ordered host lane
    handed over as a strided view would be read as the wrong lanes."""
    dev = check_device(device)
    out = {}
    for name, dtype in FIELD_DTYPES.items():
        host = np.ascontiguousarray(fields[name], dtype=dtype)
        out[name] = torch.from_numpy(host).to(dev, copy=True)
    return GroupState(**out)


def group_state_to_numpy(state: GroupState) -> dict[str, np.ndarray]:
    """Inverse of `group_state_from_numpy`: C-ordered host copies."""
    return {
        name: getattr(state, name).detach().cpu().numpy().copy()
        for name in FIELD_DTYPES
    }
