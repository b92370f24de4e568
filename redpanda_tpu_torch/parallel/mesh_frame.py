"""Mesh-resident live tick frame: fold + commit + health over lane
tensors laid out as D chip blocks, with the fleet totals as the frame's
one cross-chip fold.

Port of redpanda_tpu/parallel/mesh_frame.py. The reference places every
`[G, ...]` lane of a shard's `ShardGroupArrays` with `NamedSharding`
over `make_mesh()` and runs one compiled program per frame:

  * append-reply fold (seq-guarded scatter)      — chip-local,
  * masked-quorum commit/visible advance         — chip-local,
  * health reduction                             — chip-local,
  * fleet totals (advanced / lag / under / leaderless / active)
    — the one cross-chip fold per frame.

Here the D chip blocks are contiguous row ranges on one card
(parallel/mesh.py), and the frame reads each row once
(ops/quorum.launch_mesh_frame, csrc/quorum.cu): the fold kernel (one
cooperative launch, every seq guard against the pre-batch last_seq),
then the mesh sweep kernel, which sweeps every row, takes the row's
health against its new commit from the same registers and counts the
row into the five fleet totals (`advanced` compares the commit it loaded
with the one it wrote, so no copy of the commit lane is taken). The
totals are sums and a max over all rows, which do not depend on how rows
are grouped, so the kernel does not attribute rows to chip blocks: each
CUDA block reduces its own rows and adds them into one of 32 accumulator
sets, and the last block to finish folds the sets into the [5] totals
(a ticket, csrc/chip_blocks.cuh grid_totals) — the frame's one
cross-chip fold, still counted once a frame (devplane.count_fold). The
accumulators and the ticket are per stream (ops/quorum._totals_scratch),
so frames on two streams do not share them. On the CPU the frame is the
plain chain: heartbeat_tick, then health_totals against a copy of the
commit lane. The heartbeat gather is not in the frame: on the mesh
backend it is served from the host mirrors. `mesh_health` (the read
path's refresh) is `health_totals`, per chip block then folded.

`RP_MESH_DEVICES=n` sets D (default: every visible CUDA card); since
the blocks share one card, n may exceed the card count. Capacity
padding: rows are padded to a multiple of D with neutral rows
(is_leader / voters / active all False — they cannot advance and add
zero to every total) and sliced off on readback, so results equal the
host fold's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.consensus_state import GroupState
from ..observability import devplane
from ..ops import health as health_ops
from ..ops import quorum as q
from .mesh import make_mesh, place_rows


def mesh_device_count() -> int:
    """Chip blocks for the live mesh backend: RP_MESH_DEVICES if set,
    else every visible CUDA card."""
    n = int(os.environ.get("RP_MESH_DEVICES", "0") or 0)
    return n if n > 0 else torch.cuda.device_count()


def _totals(totals: torch.Tensor, keys) -> dict:
    return {k: totals[health_ops.TOTALS.index(k)] for k in keys}


def mesh_tick_frame(
    state: GroupState,
    group_idx: torch.Tensor,
    replica_slot: torch.Tensor,
    last_dirty: torch.Tensor,
    last_flushed: torch.Tensor,
    seq: torch.Tensor,
    leader_known: torch.Tensor,  # [G] bool
    active: torch.Tensor,        # [G] bool
    n_devices: int,
) -> tuple[GroupState, dict, dict]:
    """One mesh frame over `n_devices` chip blocks: fold + commit
    advance + health, all chip-local, plus the fleet totals (0-d i64
    tensors) folded once across the blocks. Updates the state's lanes in
    place and returns it. On the card one pass over the rows
    (ops.quorum.launch_mesh_frame); on the CPU the plain chain."""
    g = state.match_index.shape[0]
    if n_devices < 1 or g % n_devices:
        raise ValueError(f"{g} rows do not split into {n_devices} equal chip blocks")
    if q._on_card(state):
        state, health, totals = q.launch_mesh_frame(
            state, (group_idx, replica_slot, last_dirty, last_flushed, seq), leader_known, active
        )
        return state, health, _totals(totals, health_ops.TOTALS)
    before = state.commit_index.clone()
    state = q.heartbeat_tick(state, group_idx, replica_slot, last_dirty, last_flushed, seq)
    health, totals = health_ops.health_totals(
        state.match_index,
        state.commit_index,
        state.is_voter,
        state.is_voter_old,
        state.is_leader,
        leader_known,
        active,
        n_devices,
        before=before,
    )
    return state, health, _totals(totals, health_ops.TOTALS)


def mesh_health(
    match: torch.Tensor,
    commit: torch.Tensor,
    is_voter: torch.Tensor,
    is_voter_old: torch.Tensor,
    is_leader: torch.Tensor,
    leader_known: torch.Tensor,
    active: torch.Tensor,
    n_devices: int,
) -> tuple[dict, dict]:
    """Health-only mesh frame (the read-path refresh — no reply fold, no
    commit movement), same one-cross-chip-fold discipline."""
    health, totals = health_ops.health_totals(
        match, commit, is_voter, is_voter_old, is_leader, leader_known, active, n_devices
    )
    return health, _totals(totals, health_ops.TOTALS[1:])


class MeshFrame:
    """One shard's mesh placement + frame launch sequences. Lazily
    constructed by ShardGroupArrays the first time the `mesh` backend
    runs a full frame; the host mirrors stay authoritative (control-
    plane writes are numpy), so each full frame places fresh — the
    steady path never reaches the card at all (incremental chip-local
    sweep, see shard_state._mesh_tick). `device` is the shard's device;
    a CUDA device raises here on a machine without one."""

    def __init__(self, n_devices: int | None = None, device="cuda"):
        n = n_devices if n_devices is not None else mesh_device_count()
        self.mesh = make_mesh(n, device)
        self.n_devices = self.mesh.n_devices

    def _place(self, a: np.ndarray) -> torch.Tensor:
        """Pad the row axis to a multiple of the block count with neutral
        rows and copy it, row-major, onto the mesh's device."""
        devplane.count_transfer(a.nbytes, "h2d")
        return place_rows(a, self.mesh)

    def place_state(self, arrays) -> GroupState:
        """ShardGroupArrays host lanes -> padded GroupState on the card."""
        return GroupState(
            term=self._place(arrays.term),
            is_leader=self._place(arrays.is_leader),
            commit_index=self._place(arrays.commit_index),
            term_start=self._place(arrays.term_start),
            last_visible=self._place(arrays.last_visible),
            match_index=self._place(arrays.match_index),
            flushed_index=self._place(arrays.flushed_index),
            is_voter=self._place(arrays.is_voter),
            is_voter_old=self._place(arrays.is_voter_old),
            last_seq=self._place(arrays.last_seq),
        )

    def _upload(self, *vecs: np.ndarray) -> list:
        return [torch.from_numpy(np.ascontiguousarray(v)).to(self.mesh.device) for v in vecs]

    def run(
        self,
        arrays,
        g_rows: np.ndarray,
        g_slots: np.ndarray,
        g_dirty: np.ndarray,
        g_flushed: np.ndarray,
        g_seqs: np.ndarray,
    ) -> tuple[dict, dict, dict]:
        """One full mesh frame over `arrays`' lanes. Reply columns are
        copied whole (they are tiny); the state is laid out in chip
        blocks. Returns host numpy (state lanes, health lanes) sliced
        back to capacity, and the fleet totals as python ints. Records
        the upload / kernels / readback split in `arrays.stage_ms` when
        that is on."""
        cap = arrays.capacity
        with devplane.frame_scope("tick"):
            e0 = arrays._stamp()
            state = self.place_state(arrays)
            if devplane.ENABLED:
                devplane.count_transfer(
                    g_rows.nbytes + g_slots.nbytes + g_dirty.nbytes
                    + g_flushed.nbytes + g_seqs.nbytes,
                    "h2d",
                )
                # the totals fold closing the frame is its single
                # cross-chip fold (RPL018 invariant)
                devplane.count_fold()
            replies = self._upload(g_rows, g_slots, g_dirty, g_flushed, g_seqs)
            known = self._place(arrays.leader_id >= 0)
            active = self._place(arrays.row_active)
            e1 = arrays._stamp()
            new, health, totals = mesh_tick_frame(
                state, *replies, known, active, self.n_devices
            )
            e2 = arrays._stamp()
            out = {
                "commit_index": new.commit_index[:cap].cpu().numpy(),
                "last_visible": new.last_visible[:cap].cpu().numpy(),
                "match_index": new.match_index[:cap].cpu().numpy(),
                "flushed_index": new.flushed_index[:cap].cpu().numpy(),
                "last_seq": new.last_seq[:cap].cpu().numpy(),
            }
            health_np = {k: v[:cap].cpu().numpy() for k, v in health.items()}
            totals = {k: int(v) for k, v in totals.items()}
            arrays._record_stages(e0, e1, e2, arrays._stamp())
            if devplane.ENABLED:
                devplane.count_transfer(
                    sum(a.nbytes for a in out.values())
                    + sum(a.nbytes for a in health_np.values()),
                    "d2h",
                )
        return out, health_np, totals

    def run_health(self, arrays) -> tuple[dict, dict]:
        """Health-only refresh through the mesh (the read path)."""
        cap = arrays.capacity
        with devplane.frame_scope("health"):
            if devplane.ENABLED:
                # same one-cross-chip-fold discipline as the tick frame
                devplane.count_fold()
            health, totals = mesh_health(
                self._place(arrays.match_index),
                self._place(arrays.commit_index),
                self._place(arrays.is_voter),
                self._place(arrays.is_voter_old),
                self._place(arrays.is_leader),
                self._place(arrays.leader_id >= 0),
                self._place(arrays.row_active),
                self.n_devices,
            )
            health_np = {k: v[:cap].cpu().numpy() for k, v in health.items()}
            if devplane.ENABLED:
                devplane.count_transfer(sum(a.nbytes for a in health_np.values()), "d2h")
        return health_np, {k: int(v) for k, v in totals.items()}
