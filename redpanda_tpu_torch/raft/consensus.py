"""Per-group Raft consensus (reference: src/v/raft/consensus.{h,cc}).

One instance per partition. Handles what MUST stay per-group — log I/O,
elections, membership, truncation — while all hot decision math (match/
flushed tracking, quorum commit) lives in the shard-wide SoA
(shard_state.ShardGroupArrays) so the heartbeat manager can step every
group in one batched device call (SURVEY.md §3.3).

Protocol fidelity notes (all cited into the reference):
* commit rule: median-of-voters over min(flushed, match), clamped to the
  leader's flushed offset, gated on current-term (consensus.cc:2704-2759,
  group_configuration.h:407-428) — via shard arrays scalar/device path.
* follower commit: min(leader_commit, flushed), monotone
  (consensus.cc:2760-2777).
* append_entries follower path: term checks → gap check → prev-term
  match → truncate-on-conflict → append → flush → commit update
  (consensus.cc:1734-1928).
* election: randomized timeout, vote persistence, log-up-to-date check
  (vote_stm.cc; voted_for durable in kvstore as in the reference).
* new leader appends a configuration batch in its own term so the
  commit gate `term_start` can advance (consensus.cc leadership path).
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import logging
import os
import random
import struct
import time
from enum import Enum
from typing import Awaitable, Callable, Optional

from ..models.record import (
    HEADER_SIZE,
    RecordBatch,
    RecordBatchBuilder,
    RecordBatchHeader,
    RecordBatchType,
)
from ..models.consensus_state import SELF_SLOT
from ..models.fundamental import NO_OFFSET
from ..storage import snapshot as snapfmt
from ..storage.kvstore import KeySpace, KvStore, KvStoreClosed
from ..storage.log import Log
from ..utils import native as native_mod
from ..observability import trace
from ..utils import serde
from ..utils.locks import LockMap
from ..utils.retry_chain import RetryChainAborted, RetryChainNode
from . import quorum_scalar as qs
from . import types as rt
from .configuration import GroupConfiguration
from .shard_state import ShardGroupArrays
from .snapshot import RaftSnapshotMetadata, SnapshotPayload

logger = logging.getLogger("raft")

NO_OFFSET = -1


class Role(Enum):
    FOLLOWER = 0
    CANDIDATE = 1
    LEADER = 2


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[int]):
        super().__init__(f"not leader (leader={leader_id})")
        self.leader_id = leader_id


class ReplicateTimeout(Exception):
    pass


class _VoteState(serde.Envelope):
    SERDE_FIELDS = [("term", serde.i64), ("voted_for", serde.i32)]


# send(target_node_id, method_id, payload, timeout) -> reply payload
SendFn = Callable[[int, int, bytes, float], Awaitable[bytes]]


def seed_group_state(
    kvstore: KvStore,
    group_id: int,
    *,
    term: int,
    voted_for: int,
    config_raw: bytes,
) -> None:
    """Pre-stage a moved group's raft hard state so the Consensus built
    by the adopting shard restores it at start() exactly as if it had
    always lived there (placement/host.py move_begin)."""
    st = _VoteState(
        term=int(term),
        voted_for=int(voted_for) if voted_for is not None else -1,
    )
    kvstore.put(KeySpace.consensus, f"vote/{group_id}".encode(), st.encode())
    if config_raw:
        kvstore.put(KeySpace.consensus, f"cfg/{group_id}".encode(), config_raw)


def unseed_group_state(kvstore: KvStore, group_id: int) -> None:
    """Roll back seed_group_state on move abort."""
    kvstore.remove(KeySpace.consensus, f"vote/{group_id}".encode())
    kvstore.remove(KeySpace.consensus, f"cfg/{group_id}".encode())


class Consensus:
    def __init__(
        self,
        group_id: int,
        node_id: int,
        config: GroupConfiguration,
        log: Log,
        kvstore: KvStore,
        arrays: ShardGroupArrays,
        send: SendFn,
        election_timeout_s: float = 0.3,
        recovery_throttle=None,
        probe=None,
        tick_frame=None,
    ):
        self.group_id = group_id
        # load-ledger key for this replicated log; partition_manager
        # rewrites it to the ntp form ("ns/topic/partition") so raft
        # append rates merge with kafka produce/fetch rates per NTP
        self.ledger_key = f"group/{group_id}"
        self.node_id = node_id
        self.config = config
        self.log = log
        self._kvstore = kvstore
        self.arrays = arrays
        self._send = send
        self._election_timeout = election_timeout_s
        # node-wide recovery rate/memory budget shared by every group
        # (raft/recovery.py; ref recovery_throttle.h) — None in unit
        # fixtures that build Consensus directly
        self.recovery_throttle = recovery_throttle
        # latency/event probe (raft/probe.cc analog): GroupManager
        # shares its node-level probe; direct fixtures get a private
        # unscraped one so the hot path never branches on None
        if probe is None:
            from .probe import fixture_probe

            probe = fixture_probe()
        self.probe = probe
        self._observe_commit = probe.observe_commit
        # shard tick frame (raft/tick_frame.py): when wired (via
        # GroupManager), per-reply quorum math becomes an enqueue into
        # the frame's pending columns; None (direct fixtures) keeps
        # the scalar per-reply path — which doubles as the live
        # differential oracle for the batched plane
        self._tick_frame = tick_frame
        self._election_t0: Optional[float] = None
        # unified retry budget for the remote send loops (catch-up
        # backoff, snapshot chunks): a child of the node-wide root when
        # one is wired, so a node-level abort cancels every group's
        # nested retries; standalone fixtures own a private root
        parent = getattr(recovery_throttle, "retry_root", None)
        self._own_retry_root = parent is None
        self._retry_root = (
            RetryChainNode(base_backoff_s=0.02, max_backoff_s=0.5)
            if parent is None
            else parent.child()
        )

        self.row = arrays.alloc_row()
        self._role = Role.FOLLOWER
        arrays.is_follower[self.row] = True
        arrays.touch()
        self._voted_for: Optional[int] = None
        self._slot_map: dict[int, int] = {}
        self._next_index: dict[int, int] = {}
        self._peer_locks = LockMap()  # one catch-up fiber per follower
        self._commit_event = asyncio.Event()
        self._leadership_waiters: list[asyncio.Event] = []
        # offset-keyed quorum waiters (heap by round-last offset):
        # resolved INLINE from _notify_commit instead of one waiter
        # task + Event churn per flush round (r4 profile: 6+ task
        # wakeups per round, asyncio:loop 27% of core)
        self._quorum_waiters: list[tuple] = []
        self._qw_seq = itertools.count()
        self._qw_timer: Optional[asyncio.TimerHandle] = None
        # persistent per-peer catch-up fibers, kicked by event instead
        # of a task spawn per flush round (replicate_entries_stm
        # dispatch fibers, ref replicate_entries_stm.cc:143)
        self._peer_kicks: dict[int, asyncio.Event] = {}
        self._peer_fibers: dict[int, asyncio.Task] = {}
        # quorum-first dispatch state (kick_quorum_ackers): peers whose
        # last append dispatch failed — per-peer, so a dead NON-
        # preferred follower doesn't flap the group into fan-out and a
        # dead preferred one can't be masked by another peer's success
        self._failed_peers: set[int] = set()
        self._lazy_last_kick: dict[int, float] = {}
        self._bg_tasks: set[asyncio.Task] = set()
        self._append_lock = asyncio.Lock()  # append_entries_buffer analog
        # scratch (state, desc, reply) for the native append fast path,
        # allocated on first use; reuse is safe because calls are
        # serialized under _append_lock on one event loop
        self._af_bufs = None
        self._vote_lock = asyncio.Lock()
        # fired on role/config/slot changes so the heartbeat manager
        # can invalidate its cached per-peer build plan
        self.on_topology_change: list = []
        # (offset, config) of every config batch in the log — lets
        # truncation roll the active config back (reference:
        # raft/configuration_manager.{h,cc} persisted history)
        self._config_history: list[tuple[int, GroupConfiguration]] = []
        self._initial_config = config
        self._closed = False
        # live-move quiesce (placement/mover.py): while frozen the
        # group accepts no replicate/append/vote traffic — writers get
        # retriable errors and the log stays byte-stable for shipping
        self._frozen = False
        # -- raft snapshot state (consensus.cc install_snapshot +
        # recovery_stm.cc snapshot fallback) --------------------------
        self._snapshot_path = os.path.join(log.directory, "snapshot")
        self._snap_index = NO_OFFSET  # last offset covered by snapshot
        self._snap_term = -1
        self._accum_size = 0  # install-side chunk accumulator position
        # named state machines contributing capture/restore blobs
        # (partition offset-translator+producers, STMs); see snapshot.py
        self.snapshot_contributors: dict[str, object] = {}
        # blobs from a snapshot installed/loaded before contributors
        # registered (crash-recovery ordering)
        self._install_blobs: dict[str, bytes] = {}
        from .replicate_batcher import ReplicateBatcher

        self._batcher = ReplicateBatcher(self)

    @property
    def role(self) -> Role:
        return self._role

    @role.setter
    def role(self, v: Role) -> None:
        """Mirror the follower flag into the SoA so the node-batched
        heartbeat answer needs no per-group Python role check."""
        self._role = v
        self.arrays.is_follower[self.row] = v is Role.FOLLOWER
        self.arrays.touch()

    # ---------------------------------------------------------- setup
    def _vote_key(self) -> bytes:
        return f"vote/{self.group_id}".encode()

    def _config_key(self) -> bytes:
        return f"cfg/{self.group_id}".encode()

    def _load_config_state(self) -> None:
        raw = self._kvstore.get(KeySpace.consensus, self._config_key())
        if raw is not None:
            self.config = GroupConfiguration.decode(raw)

    def _persist_config(self) -> None:
        try:
            self._kvstore.put(
                KeySpace.consensus, self._config_key(), self.config.encode()
            )
        except KvStoreClosed:
            # append racing shutdown: the kvstore copy is a cache — the
            # config is re-derived from the log's config batches at
            # boot (_hydrate_config_history), so skipping is safe; a
            # closed store outside shutdown is a real bug
            if not self._closed:
                raise

    def _observe_append(self, batch: RecordBatch) -> None:
        """Log-append hook: raft requires configs take effect the
        moment they are APPENDED, not committed (consensus.cc applies
        via configuration_manager at append) — otherwise followers keep
        voting with a stale voter set after the leader reconfigures."""
        if batch.header.term >= 0:
            # keep the term-boundary mirror current (O(1); feeds the
            # batched heartbeat build's vectorized term_at)
            self.arrays.tb_note_append(
                self.row, batch.header.base_offset, batch.header.term
            )
        if batch.header.type != RecordBatchType.raft_configuration:
            return
        for rec in batch.records():
            if rec.value is not None:
                cfg = GroupConfiguration.decode(rec.value)
                self._config_history.append((batch.header.base_offset, cfg))
                self.config = cfg
                self._rebuild_slots()
                self._persist_config()

    def _hydrate_config_history(self) -> None:
        """Rebuild the in-log config history on restart so a later
        truncation of an uncommitted config batch can roll the active
        config back (configuration_manager.cc recovery)."""
        offs = self.log.offsets()
        pos = max(offs.start_offset, 0)
        while pos <= offs.dirty_offset:
            batches = self.log.read(pos, max_bytes=1 << 22)
            if not batches:
                break
            for b in batches:
                pos = b.header.last_offset + 1
                if b.header.type != RecordBatchType.raft_configuration:
                    continue
                for rec in b.records():
                    if rec.value is not None:
                        self._config_history.append(
                            (
                                b.header.base_offset,
                                GroupConfiguration.decode(rec.value),
                            )
                        )
        if self._config_history:
            self.config = self._config_history[-1][1]

    def _sync_term_bounds(self) -> None:
        """Rebuild the row's term-boundary + log-offset mirrors from
        the log and the snapshot boundary (start, truncation, prefix
        truncation, snapshot install)."""
        bounds: list[tuple[int, int]] = []
        if self._snap_index >= 0:
            bounds.append((self._snap_index, self._snap_term))
        for start, term in self.log.term_boundaries():
            if not bounds or term > bounds[-1][1]:
                bounds.append((start, term))
        self.arrays.tb_set(self.row, bounds)
        self.arrays.log_start[self.row] = self.log.offsets().start_offset
        self.arrays.snap_index[self.row] = self._snap_index
        self.arrays.touch()

    def _observe_prefix_truncate(self, _new_start: int) -> None:
        self._sync_term_bounds()

    def _notify_topology(self) -> None:
        for fn in self.on_topology_change:
            fn()

    def _observe_truncate(self, offset: int) -> None:
        self._sync_term_bounds()
        changed = False
        while self._config_history and self._config_history[-1][0] >= offset:
            self._config_history.pop()
            changed = True
        if changed:
            self.config = (
                self._config_history[-1][1]
                if self._config_history
                else self._initial_config
            )
            self._rebuild_slots()
            self._persist_config()

    def _load_vote_state(self) -> None:
        raw = self._kvstore.get(KeySpace.consensus, self._vote_key())
        if raw is not None:
            st = _VoteState.decode(raw)
            self.arrays.term[self.row] = max(int(st.term), 0)
            self.arrays.touch()
            self._voted_for = st.voted_for if st.voted_for >= 0 else None

    def _persist_vote_state(self) -> None:
        # NOTE: persistence failures MUST propagate — handle_vote must
        # never reply granted for a vote that was not made durable
        # (one-vote-per-term is exactly what the persistence protects)
        st = _VoteState(
            term=int(self.term),
            voted_for=self._voted_for if self._voted_for is not None else -1,
        )
        self._kvstore.put(KeySpace.consensus, self._vote_key(), st.encode())

    def _rebuild_slots(self) -> None:
        """slot 0 = self; peers in sorted order. Rewrites voter masks
        AND migrates per-slot replication state by peer id — on
        reconfiguration a peer may land in a different slot, and
        inheriting another peer's match/flushed/seq lanes would count
        unreplicated entries toward quorum (types.h:78-117 keeps this
        state per-follower, not per-position)."""
        row = self.row
        old_map = getattr(self, "_slot_map", {})
        saved = {
            peer: (
                int(self.arrays.match_index[row, slot]),
                int(self.arrays.flushed_index[row, slot]),
                int(self.arrays.last_seq[row, slot]),
                int(self.arrays.next_seq[row, slot]),
            )
            for peer, slot in old_map.items()
        }
        self._slot_map = {self.node_id: SELF_SLOT}
        peers = sorted(n for n in self.config.all_nodes() if n != self.node_id)
        if len(peers) + 1 > self.arrays.replica_slots:
            raise ValueError("replication factor exceeds replica slots")
        self.arrays.is_voter[row] = False
        self.arrays.is_voter_old[row] = False
        self.arrays.is_voter[row, SELF_SLOT] = self.config.is_voter(self.node_id)
        self.arrays.is_voter_old[row, SELF_SLOT] = self.node_id in self.config.old_voters
        for i, peer in enumerate(peers):
            slot = i + 1
            self._slot_map[peer] = slot
            self.arrays.is_voter[row, slot] = self.config.is_voter(peer)
            self.arrays.is_voter_old[row, slot] = peer in self.config.old_voters
            match, flushed, last_seq, next_seq = saved.get(
                peer, (int(NO_OFFSET), int(NO_OFFSET), 0, 0)
            )
            self.arrays.match_index[row, slot] = match
            self.arrays.flushed_index[row, slot] = flushed
            self.arrays.last_seq[row, slot] = last_seq
            self.arrays.next_seq[row, slot] = next_seq
            self.arrays.touch()
            self._peer_locks.lock(peer)
        # reclaim registry entries for peers the config change dropped
        # (a held lock survives: its catch-up fiber finishes first and
        # the entry falls to the next prune)
        self._peer_locks.prune(keep=peers)
        # slots past the new peer set hold stale lanes: neutralize them
        for slot in range(len(peers) + 1, self.arrays.replica_slots):
            self.arrays.match_index[row, slot] = int(NO_OFFSET)
            self.arrays.flushed_index[row, slot] = int(NO_OFFSET)
            self.arrays.last_seq[row, slot] = 0
            self.arrays.next_seq[row, slot] = 0
        self.arrays.voter_epoch += 1
        # a config change alters quorum shape: force the incremental
        # sweep to recompute this row even if no offsets move
        self.arrays.quorum_dirty[row] = True
        self._notify_topology()

    def _load_snapshot(self) -> None:
        """Hydrate snapshot state on restart. If the log is behind the
        snapshot (crash between snapshot install and log reset), finish
        the reset and stage the payload blobs for contributors that
        register later."""
        if not os.path.exists(self._snapshot_path):
            return
        try:
            meta_raw, payload = snapfmt.read_snapshot(self._snapshot_path)
            meta = RaftSnapshotMetadata.decode(meta_raw)
        except (snapfmt.SnapshotCorruption, serde.SerdeError, OSError):
            logger.exception("g%d: dropping corrupt snapshot", self.group_id)
            os.remove(self._snapshot_path)
            return
        self._snap_index = int(meta.last_included_index)
        self._snap_term = int(meta.last_included_term)
        cfg = GroupConfiguration.decode(meta.config)
        # the snapshot's config is the floor: any config batches still
        # in the log (handled by _hydrate_config_history) are newer
        self._initial_config = cfg
        self.config = cfg
        row = self.row
        self.arrays.commit_index[row] = max(
            int(self.arrays.commit_index[row]), self._snap_index
        )
        self.arrays.touch()
        self.arrays.last_visible[row] = max(
            int(self.arrays.last_visible[row]), self._snap_index
        )
        if self.log.offsets().dirty_offset < self._snap_index:
            self.log.install_snapshot_reset(self._snap_index + 1, self._snap_term)
        else:
            # the logical start is not persisted by the log — the
            # snapshot metadata IS its durable form; re-establish it so
            # replay and reads begin past the summarized prefix
            self.log.prefix_truncate(self._snap_index + 1)
        # stage the payload for contributors in EVERY restart, not just
        # the crash-mid-install case: derived state whose commands sit
        # below the log start (producer dedupe, tx ranges, archival
        # metadata trimmed away by retention) is only recoverable from
        # the snapshot — log replay alone silently loses it
        try:
            sp = SnapshotPayload.decode(payload)
            self._install_blobs = dict(zip(sp.names, sp.blobs))
        except serde.SerdeError:
            logger.exception(
                "g%d: snapshot payload undecodable; contributors will "
                "rebuild from the log suffix only",
                self.group_id,
            )

    def staged_snapshot(self, name: str) -> bytes | None:
        """Snapshot payload blob waiting for contributor `name`, if a
        local snapshot exists — lets a contributor skip its own
        full-log rebuild at boot (registration restores the blob and
        replays only the suffix)."""
        return self._install_blobs.get(name)

    def register_snapshot_contributor(self, name: str, obj) -> None:
        """obj: capture_snapshot(upto)->bytes, restore_snapshot(blob, last_included)."""
        self.snapshot_contributors[name] = obj
        blob = self._install_blobs.get(name)
        if blob is not None:
            obj.restore_snapshot(blob, self._snap_index)

    async def start(self) -> None:
        self._load_snapshot()
        self._load_vote_state()
        self._load_config_state()
        self._hydrate_config_history()
        self.log.on_append.append(self._observe_append)
        self.log.on_truncate.append(self._observe_truncate)
        self.log.on_prefix_truncate.append(self._observe_prefix_truncate)
        self._sync_term_bounds()
        self._rebuild_slots()
        offs = self.log.offsets()
        row = self.row
        self.arrays.match_index[row, SELF_SLOT] = offs.dirty_offset
        self.arrays.flushed_index[row, SELF_SLOT] = offs.committed_offset
        self.arrays.touch()
        last_term = self.log.term_of_last_batch()
        if last_term > self.term:
            self.arrays.term[row] = last_term
        self._last_heartbeat = asyncio.get_event_loop().time()
        # election scheduling is node-batched: the GroupManager sweeper
        # scans the el_* lanes (one task per NODE, not per group) and
        # calls try_election() on expiry — see group_manager.py
        self.arrays.el_timeout[row] = self._election_timeout
        self.arrays.el_jitter[row] = random.random()
        self.arrays.last_el[row] = 0.0

    async def stop(self) -> None:
        self._closed = True
        if self._own_retry_root:
            # shared roots belong to the node (GroupManager aborts
            # them); aborting one here would kill sibling groups' loops
            self._retry_root.abort()
        await self._batcher.stop()
        for t in self._bg_tasks:
            t.cancel()
        tasks = list(self._bg_tasks)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if self._observe_append in self.log.on_append:
            self.log.on_append.remove(self._observe_append)
        if self._observe_truncate in self.log.on_truncate:
            self.log.on_truncate.remove(self._observe_truncate)
        if self._observe_prefix_truncate in self.log.on_prefix_truncate:
            self.log.on_prefix_truncate.remove(self._observe_prefix_truncate)
        self._notify_commit()  # release waiters
        self._fail_quorum_waiters(lambda: ReplicateTimeout("node stopped"))

    # ------------------------------------------------- live-move quiesce
    async def freeze(self, drain_timeout_s: float = 5.0) -> None:
        """Quiesce for a live shard move: stop accepting writes/votes
        (_frozen guards), park the election sweeper, drain in-flight
        replication, and flush so the on-disk log is the full state."""
        self._frozen = True
        loop = asyncio.get_event_loop()
        # park the sweeper — a frozen group must not campaign while its
        # hard state is being shipped
        self.arrays.el_timeout[self.row] = 1e9
        self._last_heartbeat = loop.time()
        self.arrays.touch()
        deadline = loop.time() + drain_timeout_s
        while self._batcher._pending_bytes > 0 or self._quorum_waiters:
            if loop.time() >= deadline:
                self._fail_quorum_waiters(
                    lambda: NotLeaderError(self.leader_id)
                )
                break
            await asyncio.sleep(0.005)
        if self._tick_frame is not None:
            self._tick_frame.flush()
        await self.log.flush_async()

    def thaw(self) -> None:
        """Undo freeze() after a move rollback: resume service on the
        source copy as if the move never started."""
        self._frozen = False
        self.arrays.el_timeout[self.row] = self._election_timeout
        self._last_heartbeat = asyncio.get_event_loop().time()
        self.arrays.touch()

    # ------------------------------------------------------ properties
    # hot per-group scalars live as lanes in the shard SoA so the
    # node-batched heartbeat service can read/write them for every
    # group with one vector op (service.py heartbeat fast path)
    @property
    def leader_id(self) -> Optional[int]:
        v = int(self.arrays.leader_id[self.row])
        return None if v < 0 else v

    @leader_id.setter
    def leader_id(self, v: Optional[int]) -> None:
        self.arrays.leader_id[self.row] = -1 if v is None else int(v)

    @property
    def _last_heartbeat(self) -> float:
        row = self.row
        hb = float(self.arrays.last_hb[row])
        cover = int(self.arrays.same_cover_node[row])
        if cover >= 0:
            # quiesced leader: liveness arrives as node-level SAME
            # stamps, not per-row writes
            hb = max(hb, self.arrays.node_hb.get(cover, 0.0))
        return hb

    @_last_heartbeat.setter
    def _last_heartbeat(self, v: float) -> None:
        self.arrays.last_hb[self.row] = v

    @property
    def kvstore(self) -> KvStore:
        return self._kvstore

    @property
    def term(self) -> int:
        return int(self.arrays.term[self.row])

    @property
    def commit_index(self) -> int:
        return int(self.arrays.commit_index[self.row])

    @property
    def term_start(self) -> int:
        """First offset appended in the current leadership term (the
        own-term configuration batch). commit_index >= term_start is
        the linearizable barrier condition: once an own-term entry
        commits, every offset committed under prior leaders is covered
        (consensus.cc:2741 commit gate / group_manager.cc:548)."""
        return int(self.arrays.term_start[self.row])

    @property
    def last_visible_index(self) -> int:
        return int(self.arrays.last_visible[self.row])

    def is_leader(self) -> bool:
        return self.role == Role.LEADER

    def peers(self) -> list[int]:
        return [n for n in self.config.all_nodes() if n != self.node_id]

    def dirty_offset(self) -> int:
        return int(self.arrays.match_index[self.row, SELF_SLOT])

    def flushed_offset(self) -> int:
        return int(self.arrays.flushed_index[self.row, SELF_SLOT])

    @property
    def snapshot_index(self) -> int:
        return self._snap_index

    def term_at(self, offset: int) -> Optional[int]:
        """Term of the entry at offset, answering from the snapshot
        boundary for the last included offset (Raft: the snapshot's
        (index, term) pair substitutes for discarded entries)."""
        if offset < 0:
            return -1
        if offset == self._snap_index:
            return self._snap_term
        return self.log.get_term(offset)

    # ------------------------------------------------------- elections
    async def try_election(self) -> None:
        """One election attempt — fired by the node-level sweeper when
        this group's randomized deadline expired (semantics of the old
        per-group timer loop, minus 1-task-per-group overhead)."""
        if self._closed or self.role == Role.LEADER:
            return
        now = asyncio.get_event_loop().time()
        if now - self._last_heartbeat < self._election_timeout:
            return
        if not self.config.is_voter(self.node_id):
            return
        try:
            if await self.dispatch_prevote():
                # Re-check leader liveness before mutating ANY term
                # state: on a loaded host the sweeper can observe a
                # stale _last_heartbeat after a loop stall, win the
                # (stateless) prevote off equally stale observers, and
                # only HERE — after the prevote gather's awaits drained
                # the queued heartbeats — is the truth visible. An
                # election that was a scheduling artifact aborts with
                # terms untouched.
                now = asyncio.get_event_loop().time()
                if (
                    self._closed
                    or self.role == Role.LEADER
                    or now - self._last_heartbeat < self._election_timeout
                ):
                    return
                self.probe.elections_started.inc()
                self._election_t0 = now
                await self.dispatch_vote()
        except Exception:
            logger.exception("g%d: election round failed", self.group_id)

    async def dispatch_prevote(self) -> bool:
        """Prevote round (prevote_stm.cc): ask voters whether a REAL
        election at term+1 could win, without mutating any state. A
        partitioned or flapping node therefore stops bumping terms
        cluster-wide — its prevotes are denied (peers still hear the
        leader) or unanswerable (it is cut off), and its term never
        moves. Grants carry no durable state: no voted_for write, no
        step-down, no heartbeat-suppression on the receiving side."""
        offs = self.log.offsets()
        req = rt.VoteRequest(
            group=self.group_id,
            node_id=self.node_id,
            term=self.term + 1,
            prev_log_index=offs.dirty_offset,
            prev_log_term=self.log.term_of_last_batch(),
            leadership_transfer=False,
            prevote=True,
        ).encode()

        async def ask(peer: int) -> Optional[rt.VoteReply]:
            try:
                raw = await self._send(peer, rt.VOTE, req, self._election_timeout)
                return rt.VoteReply.decode(raw)
            except Exception:
                return None

        peers = self.peers()
        replies = await asyncio.gather(*(ask(p) for p in peers))
        granted = {self.node_id}
        for peer, rep in zip(peers, replies):
            if rep is not None and rep.granted:
                granted.add(peer)
        return self._has_majority(granted)

    async def dispatch_vote(self, leadership_transfer: bool = False) -> bool:
        """One election round (vote_stm.cc). Returns True on win.

        The vote lock is held only for the local state mutations, NOT
        across the remote gather — two simultaneous candidates holding
        their locks across RPCs would block each other's handle_vote
        until timeout and systematically fail contested rounds."""
        async with self._vote_lock:
            row = self.row
            self.role = Role.CANDIDATE
            self.leader_id = None
            self.arrays.term[row] = self.term + 1
            self.arrays.touch()
            term = self.term
            self._voted_for = self.node_id
            try:
                self._persist_vote_state()
            except KvStoreClosed:
                # our OWN candidacy racing broker shutdown: abort before
                # any RPC goes out (nothing was granted to anyone).
                # handle_vote deliberately has no such catch — a voter
                # that cannot persist must error, not grant.
                return False
            offs = self.log.offsets()
            req = rt.VoteRequest(
                group=self.group_id,
                node_id=self.node_id,
                term=term,
                prev_log_index=offs.dirty_offset,
                prev_log_term=self.log.term_of_last_batch(),
                leadership_transfer=leadership_transfer,
                prevote=False,
            ).encode()

        async def ask(peer: int) -> Optional[rt.VoteReply]:
            try:
                raw = await self._send(peer, rt.VOTE, req, self._election_timeout)
                return rt.VoteReply.decode(raw)
            except Exception:
                return None

        peers = self.peers()
        replies = await asyncio.gather(*(ask(p) for p in peers))

        async with self._vote_lock:
            granted = {self.node_id}
            for peer, rep in zip(peers, replies):
                if rep is None:
                    continue
                if rep.term > term:
                    self._step_down(int(rep.term))
                    return False
                if rep.granted:
                    granted.add(peer)
            # state may have moved while gathering: only claim
            # leadership if still the same term's candidate
            if self.term != term or self.role != Role.CANDIDATE:
                return False
            if self._has_majority(granted):
                self._become_leader()
                return True
            self.role = Role.FOLLOWER
            return False

    def _has_majority(self, granted: set[int]) -> bool:
        cur = [v for v in self.config.voters if v in granted]
        ok = len(cur) >= self.config.majority_size()
        if self.config.is_joint():
            old = [v for v in self.config.old_voters if v in granted]
            ok = ok and len(old) >= (len(self.config.old_voters) // 2 + 1)
        return ok

    def _become_leader(self) -> None:
        self.probe.leadership_changes.inc()
        if self._election_t0 is not None:
            self.probe.election_hist.observe(
                asyncio.get_event_loop().time() - self._election_t0
            )
            self._election_t0 = None
        row = self.row
        self.role = Role.LEADER
        self.leader_id = self.node_id
        offs = self.log.offsets()
        self.arrays.is_leader[row] = True
        self.arrays.touch()
        # reset follower tracking for the new term
        for peer, slot in self._slot_map.items():
            if peer == self.node_id:
                continue
            self.arrays.match_index[row, slot] = NO_OFFSET
            self.arrays.flushed_index[row, slot] = NO_OFFSET
            self._next_index[peer] = offs.dirty_offset + 1
        # commit gate: only entries of our own term count
        # (consensus.cc:2741 / Raft §5.4.2) — established by replicating
        # the configuration in the new term
        self.arrays.term_start[row] = offs.dirty_offset + 1
        builder = RecordBatchBuilder(batch_type=RecordBatchType.raft_configuration)
        builder.add(value=self.config.encode(), key=b"raft_configuration")
        batch = builder.build()
        base, last = self.log.append(batch, term=self.term)
        flushed = self.log.flush()
        self.arrays.match_index[row, SELF_SLOT] = last
        self.arrays.flushed_index[row, SELF_SLOT] = flushed
        self.arrays.touch()
        if self.arrays.scalar_commit_update(row):
            self._notify_commit()
        logger.info(
            "g%d: node %d elected leader term %d", self.group_id, self.node_id, self.term
        )
        self._notify_topology()
        for ev in self._leadership_waiters:
            ev.set()
        # establish leadership immediately
        for peer in self.peers():
            self.kick_catch_up(peer)

    def _step_down(self, term: int) -> None:
        row = self.row
        if term > self.term:
            self.arrays.term[row] = term
            self.arrays.touch()
            self._voted_for = None
            self._persist_vote_state()
        was_leader = self.role == Role.LEADER
        if was_leader:
            logger.info("g%d: node %d stepping down term %d", self.group_id, self.node_id, term)
        self.role = Role.FOLLOWER
        self.arrays.is_leader[row] = False
        if was_leader:
            self._notify_topology()
        self._notify_commit()  # wake replicate waiters → they fail fast
        if self._quorum_waiters:
            # registered while we led; none can commit under our
            # leadership anymore — fail them now, not at timeout
            self._fail_quorum_waiters(lambda: NotLeaderError(self.leader_id))

    async def wait_for_leadership(self, timeout: float = 5.0) -> None:
        if self.is_leader():
            return
        ev = asyncio.Event()
        self._leadership_waiters.append(ev)
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        finally:
            self._leadership_waiters.remove(ev)

    # ---------------------------------------------------------- voting
    async def handle_vote(self, req: rt.VoteRequest) -> rt.VoteReply:
        async with self._vote_lock:
            if self._frozen:
                # mid-move: granting could double-vote once the moved
                # copy restarts from the shipped hard state
                return rt.VoteReply(
                    group=self.group_id,
                    term=self.term,
                    granted=False,
                    log_ok=False,
                )
            if req.term < self.term:
                return rt.VoteReply(
                    group=self.group_id, term=self.term, granted=False, log_ok=False
                )
            offs = self.log.offsets()
            last_term = self.log.term_of_last_batch()
            log_ok = (req.prev_log_term > last_term) or (
                req.prev_log_term == last_term
                and req.prev_log_index >= offs.dirty_offset
            )
            if req.prevote:
                # advisory only: no step-down, no voted_for write, no
                # election suppression. Deny while a leader is live
                # (Raft §4.2.3 leader stickiness) so a flapping node
                # cannot talk a healthy cluster into an election.
                now = asyncio.get_event_loop().time()
                leader_live = (
                    self.role == Role.LEADER
                    or (
                        self.leader_id is not None
                        and now - self._last_heartbeat < self._election_timeout
                    )
                )
                return rt.VoteReply(
                    group=self.group_id,
                    term=self.term,
                    granted=log_ok and not leader_live,
                    log_ok=log_ok,
                )
            if req.term > self.term:
                self._step_down(int(req.term))
            granted = log_ok and (
                self._voted_for is None or self._voted_for == req.node_id
            )
            if granted:
                self._voted_for = int(req.node_id)
                self._persist_vote_state()
                # grant ⇒ suppress own election for a while
                self._last_heartbeat = asyncio.get_event_loop().time()
            return rt.VoteReply(
                group=self.group_id, term=self.term, granted=granted, log_ok=log_ok
            )

    # ------------------------------------------------ follower appends
    async def handle_append_entries(
        self, req: rt.AppendEntriesRequest
    ) -> rt.AppendEntriesReply:
        """Follower-side append path (consensus.cc:1734 do_append_entries),
        serialized per group (append_entries_buffer analog)."""
        async with self._append_lock:
            return await self._do_append_entries(req)

    async def try_native_append(self, payload: bytes) -> bytes | None:
        """RPC-layer zero-decode fast path: run the native follower
        framing under the same per-group lock the Python handler uses.
        `payload` is the serialized AppendEntriesRequest envelope;
        returns encoded reply bytes, or None ⇒ caller decodes and
        dispatches through handle_append_entries as usual."""
        if self._frozen:
            return None  # decode route answers with the frozen reply
        async with self._append_lock:
            with trace.section("log_append", self.probe.registry):
                return self.native_append_frame(payload)

    def _reply(self, status: int, seq: int) -> rt.AppendEntriesReply:
        return rt.AppendEntriesReply(
            group=self.group_id,
            node_id=self.node_id,
            term=self.term,
            last_dirty_log_index=self.dirty_offset(),
            last_flushed_log_index=self.flushed_offset(),
            seq=seq,
            status=status,
        )

    async def _do_append_entries(
        self, req: rt.AppendEntriesRequest
    ) -> rt.AppendEntriesReply:
        row = self.row
        if self._frozen:
            # mid-move: the log must stay byte-stable while it ships;
            # GROUP_UNAVAILABLE makes the leader back off and retry
            # (against the new shard once the route rebinds)
            return self._reply(
                rt.AppendEntriesReply.GROUP_UNAVAILABLE, int(req.seq)
            )
        # 1. term checks (consensus.cc:1752-1774)
        if req.term < self.term:
            return self._reply(rt.AppendEntriesReply.FAILURE, int(req.seq))
        self._last_heartbeat = asyncio.get_event_loop().time()
        if req.term > self.term or self.role != Role.FOLLOWER:
            self._step_down(int(req.term))
        self.leader_id = int(req.node_id)

        offs = self.log.offsets()
        # 2. gap check (consensus.cc:1789)
        if req.prev_log_index > offs.dirty_offset:
            return self._reply(rt.AppendEntriesReply.FAILURE, int(req.seq))
        # 3. prev-term match (consensus.cc:1800-1828). Offsets at-or-
        # below the snapshot boundary are committed and match by
        # definition; the boundary itself answers from snapshot state.
        if req.prev_log_index >= 0 and req.prev_log_index >= self._snap_index:
            local_term = self.term_at(req.prev_log_index)
            if (
                req.prev_log_index >= offs.start_offset
                or req.prev_log_index == self._snap_index
            ) and (local_term is None or local_term != req.prev_log_term):
                return self._reply(rt.AppendEntriesReply.FAILURE, int(req.seq))

        # 4. append, truncating on conflict (consensus.cc:1869-1928).
        # Entries at-or-below `last_new_entry` are verified identical to
        # the leader's log; the commit update below must never run past
        # it (Raft §5.3: min(leaderCommit, index of last new entry)) —
        # a retained local suffix beyond it may be divergent.
        # the write and its flush hold the loop: one section
        with trace.section("log_append", self.probe.registry):
            appended = False
            last_new_entry = int(req.prev_log_index)
            for raw in req.batches:
                batch = RecordBatch.deserialize(raw)
                base = batch.header.base_offset
                if batch.header.last_offset <= self._snap_index:
                    # fully covered by our snapshot: committed by definition
                    last_new_entry = batch.header.last_offset
                    continue
                cur = self.log.offsets()
                if base <= cur.dirty_offset:
                    local_term = self.log.get_term(base)
                    if local_term == batch.header.term:
                        last_new_entry = batch.header.last_offset
                        continue  # duplicate delivery
                    # safety gate BEFORE any destruction: committed data
                    # must never be truncated
                    if self.commit_index >= base:
                        raise RuntimeError(
                            f"g{self.group_id}: attempt to truncate committed "
                            f"offset {base} <= {self.commit_index}"
                        )
                    logger.info(
                        "g%d: truncating at %d (term conflict %s != %d)",
                        self.group_id, base, local_term, batch.header.term,
                    )
                    self.log.truncate(base)
                    self.arrays.match_index[row, SELF_SLOT] = base - 1
                    self.arrays.flushed_index[row, SELF_SLOT] = min(
                        int(self.arrays.flushed_index[row, SELF_SLOT]), base - 1
                    )
                    self.arrays.touch()
                self.log.append_exactly(batch)
                appended = True
                last_new_entry = batch.header.last_offset
            if appended or req.flush:
                flushed = self.log.flush()
                new_offs = self.log.offsets()
                self.arrays.match_index[row, SELF_SLOT] = new_offs.dirty_offset
                self.arrays.flushed_index[row, SELF_SLOT] = flushed
                self.arrays.touch()

        # 5. follower commit index (consensus.cc:2760-2777), capped at
        # the last entry confirmed to match the leader's log
        new_commit = qs.follower_commit_index(
            self.commit_index,
            self.flushed_offset(),
            min(int(req.commit_index), last_new_entry),
        )
        if new_commit != self.commit_index:
            self.arrays.commit_index[row] = new_commit
            self.arrays.last_visible[row] = max(
                int(self.arrays.last_visible[row]), new_commit
            )
            self.arrays.touch()
            self._notify_commit()
        return self._reply(rt.AppendEntriesReply.SUCCESS, int(req.seq))

    def native_append_frame(self, payload: bytes) -> bytes | None:
        """Steady-state follower append in one native call
        (native/append_frame.cc): parse + guards + per-batch CRC +
        reply build happen in C; this method only assembles the scalar
        state snapshot, writev()s the verified spans into the active
        segment, and mirrors the bookkeeping _do_append_entries would
        have done (index, cache, on_append hooks, arrays, commit).

        Returns the encoded AppendEntriesReply bytes, or None to PUNT —
        any non-happy-path condition falls back byte-for-byte to the
        Python handler. Caller must hold _append_lock."""
        log = self.log
        segs = log._segments
        if not segs:
            return None
        seg = segs[-1]
        dirty = seg.dirty_offset
        if dirty >= seg.base_offset:
            last_term = seg.term
        elif dirty == self._snap_index:
            last_term = self._snap_term
        else:
            return None  # empty tail not at the snapshot boundary
        if dirty < self._snap_index:
            return None  # below-snapshot batches need the dedup loop
        row = self.row
        arrays = self.arrays
        if int(arrays.match_index[row, SELF_SLOT]) != dirty:
            return None  # arrays mirror out of step with storage
        bufs = self._af_bufs
        if bufs is None:
            bufs = self._af_bufs = native_mod.append_frame_buffers()
        state, desc, reply = bufs
        state[0] = self.group_id
        state[1] = int(arrays.term[row])
        state[2] = dirty
        state[3] = last_term
        state[4] = int(arrays.commit_index[row])
        state[5] = 1 if self._role is Role.FOLLOWER else 0
        state[6] = self.node_id
        state[7] = seg.term
        state[8] = log.config.segment_max_bytes - seg._size
        rc = native_mod.append_frame(payload, state, desc, reply)
        if rc != 0:
            return None
        # happy path: everything below mirrors _do_append_entries with
        # the request already validated — no punt past this point
        self._last_heartbeat = asyncio.get_event_loop().time()
        self.leader_id = int(desc[5])
        n = int(desc[0])
        new_dirty = int(desc[2])
        pv = memoryview(payload)
        d = native_mod.AF_DESC_HDR
        w = native_mod.AF_DESC_W
        span_list = []
        batches = []
        for i in range(n):
            off = desc[d + i * w]
            ln = desc[d + i * w + 1]
            span_list.append(pv[off : off + ln])
            hdr = RecordBatchHeader.unpack(payload[off : off + HEADER_SIZE])
            batch = RecordBatch(hdr, payload[off + HEADER_SIZE : off + ln])
            batch.finalized = True  # both CRCs verified in C
            batches.append(batch)
        t_seg = time.monotonic()
        seg.append_verified_spans(span_list, batches)
        log._observe_append(time.monotonic() - t_seg)
        cache = log._cache_index
        hooks = log.on_append
        for batch in batches:
            if cache is not None:
                cache.put(batch)
            for fn in hooks:
                fn(batch)
        flushed = log.flush()
        arrays.match_index[row, SELF_SLOT] = new_dirty
        arrays.flushed_index[row, SELF_SLOT] = flushed
        new_commit = qs.follower_commit_index(
            int(arrays.commit_index[row]),
            flushed,
            min(int(desc[6]), int(desc[3])),
        )
        if new_commit != int(arrays.commit_index[row]):
            arrays.commit_index[row] = new_commit
            if new_commit > int(arrays.last_visible[row]):
                arrays.last_visible[row] = new_commit
            arrays.touch()
            self._notify_commit()
        else:
            arrays.touch()
        out = reply.raw
        if flushed != new_dirty:  # defensive: reply carries the truth
            out = bytearray(out)
            struct.pack_into("<q", out, 34, flushed)
            out = bytes(out)
        return out

    def handle_heartbeat(
        self,
        leader_id: int,
        term: int,
        prev_log_index: int,
        prev_log_term: int,
        commit_index: int,
        seq: int,
    ) -> tuple[int, int, int, int, int]:
        """Empty-append fast path (consensus.cc:1833-1846). Runs the
        SAME term/gap/prev-term checks as the full append path — a
        heartbeat is an empty append_entries in the reference, and
        skipping the checks would let a rejoining divergent follower
        commit its own never-replicated suffix. Returns
        (term, dirty, flushed, seq, status) for the batched reply.
        Synchronous: no log I/O on this path."""
        row = self.row
        if term < self.term:
            return (self.term, self.dirty_offset(), self.flushed_offset(), seq,
                    rt.AppendEntriesReply.FAILURE)
        self._last_heartbeat = asyncio.get_event_loop().time()
        if term > self.term or self.role != Role.FOLLOWER:
            self._step_down(term)
        self.leader_id = leader_id
        # gap / prev-term consistency (consensus.cc:1789-1828): reject
        # without committing anything if our log does not match the
        # leader's view at prev
        if prev_log_index > self.dirty_offset():
            return (self.term, self.dirty_offset(), self.flushed_offset(), seq,
                    rt.AppendEntriesReply.FAILURE)
        if prev_log_index >= 0 and (
            prev_log_index >= self.log.offsets().start_offset
            or prev_log_index == self._snap_index
        ):
            local_term = self.term_at(prev_log_index)
            if local_term is None or local_term != prev_log_term:
                return (self.term, self.dirty_offset(), self.flushed_offset(), seq,
                        rt.AppendEntriesReply.FAILURE)
        # only entries ≤ prev are confirmed identical to the leader's
        # log; never commit a (possibly divergent) local suffix beyond
        # it (Raft §5.3: min(leaderCommit, index of last new entry))
        capped = min(commit_index, prev_log_index) if prev_log_index >= 0 else -1
        new_commit = qs.follower_commit_index(
            self.commit_index, self.flushed_offset(), capped
        )
        if new_commit != self.commit_index:
            self.arrays.commit_index[row] = new_commit
            self.arrays.last_visible[row] = max(
                int(self.arrays.last_visible[row]), new_commit
            )
            self.arrays.touch()
            self._notify_commit()
        return (self.term, self.dirty_offset(), self.flushed_offset(), seq,
                rt.AppendEntriesReply.SUCCESS)

    # ------------------------------------------------- leader replicate
    async def replicate_in_stages(
        self,
        builder_or_batch: "RecordBatchBuilder | RecordBatch",
        acks: int = -1,
    ):
        """Two-stage leader write (consensus.cc:728
        replicate_in_stages): returns ReplicateStages whose `enqueued`
        future resolves with (base, last) in log order and `done`
        resolves at the requested ack level. Concurrent calls coalesce
        into one append+fsync+dispatch round (replicate_batcher)."""
        if self.role != Role.LEADER or self._frozen:
            # frozen ⇒ retriable exactly like a moving leader: the
            # client re-routes once the placement table rebinds
            raise NotLeaderError(self.leader_id)
        batch = (
            builder_or_batch.build()
            if isinstance(builder_or_batch, RecordBatchBuilder)
            else builder_or_batch
        )
        return await self._batcher.replicate_in_stages(batch, acks)

    async def replicate(
        self,
        builder_or_batch: "RecordBatchBuilder | RecordBatch",
        acks: int = -1,
        timeout: float = 10.0,
    ) -> tuple[int, int]:
        """Leader write path (consensus.cc:717 replicate). acks: -1 =
        quorum (wait for commit), 1 = leader ack (local flush only),
        0 = fire and forget. Returns (base, last) assigned offsets."""
        stages = await self.replicate_in_stages(builder_or_batch, acks)
        try:
            return await asyncio.wait_for(
                asyncio.shield(stages.done), timeout
            )
        except asyncio.TimeoutError:
            from .replicate_batcher import consume_exc

            consume_exc(stages.done)  # abandoned: round settles later
            raise ReplicateTimeout(
                f"g{self.group_id}: not acked in {timeout}s"
            ) from None

    def _notify_commit(self) -> None:
        ev = self._commit_event
        self._commit_event = asyncio.Event()
        ev.set()
        if self._quorum_waiters:
            ci = self.commit_index
            qw = self._quorum_waiters
            while qw and qw[0][0] <= ci:
                _, _, term, items, _ = heapq.heappop(qw)
                self._resolve_quorum_items(term, items)

    # -- offset-keyed quorum waiters (replicate_batcher acks=-1) ------
    def add_quorum_waiter(
        self, term: int, round_last: int, items: list, timeout_s: float
    ) -> None:
        """Resolve each item's `done` future once round_last commits
        under `term`. Resolution happens inline in _notify_commit —
        no waiter task, no Event churn per round. Failure paths:
        step-down/close fail all waiters eagerly; a coarse 1 s timer
        sweeps timeouts (they are 30 s — precision is irrelevant)."""
        if self.commit_index >= round_last:
            self._resolve_quorum_items(term, items)
            return
        loop = asyncio.get_event_loop()
        heapq.heappush(
            self._quorum_waiters,
            (round_last, next(self._qw_seq), term, items,
             loop.time() + timeout_s),
        )
        if self._qw_timer is None:
            self._qw_timer = loop.call_later(1.0, self._sweep_quorum_timeouts)

    def _resolve_quorum_items(self, term: int, items: list) -> None:
        now = time.monotonic()
        observe = self._observe_commit
        observe_quorum = self.probe.observe_stage_quorum
        for it in items:
            fut = it.stages.done
            if fut.done():
                continue
            # a newer leader may have truncated the round while pending
            if self.term_at(it.base) != term:
                fut.set_exception(NotLeaderError(self.leader_id))
            else:
                fut.set_result((it.base, it.last))
                # enqueue -> quorum ack (raft/probe.cc replicate done)
                observe(now - it.t0)
                # fsync-done -> quorum ack (the pure commit-wait tail)
                observe_quorum(now - it.t_q0)

    def _fail_quorum_waiters(self, make_exc) -> None:
        waiters, self._quorum_waiters = self._quorum_waiters, []
        for _, _, _term, items, _ in waiters:
            for it in items:
                if not it.stages.done.done():
                    it.stages.done.set_exception(make_exc())
        if self._qw_timer is not None:
            self._qw_timer.cancel()
            self._qw_timer = None

    def _sweep_quorum_timeouts(self) -> None:
        self._qw_timer = None
        if not self._quorum_waiters:
            return
        now = asyncio.get_event_loop().time()
        keep = []
        for ent in self._quorum_waiters:
            round_last, _, _term, items, deadline = ent
            if deadline <= now:
                for it in items:
                    if not it.stages.done.done():
                        it.stages.done.set_exception(ReplicateTimeout(
                            f"g{self.group_id}: offset {round_last} "
                            f"not committed"
                        ))
            else:
                keep.append(ent)
        heapq.heapify(keep)
        self._quorum_waiters = keep
        if keep:
            self._qw_timer = asyncio.get_event_loop().call_later(
                1.0, self._sweep_quorum_timeouts
            )

    async def wait_committed(self, offset: int, timeout: float = 10.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while self.commit_index < offset:
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                raise ReplicateTimeout(f"offset {offset} not committed")
            ev = self._commit_event
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                continue

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    # quorum-first dispatch: per flush round kick only the voters
    # needed for quorum (majority minus self); the remaining followers
    # catch up lazily in multi-batch strides (the catch-up fiber reads
    # up to 1 MiB per dispatch), bounded by offset lag and time. Raft
    # permits this freely — commit needs majority, not all — and the
    # per-round CPU of a full dispatch (~0.3 ms at 64 KiB) is the
    # dominant replicated-path cost, so halving dispatches/round at
    # rf=3 buys ~20% of the whole path. Lazy followers stay within
    # LAZY_LAG_OFFSETS/LAZY_MAX_DELAY_S of the head; the heartbeat
    # manager's lag scan is the backstop. Fallbacks to kick-everyone:
    # joint configs (commit needs majorities of BOTH sets) and any
    # dispatch failure of a preferred acker.
    LAZY_LAG_OFFSETS = 512
    LAZY_MAX_DELAY_S = 0.02

    def kick_quorum_ackers(self) -> None:
        cfg = self.config
        peers = self.peers()
        if cfg.is_joint() or len(peers) <= 1:
            for peer in peers:
                self.kick_catch_up(peer)
            return
        need = cfg.majority_size() - 1  # follower acks needed
        voters = [p for p in peers if cfg.is_voter(p)]
        # deterministic per-group rotation: different groups prefer
        # different followers, so node-level load stays balanced and
        # each (group, follower) pair keeps a hot cache affinity
        if len(voters) > need:
            start = self.group_id % len(voters)
            preferred = [
                voters[(start + i) % len(voters)] for i in range(need)
            ]
        else:
            preferred = voters
        pref_set = set(preferred)
        if self._failed_peers & pref_set:
            # a preferred acker failed recently: kick everyone until
            # ITS dispatch succeeds again (commit must not stall on a
            # dead preferred follower; failures of lazy followers
            # don't force fan-out)
            for peer in peers:
                self.kick_catch_up(peer)
            return
        for peer in preferred:
            self.kick_catch_up(peer)
        now = None
        row = self.row
        dirty = int(self.arrays.match_index[row, SELF_SLOT])
        for peer in peers:
            if peer in pref_set:
                continue
            slot = self._slot_map.get(peer)
            if slot is None:
                continue
            lag = dirty - int(self.arrays.match_index[row, slot])
            if lag >= self.LAZY_LAG_OFFSETS:
                self.kick_catch_up(peer)
                continue
            if now is None:
                now = asyncio.get_event_loop().time()
            last = self._lazy_last_kick.get(peer, 0.0)
            if now - last >= self.LAZY_MAX_DELAY_S:
                self._lazy_last_kick[peer] = now
                self.kick_catch_up(peer)

    def kick_catch_up(self, peer: int) -> None:
        """Wake the persistent dispatch fiber for `peer` (spawning it
        on first use). Replaces a Task spawn per flush round per peer
        — at 2 peers that was 2 of the ~6 task creations per round
        (ref replicate_entries_stm.cc:143 per-follower dispatch)."""
        kick = self._peer_kicks.get(peer)
        if kick is None:
            kick = self._peer_kicks[peer] = asyncio.Event()
        kick.set()
        task = self._peer_fibers.get(peer)
        if task is None or task.done():
            task = asyncio.ensure_future(self._peer_fiber(peer, kick))
            self._peer_fibers[peer] = task
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)

    async def _peer_fiber(self, peer: int, kick: asyncio.Event) -> None:
        """Long-lived per-follower dispatch fiber: parks on its kick
        event between rounds (an idle Event wait costs nothing; set()
        is one call_soon — far cheaper than a Task per round). Survives
        step-down/re-election; exits only on close."""
        try:
            while not self._closed:
                await kick.wait()
                kick.clear()
                if self._closed or self.role != Role.LEADER:
                    continue
                try:
                    await self._catch_up(peer)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception(
                        "g%d: catch-up fiber for peer %d",
                        self.group_id, peer,
                    )
        finally:
            if self._peer_fibers.get(peer) is asyncio.current_task():
                self._peer_fibers.pop(peer, None)

    async def _catch_up(self, peer: int) -> None:
        """Per-follower replication/recovery fiber
        (replicate_entries_stm.cc dispatch_one + recovery_stm). Drives
        the follower to the leader's dirty offset, backing off
        next_index on log mismatch."""
        lock = self._peer_locks.lock(peer)
        if lock.locked():
            return  # a fiber is already driving this follower
        async with lock:
            # while this fiber drives the follower, the batched
            # heartbeat skips its slot (consensus::suppress_heartbeats):
            # every dispatch carries term/commit anyway, and a tick-time
            # task spawn per in-flight group is pure overhead
            sup_slot = self._slot_map.get(peer)
            sup_row = self.row
            if sup_slot is not None:
                self.arrays.hb_suppress[sup_row, sup_slot] += 1
                self.arrays.hb_suppress_total += 1
            try:
                await self._catch_up_locked(peer)
            finally:
                if sup_slot is not None:
                    self.arrays.hb_suppress[sup_row, sup_slot] -= 1
                    self.arrays.hb_suppress_total -= 1

    async def _catch_up_locked(self, peer: int) -> None:
        rounds = 0
        chain = self._retry_root.child()
        while (
            not self._closed
            and self.role == Role.LEADER
            and self._follower_needs_data(peer)
        ):
            slot = self._slot_map.get(peer)
            if slot is None:
                return  # peer left the configuration
            before = (
                int(self.arrays.match_index[self.row, slot]),
                int(self.arrays.flushed_index[self.row, slot]),
            )
            # round 0 is NORMAL replication (the batcher ships each
            # flush round through this fiber): never throttled. A
            # follower still behind after a full 1 MiB round is in
            # genuine recovery — only then does the node-wide
            # budget apply (recovery_throttle.h's learner seam).
            if not await self._dispatch_append(
                peer, recovering=rounds > 0
            ):
                return
            rounds += 1
            if rounds > 1:
                self.probe.recovery_rounds.inc()
            slot = self._slot_map.get(peer)
            if slot is None:
                return
            after = (
                int(self.arrays.match_index[self.row, slot]),
                int(self.arrays.flushed_index[self.row, slot]),
            )
            if after <= before:
                # no forward progress this round (mismatch backoff,
                # reordered reply, stuck follower): back off — a hot
                # retry loop here monopolizes the event loop with
                # full-size append payloads (recovery_stm backoff).
                # Jittered exponential via the node's retry tree, so
                # node stop aborts the sleep instead of waiting it out
                try:
                    if not await chain.backoff():
                        return
                except RetryChainAborted:
                    return
            else:
                # forward progress: re-arm the backoff from the base
                chain = self._retry_root.child()

    def _follower_needs_data(self, peer: int) -> bool:
        slot = self._slot_map[peer]
        match = int(self.arrays.match_index[self.row, slot])
        flushed = int(self.arrays.flushed_index[self.row, slot])
        return match < self.dirty_offset() or flushed < match

    async def _dispatch_append(
        self, peer: int, recovering: bool = False
    ) -> bool:
        """One append_entries round to one follower. Returns False to
        stop the catch-up fiber (rpc error / stepped down).
        `recovering` routes the round through the node-wide recovery
        throttle; the normal replication path never sets it."""
        row = self.row
        slot = self._slot_map[peer]
        term = self.term
        next_idx = self._next_index.get(peer, self.dirty_offset() + 1)
        prev = next_idx - 1
        offs = self.log.offsets()
        # appends are feasible only when we can both read from next_idx
        # and state prev's term: prev at the snapshot boundary, at the
        # head of a never-truncated log, or inside the log. Anything
        # else (including a brand-new/wiped follower at prev == -1 when
        # our log starts above 0) needs the snapshot
        # (recovery_stm.cc install_snapshot fallback).
        feasible = (
            prev == self._snap_index
            or (prev == -1 and offs.start_offset == 0)
            or prev >= offs.start_offset
        )
        if not feasible:
            if self._snap_index >= 0:
                return await self._send_snapshot(peer)
            logger.warning(
                "g%d: follower %d below log start and no snapshot",
                self.group_id, peer,
            )
            return False
        prev_term = self.term_at(prev) if prev >= 0 else -1
        if prev_term is None:
            prev_term = -1
        throttle = self.recovery_throttle if recovering else None
        if throttle is not None:
            # hold a memory-quota slot while the read range is in
            # flight, and pay the node-wide recovery rate for the bytes
            # (ref recovery_throttle.h, recovery_memory_quota.cc)
            async with throttle.dispatch_slot():
                batches = (
                    self.log.read(next_idx, max_bytes=1 << 20)
                    if next_idx <= offs.dirty_offset
                    else []
                )
                if batches:
                    await throttle.throttle(
                        sum(b.size_bytes() for b in batches)
                    )
                return await self._dispatch_append_send(
                    peer, row, slot, term, next_idx, prev, prev_term, batches
                )
        batches = self.log.read(next_idx, max_bytes=1 << 20) if next_idx <= offs.dirty_offset else []
        return await self._dispatch_append_send(
            peer, row, slot, term, next_idx, prev, prev_term, batches
        )

    async def _dispatch_append_send(
        self, peer, row, slot, term, next_idx, prev, prev_term, batches
    ) -> bool:
        # the throttled path awaits (semaphore + rate debt) between the
        # caller's slot capture and this send: revalidate against
        # reconfiguration/step-down that may have happened meanwhile
        if self._closed or self.role != Role.LEADER or self.term != term:
            return False
        slot = self._slot_map.get(peer)
        if slot is None:
            return False
        seq = int(self.arrays.next_seq[row, slot]) + 1
        self.arrays.next_seq[row, slot] = seq
        req = rt.AppendEntriesRequest(
            group=self.group_id,
            node_id=self.node_id,
            target_node_id=peer,
            term=term,
            prev_log_index=prev,
            prev_log_term=prev_term,
            commit_index=self.commit_index,
            seq=seq,
            flush=True,
            batches=[b.serialize() for b in batches],
        ).encode()
        try:
            t_wire = time.monotonic()
            raw = await self._send(peer, rt.APPEND_ENTRIES, req, 5.0)
            self.probe.observe_stage_wire(time.monotonic() - t_wire)
            rep = rt.AppendEntriesReply.decode(raw)
        except Exception:
            # quorum-first: a failed peer flips subsequent rounds to
            # kick-everyone while it is a preferred acker, so commit
            # never stalls on a dead preferred follower
            self._failed_peers.add(peer)
            return False
        if self._closed or self.role != Role.LEADER or self.term != term:
            return False
        if rep.term > term:
            self._step_down(int(rep.term))
            return False
        slot = self._slot_map.get(peer)
        if slot is None:
            return False  # peer reconfigured away during the rpc
        # staleness gate BEFORE folding: a duplicated or reordered old
        # reply (nemesis duplicate/reorder, or a late packet beaten by
        # a newer round) must move neither next_index nor the mismatch
        # backoff — process_append_reply has the same guard internally
        # for match/flushed, but next_index lives host-side here
        stale = int(rep.seq) <= int(self.arrays.last_seq[row, slot])
        if rep.status == rt.AppendEntriesReply.SUCCESS:
            self._failed_peers.discard(peer)
            self.process_append_reply(
                peer,
                int(rep.last_dirty_log_index),
                int(rep.last_flushed_log_index),
                int(rep.seq),
            )
            if not stale:
                self._next_index[peer] = int(rep.last_dirty_log_index) + 1
            return True
        if stale:
            return True  # stale mismatch hint: newer evidence already folded
        self.arrays.last_seq[row, slot] = int(rep.seq)
        self.arrays.touch()  # last_seq is a SAME lane
        # log mismatch: back off (consensus.cc follower hints)
        self._next_index[peer] = min(
            max(0, next_idx - 1), int(rep.last_dirty_log_index) + 1
        )
        return True

    def process_append_reply(
        self, peer: int, dirty: int, flushed: int, seq: int
    ) -> None:
        """Fold one follower reply into the SoA
        (update_follower_index consensus.cc:274) and advance commit.
        Cell bookkeeping (seq guard + match/flushed lanes) stays
        inline — the catch-up fiber's progress detection reads these
        synchronously — but the quorum/commit MATH defers to the shard
        tick frame when one is wired: O(1) enqueue here, one
        vectorized frame per window there. Direct fixtures (no frame)
        run the scalar oracle per reply, as before."""
        row = self.row
        slot = self._slot_map.get(peer)
        if slot is None:
            return
        if seq <= int(self.arrays.last_seq[row, slot]):
            return  # reordered reply
        self.arrays.last_seq[row, slot] = seq
        self.arrays.match_index[row, slot] = max(
            int(self.arrays.match_index[row, slot]), dirty
        )
        self.arrays.touch()
        self.arrays.flushed_index[row, slot] = max(
            int(self.arrays.flushed_index[row, slot]), flushed
        )
        frame = self._tick_frame
        if frame is not None:
            frame.enqueue_reply(row, slot, dirty, flushed, seq)
        elif self.arrays.scalar_commit_update(row):
            self._notify_commit()

    def on_batched_commit_advance(self) -> None:
        """Called by the heartbeat manager after the device sweep
        advanced this group's commit index."""
        self._notify_commit()

    # ------------------------------------------------------- snapshots
    def _config_at(self, offset: int) -> GroupConfiguration:
        cfg = self._initial_config
        for off, c in self._config_history:
            if off <= offset:
                cfg = c
            else:
                break
        return cfg

    def write_snapshot(self, last_included: Optional[int] = None) -> int:
        """Take a local snapshot at-or-below commit_index and prefix-
        truncate the log past it (consensus.cc write_snapshot). Returns
        the resulting snapshot index. Contributors capture their state;
        for log-derived state captured slightly ahead of the snapshot
        point (producer table tracks appends), re-replay above the
        boundary is idempotent — see partition.py."""
        target = self.commit_index
        if last_included is not None:
            target = min(target, last_included)
        if target <= self._snap_index or target < 0:
            return self._snap_index
        term = self.term_at(target)
        if term is None or term < 0:
            return self._snap_index
        names, blobs = [], []
        for name, obj in self.snapshot_contributors.items():
            names.append(name)
            blobs.append(obj.capture_snapshot(target))
        meta = RaftSnapshotMetadata(
            group=self.group_id,
            last_included_index=target,
            last_included_term=term,
            config=self._config_at(target).encode(),
        )
        snapfmt.write_snapshot(
            self._snapshot_path,
            meta.encode(),
            SnapshotPayload(names=names, blobs=blobs).encode(),
        )
        self._snap_index, self._snap_term = target, term
        self._install_blobs = {}
        # roll first so the entire summarized history becomes whole
        # segments below the cut — physically reclaimable now, not at
        # the next incidental roll
        self.log.force_roll()
        self.log.prefix_truncate(target + 1)
        logger.info(
            "g%d: snapshot at %d term %d (log start now %d)",
            self.group_id, target, term, self.log.offsets().start_offset,
        )
        return target

    async def _send_snapshot(self, peer: int) -> bool:
        """Stream the snapshot file to a stranded follower in chunks
        (recovery_stm.cc install_snapshot loop). On success the
        follower resumes appends at last_included + 1."""
        try:
            # cold path: one read per stranded follower, snapshots are
            # small in this model (state-machine images, not segments)
            with open(self._snapshot_path, "rb") as f:  # rplint: disable=RPL004
                data = f.read()
        except OSError:
            return False
        snap_idx = self._snap_index
        term = self.term
        chunk_size = 1 << 17
        sent = 0
        logger.info(
            "g%d: sending snapshot (%d bytes, upto %d) to follower %d",
            self.group_id, len(data), snap_idx, peer,
        )
        # bounded retry budget for the whole stream: a dropped chunk
        # rpc no longer abandons the transfer (the old behavior forced
        # a full stream restart on the next catch-up kick)
        chain = self._retry_root.child(deadline_s=30.0)
        while True:
            chunk = data[sent : sent + chunk_size]
            done = sent + len(chunk) >= len(data)
            req = rt.InstallSnapshotRequest(
                group=self.group_id,
                node_id=self.node_id,
                term=term,
                last_included_index=snap_idx,
                last_included_term=self._snap_term,
                file_offset=sent,
                chunk=chunk,
                done=done,
            ).encode()
            try:
                raw = await self._send(peer, rt.INSTALL_SNAPSHOT, req, 10.0)
                rep = rt.InstallSnapshotReply.decode(raw)
            except Exception:
                try:
                    if await chain.backoff():
                        continue  # re-send the same chunk offset
                except RetryChainAborted:
                    pass
                return False
            if self._closed or self.role != Role.LEADER or self.term != term:
                return False
            if rep.term > term:
                self._step_down(int(rep.term))
                return False
            if not rep.success:
                return False
            sent += len(chunk)
            if done:
                break
        self._next_index[peer] = snap_idx + 1
        return True

    async def handle_install_snapshot(
        self, req: rt.InstallSnapshotRequest
    ) -> rt.InstallSnapshotReply:
        async with self._append_lock:
            return await self._do_install_snapshot(req)

    async def _do_install_snapshot(
        self, req: rt.InstallSnapshotRequest
    ) -> rt.InstallSnapshotReply:
        def reply(ok: bool) -> rt.InstallSnapshotReply:
            return rt.InstallSnapshotReply(
                group=self.group_id,
                term=self.term,
                bytes_stored=self._accum_size,
                success=ok,
            )

        if req.term < self.term:
            return reply(False)
        self._last_heartbeat = asyncio.get_event_loop().time()
        if req.term > self.term or self.role != Role.FOLLOWER:
            self._step_down(int(req.term))
        self.leader_id = int(req.node_id)
        accum = self._snapshot_path + ".accum"
        file_offset = int(req.file_offset)
        if file_offset == 0:
            self._accum_size = 0
            mode = "wb"
        else:
            if not os.path.exists(accum) or self._accum_size != file_offset:
                return reply(False)  # out of order: leader restarts stream
            mode = "ab"
        # cold path: install_snapshot chunk accumulation, bounded chunks
        with open(accum, mode) as f:  # rplint: disable=RPL004
            f.write(req.chunk)
        self._accum_size = file_offset + len(req.chunk)
        if not req.done:
            return reply(True)
        try:
            meta_raw, payload = snapfmt.read_snapshot(accum)
            meta = RaftSnapshotMetadata.decode(meta_raw)
        except (snapfmt.SnapshotCorruption, serde.SerdeError):
            logger.exception("g%d: corrupt incoming snapshot", self.group_id)
            os.remove(accum)
            return reply(False)
        if int(meta.last_included_index) <= max(self.commit_index, self._snap_index):
            os.remove(accum)  # stale: we already have everything it covers
            return reply(True)
        os.replace(accum, self._snapshot_path)
        self._install_snapshot_state(meta, payload)
        return reply(True)

    def _install_snapshot_state(
        self, meta: RaftSnapshotMetadata, payload: bytes
    ) -> None:
        row = self.row
        snap_idx = int(meta.last_included_index)
        snap_term = int(meta.last_included_term)
        logger.info(
            "g%d: installing snapshot upto %d term %d", self.group_id,
            snap_idx, snap_term,
        )
        self.log.install_snapshot_reset(snap_idx + 1, snap_term)
        self._snap_index, self._snap_term = snap_idx, snap_term
        self._sync_term_bounds()
        cfg = GroupConfiguration.decode(meta.config)
        self._config_history = []
        self._initial_config = cfg
        self.config = cfg
        self._rebuild_slots()
        self._persist_config()
        self.arrays.match_index[row, SELF_SLOT] = snap_idx
        self.arrays.flushed_index[row, SELF_SLOT] = snap_idx
        self.arrays.commit_index[row] = snap_idx
        self.arrays.touch()
        self.arrays.last_visible[row] = max(
            int(self.arrays.last_visible[row]), snap_idx
        )
        sp = SnapshotPayload.decode(payload)
        self._install_blobs = dict(zip(sp.names, sp.blobs))
        for name, obj in self.snapshot_contributors.items():
            blob = self._install_blobs.get(name)
            if blob is not None:
                obj.restore_snapshot(blob, snap_idx)
        self._notify_commit()

    # ------------------------------------------------------ membership
    async def transfer_leadership(self, target: int, timeout: float = 5.0) -> None:
        """reference: consensus.cc do_transfer_leadership → timeout_now."""
        if self.role != Role.LEADER:
            raise NotLeaderError(self.leader_id)
        if target not in self._slot_map:
            raise ValueError(f"node {target} not in configuration")
        # bring the target fully up to date first. _catch_up returns
        # immediately when another fiber already drives this follower,
        # so poll until the target's match actually reaches our dirty
        # offset instead of trusting one call.
        deadline = asyncio.get_event_loop().time() + timeout
        while self._follower_needs_data(target):
            if self.role != Role.LEADER:
                raise NotLeaderError(self.leader_id)
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(
                    f"g{self.group_id}: transfer target {target} not caught up"
                )
            await self._catch_up(target)
            if self._follower_needs_data(target):
                await asyncio.sleep(0.01)
        req = rt.TimeoutNowRequest(
            group=self.group_id, node_id=self.node_id, term=self.term
        ).encode()
        await self._send(target, rt.TIMEOUT_NOW, req, timeout)

    async def handle_timeout_now(self, req: rt.TimeoutNowRequest) -> rt.TimeoutNowReply:
        if req.term >= self.term:
            self._spawn(self.dispatch_vote(leadership_transfer=True))
        return rt.TimeoutNowReply(group=self.group_id, term=self.term)

    async def change_configuration(self, new_voters: list[int], timeout: float = 10.0) -> None:
        """Joint-consensus reconfiguration (group_configuration.cc):
        replicate joint config, commit, then replicate final config."""
        if self.role != Role.LEADER:
            raise NotLeaderError(self.leader_id)
        joint = self.config.enter_joint(new_voters, self.config.revision + 1)
        await self._replicate_config(joint, timeout)
        final = joint.leave_joint(joint.revision + 1)
        await self._replicate_config(final, timeout)

    async def _replicate_config(self, cfg: GroupConfiguration, timeout: float) -> None:
        self.config = cfg
        self._rebuild_slots()
        builder = RecordBatchBuilder(batch_type=RecordBatchType.raft_configuration)
        builder.add(value=cfg.encode(), key=b"raft_configuration")
        await self.replicate(builder, acks=-1, timeout=timeout)

    def apply_configuration_batch(self, batch: RecordBatch) -> None:
        """Commit-time config application hook (configuration_manager
        analog). Configs take effect at APPEND time via _observe_append;
        re-applying an older batch here would regress the active voter
        set when a newer config was already appended, so this is a
        no-op for any batch at-or-below the latest appended config."""
        if (
            self._config_history
            and batch.header.base_offset <= self._config_history[-1][0]
        ):
            return
        for rec in batch.records():
            if rec.value is not None:
                cfg = GroupConfiguration.decode(rec.value)
                self._config_history.append((batch.header.base_offset, cfg))
                self.config = cfg
                self._rebuild_slots()
                self._persist_config()


# RP_SAN=1: version-track the raft attrs whose rebinds span awaits
# (election/vote, snapshot install, shutdown) — no-op otherwise
from ..utils import rpsan as _rpsan  # noqa: E402

_rpsan.instrument(
    Consensus,
    ("_role", "_voted_for", "_snap_index", "_snap_term", "_accum_size",
     "_closed", "_frozen"),
    # _step_down's resets never derive from an earlier read: they are
    # guarded by `term > self.term`, checked loop-atomically (sync)
    # with the write, so clobbering a vote from a STRICTLY older term
    # is exactly raft's per-term vote reset, not a torn write
    reset_writers={"_voted_for": ("_step_down",), "_role": ("_step_down",)},
)
