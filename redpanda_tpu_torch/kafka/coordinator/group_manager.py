"""Group coordinator: groups + offsets on `__consumer_offsets` partitions.

Reference: src/v/kafka/server/group_manager.{h,cc} (group_manager.h:118),
group_metadata.{h,cc}, group_recovery_consumer.* and
coordinator_ntp_mapper.h — groups are sharded over the partitions of
the internal `__consumer_offsets` topic by group-id hash; the leader
of a coordinator partition serves all its groups; every state
transition and offset commit is a replicated record batch on that
partition, so coordinator failover replays the log to rebuild state.
"""

from __future__ import annotations

import asyncio
import logging
import zlib
from typing import TYPE_CHECKING, Optional

from ...models.fundamental import DEFAULT_NS, NTP
from ...models.record import RecordBatch, RecordBatchBuilder, RecordBatchType
from ...raft.consensus import NotLeaderError, ReplicateTimeout
from ...utils import serde
from ...utils.locks import LockMap
from ..protocol import ErrorCode
from .group import Group, GroupState

if TYPE_CHECKING:  # pragma: no cover
    from ...app import Broker

logger = logging.getLogger("kafka.coordinator")

OFFSETS_TOPIC = "__consumer_offsets"
DEFAULT_OFFSETS_PARTITIONS = 4

_KIND_GROUP_META = 0
_KIND_OFFSET = 1
_KIND_TX_OFFSET = 2  # staged, invisible until the tx commits
_KIND_TX_MARKER = 3  # commit/abort decision for a pid's staged offsets


class CoordinatorLoading(Exception):
    """Raised while the new leader's linearizable barrier / log replay
    is still in flight — served as coordinator_load_in_progress, which
    clients retry against the same node."""

    def __init__(self, pid: int):
        super().__init__(f"coordinator partition {pid} loading")
        self.pid = pid


class _Key(serde.Envelope):
    SERDE_FIELDS = [
        ("kind", serde.u8),
        ("group", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
    ]


class _MemberMeta(serde.Envelope):
    SERDE_FIELDS = [
        ("member_id", serde.string),
        ("client_id", serde.string),
        ("client_host", serde.string),
        ("session_timeout_ms", serde.i32),
        ("rebalance_timeout_ms", serde.i32),
        ("protocol_names", serde.vector(serde.string)),
        ("protocol_metas", serde.vector(serde.bytes_t)),
        ("assignment", serde.bytes_t),
        # v2: KIP-345 static membership (appended; old records default)
        ("group_instance_id", serde.optional(serde.string)),
    ]
    SERDE_VERSION = 2
    SERDE_DEFAULTS = {"group_instance_id": None}


class _GroupMetaValue(serde.Envelope):
    SERDE_VERSION = 2
    SERDE_FIELDS = [
        ("generation", serde.i32),
        ("protocol_type", serde.string),
        ("protocol", serde.string),
        ("leader", serde.string),
        ("state", serde.string),
        ("members", serde.vector(_MemberMeta.serde())),
        # v2 (KIP-211): when the group went EMPTY (0 = live/unknown);
        # the offset-retention clock must survive coordinator restarts
        ("empty_since_ms", serde.i64),
    ]
    SERDE_DEFAULTS = {"empty_since_ms": 0}


class _OffsetValue(serde.Envelope):
    SERDE_FIELDS = [
        ("offset", serde.i64),
        ("metadata", serde.optional(serde.string)),
        ("commit_ts_ms", serde.i64),
    ]


class _TxOffsetValue(serde.Envelope):
    SERDE_FIELDS = [
        ("pid", serde.i64),
        ("epoch", serde.i16),
        ("offset", serde.i64),
        ("metadata", serde.optional(serde.string)),
        ("commit_ts_ms", serde.i64),
    ]


class _TxMarkerValue(serde.Envelope):
    SERDE_FIELDS = [
        ("pid", serde.i64),
        ("epoch", serde.i16),
        ("commit", serde.u8),
    ]


def _stage_tx_offset(
    g: Group, pid: int, epoch: int, tp: tuple[str, int], entry: tuple
) -> None:
    """Idempotent staging shared by the live path and log replay: a
    newer epoch supersedes stale staging, an older one is ignored."""
    cur = g.pending_tx.get(pid)
    if cur is None or cur[0] < epoch:
        g.pending_tx[pid] = (epoch, {tp: entry})
    elif cur[0] == epoch:
        cur[1][tp] = entry
    # cur[0] > epoch: fenced zombie staging — drop


def _apply_tx_marker(g: Group, pid: int, epoch: int, commit: bool) -> None:
    """Tx decision shared by the live path and log replay: staged
    offsets materialize only at the SAME epoch; staging from older
    epochs is discarded (fenced), newer staging survives."""
    if epoch > g.tx_fences.get(pid, -1):
        g.tx_fences[pid] = epoch
    cur = g.pending_tx.get(pid)
    if cur is None or cur[0] > epoch:
        return
    del g.pending_tx[pid]
    if commit and cur[0] == epoch:
        g.offsets.update(cur[1])


class GroupCoordinator:
    def __init__(
        self,
        broker: "Broker",
        n_partitions: int = DEFAULT_OFFSETS_PARTITIONS,
        initial_rebalance_delay_s: float = 0.05,
    ):
        self.broker = broker
        self.n_partitions = n_partitions
        self._initial_delay = initial_rebalance_delay_s
        # per coordinator-partition group stores
        self._groups: dict[int, dict[str, Group]] = {}
        # pid → raft term at replay time: leadership can bounce away
        # and back with commits happening elsewhere in between, so a
        # replay is valid only for the term it was taken in
        self._replayed: dict[int, int] = {}
        # one replay at a time per partition: concurrent replays would
        # interleave across the `await g.close()` suspension and the
        # loser's shard assignment would discard groups created by
        # requests running between the two assignments
        self._replay_locks = LockMap()
        self._create_lock = asyncio.Lock()
        self._expire_task: Optional[asyncio.Task] = None
        self._closed = False

    async def start(self) -> None:
        self._expire_task = asyncio.ensure_future(self._expire_loop())

    async def stop(self) -> None:
        self._closed = True
        if self._expire_task is not None:
            self._expire_task.cancel()
            try:
                await self._expire_task
            except asyncio.CancelledError:
                pass
        for shard in self._groups.values():
            for g in shard.values():
                await g.close()
        self._replay_locks.prune()

    # -- mapping (coordinator_ntp_mapper.h) --------------------------
    def partition_for(self, group_id: str) -> int:
        return zlib.crc32(group_id.encode()) % self.n_partitions

    def ntp_for(self, group_id: str) -> NTP:
        return NTP(DEFAULT_NS, OFFSETS_TOPIC, self.partition_for(group_id))

    async def ensure_offsets_topic(self) -> None:
        table = self.broker.controller.topic_table
        from ...models.fundamental import TopicNamespace

        if table.contains(TopicNamespace(DEFAULT_NS, OFFSETS_TOPIC)):
            return
        async with self._create_lock:
            if table.contains(TopicNamespace(DEFAULT_NS, OFFSETS_TOPIC)):
                return
            from ...cluster.controller import TopicError

            rf = min(3, len(self.broker.controller.members))
            rf = rf if rf % 2 == 1 else rf - 1
            try:
                await self.broker.controller.create_topic(
                    OFFSETS_TOPIC,
                    partitions=self.n_partitions,
                    replication_factor=max(rf, 1),
                    # latest group/offset state per key is all that
                    # matters: compact, never time/size-expire
                    config={"cleanup.policy": "compact"},
                )
            except TopicError as e:
                if e.code != "topic_already_exists":
                    raise

    # -- coordinator resolution --------------------------------------
    async def find_coordinator(
        self, group_id: str
    ) -> tuple[int, str, int] | None:
        """(node_id, host, port) of the group's coordinator, or None
        while leadership is unsettled."""
        await self.ensure_offsets_topic()
        ntp = self.ntp_for(group_id)
        leader = self.broker.metadata_cache.leader_of(ntp)
        if leader is None:
            return None
        addr = self.broker.kafka_address_of(leader)
        if addr is None:
            return None
        return leader, addr[0], addr[1]

    def _local_partition(self, group_id: str):
        p = self.broker.partition_manager.get(self.ntp_for(group_id))
        if p is None or not p.is_leader:
            return None
        return p

    def _shard(self, pid: int) -> dict[str, Group]:
        return self._groups.setdefault(pid, {})

    async def _ensure_replayed(self, group_id: str) -> Optional[int]:
        """Replay the coordinator partition's log if this broker just
        became its leader (group_recovery_consumer analog). Returns the
        partition id, or None if not coordinator here. Raises
        CoordinatorLoading while the leadership barrier / replay is
        still settling (served as coordinator_load_in_progress).

        Correctness requires a linearizable barrier first: a brand-new
        leader's commit_index lags the true committed offset until an
        entry of its OWN term commits (the term_start gate), so a
        replay taken before that can miss offsets committed under the
        prior leader — and a later checkpoint would persist that stale
        state. The reference loops a noop injection until recovery
        covers dirty_offset (group_manager.cc:548); here the own-term
        configuration batch appended at election IS the noop, so the
        barrier is commit_index >= term_start."""
        p = self._local_partition(group_id)
        pid = self.partition_for(group_id)
        if p is None:
            self._replayed.pop(pid, None)
            return None
        term = p.consensus.term
        if self._replayed.get(pid) == term:
            return pid
        lock = self._replay_locks.lock(pid)
        async with lock:
            # re-check under the lock: a concurrent request may have
            # completed the replay, or leadership may have moved
            p = self._local_partition(group_id)
            if p is None:
                self._replayed.pop(pid, None)
                return None
            c = p.consensus
            term = c.term
            if self._replayed.get(pid) == term:
                return pid
            barrier = c.term_start
            if c.commit_index < barrier:
                try:
                    await c.wait_committed(barrier, timeout=2.0)
                except Exception:
                    raise CoordinatorLoading(pid)
                if not c.is_leader() or c.term != term:
                    raise CoordinatorLoading(pid)
            shard: dict[str, Group] = {}
            offs = p.log.offsets()
            pos = max(offs.start_offset, 0)
            while pos <= c.commit_index:
                batches = p.log.read(pos, upto=c.commit_index)
                if not batches:
                    break
                for b in batches:
                    pos = b.header.last_offset + 1
                    if b.header.type != RecordBatchType.raft_data:
                        continue
                    self._replay_batch(shard, b)
            # drop superseded in-memory groups: their waiters are
            # parked on events of a stale generation; closing cancels
            # their timers
            for g in self._groups.get(pid, {}).values():
                await g.close()
            self._groups[pid] = shard
            self._replayed[pid] = term
            logger.info(
                "node %d: coordinator partition %d replayed: %d groups "
                "(term %d, barrier %d)",
                self.broker.node_id,
                pid,
                len(shard),
                term,
                barrier,
            )
            return pid

    def _replay_batch(self, shard: dict[str, Group], batch: RecordBatch) -> None:
        import time as _time

        for rec in batch.records():
            if rec.key is None:
                continue
            key = _Key.decode(rec.key)
            g = shard.get(key.group)
            if key.kind == _KIND_GROUP_META:
                if rec.value is None:  # tombstone
                    shard.pop(key.group, None)
                    continue
                val = _GroupMetaValue.decode(rec.value)
                if g is None:
                    g = Group(key.group, self._initial_delay)
                    shard[key.group] = g
                g.generation = int(val.generation)
                g.protocol_type = val.protocol_type
                g.protocol = val.protocol
                g.leader = val.leader or None
                g.state = GroupState(val.state)
                g.empty_since = (
                    val.empty_since_ms / 1000.0
                    if int(val.empty_since_ms) > 0
                    else None
                )
                from .group import Member

                g.members = {
                    m.member_id: Member(
                        member_id=m.member_id,
                        client_id=m.client_id,
                        client_host=m.client_host,
                        session_timeout_ms=int(m.session_timeout_ms),
                        rebalance_timeout_ms=int(m.rebalance_timeout_ms),
                        protocols=list(
                            zip(m.protocol_names, m.protocol_metas)
                        ),
                        assignment=m.assignment,
                        joined=True,
                        group_instance_id=m.group_instance_id,
                    )
                    for m in val.members
                }
            elif key.kind == _KIND_OFFSET:
                if g is None:
                    g = Group(key.group, self._initial_delay)
                    shard[key.group] = g
                if rec.value is None:  # tombstone
                    g.offsets.pop((key.topic, key.partition), None)
                else:
                    val = _OffsetValue.decode(rec.value)
                    g.offsets[(key.topic, key.partition)] = (
                        int(val.offset),
                        val.metadata,
                        int(val.commit_ts_ms),
                    )
            elif key.kind == _KIND_TX_OFFSET:
                if g is None:
                    g = Group(key.group, self._initial_delay)
                    shard[key.group] = g
                val = _TxOffsetValue.decode(rec.value)
                _stage_tx_offset(
                    g,
                    int(val.pid),
                    int(val.epoch),
                    (key.topic, key.partition),
                    (int(val.offset), val.metadata, int(val.commit_ts_ms)),
                )
            elif key.kind == _KIND_TX_MARKER:
                if g is None:
                    continue
                val = _TxMarkerValue.decode(rec.value)
                _apply_tx_marker(
                    g, int(val.pid), int(val.epoch), bool(val.commit)
                )

    async def get_group(
        self, group_id: str, create: bool = False
    ) -> tuple[Optional[Group], int]:
        """(group, error). error NOT_COORDINATOR when this broker does
        not lead the group's coordinator partition,
        COORDINATOR_LOAD_IN_PROGRESS while the replay barrier settles."""
        try:
            pid = await self._ensure_replayed(group_id)
        except CoordinatorLoading:
            return None, int(ErrorCode.coordinator_load_in_progress)
        if pid is None:
            return None, int(ErrorCode.not_coordinator)
        shard = self._shard(pid)
        g = shard.get(group_id)
        if g is None:
            if not create:
                return None, int(ErrorCode.group_id_not_found)
            g = Group(group_id, self._initial_delay)
            shard[group_id] = g
        return g, 0

    # -- persistence -------------------------------------------------
    async def checkpoint_group(self, g: Group) -> int:
        """Replicate the group's metadata (returns kafka error code)."""
        p = self._local_partition(g.group_id)
        if p is None:
            return int(ErrorCode.not_coordinator)
        val = _GroupMetaValue(
            generation=g.generation,
            protocol_type=g.protocol_type,
            protocol=g.protocol,
            leader=g.leader or "",
            state=g.state.value,
            empty_since_ms=int((g.empty_since or 0) * 1000),
            members=[
                _MemberMeta(
                    member_id=m.member_id,
                    client_id=m.client_id,
                    client_host=m.client_host,
                    session_timeout_ms=m.session_timeout_ms,
                    rebalance_timeout_ms=m.rebalance_timeout_ms,
                    protocol_names=[n for n, _ in m.protocols],
                    protocol_metas=[md for _, md in m.protocols],
                    assignment=m.assignment,
                    group_instance_id=m.group_instance_id,
                )
                for m in g.members.values()
            ],
        )
        b = RecordBatchBuilder()
        b.add(
            value=val.encode(),
            key=_Key(
                kind=_KIND_GROUP_META, group=g.group_id, topic="", partition=-1
            ).encode(),
        )
        try:
            await p.replicate(b.build(), acks=-1)
            g.dirty = False
            return 0
        except NotLeaderError:
            return int(ErrorCode.not_coordinator)
        except ReplicateTimeout:
            return int(ErrorCode.request_timed_out)

    async def commit_offsets(
        self,
        g: Group,
        items: list[tuple[str, int, int, str | None]],  # topic, part, off, md
    ) -> int:
        import time as _time

        p = self._local_partition(g.group_id)
        if p is None:
            return int(ErrorCode.not_coordinator)
        now = int(_time.time() * 1000)
        b = RecordBatchBuilder()
        for topic, part, off, md in items:
            b.add(
                value=_OffsetValue(
                    offset=off, metadata=md, commit_ts_ms=now
                ).encode(),
                key=_Key(
                    kind=_KIND_OFFSET, group=g.group_id, topic=topic, partition=part
                ).encode(),
            )
        async with g.offsets_lock:
            try:
                await p.replicate(b.build(), acks=-1)
            except NotLeaderError:
                return int(ErrorCode.not_coordinator)
            except ReplicateTimeout:
                return int(ErrorCode.request_timed_out)
            for topic, part, off, md in items:
                g.offsets[(topic, part)] = (off, md, now)
        return 0

    async def delete_offsets(
        self, g: Group, items: list[tuple[str, int]]
    ) -> dict[tuple[str, int], int]:
        """OffsetDelete: tombstone committed offsets (group_manager.cc
        offset deletion — the same keyed records with null values, so
        compaction reclaims them). Per-partition error codes returned."""
        p = self._local_partition(g.group_id)
        out: dict[tuple[str, int], int] = {}
        if p is None:
            return {tp: int(ErrorCode.not_coordinator) for tp in items}
        if g.members:
            # a live group's committed positions must not vanish under
            # it (offset_delete.cc GROUP_SUBSCRIBED_TO_TOPIC). Client
            # subscription metadata is opaque to the broker, so a
            # non-empty group conservatively protects every topic.
            return {
                tp: int(ErrorCode.group_subscribed_to_topic) for tp in items
            }
        async with g.offsets_lock:
            to_delete = []
            snapshot: dict[tuple[str, int], tuple] = {}
            for tp in items:
                if tp in g.offsets:
                    to_delete.append(tp)
                    snapshot[tp] = g.offsets[tp]
                    out[tp] = 0
                else:
                    out[tp] = 0  # deleting a non-existent offset: no-op
            if to_delete:
                b = RecordBatchBuilder()
                for topic, part in to_delete:
                    b.add(
                        value=None,
                        key=_Key(
                            kind=_KIND_OFFSET,
                            group=g.group_id,
                            topic=topic,
                            partition=part,
                        ).encode(),
                    )
                try:
                    await p.replicate(b.build(), acks=-1)
                except NotLeaderError:
                    return {tp: int(ErrorCode.not_coordinator) for tp in items}
                except ReplicateTimeout:
                    return {tp: int(ErrorCode.request_timed_out) for tp in items}
                survivors = []
                for tp in to_delete:
                    cur = g.offsets.get(tp)
                    if cur == snapshot[tp]:
                        g.offsets.pop(tp, None)
                    elif cur is not None:
                        # a tx-marker materialization landed during the
                        # replicate await: the tombstone now sits AFTER
                        # that commit in the log, so re-replicate the
                        # surviving value to keep replay == memory
                        survivors.append((tp, cur))
                if survivors:
                    rb = RecordBatchBuilder()
                    for (topic, part), (off, md, ts) in survivors:
                        rb.add(
                            value=_OffsetValue(
                                offset=off, metadata=md, commit_ts_ms=ts
                            ).encode(),
                            key=_Key(
                                kind=_KIND_OFFSET,
                                group=g.group_id,
                                topic=topic,
                                partition=part,
                            ).encode(),
                        )
                    # retry until the log provably converges: a timed-out
                    # replicate may still commit later, so only two
                    # outcomes settle the replay-vs-memory question —
                    # success (restore record is last; duplicates from
                    # earlier timed-out appends are idempotent) or loss
                    # of leadership (our memory stops mattering; the next
                    # coordinator rebuilds from the log).
                    for restore_try in range(3):
                        try:
                            await p.replicate(rb.build(), acks=-1)
                            break
                        except NotLeaderError:
                            break
                        except ReplicateTimeout:
                            if restore_try == 2:
                                # outcome unknown; keep memory (the
                                # quorum usually catches up and commits
                                # the appends) and flag the hazard
                                logger.error(
                                    "group %s: restore of %d offsets "
                                    "surviving a concurrent delete timed "
                                    "out repeatedly; replayed state may "
                                    "lag live state until the appends "
                                    "commit",
                                    g.group_id,
                                    len(survivors),
                                )
        return out

    async def txn_commit_offsets(
        self,
        g: Group,
        pid: int,
        epoch: int,
        items: list[tuple[str, int, int, str | None]],  # topic, part, off, md
    ) -> int:
        """Stage transactional offsets (group.cc store_txn_offsets):
        replicated so failover keeps them, but invisible to OffsetFetch
        until the tx coordinator delivers a commit marker at the same
        producer epoch. Zombie epochs are fenced."""
        import time as _time

        p = self._local_partition(g.group_id)
        if p is None:
            return int(ErrorCode.not_coordinator)
        if epoch < g.tx_fences.get(pid, -1):
            return int(ErrorCode.invalid_producer_epoch)
        cur = g.pending_tx.get(pid)
        if cur is not None and cur[0] > epoch:
            return int(ErrorCode.invalid_producer_epoch)
        now = int(_time.time() * 1000)
        b = RecordBatchBuilder()
        for topic, part, off, md in items:
            b.add(
                value=_TxOffsetValue(
                    pid=pid, epoch=epoch, offset=off, metadata=md, commit_ts_ms=now
                ).encode(),
                key=_Key(
                    kind=_KIND_TX_OFFSET,
                    group=g.group_id,
                    topic=topic,
                    partition=part,
                ).encode(),
            )
        try:
            await p.replicate(b.build(), acks=-1)
        except NotLeaderError:
            return int(ErrorCode.not_coordinator)
        except ReplicateTimeout:
            return int(ErrorCode.request_timed_out)
        for topic, part, off, md in items:
            _stage_tx_offset(g, pid, epoch, (topic, part), (off, md, now))
        return 0

    async def complete_tx(
        self, group_id: str, pid: int, epoch: int, commit: bool
    ) -> int:
        """Apply the tx coordinator's decision to staged offsets
        (group.cc commit_tx/abort_tx via the tx gateway). The marker is
        persisted whenever it advances the fence, so replay after
        failover rejects zombie staging the same way the live path
        does."""
        g, err = await self.get_group(group_id)
        if err == int(ErrorCode.group_id_not_found):
            return 0  # nothing staged anywhere: trivially complete
        if err:
            return err
        cur = g.pending_tx.get(pid)
        has_effect = cur is not None and cur[0] <= epoch
        if not has_effect and g.tx_fences.get(pid, -1) >= epoch:
            return 0  # duplicate marker delivery
        p = self._local_partition(group_id)
        if p is None:
            return int(ErrorCode.not_coordinator)
        b = RecordBatchBuilder()
        b.add(
            value=_TxMarkerValue(
                pid=pid, epoch=epoch, commit=1 if commit else 0
            ).encode(),
            key=_Key(
                kind=_KIND_TX_MARKER, group=group_id, topic="", partition=-1
            ).encode(),
        )
        try:
            await p.replicate(b.build(), acks=-1)
        except NotLeaderError:
            return int(ErrorCode.not_coordinator)
        except ReplicateTimeout:
            return int(ErrorCode.request_timed_out)
        _apply_tx_marker(g, pid, epoch, commit)
        return 0

    async def delete_group(self, group_id: str) -> int:
        g, err = await self.get_group(group_id)
        if err:
            return err
        if g.members and g.state not in (GroupState.EMPTY, GroupState.DEAD):
            return int(ErrorCode.non_empty_group)
        p = self._local_partition(group_id)
        if p is None:
            return int(ErrorCode.not_coordinator)
        b = RecordBatchBuilder()
        for topic, part in list(g.offsets):
            b.add(
                value=None,
                key=_Key(
                    kind=_KIND_OFFSET, group=group_id, topic=topic, partition=part
                ).encode(),
            )
        b.add(
            value=None,
            key=_Key(
                kind=_KIND_GROUP_META, group=group_id, topic="", partition=-1
            ).encode(),
        )
        try:
            await p.replicate(b.build(), acks=-1)
        except (NotLeaderError, ReplicateTimeout):
            return int(ErrorCode.not_coordinator)
        self._shard(self.partition_for(group_id)).pop(group_id, None)
        await g.close()
        return 0

    # -- listing -----------------------------------------------------
    def local_groups(self) -> list[Group]:
        out = []
        for pid, shard in self._groups.items():
            ntp = NTP(DEFAULT_NS, OFFSETS_TOPIC, pid)
            p = self.broker.partition_manager.get(ntp)
            if p is not None and p.is_leader:
                out.extend(shard.values())
        return out

    # -- session expiration ------------------------------------------
    async def _expire_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(0.5)
            try:
                for g in self.local_groups():
                    expired = g.expire_members()
                    if expired:
                        logger.info(
                            "group %s: expired members %s", g.group_id, expired
                        )
                        await self.checkpoint_group(g)
                    await self._expire_offsets(g)
            except Exception:
                logger.exception("group expiration sweep failed")

    async def _expire_offsets(self, g: Group) -> None:
        """KIP-211 offset retention: committed offsets of an EMPTY
        group expire `group_offset_retention_ms` after the group went
        empty (never while members exist — an active group's positions
        are permanent). Expiry writes the same tombstones OffsetDelete
        does, so replay and compaction agree."""
        import time as time_mod

        now = time_mod.time()
        if g.members:
            g.empty_since = None
            return
        if g.empty_since is None:
            g.empty_since = now
            return
        if not g.offsets:
            return
        retention_ms = self.broker.controller.cluster_config.get(
            "group_offset_retention_ms"
        )
        if retention_ms <= 0:  # 0/negative disables expiry
            return
        boundary_ms = (now - g.empty_since) * 1000.0
        if boundary_ms < retention_ms:
            return
        expired = [
            tp
            for tp, (_off, _md, ts) in g.offsets.items()
            if now * 1000.0 - ts >= retention_ms
        ]
        if not expired:
            return
        logger.info(
            "group %s: expiring %d offsets after %.0f ms empty",
            g.group_id,
            len(expired),
            boundary_ms,
        )
        await self.delete_offsets(g, expired)
        if not g.offsets and not g.members:
            # nothing left: tombstone the group itself so neither the
            # in-memory shard nor the compacted log accumulates dead
            # group ids (Kafka transitions such groups to DEAD)
            await self.delete_group(g.group_id)
