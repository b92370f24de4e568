"""Transaction coordinator (tm_stm) + tx gateway.

Reference: src/v/cluster/tm_stm.{h,cc}, tx_gateway_frontend.{h,cc},
tx_gateway.cc and kafka_internal/tx — transactional ids are sharded
over the partitions of an internal `kafka_internal/tx` topic by id
hash; the raft leader of a tx partition coordinates all its
transactions. Every state transition is a replicated record on that
partition, so coordinator failover replays the log (with the same
linearizable leadership barrier the group coordinator uses) and
resumes any transaction caught mid-completion.

Commit/abort flow (tx_gateway_frontend.cc do_end_txn):
1. validate producer identity, move to PREPARING_COMMIT/ABORT
   (replicated — the decision is durable before any marker exists);
2. deliver control markers to every touched data partition (local
   call or WRITE_TX_MARKER RPC to the partition leader — the
   WriteTxnMarkers analog) and every touched consumer group
   (GROUP_TX_MARKER → staged offsets materialize or drop);
3. move back to EMPTY with partitions/groups cleared (replicated).
A coordinator crash between 1 and 3 is healed at the next replay:
preparing transactions re-deliver their markers (idempotent on the
receiving rm_stm) and then complete.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
import zlib
from typing import TYPE_CHECKING, Optional

from ..models.fundamental import KAFKA_INTERNAL_NS, NTP, TopicNamespace
from ..models.record import RecordBatch, RecordBatchBuilder, RecordBatchType
from ..raft.consensus import NotLeaderError, ReplicateTimeout
from ..rpc.server import Service, method
from ..utils import serde
from ..utils.locks import LockMap
from ..kafka.protocol import ErrorCode

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker

logger = logging.getLogger("cluster.tx")

TX_TOPIC = "tx"
TX_NS = KAFKA_INTERNAL_NS
DEFAULT_TX_PARTITIONS = 4

# rpc method ids (raft: 100s, controller: 200-202, dissemination: 210)
WRITE_TX_MARKER = 220
GROUP_TX_MARKER = 221

# tx statuses (tm_stm.h tx_status)
TX_EMPTY = 0
TX_ONGOING = 1
TX_PREPARING_COMMIT = 2
TX_PREPARING_ABORT = 3

_E = ErrorCode


class _TxPartitionE(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
    ]


class _TxMetaValue(serde.Envelope):
    SERDE_FIELDS = [
        ("pid", serde.i64),
        ("epoch", serde.i16),
        ("timeout_ms", serde.i32),
        ("status", serde.u8),
        ("partitions", serde.vector(_TxPartitionE.serde())),
        ("groups", serde.vector(serde.string)),
        ("update_ms", serde.i64),
    ]


class _MarkerReq(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
        ("pid", serde.i64),
        ("epoch", serde.i16),
        ("commit", serde.u8),
    ]


class _GroupMarkerReq(serde.Envelope):
    SERDE_FIELDS = [
        ("group", serde.string),
        ("pid", serde.i64),
        ("epoch", serde.i16),
        ("commit", serde.u8),
    ]


class _MarkerReply(serde.Envelope):
    SERDE_FIELDS = [("code", serde.string)]  # "" ok | "not_leader" | msg


@dataclasses.dataclass
class TxMeta:
    tx_id: str
    pid: int
    epoch: int
    timeout_ms: int
    status: int
    partitions: set[NTP]
    groups: set[str]
    update_ms: int


class TxGatewayService(Service):
    """Marker delivery endpoints served by every broker
    (reference: cluster/tx_gateway.cc)."""

    def __init__(self, broker: "Broker"):
        self._broker = broker

    @method(WRITE_TX_MARKER)
    async def write_tx_marker(self, payload: bytes) -> bytes:
        req = _MarkerReq.decode(payload)
        ntp = NTP(req.ns, req.topic, int(req.partition))
        p = self._broker.partition_manager.get(ntp)
        if p is None:
            return _MarkerReply(code="not_leader").encode()
        try:
            await p.write_tx_marker(
                int(req.pid), int(req.epoch), bool(req.commit)
            )
            return _MarkerReply(code="").encode()
        except NotLeaderError:
            return _MarkerReply(code="not_leader").encode()
        except Exception as e:
            return _MarkerReply(code=f"error: {e}").encode()

    @method(GROUP_TX_MARKER)
    async def group_tx_marker(self, payload: bytes) -> bytes:
        req = _GroupMarkerReq.decode(payload)
        code = await self._broker.group_coordinator.complete_tx(
            req.group, int(req.pid), int(req.epoch), bool(req.commit)
        )
        if code == 0:
            return _MarkerReply(code="").encode()
        if code in (
            int(_E.not_coordinator),
            int(_E.coordinator_load_in_progress),
        ):
            return _MarkerReply(code="not_leader").encode()
        return _MarkerReply(code=f"error: kafka {code}").encode()


class TxCoordinator:
    """tm_stm: transactional-id registry + two-phase commit driver."""

    def __init__(self, broker: "Broker", n_partitions: int = DEFAULT_TX_PARTITIONS):
        self.broker = broker
        self.n_partitions = n_partitions
        self._txs: dict[int, dict[str, TxMeta]] = {}  # pid shard -> txs
        self._replayed: dict[int, int] = {}  # pid -> replay term
        self._replay_locks = LockMap()
        self._tx_locks = LockMap()  # per tx-id op lock
        self._create_lock = asyncio.Lock()
        self.service = TxGatewayService(broker)
        self._expire_task: Optional[asyncio.Task] = None
        self._recovery_tasks: set[asyncio.Task] = set()
        self._closed = False

    async def start(self) -> None:
        self._expire_task = asyncio.ensure_future(self._expire_loop())

    async def stop(self) -> None:
        self._closed = True
        for t in [self._expire_task, *self._recovery_tasks]:
            if t is None:
                continue
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        # per-key registries: drop every parked lock (a holder that is
        # still draining keeps its entry and finishes clean)
        self._tx_locks.prune()
        self._replay_locks.prune()

    # -- mapping ------------------------------------------------------
    def partition_for(self, tx_id: str) -> int:
        return zlib.crc32(tx_id.encode()) % self.n_partitions

    def ntp_for(self, tx_id: str) -> NTP:
        return NTP(TX_NS, TX_TOPIC, self.partition_for(tx_id))

    async def ensure_tx_topic(self) -> None:
        table = self.broker.controller.topic_table
        if table.contains(TopicNamespace(TX_NS, TX_TOPIC)):
            return
        async with self._create_lock:
            if table.contains(TopicNamespace(TX_NS, TX_TOPIC)):
                return
            from .controller import TopicError

            rf = min(3, len(self.broker.controller.members))
            rf = rf if rf % 2 == 1 else rf - 1
            try:
                await self.broker.controller.create_topic(
                    TX_TOPIC,
                    partitions=self.n_partitions,
                    replication_factor=max(rf, 1),
                    ns=TX_NS,
                )
            except TopicError as e:
                if e.code != "topic_already_exists":
                    raise

    async def find_coordinator(
        self, tx_id: str
    ) -> tuple[int, str, int] | None:
        await self.ensure_tx_topic()
        ntp = self.ntp_for(tx_id)
        leader = self.broker.metadata_cache.leader_of(ntp)
        if leader is None:
            return None
        addr = self.broker.kafka_address_of(leader)
        if addr is None:
            return None
        return leader, addr[0], addr[1]

    def _local_partition(self, tx_id: str):
        return self._local_partition_pid(self.partition_for(tx_id))

    # -- replay (tm_stm hydration with leadership barrier) -----------
    async def _ensure_replayed(self, tx_id: str) -> Optional[int]:
        """Partition id if this broker coordinates tx_id, None if not;
        raises asyncio.TimeoutError while the barrier settles (callers
        map it to CONCURRENT_TRANSACTIONS / coordinator retry)."""
        pid = self.partition_for(tx_id)
        if await self.ensure_replayed_pid(pid):
            return pid
        return None

    def _local_partition_pid(self, pid: int):
        p = self.broker.partition_manager.get(NTP(TX_NS, TX_TOPIC, pid))
        if p is None or not p.is_leader:
            return None
        return p

    async def ensure_replayed_pid(self, pid: int) -> bool:
        """True if this broker leads coordinator partition `pid` and its
        tx shard is hydrated for the current term."""
        p = self._local_partition_pid(pid)
        if p is None:
            self._replayed.pop(pid, None)
            return False
        term = p.consensus.term
        if self._replayed.get(pid) == term:
            return True
        lock = self._replay_locks.lock(pid)
        async with lock:
            p = self._local_partition_pid(pid)
            if p is None:
                self._replayed.pop(pid, None)
                return False
            c = p.consensus
            term = c.term
            if self._replayed.get(pid) == term:
                return True
            if c.commit_index < c.term_start:
                await c.wait_committed(c.term_start, timeout=2.0)
                if not c.is_leader() or c.term != term:
                    raise asyncio.TimeoutError("leadership moved")
            shard: dict[str, TxMeta] = {}
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
            self._txs[pid] = shard
            self._replayed[pid] = term
            logger.info(
                "node %d: tx partition %d replayed: %d txs (term %d)",
                self.broker.node_id,
                pid,
                len(shard),
                term,
            )
            # resume transactions stranded mid-completion by the
            # previous coordinator (tm_stm recovery)
            for meta in shard.values():
                if meta.status in (TX_PREPARING_COMMIT, TX_PREPARING_ABORT):
                    t = asyncio.ensure_future(self._resume(meta))
                    self._recovery_tasks.add(t)
                    t.add_done_callback(self._recovery_tasks.discard)
            return True

    def _replay_batch(self, shard: dict[str, TxMeta], batch: RecordBatch) -> None:
        for rec in batch.records():
            if rec.key is None:
                continue
            tx_id = rec.key.decode()
            if rec.value is None:
                shard.pop(tx_id, None)
                continue
            v = _TxMetaValue.decode(rec.value)
            shard[tx_id] = TxMeta(
                tx_id=tx_id,
                pid=int(v.pid),
                epoch=int(v.epoch),
                timeout_ms=int(v.timeout_ms),
                status=int(v.status),
                partitions={
                    NTP(e.ns, e.topic, int(e.partition)) for e in v.partitions
                },
                groups=set(v.groups),
                update_ms=int(v.update_ms),
            )

    async def _resume(self, meta: TxMeta) -> None:
        try:
            lock = self._tx_locks.lock(meta.tx_id)
            async with lock:
                if meta.status not in (TX_PREPARING_COMMIT, TX_PREPARING_ABORT):
                    return
                await self._complete(meta, meta.status == TX_PREPARING_COMMIT)
        except Exception:
            logger.exception("tx %s: recovery failed", meta.tx_id)

    # -- persistence --------------------------------------------------
    async def _persist(self, meta: TxMeta) -> None:
        p = self._local_partition(meta.tx_id)
        if p is None:
            raise NotLeaderError(None)
        b = RecordBatchBuilder()
        b.add(
            value=_TxMetaValue(
                pid=meta.pid,
                epoch=meta.epoch,
                timeout_ms=meta.timeout_ms,
                status=meta.status,
                partitions=[
                    _TxPartitionE(ns=n.ns, topic=n.topic, partition=n.partition)
                    for n in meta.partitions
                ],
                groups=sorted(meta.groups),
                update_ms=meta.update_ms,
            ).encode(),
            key=meta.tx_id.encode(),
        )
        await p.replicate(b.build(), acks=-1)

    # -- marker delivery ----------------------------------------------
    async def _deliver(
        self,
        ntp: NTP,
        local_apply,  # async () -> None, raises NotLeaderError to retry
        method_id: int,
        payload: bytes,
        deadline: float,
        what: str,
    ) -> None:
        """Retry loop shared by both marker targets: resolve the
        leader of `ntp`, apply locally or RPC, retry on leadership
        churn until the deadline."""
        while True:
            leader = self.broker.metadata_cache.leader_of(ntp)
            try:
                if leader == self.broker.node_id:
                    await local_apply()
                    return
                if leader is not None:
                    raw = await self.broker.send_rpc(
                        leader, method_id, payload, 5.0
                    )
                    reply = _MarkerReply.decode(raw)
                    if reply.code == "":
                        return
                    if not reply.code.startswith("not_leader"):
                        raise RuntimeError(reply.code)
            except (NotLeaderError, ConnectionError, asyncio.TimeoutError):
                pass
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"{what} delivery timed out")
            await asyncio.sleep(0.05)

    async def _marker_to_partition(
        self, ntp: NTP, pid: int, epoch: int, commit: bool, deadline: float
    ) -> None:
        async def local() -> None:
            p = self.broker.partition_manager.get(ntp)
            if p is None:
                raise NotLeaderError(None)
            await p.write_tx_marker(pid, epoch, commit)

        req = _MarkerReq(
            ns=ntp.ns,
            topic=ntp.topic,
            partition=ntp.partition,
            pid=pid,
            epoch=epoch,
            commit=1 if commit else 0,
        ).encode()
        await self._deliver(
            ntp, local, WRITE_TX_MARKER, req, deadline, f"marker to {ntp}"
        )

    async def _marker_to_group(
        self, group: str, pid: int, epoch: int, commit: bool, deadline: float
    ) -> None:
        gc = self.broker.group_coordinator

        async def local() -> None:
            code = await gc.complete_tx(group, pid, epoch, commit)
            if code == 0:
                return
            if code in (
                int(_E.not_coordinator),
                int(_E.coordinator_load_in_progress),
            ):
                raise NotLeaderError(None)
            raise RuntimeError(f"group marker: kafka {code}")

        req = _GroupMarkerReq(
            group=group, pid=pid, epoch=epoch, commit=1 if commit else 0
        ).encode()
        await self._deliver(
            gc.ntp_for(group),
            local,
            GROUP_TX_MARKER,
            req,
            deadline,
            f"group marker to {group}",
        )

    async def _complete(self, meta: TxMeta, commit: bool) -> None:
        """Phase 2+3: deliver markers, then clear to EMPTY. Caller
        holds the tx lock and has already persisted PREPARING_*.
        In-memory state mutates only after the EMPTY record is durable
        — a failed persist must leave memory matching the log."""
        deadline = asyncio.get_event_loop().time() + 10.0
        for ntp in sorted(meta.partitions, key=str):
            await self._marker_to_partition(
                ntp, meta.pid, meta.epoch, commit, deadline
            )
        for group in sorted(meta.groups):
            await self._marker_to_group(
                group, meta.pid, meta.epoch, commit, deadline
            )
        done = dataclasses.replace(
            meta,
            status=TX_EMPTY,
            partitions=set(),
            groups=set(),
            update_ms=int(time.time() * 1000),
        )
        await self._persist(done)
        meta.status = TX_EMPTY
        meta.partitions = set()
        meta.groups = set()
        meta.update_ms = done.update_ms

    # -- frontend operations (all coordinator-local) ------------------
    def _check_producer(self, meta: Optional[TxMeta], pid: int, epoch: int) -> int:
        if meta is None or meta.pid != pid:
            return int(_E.invalid_producer_id_mapping)
        if meta.epoch != epoch:
            return int(_E.invalid_producer_epoch)
        return 0

    async def _shard_for(self, tx_id: str) -> Optional[dict[str, TxMeta]]:
        try:
            pid = await self._ensure_replayed(tx_id)
        except asyncio.TimeoutError:
            return None
        if pid is None:
            return None
        return self._txs.setdefault(pid, {})

    # -- introspection (DescribeTransactions / ListTransactions) -----
    async def describe_tx(self, tx_id: str) -> tuple[Optional[TxMeta], int]:
        """(meta, error_code) for one transactional id; meta is None
        when this broker is not its coordinator or the id is unknown."""
        shard = await self._shard_for(tx_id)
        if shard is None:
            return None, int(_E.not_coordinator)
        meta = shard.get(tx_id)
        if meta is None:
            return None, int(_E.transactional_id_not_found)
        return meta, 0

    async def list_local_txs(self) -> tuple[list[TxMeta], bool]:
        """(transactions, complete) over partitions this broker leads
        (tx_gateway_frontend.cc get_all_transactions). complete=False
        when a led partition is still hydrating — callers must answer
        COORDINATOR_LOAD_IN_PROGRESS rather than a silently partial
        list."""
        out: list[TxMeta] = []
        complete = True
        for pid in range(self.n_partitions):
            try:
                if not await self.ensure_replayed_pid(pid):
                    continue
            except asyncio.TimeoutError:
                complete = False
                continue
            out.extend(self._txs.get(pid, {}).values())
        return out, complete

    async def init_producer_id(
        self, tx_id: str, timeout_ms: int
    ) -> tuple[int, int, int]:
        """(producer_id, epoch, error_code). Aborts any in-flight
        transaction from the previous producer incarnation, then bumps
        the epoch (tx_gateway_frontend.cc init_tm_tx)."""
        shard = await self._shard_for(tx_id)
        if shard is None:
            return -1, -1, int(_E.not_coordinator)
        lock = self._tx_locks.lock(tx_id)
        async with lock:
            meta = shard.get(tx_id)
            now = int(time.time() * 1000)
            if meta is None:
                from .controller import TopicError

                try:
                    new_pid = await self.broker.controller.allocate_producer_id()
                except (TopicError, TimeoutError):
                    return -1, -1, int(_E.coordinator_not_available)
                meta = TxMeta(
                    tx_id=tx_id,
                    pid=new_pid,
                    epoch=0,
                    timeout_ms=timeout_ms,
                    status=TX_EMPTY,
                    partitions=set(),
                    groups=set(),
                    update_ms=now,
                )
            else:
                if meta.status == TX_ONGOING:
                    # fence the zombie: bump the epoch FIRST so the
                    # abort markers land with the new epoch and raise
                    # the fence on every touched partition (KIP-360
                    # bumped-epoch abort; rm_stm fencing)
                    candidate = dataclasses.replace(
                        meta,
                        epoch=meta.epoch + 1,
                        status=TX_PREPARING_ABORT,
                        update_ms=now,
                    )
                    try:
                        await self._persist(candidate)
                        meta.epoch = candidate.epoch
                        meta.status = candidate.status
                        meta.update_ms = now
                        await self._complete(meta, commit=False)
                    except (NotLeaderError, ReplicateTimeout, TimeoutError):
                        return -1, -1, int(_E.coordinator_not_available)
                    bumped = True
                elif meta.status in (TX_PREPARING_COMMIT, TX_PREPARING_ABORT):
                    try:
                        await self._complete(
                            meta, meta.status == TX_PREPARING_COMMIT
                        )
                    except (NotLeaderError, ReplicateTimeout, TimeoutError):
                        return -1, -1, int(_E.concurrent_transactions)
                    bumped = False
                else:
                    bumped = False
                meta = dataclasses.replace(
                    meta,
                    epoch=meta.epoch if bumped else meta.epoch + 1,
                    timeout_ms=timeout_ms,
                    status=TX_EMPTY,
                    partitions=set(),
                    groups=set(),
                    update_ms=now,
                )
            try:
                shard[tx_id] = meta
                await self._persist(meta)
            except (NotLeaderError, ReplicateTimeout):
                return -1, -1, int(_E.not_coordinator)
            return meta.pid, meta.epoch, 0

    async def add_partitions(
        self, tx_id: str, pid: int, epoch: int, ntps: list[NTP]
    ) -> int:
        shard = await self._shard_for(tx_id)
        if shard is None:
            return int(_E.not_coordinator)
        lock = self._tx_locks.lock(tx_id)
        async with lock:
            meta = shard.get(tx_id)
            code = self._check_producer(meta, pid, epoch)
            if code:
                return code
            if meta.status in (TX_PREPARING_COMMIT, TX_PREPARING_ABORT):
                return int(_E.concurrent_transactions)
            if meta.partitions.issuperset(ntps) and meta.status == TX_ONGOING:
                return 0  # idempotent retry (of a DURABLE addition —
                # failed persists below never reach the in-memory set)
            candidate = dataclasses.replace(
                meta,
                partitions=meta.partitions | set(ntps),
                status=TX_ONGOING,
                update_ms=int(time.time() * 1000),
            )
            try:
                await self._persist(candidate)
            except (NotLeaderError, ReplicateTimeout):
                return int(_E.not_coordinator)
            meta.partitions = candidate.partitions
            meta.status = TX_ONGOING
            meta.update_ms = candidate.update_ms
            return 0

    async def add_offsets(
        self, tx_id: str, pid: int, epoch: int, group: str
    ) -> int:
        shard = await self._shard_for(tx_id)
        if shard is None:
            return int(_E.not_coordinator)
        lock = self._tx_locks.lock(tx_id)
        async with lock:
            meta = shard.get(tx_id)
            code = self._check_producer(meta, pid, epoch)
            if code:
                return code
            if meta.status in (TX_PREPARING_COMMIT, TX_PREPARING_ABORT):
                return int(_E.concurrent_transactions)
            if group in meta.groups and meta.status == TX_ONGOING:
                return 0
            candidate = dataclasses.replace(
                meta,
                groups=meta.groups | {group},
                status=TX_ONGOING,
                update_ms=int(time.time() * 1000),
            )
            try:
                await self._persist(candidate)
            except (NotLeaderError, ReplicateTimeout):
                return int(_E.not_coordinator)
            meta.groups = candidate.groups
            meta.status = TX_ONGOING
            meta.update_ms = candidate.update_ms
            return 0

    async def end_txn(
        self, tx_id: str, pid: int, epoch: int, commit: bool
    ) -> int:
        shard = await self._shard_for(tx_id)
        if shard is None:
            return int(_E.not_coordinator)
        lock = self._tx_locks.lock(tx_id)
        async with lock:
            meta = shard.get(tx_id)
            code = self._check_producer(meta, pid, epoch)
            if code:
                return code
            if meta.status == TX_EMPTY:
                return 0  # nothing staged: trivially done
            if meta.status in (TX_PREPARING_COMMIT, TX_PREPARING_ABORT):
                # the decision is already durable: a retry with the
                # same direction resumes marker delivery; the opposite
                # direction can no longer win
                if (meta.status == TX_PREPARING_COMMIT) != commit:
                    return int(_E.invalid_txn_state)
                try:
                    await self._complete(meta, commit)
                except (NotLeaderError, ReplicateTimeout):
                    return int(_E.not_coordinator)
                except TimeoutError:
                    return int(_E.request_timed_out)
                return 0
            # the decision must be durable BEFORE any marker exists —
            # and before the in-memory status says so (a retry against
            # un-logged PREPARING state would deliver markers for a
            # decision a failover could reverse)
            candidate = dataclasses.replace(
                meta,
                status=TX_PREPARING_COMMIT if commit else TX_PREPARING_ABORT,
                update_ms=int(time.time() * 1000),
            )
            try:
                await self._persist(candidate)
                meta.status = candidate.status
                meta.update_ms = candidate.update_ms
                await self._complete(meta, commit)
            except (NotLeaderError, ReplicateTimeout):
                return int(_E.not_coordinator)
            except TimeoutError:
                # decision is durable; recovery finishes delivery
                return int(_E.request_timed_out)
            return 0

    # -- expiry (tm_stm expire_old_txs) -------------------------------
    async def _expire_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(1.0)
            try:
                now = int(time.time() * 1000)
                for pid, shard in list(self._txs.items()):
                    p = self.broker.partition_manager.get(
                        NTP(TX_NS, TX_TOPIC, pid)
                    )
                    if p is None or not p.is_leader:
                        continue
                    # the in-memory shard is authoritative only for the
                    # term it was replayed in — after regaining
                    # leadership it is STALE until a frontend op runs
                    # _ensure_replayed, and acting on it here would
                    # abort transactions a newer leader already moved
                    # forward
                    if self._replayed.get(pid) != p.consensus.term:
                        continue
                    for meta in list(shard.values()):
                        if (
                            meta.status == TX_ONGOING
                            and now - meta.update_ms > meta.timeout_ms
                        ):
                            logger.info(
                                "tx %s: timed out after %dms, aborting",
                                meta.tx_id,
                                now - meta.update_ms,
                            )
                            lock = self._tx_locks.lock(meta.tx_id)
                            async with lock:
                                if meta.status != TX_ONGOING:
                                    continue
                                # bumped-epoch abort: the markers fence
                                # the expired producer's stragglers
                                candidate = dataclasses.replace(
                                    meta,
                                    epoch=meta.epoch + 1,
                                    status=TX_PREPARING_ABORT,
                                    update_ms=now,
                                )
                                try:
                                    await self._persist(candidate)
                                    meta.epoch = candidate.epoch
                                    meta.status = candidate.status
                                    meta.update_ms = now
                                    await self._complete(meta, commit=False)
                                except Exception:
                                    logger.exception(
                                        "tx %s: expiry abort failed", meta.tx_id
                                    )
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("tx expiry sweep failed")
