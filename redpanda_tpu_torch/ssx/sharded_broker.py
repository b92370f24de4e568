"""Sharded broker composition: one full broker on shard 0 plus
partition engines on shards 1..N-1 (reference: redpanda/application.cc
runs every subsystem as a `ss::sharded<T>` across all cores; here the
controller/coordinators stay on shard 0 and only the partition data
plane — storage, raft groups, produce/fetch — spreads).

Division of labor:
- shard 0 (the parent process): the unmodified `app.Broker` — raft0
  controller, group/tx coordinators, admin, and the Kafka listener
  (bound with SO_REUSEPORT). Partition deltas whose raft group maps to
  another shard are routed there through `invoke_on` instead of the
  local partition_manager (cluster/controller.py backend seam), and
  produce/fetch/list_offsets for those partitions forward the same way
  (kafka/server.py seam).
- shards k>0: a `PartitionShard` — its own StorageApi (data_dir/
  shard_k), GroupManager and PartitionManager, serving the `partition`
  invoke service; outbound raft RPC relays through shard 0's
  connection cache (`rpc.out`). Each shard also binds a thin Kafka
  frontend on the SHARED SO_REUSEPORT port: the kernel spreads
  accepted client connections across shards, and frames a shard cannot
  serve locally forward to shard 0's full protocol engine as raw
  envelopes (`kafka.raw`) — `smp_service_group` style cross-core
  request passing.

Placement (PR 12): which shard hosts a group is decided by the
placement layer (`placement/table.py`), not a hash baked in here. The
controller asks `PlacementTable.assign` for new partitions — any
default-namespace data partition spreads, replicated or not (the v1
shard-0 pin for replicated groups is retired; `RP_PLACEMENT_PIN=1`
restores it for A/B baselines) — and the live map can change at
runtime: `placement/mover.py` moves partitions between shards through
the `move_*` methods of the `partition` service below. Inbound raft
RPC for worker-owned groups forwards through the RaftService shard
seam (raft/service.py `shard_forward`) to each worker's `raft`
service; worker-shard leadership flows back to shard 0 as
`LeaderHintBatch` on the parent's `placement` service, feeding
metadata dissemination. Transactions and consumer groups still live
on shard 0: their coordinator topics are internal (`__`-prefixed),
which `PlacementTable.assign` keeps on the full broker where the
coordinator machinery runs.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from ..observability import fleet, trace
from ..utils.serde import (
    Envelope,
    boolean,
    bytes_t,
    f64,
    i8,
    i16,
    i32,
    i64,
    optional,
    string,
    u16,
    u32,
    u64,
    vector,
)
from .shards import (
    InvokeError,
    ShardContext,
    ShardRuntime,
    bind_reuse_port,
    reserve_reuse_port,
    standdown_reason,
)

logger = logging.getLogger("ssx.broker")


# ------------------------------------------------------- wire envelopes
class PartitionCreate(Envelope):
    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("group", i64),
        ("replicas", vector(i32)),
        ("segment_max_bytes", i64),
        ("retention_bytes", optional(i64)),
        ("retention_ms", optional(i64)),
        ("cleanup_policy", string),
        ("local_retention_bytes", optional(i64)),
        ("local_retention_ms", optional(i64)),
    ]


class PartitionRef(Envelope):
    SERDE_FIELDS = [("ns", string), ("topic", string), ("partition", i32)]


class ShardProduceRequest(Envelope):
    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("acks", i8),
        ("records", bytes_t),
    ]


class ShardProduceReply(Envelope):
    SERDE_FIELDS = [("error", i16), ("base_offset", i64)]


class ShardFetchRequest(Envelope):
    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("offset", i64),
        ("max_bytes", i64),
        ("read_committed", boolean),
    ]


class ShardFetchReply(Envelope):
    SERDE_FIELDS = [
        ("error", i16),
        ("high_watermark", i64),
        ("last_stable_offset", i64),
        ("log_start", i64),
        ("records", bytes_t),
    ]


class ShardListOffsetsRequest(Envelope):
    SERDE_FIELDS = [
        ("ns", string),
        ("topic", string),
        ("partition", i32),
        ("timestamp", i64),
    ]


class ShardListOffsetsReply(Envelope):
    SERDE_FIELDS = [("error", i16), ("offset", i64), ("timestamp", i64)]


class RpcOut(Envelope):
    """Outbound internal RPC relayed through shard 0's connection
    cache (children own no peer transports)."""

    SERDE_FIELDS = [
        ("node", i32),
        ("method", u32),
        ("payload", bytes_t),
        ("timeout", f64),
    ]


class KafkaFrame(Envelope):
    """One raw Kafka request frame forwarded from a shard's thin
    frontend to shard 0's protocol engine."""

    SERDE_FIELDS = [("conn", u64), ("frame", bytes_t)]


class KafkaFrameReply(Envelope):
    SERDE_FIELDS = [
        ("has_resp", boolean),
        ("resp", bytes_t),
        ("close", boolean),
    ]


class ShardStats(Envelope):
    """Per-shard attribution counters (bench_profiles tables)."""

    SERDE_FIELDS = [
        ("shard", u16),
        ("partitions", u32),
        ("leaders", u32),
        ("produce_reqs", u64),
        ("produce_bytes", u64),
        ("fetch_reqs", u64),
        ("fetch_bytes", u64),
        ("frontend_conns", u64),
        ("frontend_frames", u64),
    ]


def _ntp_of(ns: str, topic: str, partition: int):
    from ..models.fundamental import NTP

    return NTP(ns, topic, partition)


# ------------------------------------------------------------- children
class ShardKafkaFrontend:
    """Thin per-shard Kafka listener on the shared SO_REUSEPORT port.
    Frames are forwarded whole to shard 0 (`kafka.raw`) and responses
    relayed back in order — per-connection serialization, which is the
    Kafka protocol's own ordering contract anyway."""

    def __init__(self, ctx: ShardContext, host: str, port: int):
        self._ctx = ctx
        self.host = host
        self.port = port
        self._server = None
        self._conn_seq = 0
        self.conns_total = 0
        self.frames_total = 0

    async def start(self) -> None:
        sock = bind_reuse_port(self.host, self.port)
        self._server = await asyncio.start_server(
            self._on_conn, sock=sock, limit=1 << 21
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _on_conn(self, reader, writer) -> None:
        import struct

        size_s = struct.Struct(">i")
        self._conn_seq += 1
        self.conns_total += 1
        # globally unique across shards: shard id in the high bits
        conn_id = (self._ctx.shard_id << 48) | self._conn_seq
        try:
            while True:
                try:
                    raw = await reader.readexactly(4)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                (size,) = size_s.unpack(raw)
                if size <= 0 or size > (1 << 26):
                    return
                frame = await reader.readexactly(size)
                self.frames_total += 1
                # root span on the forwarding shard: the invoke_on hop
                # carries its (trace_id, span_id) so shard 0's handler
                # tree stitches under it at dump time
                with trace.span(
                    "kafka.forward", recorder=self._ctx.recorder
                ):
                    rep_raw = await self._ctx.invoke_on(
                        0,
                        "kafka",
                        "raw",
                        KafkaFrame(conn=conn_id, frame=frame).encode(),
                        timeout=60.0,
                    )
                rep = KafkaFrameReply.decode(rep_raw)
                if rep.has_resp:
                    body = bytes(rep.resp)
                    writer.write(size_s.pack(len(body)) + body)
                    await writer.drain()
                if rep.close:
                    return
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
            InvokeError,
        ):
            pass
        finally:
            try:
                await self._ctx.invoke_on(
                    0,
                    "kafka",
                    "close",
                    KafkaFrame(conn=conn_id, frame=b"").encode(),
                    timeout=5.0,
                )
            except (InvokeError, ConnectionError, OSError, RuntimeError):
                pass  # shard 0 already tearing down; ctx state is gone
            try:
                writer.close()
            except Exception:
                pass


class PartitionShard:
    """The data-plane engine a worker shard runs: local storage + raft
    + partitions, exposed to siblings via the `partition` service."""

    def __init__(self, config, ctx: ShardContext):
        self._config = config
        self.ctx = ctx
        base = os.path.join(config.data_dir, f"shard_{ctx.shard_id}")
        os.makedirs(base, exist_ok=True)
        from ..cluster.partition_manager import PartitionManager
        from ..metrics import MetricsRegistry
        from ..raft.group_manager import GroupManager
        from ..storage.log_manager import StorageApi

        # each worker shard owns a full registry + flight recorder; the
        # fleet plane ships both to shard 0 over the "obs" service
        self.metrics = MetricsRegistry()
        self.recorder = trace.FlightRecorder(
            node_id=config.node_id, shard=ctx.shard_id
        )
        ctx.recorder = self.recorder
        self.storage = StorageApi(base, metrics=self.metrics)

        async def send(node, method_id, payload, timeout):
            env = RpcOut(
                node=node, method=method_id, payload=payload, timeout=timeout
            ).encode()
            return await ctx.invoke_on(
                0, "rpc.out", "call", env, timeout=timeout + 5.0
            )

        self.group_manager = GroupManager(
            config.node_id,
            base,
            send,
            election_timeout_s=config.election_timeout_s,
            heartbeat_interval_s=config.heartbeat_interval_s,
            kvstore=self.storage.kvs,
            metrics=self.metrics,
            shard_id=ctx.shard_id,
            shard_count=ctx.n_shards,
            device=config.device,
        )
        self.partition_manager = PartitionManager(
            self.storage.log_mgr, self.group_manager
        )
        from ..placement.host import MoveHost

        # this shard's side of the live-move protocol (source AND
        # target), reached via the `move_*` methods of the partition
        # service below
        self.move_host = MoveHost(
            self.partition_manager, self.group_manager, self.storage.log_mgr
        )
        # inbound raft frames forwarded from shard 0's RPC server for
        # groups this shard owns (RaftService shard seam)
        self._raft_methods = {
            mid: fn
            for mid, (_name, fn) in
            self.group_manager.service.rpc_methods().items()
        }
        self._hint_task: Optional[asyncio.Task] = None
        self.frontend: Optional[ShardKafkaFrontend] = None
        self.produce_reqs = 0
        self.produce_bytes = 0
        self.fetch_reqs = 0
        self.fetch_bytes = 0
        self._register_shard_probes()

    def _register_shard_probes(self) -> None:
        pm = self.partition_manager
        self.metrics.gauge(
            "shard_partitions",
            lambda: len(pm.partitions()),
            "partitions owned by this worker shard",
        )
        self.metrics.gauge(
            "shard_leaders",
            lambda: sum(1 for p in pm.partitions().values() if p.is_leader),
            "leader partitions on this worker shard",
        )
        self.metrics.gauge(
            "shard_produce_reqs_total",
            lambda: self.produce_reqs,
            "produce requests served by this worker shard",
        )
        self.metrics.gauge(
            "shard_fetch_reqs_total",
            lambda: self.fetch_reqs,
            "fetch requests served by this worker shard",
        )
        self.metrics.gauge(
            "shard_frontend_conns_total",
            lambda: self.frontend.conns_total if self.frontend else 0,
            "kafka connections accepted by this shard's frontend",
        )
        self.metrics.gauge(
            "shard_frontend_frames_total",
            lambda: self.frontend.frames_total if self.frontend else 0,
            "kafka frames forwarded by this shard's frontend",
        )
        self.metrics.gauge(
            "trace_trees_total",
            lambda: self.recorder.trees_total,
            "span trees completed on this shard",
        )
        # per-shard tick frame (raft/tick_frame.py): window sizes tell
        # whether the live replication plane is actually batching —
        # replies/flush near 1.0 means the frame degenerated to the
        # old per-reply cadence
        tf = self.group_manager.tick_frame
        self.metrics.gauge(
            "shard_tick_frame_flushes_total",
            lambda: tf.flushes,
            "tick-frame windows folded on this shard",
        )
        self.metrics.gauge(
            "shard_tick_frame_replies_total",
            lambda: tf.replies_folded,
            "append replies folded through this shard's tick frames",
        )
        self.metrics.gauge(
            "shard_tick_frame_max_batch",
            lambda: tf.max_batch,
            "largest reply window one tick-frame fold covered",
        )
        self.metrics.gauge(
            "shard_tick_frame_pending",
            lambda: tf.pending,
            "replies + forced rows awaiting the next tick-frame flush",
        )
        # bounded partition-health gauge family (top-k + fixed-width
        # lag distribution); the fleet scrape injects the shard label
        from ..observability.health import HealthSampler, register_exporter

        self.health_sampler = HealthSampler(
            self.group_manager, self.group_manager.probe.ledger
        )
        register_exporter(self.metrics, self.health_sampler)
        # flight-data plane, per worker shard: this shard's own history
        # ring + profiler view, served to shard 0 over the obs service
        # ("history"/"profile") the same way metrics/traces/health are
        from ..observability import devplane as _devplane
        from ..observability import flightdata as _flightdata
        from ..observability import profiler as _profiler

        # device-plane families join this worker's registry (adopted
        # before the ring is built so they ride its windows); the
        # dedicated "devplane" obs method additionally serves the raw
        # process-global registry for /v1/devplane's exact merge
        _devplane.register(self.metrics)
        self.flightdata = _flightdata.MetricsHistory(self.metrics)
        self.profiler = _profiler.get_profiler()

    async def start(self) -> None:
        await self.group_manager.start()
        self.ctx.register("partition", self.partition_service)
        self.ctx.register("obs", self.obs_service)
        self.ctx.register("raft", self.raft_service)
        # leadership relay: worker-shard raft leadership must reach
        # shard 0's metadata plane (leaders table + cross-broker
        # dissemination) — poll the local groups and push deltas
        self._hint_task = asyncio.ensure_future(self._leader_hint_loop())
        from ..observability import flightdata as _flightdata
        from ..observability import profiler as _profiler

        if _flightdata.ENABLED:
            self.flightdata.start()
        if _profiler.ENABLED:
            self.profiler.acquire()
        self.frontend = ShardKafkaFrontend(
            self.ctx, self._config.kafka_host, self._config.kafka_port
        )
        await self.frontend.start()

    async def stop(self) -> None:
        hint_task, self._hint_task = self._hint_task, None
        if hint_task is not None:
            hint_task.cancel()
            try:
                await hint_task
            except asyncio.CancelledError:
                pass
        if self.frontend is not None:
            await self.frontend.stop()
        from ..observability import profiler as _profiler

        await self.flightdata.stop()
        if _profiler.ENABLED:
            self.profiler.release()
        await self.group_manager.stop()
        self.storage.close()

    # -- invoke service ----------------------------------------------
    async def partition_service(self, method: str, payload: bytes) -> bytes:
        if method == "create":
            return await self._create(PartitionCreate.decode(payload))
        if method == "remove":
            return await self._remove(PartitionRef.decode(payload))
        if method == "produce":
            return await self._produce(ShardProduceRequest.decode(payload))
        if method == "fetch":
            return self._fetch(ShardFetchRequest.decode(payload))
        if method == "list_offsets":
            return self._list_offsets(
                ShardListOffsetsRequest.decode(payload)
            )
        if method == "stats":
            return self._stats()
        if method.startswith("move_"):
            # live-move protocol endpoint (placement/host.py)
            return await self.move_host.handle(method, payload)
        raise LookupError(f"partition: no such method {method!r}")

    async def raft_service(self, method: str, payload: bytes) -> bytes:
        """Inbound raft RPC for groups this shard owns, forwarded raw
        from shard 0's RaftService (the placement shard seam)."""
        if method != "call":
            raise LookupError(f"raft: no such method {method!r}")
        from ..placement.envelopes import RaftForward

        req = RaftForward.decode(payload)
        fn = self._raft_methods.get(int(req.method))
        if fn is None:
            raise LookupError(f"raft: no method id {req.method}")
        return await fn(bytes(req.payload))

    async def _leader_hint_loop(self) -> None:
        from ..placement.envelopes import LeaderHint, LeaderHintBatch

        last: dict[int, tuple] = {}
        while True:
            await asyncio.sleep(0.2)
            hints = []
            arrays = self.group_manager.arrays
            for ntp, p in self.partition_manager.partitions().items():
                c = p.consensus
                leader = c.leader_id
                state = (c.term, leader if leader is not None else -1, c.row)
                if last.get(p.group_id) == state:
                    continue
                last[p.group_id] = state
                hints.append(
                    LeaderHint(
                        ns=ntp.ns,
                        topic=ntp.topic,
                        partition=ntp.partition,
                        group=p.group_id,
                        term=state[0],
                        leader=state[1],
                        row=state[2],
                        chip=arrays.chip_of(state[2]),
                    )
                )
            if not hints:
                continue
            try:
                await self.ctx.invoke_on(
                    0,
                    "placement",
                    "leader_update",
                    LeaderHintBatch(
                        shard=self.ctx.shard_id,
                        hints=[h.encode() for h in hints],
                    ).encode(),
                    timeout=5.0,
                )
            except (InvokeError, ConnectionError, OSError, RuntimeError):
                # parent busy or tearing down: forget what we claimed
                # to have sent so the delta goes out next tick
                for h in hints:
                    last.pop(h.group, None)

    async def obs_service(self, method: str, payload: bytes) -> bytes:
        """Fleet observability plane: this shard's registry snapshot and
        flight-recorder dump as serde envelopes (RPL009)."""
        if method == "metrics":
            return fleet.snapshot_registry(
                self.metrics, self.ctx.shard_id, self._config.node_id
            ).encode()
        if method == "traces":
            return fleet.dump_to_envelope(self.recorder.dump()).encode()
        if method == "health":
            from ..observability import health as _health

            rep = _health.build_report(
                self.group_manager,
                self.group_manager.probe.ledger,
                storage=self.storage,
            )
            return fleet.health_to_envelope(
                rep, self.ctx.shard_id, self._config.node_id
            ).encode()
        if method == "history":
            from ..observability import flightdata as _fd

            return _fd.window_reply(
                self.flightdata,
                self.ctx.shard_id,
                _fd.WindowQuery.decode(payload),
            ).encode()
        if method == "profile":
            from ..observability import profiler as _prof

            return _prof.profile_reply(
                self.profiler,
                self.ctx.shard_id,
                _prof.ProfileQuery.decode(payload),
            ).encode()
        if method == "devplane":
            from ..observability import devplane as _devplane

            return _devplane.snapshot(
                self.ctx.shard_id, self._config.node_id
            ).encode()
        raise LookupError(f"obs: no such method {method!r}")

    async def _create(self, req: PartitionCreate) -> bytes:
        from ..storage.log import LogConfig

        ntp = _ntp_of(req.ns, req.topic, req.partition)
        cfg = LogConfig(
            segment_max_bytes=req.segment_max_bytes,
            retention_bytes=req.retention_bytes,
            retention_ms=req.retention_ms,
            cleanup_policy=req.cleanup_policy,
            local_retention_bytes=req.local_retention_bytes,
            local_retention_ms=req.local_retention_ms,
        )
        await self.partition_manager.manage(
            ntp, req.group, list(req.replicas), log_config=cfg
        )
        return b""

    async def _remove(self, req: PartitionRef) -> bytes:
        await self.partition_manager.remove(
            _ntp_of(req.ns, req.topic, req.partition)
        )
        return b""

    async def _produce(self, req: ShardProduceRequest) -> bytes:
        from ..cluster.producer_state import (
            DuplicateSequence,
            OutOfOrderSequence,
            ProducerFenced,
        )
        from ..kafka.protocol.headers import ErrorCode
        from ..models.record import CrcMismatch, RecordBatch
        from ..raft.consensus import NotLeaderError, ReplicateTimeout
        from ..utils.iobuf import IOBufParser

        def perr(exc: BaseException) -> int:
            if isinstance(exc, CrcMismatch):
                return int(ErrorCode.corrupt_message)
            if isinstance(exc, NotLeaderError):
                return int(ErrorCode.not_leader_for_partition)
            if isinstance(exc, (ReplicateTimeout, asyncio.TimeoutError)):
                return int(ErrorCode.request_timed_out)
            if isinstance(exc, OutOfOrderSequence):
                return int(ErrorCode.out_of_order_sequence_number)
            if isinstance(exc, ProducerFenced):
                return int(ErrorCode.invalid_producer_epoch)
            if isinstance(exc, ValueError):
                return int(ErrorCode.corrupt_message)
            return int(ErrorCode.unknown_server_error)

        self.produce_reqs += 1
        self.produce_bytes += len(req.records)
        self.group_manager.probe.ledger.note_produce(
            f"{req.ns}/{req.topic}/{req.partition}", len(req.records)
        )
        partition = self.partition_manager.get(
            _ntp_of(req.ns, req.topic, req.partition)
        )
        if partition is None:
            # routed here by the shard table: creation not reconciled
            # yet — retriable, exactly like a moving leader
            return ShardProduceReply(
                error=int(ErrorCode.not_leader_for_partition), base_offset=-1
            ).encode()
        entries: list[tuple] = []
        try:
            parser = IOBufParser(req.records)
            prev_enqueued = None
            while parser.bytes_left() > 0:
                batch = RecordBatch.from_kafka_wire(parser, verify=True)
                if prev_enqueued is not None:
                    await asyncio.shield(prev_enqueued)
                try:
                    ps = await partition.replicate_in_stages(
                        batch, acks=req.acks
                    )
                except DuplicateSequence as dup:
                    entries.append(("dup", dup.base_offset))
                    continue
                entries.append(("ps", ps))
                prev_enqueued = ps.enqueued
        except Exception as e:
            for kind, v in entries:
                if kind == "ps":
                    _consume_exc(v.enqueued)
                    _consume_exc(v.done)
            return ShardProduceReply(error=perr(e), base_offset=-1).encode()
        base = -1
        err = 0
        for i, (kind, v) in enumerate(entries):
            if kind == "dup":
                if base < 0:
                    base = v
                continue
            try:
                kbase = await asyncio.wait_for(asyncio.shield(v.done), 10.0)
                if base < 0:
                    base = kbase
            except Exception as e:
                err = perr(e)
                for kind2, v2 in entries[i:]:
                    if kind2 == "ps":
                        _consume_exc(v2.done)
                break
        return ShardProduceReply(
            error=err, base_offset=base if not err else -1
        ).encode()

    def _fetch(self, req: ShardFetchRequest) -> bytes:
        from ..kafka.protocol.headers import ErrorCode
        from ..kafka.server import read_fetch_rows

        self.fetch_reqs += 1
        partition = self.partition_manager.get(
            _ntp_of(req.ns, req.topic, req.partition)
        )
        if partition is None or not partition.is_leader:
            return ShardFetchReply(
                error=int(ErrorCode.not_leader_for_partition),
                high_watermark=-1,
                last_stable_offset=-1,
                log_start=-1,
                records=b"",
            ).encode()
        hw = partition.high_watermark()
        lso = partition.last_stable_offset()
        start = partition.start_offset()
        if req.offset < start or req.offset > hw:
            return ShardFetchReply(
                error=int(ErrorCode.offset_out_of_range),
                high_watermark=hw,
                last_stable_offset=lso,
                log_start=start,
                records=b"",
            ).encode()
        # wire-plane serving seam shared with read_all (RP_FETCH_WIRE
        # gated inside): the relay ships patched spans, never decodes
        wire, _fetch_end = read_fetch_rows(
            partition,
            req.offset,
            max_bytes=req.max_bytes,
            upto_kafka=lso if req.read_committed else None,
        )
        self.fetch_bytes += len(wire)
        if wire:
            self.group_manager.probe.ledger.note_fetch(
                f"{req.ns}/{req.topic}/{req.partition}", len(wire)
            )
        return ShardFetchReply(
            error=0,
            high_watermark=hw,
            last_stable_offset=lso,
            log_start=start,
            records=wire,
        ).encode()

    def _list_offsets(self, req: ShardListOffsetsRequest) -> bytes:
        from ..kafka.protocol.headers import ErrorCode

        partition = self.partition_manager.get(
            _ntp_of(req.ns, req.topic, req.partition)
        )
        if partition is None or not partition.is_leader:
            return ShardListOffsetsReply(
                error=int(ErrorCode.not_leader_for_partition),
                offset=-1,
                timestamp=-1,
            ).encode()
        if req.timestamp == -2:  # earliest
            off, ts = partition.start_offset(), -1
        elif req.timestamp == -1:  # latest
            off, ts = partition.high_watermark(), -1
        else:
            q = partition.timequery(req.timestamp)
            off, ts = (q, req.timestamp) if q is not None else (-1, -1)
        return ShardListOffsetsReply(
            error=0, offset=off, timestamp=ts
        ).encode()

    def _stats(self) -> bytes:
        parts = self.partition_manager.partitions()
        return ShardStats(
            shard=self.ctx.shard_id,
            partitions=len(parts),
            leaders=sum(1 for p in parts.values() if p.is_leader),
            produce_reqs=self.produce_reqs,
            produce_bytes=self.produce_bytes,
            fetch_reqs=self.fetch_reqs,
            fetch_bytes=self.fetch_bytes,
            frontend_conns=(
                self.frontend.conns_total if self.frontend else 0
            ),
            frontend_frames=(
                self.frontend.frames_total if self.frontend else 0
            ),
        ).encode()


def _consume_exc(fut) -> None:
    """Mark a future's exception retrieved (mirrors kafka/server.py)."""

    def _done(f):
        if not f.cancelled():
            f.exception()

    fut.add_done_callback(_done)


# --------------------------------------------------------------- router
class ShardRouter:
    """Shard-0 facade the kafka layer and controller backend use to
    reach partition engines on other shards. Thin typed wrappers over
    `invoke_on` with serde envelopes (RPL009)."""

    def __init__(self, runtime: ShardRuntime, n_shards: int):
        self._rt = runtime

    @property
    def n_shards(self) -> int:
        # elastic: the runtime's count grows with spawn_shard, so the
        # router (and everything reading it — table sync, stats,
        # admin) always sees the live topology
        return self._rt.n_shards

    async def move_invoke(self, shard: int, method: str, payload: bytes) -> bytes:
        """One live-move protocol frame to a worker shard's MoveHost
        (PartitionMover's transport)."""
        return await self._rt.invoke_on(
            shard, "partition", method, payload, timeout=30.0
        )

    async def raft_invoke(self, shard: int, method_id: int, payload: bytes) -> bytes:
        """One raw raft frame to the worker shard that owns its group
        (RaftService shard seam)."""
        from ..placement.envelopes import RaftForward

        return await self._rt.invoke_on(
            shard,
            "raft",
            "call",
            RaftForward(method=method_id, payload=payload).encode(),
            timeout=10.0,
        )

    async def create_partition(
        self, shard: int, ntp, group: int, replicas, log_cfg
    ) -> None:
        await self._rt.invoke_on(
            shard,
            "partition",
            "create",
            PartitionCreate(
                ns=ntp.ns,
                topic=ntp.topic,
                partition=ntp.partition,
                group=group,
                replicas=list(replicas),
                segment_max_bytes=log_cfg.segment_max_bytes,
                retention_bytes=log_cfg.retention_bytes,
                retention_ms=log_cfg.retention_ms,
                cleanup_policy=log_cfg.cleanup_policy,
                local_retention_bytes=log_cfg.local_retention_bytes,
                local_retention_ms=log_cfg.local_retention_ms,
            ).encode(),
        )

    async def remove_partition(self, shard: int, ntp) -> None:
        await self._rt.invoke_on(
            shard,
            "partition",
            "remove",
            PartitionRef(
                ns=ntp.ns, topic=ntp.topic, partition=ntp.partition
            ).encode(),
        )

    async def produce(
        self, shard: int, ntp, records: bytes, acks: int
    ) -> tuple[int, int]:
        # ProcNemesis boundary: a mid-produce process fault lands here,
        # BEFORE the invoke, so the in-flight record is the one at risk
        self._rt._nemesis_act("produce", shard)
        raw = await self._rt.invoke_on(
            shard,
            "partition",
            "produce",
            ShardProduceRequest(
                ns=ntp.ns,
                topic=ntp.topic,
                partition=ntp.partition,
                acks=acks,
                records=records,
            ).encode(),
            timeout=15.0,
        )
        rep = ShardProduceReply.decode(raw)
        return rep.error, rep.base_offset

    async def fetch(
        self,
        shard: int,
        ntp,
        offset: int,
        max_bytes: int,
        read_committed: bool,
    ) -> ShardFetchReply:
        raw = await self._rt.invoke_on(
            shard,
            "partition",
            "fetch",
            ShardFetchRequest(
                ns=ntp.ns,
                topic=ntp.topic,
                partition=ntp.partition,
                offset=offset,
                max_bytes=max_bytes,
                read_committed=read_committed,
            ).encode(),
            timeout=15.0,
        )
        return ShardFetchReply.decode(raw)

    async def list_offsets(
        self, shard: int, ntp, timestamp: int
    ) -> tuple[int, int, int]:
        raw = await self._rt.invoke_on(
            shard,
            "partition",
            "list_offsets",
            ShardListOffsetsRequest(
                ns=ntp.ns,
                topic=ntp.topic,
                partition=ntp.partition,
                timestamp=timestamp,
            ).encode(),
            timeout=10.0,
        )
        rep = ShardListOffsetsReply.decode(raw)
        return rep.error, rep.offset, rep.timestamp

    async def stats(self, shard: int) -> ShardStats:
        raw = await self._rt.invoke_on(
            shard, "partition", "stats", b"", timeout=10.0
        )
        return ShardStats.decode(raw)

    # -- fleet observability ------------------------------------------
    async def obs_metrics(self, shard: int) -> fleet.RegistrySnapshot:
        raw = await self._rt.invoke_on(
            shard, "obs", "metrics", b"", timeout=10.0
        )
        return fleet.RegistrySnapshot.decode(raw)

    async def obs_traces(self, shard: int) -> dict:
        raw = await self._rt.invoke_on(
            shard, "obs", "traces", b"", timeout=10.0
        )
        return fleet.envelope_to_dump(fleet.TraceDump.decode(raw))

    async def obs_health(self, shard: int) -> dict:
        """One worker shard's partition-health report (serde on the
        wire, dict once decoded — merge with health.merge_reports)."""
        raw = await self._rt.invoke_on(
            shard, "obs", "health", b"", timeout=10.0
        )
        return fleet.envelope_to_health(fleet.HealthSnapshot.decode(raw))

    async def obs_history(self, shard: int, query) -> "object":
        """One worker shard's windowed history view (flightdata
        WindowQuery in, WindowReply out — diff buckets on the wire so
        the shard-0 quantile merge stays exact)."""
        from ..observability import flightdata as _fd

        raw = await self._rt.invoke_on(
            shard, "obs", "history", query.encode(), timeout=10.0
        )
        return _fd.WindowReply.decode(raw)

    async def obs_profile(self, shard: int, query) -> "object":
        """One worker shard's collapsed-stack profile window."""
        from ..observability import profiler as _prof

        raw = await self._rt.invoke_on(
            shard, "obs", "profile", query.encode(), timeout=10.0
        )
        return _prof.ProfileReply.decode(raw)

    async def obs_devplane(self, shard: int) -> fleet.RegistrySnapshot:
        """One worker shard's devplane registry snapshot (raw buckets
        on the wire so the /v1/devplane quantile merge stays exact)."""
        raw = await self._rt.invoke_on(
            shard, "obs", "devplane", b"", timeout=10.0
        )
        return fleet.RegistrySnapshot.decode(raw)

    def worker_shards(self) -> list[int]:
        """The LIVE worker shard ids — not a dense range once shards
        grow/retire/restart. Shard 0 (the parent) is never a worker."""
        return [s for s in sorted(self._rt.shard_pids)]

    def liveness(self) -> dict:
        """Supervisor view for /v1/debug/probes and the aggregated
        stats endpoint: per-shard pid/core plus crash/restart counters."""
        rt = self._rt
        return {
            "n_shards": self.n_shards,
            "alive": {
                str(sid): pid for sid, pid in sorted(rt.shard_pids.items())
            },
            "cores": {
                str(sid): core
                for sid, core in sorted(rt.shard_cores.items())
            },
            "crashed": {
                str(sid): st for sid, st in sorted(rt.crashed.items())
            },
            "restarts": rt.restarts,
            "shard_restarts": {
                str(sid): n for sid, n in sorted(rt.shard_restarts.items())
            },
            "gray_failures": {
                str(sid): n for sid, n in sorted(rt.gray_failures.items())
            },
            "retired": sorted(rt.retired),
            "spawns": rt.spawns,
            "failed": rt.failed.is_set(),
        }


# ------------------------------------------------- elastic lifecycle
class ShardLifecycle:
    """Coordinator for elastic shard membership and per-shard crash
    recovery. Three flows, each complete-or-rollback under ProcNemesis:

    - grow: fork (`ShardRuntime.spawn_shard`) -> readiness probe ->
      placement activation. The new shard is provisional (supervisor
      auto-restart suppressed) until it is placement-visible; any
      failure reaps it with zero residue.
    - retire: freeze NEW placements (`table.deactivate`) -> evacuate
      every resident group through the PartitionMover (budget already
      charged here, not per-move) -> drain check -> process stop
      ladder. A failed evacuation rolls the shard back to active with
      whatever groups still live on it — the map stays consistent.
    - crash recovery seams: `on_shard_down` marks the dead shard's
      groups UNAVAILABLE (produce/fetch answer retriable errors, never
      hang); `on_shard_up` re-adopts every mapped group into the
      reborn child from its on-disk StorageApi dir and lifts the
      marker, recording the unavailability window.

    All flows share one MoveBudget-style token window so an
    oscillating capacity signal cannot thrash fork/retire cycles."""

    def __init__(self, sb: "ShardedBroker"):
        from ..placement.mover import MoveBudget

        self._sb = sb
        self.budget = MoveBudget(
            moves_per_window=int(os.environ.get("RP_LIFECYCLE_OPS", "4")),
            window_s=float(os.environ.get("RP_LIFECYCLE_WINDOW_S", "60")),
        )
        # RP_ELASTIC=1 lets the rebalancer drive grow/retire from its
        # capacity signal; the admin POSTs work either way
        self.auto = os.environ.get("RP_ELASTIC", "0") == "1"
        self.grows = 0
        self.retires = 0
        self.rolled_back = 0
        self.readopts = 0
        self.grow_ms: list[float] = []
        self.unavailable_ms: list[float] = []
        self._down_t0: dict[int, float] = {}

    @property
    def _table(self):
        return self._sb.broker.shard_table

    async def grow(self, sid: Optional[int] = None) -> int:
        """Fork + mesh + activate one new worker shard; returns its id.
        Raises (ForkFailInjected, MoveBudgetExhausted, RuntimeError)
        with no partial state on any failure."""
        from ..placement.mover import MoveBudgetExhausted

        rt = self._sb.runtime
        if rt is None or self._sb.router is None:
            raise RuntimeError("shard runtime not active")
        if not self.budget.try_acquire():
            raise MoveBudgetExhausted("lifecycle budget exhausted")
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        if sid is None:
            sid = rt._next_sid
        # provisional: a mid-grow death is GROW's to roll back, not the
        # supervisor's to restart
        rt.begin_retire(sid)
        try:
            await rt.spawn_shard(sid)
            rt._nemesis_act("grow.ready", sid)
            # readiness probe: the partition engine must answer before
            # the shard becomes placement-visible
            await self._sb.router.stats(sid)
            rt._nemesis_act("grow.activate", sid)
            self._table.activate(sid)
        except BaseException:
            self.rolled_back += 1
            try:
                await rt.retire_shard(sid)
            except Exception:
                logger.exception("grow rollback of shard %d failed", sid)
            raise
        finally:
            rt.abort_retire(sid)
        self.grows += 1
        self.grow_ms.append((loop.time() - t0) * 1e3)
        logger.info("shard %d grown and placement-active", sid)
        return sid

    async def retire(self, sid: int) -> None:
        """Freeze -> evacuate -> drain -> stop. Rolls the shard back to
        active (with its unevacuated groups) on any failure."""
        from ..placement.mover import MoveBudgetExhausted

        rt = self._sb.runtime
        table, mover = self._table, self._sb.mover
        if sid == 0:
            raise ValueError("shard 0 cannot retire")
        if rt is None or sid not in rt.shard_pids:
            raise ValueError(f"no live shard {sid}")
        if not self.budget.try_acquire():
            raise MoveBudgetExhausted("lifecycle budget exhausted")
        rt._nemesis_act("retire.freeze", sid)
        table.deactivate(sid)
        try:
            rt._nemesis_act("retire.evacuate", sid)
            for ntp in table.ntps_on(sid):
                targets = [
                    s
                    for s in table.active_shards()
                    if s != sid and (s == 0 or s in rt.shard_pids)
                ]
                counts = table.counts()
                dst = min(targets, key=lambda s: counts.get(s, 0))
                await mover.move(ntp, dst, charge_budget=False)
            rt._nemesis_act("retire.drain", sid)
            left = table.ntps_on(sid)
            if left:
                raise RuntimeError(
                    f"retire drain: {len(left)} groups still on shard {sid}"
                )
        except BaseException:
            self.rolled_back += 1
            table.activate(sid)
            raise
        rt._nemesis_act("retire.stop", sid)
        await rt.retire_shard(sid)
        self.retires += 1
        logger.info("shard %d evacuated and retired", sid)

    # -- crash-recovery seams (ShardRuntime hooks) --------------------
    def on_shard_down(self, sid: int, status: int) -> None:
        broker = self._sb.broker
        if broker is None:
            return
        self._down_t0[sid] = asyncio.get_event_loop().time()
        broker.shard_table.set_unavailable(sid, True)
        logger.warning(
            "shard %d down (status %d): %d groups marked UNAVAILABLE",
            sid, status, len(broker.shard_table.ntps_on(sid)),
        )

    async def on_shard_up(self, sid: int) -> None:
        """Re-adopt the reborn shard's groups from its on-disk state:
        the table kept every ntp -> sid binding through the crash, so
        create_partition against the same shard dir re-opens each log
        + kvstore snapshot in place, then the UNAVAILABLE marker lifts
        (epoch bump rebinds the routing caches)."""
        broker = self._sb.broker
        rt = self._sb.runtime
        if broker is None or rt is None:
            return
        rt._nemesis_act("restart.readopt", sid)
        table = broker.shard_table
        controller = broker.controller
        tt = controller.topic_table
        for ntp in table.ntps_on(sid):
            md = tt.get(ntp.tp_ns)
            a = md.assignments.get(ntp.partition) if md is not None else None
            if a is None:
                continue
            await self._sb.router.create_partition(
                sid, ntp, a.group, a.replicas, controller._log_config_for(ntp)
            )
            self.readopts += 1
        table.set_unavailable(sid, False)
        t0 = self._down_t0.pop(sid, None)
        if t0 is not None:
            self.unavailable_ms.append(
                (asyncio.get_event_loop().time() - t0) * 1e3
            )
        logger.warning("shard %d re-adopted and AVAILABLE again", sid)

    def describe(self) -> dict:
        rt = self._sb.runtime
        return {
            "auto": self.auto,
            "budget": self.budget.describe(),
            "grows": self.grows,
            "retires": self.retires,
            "rolled_back": self.rolled_back,
            "readopts": self.readopts,
            "grow_ms": [round(x, 3) for x in self.grow_ms[-16:]],
            "unavailable_ms": [
                round(x, 3) for x in self.unavailable_ms[-16:]
            ],
            "restart_ms": (
                [round(x, 3) for x in rt.restart_ms[-16:]]
                if rt is not None
                else []
            ),
        }


# ------------------------------------------------------- sharded broker
class ShardedBroker:
    """Owner of one broker's shard group. With `n_shards <= 1`, a
    stand-down condition (RP_SHARDS=0, fault injection armed), or any
    activation failure it degrades to the plain single-process Broker —
    the default loopback/NemesisNet test path is untouched."""

    def __init__(self, config, n_shards: int = 2):
        self.config = config
        self.n_shards = max(1, int(n_shards))
        self.broker = None
        self.runtime: Optional[ShardRuntime] = None
        self.router: Optional[ShardRouter] = None
        self.active = False
        self.standdown: Optional[str] = None
        self.failed = asyncio.Event()
        self._reserve_sock = None
        self._fwd_ctx: dict[int, object] = {}
        # placement layer (live moves + alert-driven rebalance); wired
        # in start() once the broker and runtime exist
        self.move_host = None
        self.mover = None
        self.rebalancer = None
        self.lifecycle = None

    async def start(self) -> None:
        from ..app import Broker

        reason = (
            "n_shards <= 1" if self.n_shards <= 1 else standdown_reason()
        )
        if reason is not None:
            self.standdown = reason
            if self.n_shards > 1:
                logger.warning(
                    "shard runtime standing down (%s): single-process broker",
                    reason,
                )
            self.broker = Broker(self.config)
            await self.broker.start()
            return
        # reserve the shared kafka port BEFORE forking so every shard
        # (parent included) binds the same number with SO_REUSEPORT
        self._reserve_sock, port = reserve_reuse_port(
            self.config.kafka_host, self.config.kafka_port
        )
        self.config.kafka_port = port
        self.config.kafka_reuse_port = True
        self.runtime = ShardRuntime(
            self.n_shards,
            self._shard_child_main,
            restart_limit=int(os.environ.get("RP_SHARD_RESTARTS", "8")),
            heartbeat_deadline=float(os.environ.get("RP_SHARD_HB_S", "5")),
        )
        self.runtime.register("rpc.out", self._rpc_out_service)
        self.runtime.register("kafka", self._kafka_service)
        self.runtime.register("placement", self._placement_service)
        self.runtime.on_crash = self._on_shard_crash
        await self.runtime.start()
        # the Broker is constructed AFTER the fork: children must not
        # inherit open storage fds or the admin/kafka listeners
        self.broker = Broker(self.config)
        self.router = ShardRouter(self.runtime, self.n_shards)
        self.broker.shard_router = self.router
        self.broker.shard_table.shard_count = self.n_shards
        self.broker.controller.shard_router = self.router
        # placement layer: the broker's shard_table IS the
        # PlacementTable (cluster/shard_table.py) — wire the live-move
        # coordinator, the alert-driven rebalancer, and the raft shard
        # seam so worker-owned groups are fully replicable
        from ..placement import MoveHost, PartitionMover, Rebalancer

        table = self.broker.shard_table
        self.move_host = MoveHost(
            self.broker.partition_manager,
            self.broker.group_manager,
            self.broker.storage.log_mgr,
        )
        self.mover = PartitionMover(table, self.move_host, router=self.router)
        self.rebalancer = Rebalancer(self.broker, self.mover, table)
        self.broker.placement_mover = self.mover
        self.broker.placement_rebalancer = self.rebalancer
        # elastic lifecycle: grow/retire coordination + the crash
        # recovery seams (UNAVAILABLE marking + on-disk re-adoption)
        self.lifecycle = ShardLifecycle(self)
        self.broker.shard_lifecycle = self.lifecycle
        self.rebalancer.lifecycle = self.lifecycle
        self.runtime.on_shard_down = self.lifecycle.on_shard_down
        self.runtime.on_shard_up = self.lifecycle.on_shard_up
        svc = self.broker.group_manager.service
        svc.shard_resolver = table.shard_for_group
        svc.shard_forward = self.router.raft_invoke
        svc.shard_epoch = lambda: table.epoch
        # invoke_on continuations served on shard 0 record into the
        # broker's flight recorder, same ring the admin surface reads
        self.runtime.ctx.recorder = self.broker.recorder
        await self.broker.start()
        # the closed loop: skew is a first-class gauge (feeds the
        # flight-data ring), the shard_skew rule judges it, and the
        # firing transition hands the alert to the rebalancer
        from ..observability import alerts as _alerts

        self.broker.metrics.gauge(
            "placement_shard_skew",
            self.rebalancer.skew,
            "cross-shard byte-rate skew index (1.0 = balanced)",
        )
        if self.broker.alerts is not None:
            self.broker.alerts.rules.append(_alerts.shard_skew_rule())
            self.broker.alerts.on_fire.append(self.rebalancer.on_alert)
        self.rebalancer.start()
        self._reserve_sock.close()
        self._reserve_sock = None
        self.active = True
        logger.info(
            "sharded broker up: node %d, %d shards on kafka port %d",
            self.config.node_id,
            self.n_shards,
            self.broker.kafka_server.port,
        )

    async def stop(self) -> None:
        rebalancer, self.rebalancer = self.rebalancer, None
        if rebalancer is not None:
            await rebalancer.stop()
        broker, self.broker = self.broker, None
        if broker is not None:
            await broker.stop()
        runtime, self.runtime = self.runtime, None
        if runtime is not None:
            await runtime.stop()
        if self._reserve_sock is not None:
            self._reserve_sock.close()
            self._reserve_sock = None
        self.active = False

    # -- child side ----------------------------------------------------
    async def _shard_child_main(self, ctx: ShardContext):
        # `self` here is the fork-time copy: config only, no Broker
        shard = PartitionShard(self.config, ctx)
        await shard.start()
        return shard.stop

    # -- parent services ----------------------------------------------
    def _on_shard_crash(self, shard_id: int, status: int) -> None:
        # with per-shard restart this only fires once the restart
        # budget is exhausted — crashes within budget recover in place
        logger.error(
            "node %d: shard %d died (status %d) and the restart budget "
            "is exhausted — broker must stop",
            self.config.node_id,
            shard_id,
            status,
        )
        self.failed.set()

    async def _rpc_out_service(self, method: str, payload: bytes) -> bytes:
        if method != "call":
            raise LookupError(f"rpc.out: no such method {method!r}")
        if self.broker is None:
            raise RuntimeError("broker not started")
        req = RpcOut.decode(payload)
        return await self.broker.send_rpc(
            req.node, req.method, bytes(req.payload), req.timeout
        )

    async def _placement_service(self, method: str, payload: bytes) -> bytes:
        """Parent-side placement endpoints: worker shards push their
        raft leadership deltas here so shard 0's metadata plane (the
        leaders table AND cross-broker dissemination gossip) covers
        worker-owned groups, and the lane map tracks their rows."""
        if method != "leader_update":
            raise LookupError(f"placement: no such method {method!r}")
        if self.broker is None:
            raise RuntimeError("broker not started")
        from ..placement.envelopes import LeaderHint, LeaderHintBatch

        batch = LeaderHintBatch.decode(payload)
        table = self.broker.shard_table
        md = self.broker.metadata_dissemination
        for raw in batch.hints:
            h = LeaderHint.decode(bytes(raw))
            ntp = _ntp_of(h.ns, h.topic, h.partition)
            table.bind_lane(h.group, h.row, chip=h.chip)
            if h.leader >= 0:
                md.apply_hint(ntp, int(h.term), int(h.leader))
        return b""

    async def _kafka_service(self, method: str, payload: bytes) -> bytes:
        from ..kafka.server import (
            ConnectionContext,
            _CloseConnection,
            _TrackedResponse,
        )

        req = KafkaFrame.decode(payload)
        if method == "close":
            self._fwd_ctx.pop(req.conn, None)
            return b""
        if method != "raw":
            raise LookupError(f"kafka: no such method {method!r}")
        if self.broker is None:
            raise RuntimeError("broker not started")
        ctx = self._fwd_ctx.get(req.conn)
        if ctx is None:
            ctx = self._fwd_ctx[req.conn] = ConnectionContext()
        ks = self.broker.kafka_server
        try:
            resp = await ks._process(bytes(req.frame), ctx)
        except _CloseConnection as e:
            data = e.args[0] if e.args else b""
            self._fwd_ctx.pop(req.conn, None)
            return KafkaFrameReply(
                has_resp=bool(data), resp=data or b"", close=True
            ).encode()
        on_written = None
        if type(resp) is _TrackedResponse:
            on_written = resp.on_written
            resp = resp.resp
        if asyncio.iscoroutine(resp):
            resp = await resp
        out = KafkaFrameReply(
            has_resp=resp is not None, resp=resp or b"", close=False
        ).encode()
        if on_written is not None:
            on_written()
        return out

    # -- conveniences --------------------------------------------------
    @property
    def kafka_port(self) -> int:
        return self.broker.kafka_server.port

    async def shard_stats(self) -> list[ShardStats]:
        if not self.active or self.router is None:
            return []
        out = []
        for sid in self.router.worker_shards():
            try:
                out.append(await self.router.stats(sid))
            except InvokeError:
                pass
        return out
