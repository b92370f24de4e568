"""Cluster controller (reference: src/v/cluster/controller.{h,cc},
controller_stm.{h,cc}, topics_frontend.{h,cc}, controller_backend.{h,cc}).

Raft group 0 replicates controller commands to every node; the
ControllerStm applies them to the topic table; the backend reconciles
table deltas into local partitions (partition_manager.manage/remove).
Non-leader nodes route mutations to the controller leader over the
internal RPC (topics_frontend.cc:681 leader routing).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Optional

from ..models.fundamental import (
    CONTROLLER_GROUP,
    CONTROLLER_NTP,
    DEFAULT_NS,
    NTP,
    TopicNamespace,
)
from ..models.record import RecordBatch, RecordBatchType
from ..raft.consensus import NotLeaderError
from ..raft.group_manager import GroupManager
from ..raft.state_machine import StateMachine
from ..rpc.server import Service, method
from ..utils import serde
from .allocator import AllocationError, PartitionAllocator
from ..security import AclStore, Authorizer, CredentialStore
from ..security.acl import AclBinding, AclBindingE, AclFilter
from ..security.scram import decode_credential
from .commands import (
    BootstrapClusterCmd,
    ReserveNodeIdCmd,
    AllocateProducerIdCmd,
    CmdType,
    ConfigSetCmd,
    CreateAclsCmd,
    CreatePartitionsCmd,
    CreateTopicCmd,
    CreateUserCmd,
    DecommissionNodeCmd,
    DeleteAclsCmd,
    DeleteTopicCmd,
    DeleteUserCmd,
    FeatureUpdateCmd,
    FinishMoveCmd,
    MigrationDoneCmd,
    MoveReplicasCmd,
    PartitionAssignmentE,
    RecommissionNodeCmd,
    RegisterNodeCmd,
    UpdateTopicConfigCmd,
    decode_commands,
    encode_command,
)
from .features import LATEST_LOGICAL_VERSION, FeatureTable
from .members import MembersTable, MembershipState
from .partition_manager import PartitionManager
from .shard_table import ShardTable
from .topic_table import TopicTable

logger = logging.getLogger("cluster.controller")

# rpc method ids (raft uses 100-104; dissemination 210; tx 220-221;
# node_status 230)
CREATE_TOPIC = 200
DELETE_TOPIC = 201
ALLOCATE_PRODUCER_ID = 202
REPLICATE_CMD = 203  # generic leader-routed controller command
JOIN_NODE = 204  # node join: register endpoints + add as raft0 voter
ASSIGN_NODE_ID = 205  # bootstrap: node_uuid -> reserved node id


class TopicError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class _TopicReq(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partitions", serde.i32),
        ("replication_factor", serde.i16),
        ("config", serde.mapping(serde.string, serde.optional(serde.string))),
    ]


class _TopicReply(serde.Envelope):
    SERDE_FIELDS = [
        ("code", serde.string),  # "" = ok
        ("message", serde.string),
        # controller-log revision of the committed command (-1 when the
        # request failed) — the router barriers its local table on this
        # so routed mutations are read-your-writes on the calling node
        ("revision", serde.i64),
    ]


class _IdReply(serde.Envelope):
    SERDE_FIELDS = [
        ("id", serde.i64),
        ("code", serde.string),  # "" = ok
    ]


class _CmdReq(serde.Envelope):
    """Generic leader-routed controller command: the follower ships the
    already-encoded command envelope; the leader validates + replicates
    (topics_frontend.cc leader routing generalized)."""

    SERDE_FIELDS = [
        ("cmd_type", serde.u8),
        ("payload", serde.bytes_t),
    ]


class ControllerStm(StateMachine):
    """Applies committed controller batches to the topic table and the
    security stores (reference: cluster/controller_stm.h via
    raft/mux_state_machine — the mux dispatch by command family)."""

    def __init__(self, consensus, controller: "Controller"):
        super().__init__(consensus)
        self._c = controller
        self.topic_table = controller.topic_table
        self.allocator = controller.allocator

    async def apply(self, batch: RecordBatch) -> None:
        if batch.header.type != RecordBatchType.topic_management_cmd:
            return
        revision = batch.header.base_offset
        for cmd_type, cmd in decode_commands(batch):
            if cmd_type == CmdType.create_topic:
                for a in cmd.assignments:
                    self.allocator.account(list(a.replicas))
            elif cmd_type == CmdType.delete_topic:
                md = self.topic_table.get(TopicNamespace(cmd.ns, cmd.topic))
                if md is not None:
                    for a in md.assignments.values():
                        self.allocator.account(a.replicas, sign=-1)
            elif cmd_type == CmdType.create_partitions:
                for a in cmd.assignments:
                    self.allocator.account(list(a.replicas))
            elif cmd_type == CmdType.create_user:
                self._c.credentials.put(
                    cmd.user, decode_credential(cmd.credential)
                )
            elif cmd_type == CmdType.delete_user:
                self._c.credentials.remove(cmd.user)
            elif cmd_type == CmdType.create_acls:
                self._c.acls.add(
                    AclBindingE.decode(raw).to_binding()
                    for raw in cmd.bindings
                )
            elif cmd_type == CmdType.delete_acls:
                self._c.acls.remove_matching(_cmd_to_filter(cmd))
            elif cmd_type == CmdType.config_set:
                self._c.cluster_config.apply(
                    dict(cmd.upserts), list(cmd.removes)
                )
            elif cmd_type == CmdType.register_node:
                self._c.members_table.apply_register(
                    int(cmd.node_id),
                    (cmd.rpc_host, int(cmd.rpc_port)),
                    (cmd.kafka_host, int(cmd.kafka_port)),
                    rack=str(cmd.rack or ""),
                    logical_version=int(cmd.logical_version),
                )
                self.allocator.register_node(
                    int(cmd.node_id), rack=str(cmd.rack or "")
                )
            elif cmd_type == CmdType.decommission_node:
                self._c.members_table.apply_state(
                    int(cmd.node_id), MembershipState.draining
                )
            elif cmd_type == CmdType.recommission_node:
                ep = self._c.members_table.get(int(cmd.node_id))
                if ep is not None and ep.state == MembershipState.draining:
                    # recommission cancels a DECOMMISSION only; it must
                    # not clear maintenance through the wrong command
                    self._c.members_table.apply_state(
                        int(cmd.node_id), MembershipState.active
                    )
            elif cmd_type == CmdType.set_maintenance:
                ep = self._c.members_table.get(int(cmd.node_id))
                if cmd.on:
                    # the STM is the authoritative guard (the API-side
                    # check runs on a possibly-stale follower view):
                    # maintenance must never overwrite an in-progress
                    # decommission
                    if ep is None or ep.state != MembershipState.draining:
                        self._c.members_table.apply_state(
                            int(cmd.node_id), MembershipState.maintenance
                        )
                elif (
                    ep is not None
                    and ep.state == MembershipState.maintenance
                ):
                    # off only leaves MAINTENANCE: it must never cancel
                    # an in-progress decommission (draining)
                    self._c.members_table.apply_state(
                        int(cmd.node_id), MembershipState.active
                    )
            elif cmd_type == CmdType.feature_update:
                self._c.features.apply(
                    cmd.name, cmd.state, int(cmd.cluster_version)
                )
            elif cmd_type == CmdType.migration_done:
                self._c.migrations_done.add(cmd.name)
            elif cmd_type == CmdType.bootstrap_cluster:
                # first write wins: genesis happens exactly once
                if not self._c.cluster_uuid:
                    self._c.cluster_uuid = str(cmd.cluster_uuid)
            elif cmd_type == CmdType.reserve_node_id:
                uuid_ = str(cmd.node_uuid)
                if uuid_ not in self._c.node_uuid_map:
                    nid = int(cmd.node_id)
                    taken = set(
                        self._c.members_table.node_ids()
                    ) | set(self._c.node_uuid_map.values())
                    if nid in taken:
                        # two leaders (or two in-flight reservations)
                        # raced to the same id: remap deterministically
                        # — every replica computes the same next-free
                        nid = max(taken, default=-1) + 1
                    self._c.node_uuid_map[uuid_] = nid
            elif cmd_type == CmdType.move_replicas:
                md = self.topic_table.get(TopicNamespace(cmd.ns, cmd.topic))
                if md is not None:
                    a = md.assignments.get(int(cmd.partition))
                    new = [int(r) for r in cmd.replicas]
                    if a is not None and a.replicas != new:
                        self.allocator.account(a.replicas, sign=-1)
                        self.allocator.account(new)
            # topic_table.apply handles its own families and bumps the
            # applied revision for every command type, which is what
            # wait_revision barriers on
            self.topic_table.apply(cmd_type, cmd, revision)


def _cmd_to_filter(cmd: DeleteAclsCmd) -> AclFilter:
    from ..security.acl import (
        AclOperation,
        AclPatternType,
        AclPermission,
        AclResourceType,
    )

    return AclFilter(
        resource_type=AclResourceType(int(cmd.resource_type)),
        pattern_type=AclPatternType(int(cmd.pattern_type)),
        resource_name=cmd.resource_name,
        principal=cmd.principal,
        host=cmd.host,
        operation=AclOperation(int(cmd.operation)),
        permission=AclPermission(int(cmd.permission)),
    )


class ControllerService(Service):
    """Leader-routed topic mutations (reference: cluster/controller.json)."""

    def __init__(self, controller: "Controller"):
        self._controller = controller

    @method(CREATE_TOPIC)
    async def create_topic(self, payload: bytes) -> bytes:
        req = _TopicReq.decode(payload)
        try:
            await self._controller.create_topic_local(
                req.ns,
                req.topic,
                int(req.partitions),
                int(req.replication_factor),
                dict(req.config),
            )
            return _TopicReply(code="", message="", revision=-1).encode()
        except TopicError as e:
            return _TopicReply(code=e.code, message=e.message, revision=-1).encode()
        except NotLeaderError:
            return _TopicReply(code="not_controller", message="", revision=-1).encode()

    @method(ALLOCATE_PRODUCER_ID)
    async def allocate_producer_id(self, payload: bytes) -> bytes:
        try:
            pid = await self._controller.allocate_producer_id_local()
            return _IdReply(id=pid, code="").encode()
        except NotLeaderError:
            return _IdReply(id=-1, code="not_controller").encode()
        except Exception as e:
            return _IdReply(id=-1, code=f"error: {e}").encode()

    @method(REPLICATE_CMD)
    async def replicate_cmd(self, payload: bytes) -> bytes:
        req = _CmdReq.decode(payload)
        from .commands import CMD_CLASSES

        cmd_type = CmdType(int(req.cmd_type))
        cmd = CMD_CLASSES[cmd_type].decode(req.payload)
        try:
            if cmd_type == CmdType.create_partitions and not cmd.assignments:
                # follower-routed grow request: the LEADER allocates
                base = await self._controller._create_partitions_local(
                    cmd.ns, cmd.topic, int(cmd.new_total)
                )
            else:
                base = await self._controller.replicate_cmd_local(
                    cmd_type, cmd
                )
            return _TopicReply(code="", message="", revision=base).encode()
        except TopicError as e:
            return _TopicReply(
                code=e.code, message=e.message, revision=-1
            ).encode()
        except NotLeaderError:
            return _TopicReply(
                code="not_controller", message="", revision=-1
            ).encode()

    @method(ASSIGN_NODE_ID)
    async def assign_node_id(self, payload: bytes) -> bytes:
        node_uuid = payload.decode("utf-8", "replace")
        try:
            nid = await self._controller.assign_node_id_local(node_uuid)
            return _TopicReply(code="", message="", revision=nid).encode()
        except NotLeaderError:
            return _TopicReply(
                code="not_controller", message="", revision=-1
            ).encode()
        except Exception as e:
            return _TopicReply(
                code="error", message=str(e), revision=-1
            ).encode()

    @method(JOIN_NODE)
    async def join_node(self, payload: bytes) -> bytes:
        cmd = RegisterNodeCmd.decode(payload)
        try:
            base = await self._controller.join_node_local(cmd)
            return _TopicReply(code="", message="", revision=base).encode()
        except TopicError as e:
            return _TopicReply(
                code=e.code, message=e.message, revision=-1
            ).encode()
        except NotLeaderError:
            return _TopicReply(
                code="not_controller", message="", revision=-1
            ).encode()

    @method(DELETE_TOPIC)
    async def delete_topic(self, payload: bytes) -> bytes:
        req = _TopicReq.decode(payload)
        try:
            await self._controller.delete_topic_local(req.ns, req.topic)
            return _TopicReply(code="", message="", revision=-1).encode()
        except TopicError as e:
            return _TopicReply(code=e.code, message=e.message, revision=-1).encode()
        except NotLeaderError:
            return _TopicReply(code="not_controller", message="", revision=-1).encode()


class Controller:
    def __init__(
        self,
        node_id: int,
        group_manager: GroupManager,
        partition_manager: PartitionManager,
        shard_table: ShardTable,
        members: list[int],
        send: Callable,  # async (node, method, payload, timeout) -> bytes
    ):
        self.node_id = node_id
        self._gm = group_manager
        self._pm = partition_manager
        self._shards = shard_table
        self.seeds = list(members)
        self._send = send
        self.topic_table = TopicTable()
        self.allocator = PartitionAllocator()
        self.credentials = CredentialStore()
        self.acls = AclStore()
        self.authorizer = Authorizer(self.acls)
        self.members_table = MembersTable()
        self.features = FeatureTable()
        # replicated one-shot migration completion set (migrations/)
        self.migrations_done: set[str] = set()
        # advertise an older feature level (mixed-version test seam)
        self._logical_version_override: int | None = None
        from .feature_barrier import FeatureBarrier

        self.barrier = FeatureBarrier(
            node_id, send, members=lambda: self.members
        )
        # followers enter feature-activation barriers implicitly when
        # their build speaks the required version
        self.barrier.register_auto_enter(
            "feature:", self._feature_barrier_ready
        )
        from ..config import ClusterConfig

        self.cluster_config = ClusterConfig()
        for m in members:
            self.members_table.seed(m)
            self.allocator.register_node(m)
        self.consensus = None
        self.stm: Optional[ControllerStm] = None
        self.service = ControllerService(self)
        self._backend_task: Optional[asyncio.Task] = None
        self._create_lock = asyncio.Lock()
        self._local_next_group = 1
        self._move_tasks: dict = {}
        # async (ntp, partition) hook run after the backend creates a
        # local partition (Broker wires cloud recovery seeding here)
        self.on_partition_added = None
        # leadership view for the balancer (Broker assigns its
        # dissemination-fed PartitionLeadersTable after construction)
        self.leaders_table = None
        # ssx.ShardRouter when worker shards are active: the backend
        # routes data-partition create/remove to the owning shard
        self.shard_router = None
        self._balance_ticks = 0
        self._barrier_defer_until = 0.0
        # cluster genesis state (bootstrap_backend): "" until the first
        # leader replicates the UUID; node_uuid -> reserved node id
        self.cluster_uuid = ""
        self.node_uuid_map: dict[str, int] = {}
        self._reserve_lock = asyncio.Lock()
        self.leader_balancer_enabled = True
        self.partition_balancer_enabled = True
        self._closed = False

    @property
    def logical_version_override(self) -> int | None:
        return self._logical_version_override

    @logical_version_override.setter
    def logical_version_override(self, v: int | None) -> None:
        """Only OLDER levels may be advertised: a value above this
        build's LATEST would replicate a cluster_version no real build
        can match — and cluster_version is monotonic, so every genuine
        build would be locked out of joins forever."""
        if v is not None and not (1 <= v <= LATEST_LOGICAL_VERSION):
            raise ValueError(
                f"logical_version must be in [1, {LATEST_LOGICAL_VERSION}]: {v}"
            )
        self._logical_version_override = v

    @property
    def members(self) -> list[int]:
        """All known cluster members (registered + unregistered seeds)."""
        return self.members_table.node_ids()

    # -- lifecycle ---------------------------------------------------
    async def start(self) -> None:
        self.consensus = await self._gm.create_group(
            int(CONTROLLER_GROUP), voters=self.seeds
        )
        # controller snapshot (ref cluster/controller_snapshot.h:211):
        # register BEFORE the STM starts — registration restores a
        # local snapshot's tables, and the STM then replays only the
        # raft0 suffix behind it (bounded boot replay)
        from .controller_snapshot import ControllerSnapshotter

        self._snapshotter = ControllerSnapshotter(self)
        self._stm_start_applied: int | None = None
        self.consensus.register_snapshot_contributor(
            "controller", self._snapshotter
        )
        self.stm = ControllerStm(self.consensus, self)
        if self._stm_start_applied is not None:
            self.stm.last_applied = self._stm_start_applied
        await self.stm.start()
        self._backend_task = asyncio.ensure_future(self._backend_loop())

    async def stop(self) -> None:
        self._closed = True
        for t in list(self._move_tasks.values()):
            t.cancel()
        self._move_tasks.clear()
        if self._backend_task is not None:
            self._backend_task.cancel()
            try:
                await self._backend_task
            except asyncio.CancelledError:
                pass
        if self.stm is not None:
            await self.stm.stop()

    @property
    def is_leader(self) -> bool:
        return self.consensus is not None and self.consensus.is_leader()

    @property
    def leader_id(self) -> Optional[int]:
        return None if self.consensus is None else self.consensus.leader_id

    async def wait_leader(self, timeout: float = 10.0) -> int:
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            lid = self.leader_id
            if lid is not None and lid >= 0:
                return int(lid)
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError("no controller leader")
            await asyncio.sleep(0.02)

    # -- frontend ----------------------------------------------------
    async def create_topic(
        self,
        topic: str,
        partitions: int,
        replication_factor: int,
        config: dict[str, str | None] | None = None,
        ns: str = DEFAULT_NS,
        timeout: float = 10.0,
    ) -> None:
        """Create from any node: routes to the controller leader."""
        req = _TopicReq(
            ns=ns,
            topic=topic,
            partitions=partitions,
            replication_factor=replication_factor,
            config=config or {},
        )
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            if self.is_leader:
                await self.create_topic_local(
                    ns, topic, partitions, replication_factor, config or {}
                )
                return
            leader = await self.wait_leader(
                max(0.01, deadline - asyncio.get_event_loop().time())
            )
            raw = await self._send(leader, CREATE_TOPIC, req.encode(), 5.0)
            reply = _TopicReply.decode(raw)
            if reply.code == "":
                # table convergence on THIS node before returning, so a
                # follow-up metadata request sees the topic
                await self._wait_topic_visible(ns, topic, deadline)
                return
            if reply.code == "not_controller":
                if asyncio.get_event_loop().time() > deadline:
                    raise TopicError("request_timed_out", "controller moved")
                await asyncio.sleep(0.05)
                continue
            raise TopicError(reply.code, reply.message)

    async def _wait_topic_visible(
        self, ns: str, topic: str, deadline: float
    ) -> None:
        tp = TopicNamespace(ns, topic)
        while not self.topic_table.contains(tp):
            if asyncio.get_event_loop().time() > deadline:
                raise TopicError("request_timed_out", "topic not visible")
            await asyncio.sleep(0.01)

    async def create_topic_local(
        self,
        ns: str,
        topic: str,
        partitions: int,
        replication_factor: int,
        config: dict[str, str | None],
    ) -> None:
        """Leader-side create (topics_frontend.cc:95 create_topics)."""
        if self.consensus is None or not self.is_leader:
            raise NotLeaderError(self.leader_id)
        if partitions <= 0:
            raise TopicError("invalid_partitions", f"partitions={partitions}")
        if replication_factor <= 0 or replication_factor % 2 == 0:
            raise TopicError(
                "invalid_replication_factor",
                f"replication_factor={replication_factor} (must be odd)",
            )
        async with self._create_lock:
            tp = TopicNamespace(ns, topic)
            if self.topic_table.contains(tp):
                raise TopicError("topic_already_exists", str(tp))
            next_group = max(
                self._local_next_group, self.topic_table.next_group_id
            )
            try:
                assignments = self.allocator.allocate(
                    partitions,
                    replication_factor,
                    next_group,
                    exclude=self._muted_nodes(),
                )
            except AllocationError:
                # maintenance is a SOFT preference (replicas may stay on
                # such nodes): when the cluster is too small to avoid
                # them — RF == cluster size during a rolling restart —
                # retry excluding only decommissioning nodes
                try:
                    assignments = self.allocator.allocate(
                        partitions,
                        replication_factor,
                        next_group,
                        exclude=self._draining_nodes(),
                    )
                except AllocationError as e:
                    raise TopicError(
                        "invalid_replication_factor", str(e)
                    ) from None
            self._local_next_group = next_group + partitions
            cmd = CreateTopicCmd(
                ns=ns,
                topic=topic,
                partition_count=partitions,
                replication_factor=replication_factor,
                revision=0,
                assignments=[
                    PartitionAssignmentE(
                        partition=a.partition,
                        group=a.group,
                        replicas=a.replicas,
                    )
                    for a in assignments
                ],
                config=config,
            )
            batch = encode_command(CmdType.create_topic, cmd)
            try:
                base, _ = await self.consensus.replicate(batch, acks=-1)
            except Exception:
                # allocation rollback: command never committed
                for a in assignments:
                    self.allocator.account(a.replicas, sign=-1)
                raise
            # double-account guard: stm apply also accounts — undo ours
            for a in assignments:
                self.allocator.account(a.replicas, sign=-1)
            await self.topic_table.wait_revision(base)

    # -- generic command replication (users/acls/config/partitions) ---
    async def replicate_cmd_local(self, cmd_type: CmdType, cmd) -> int:
        if self.consensus is None or not self.is_leader:
            raise NotLeaderError(self.leader_id)
        self._validate_cmd(cmd_type, cmd)
        batch = encode_command(cmd_type, cmd)
        base, _ = await self.consensus.replicate(batch, acks=-1)
        await self.topic_table.wait_revision(base)
        return base

    def _validate_cmd(self, cmd_type: CmdType, cmd) -> None:
        if cmd_type in (CmdType.update_topic, CmdType.create_partitions):
            tp = TopicNamespace(cmd.ns, cmd.topic)
            if not self.topic_table.contains(tp):
                raise TopicError("unknown_topic_or_partition", str(tp))
        if cmd_type == CmdType.delete_user and not self.credentials.contains(
            cmd.user
        ):
            raise TopicError("unknown_server_error", f"no such user {cmd.user}")

    async def replicate_cmd(
        self,
        cmd_type: CmdType,
        cmd,
        timeout: float = 10.0,
        local: Optional[Callable] = None,
    ) -> None:
        """Replicate a controller command from any node (leader-routed).

        `local` overrides the leader-side execution (e.g. partition
        growth, where only the leader may allocate). On the routed path
        the reply's revision barriers this node's table so the mutation
        is read-your-writes wherever the client is connected."""
        deadline = asyncio.get_event_loop().time() + timeout
        req = _CmdReq(cmd_type=int(cmd_type), payload=cmd.encode()).encode()
        while True:
            if self.is_leader:
                if local is not None:
                    await local()
                else:
                    await self.replicate_cmd_local(cmd_type, cmd)
                return
            leader = await self.wait_leader(
                max(0.01, deadline - asyncio.get_event_loop().time())
            )
            raw = await self._send(leader, REPLICATE_CMD, req, 5.0)
            reply = _TopicReply.decode(raw)
            if reply.code == "":
                if reply.revision >= 0:
                    await self.topic_table.wait_revision(
                        reply.revision,
                        max(
                            0.01,
                            deadline - asyncio.get_event_loop().time(),
                        ),
                    )
                return
            if reply.code == "not_controller":
                if asyncio.get_event_loop().time() > deadline:
                    raise TopicError("request_timed_out", "controller moved")
                await asyncio.sleep(0.05)
                continue
            raise TopicError(reply.code, reply.message)

    # -- membership frontends ------------------------------------------
    async def _bootstrap_pass(self) -> None:
        """Replicate the cluster UUID once (cluster_discovery.cc
        create_cluster: the first raft0 leader performs genesis)."""
        if self.cluster_uuid:
            return
        import secrets as _secrets

        cmd = BootstrapClusterCmd(
            cluster_uuid=_secrets.token_hex(16),
            founding_nodes=list(self.seeds),
        )
        try:
            await self.replicate_cmd_local(CmdType.bootstrap_cluster, cmd)
        except Exception:
            return  # lost leadership / timeout: the next tick retries

    async def assign_node_id_local(self, node_uuid: str) -> int:
        """Reserve a node id for a stable node UUID (members_manager
        id allocation). Idempotent: a retry with the same UUID gets
        the same id."""
        if self.consensus is None or not self.is_leader:
            raise NotLeaderError(self.leader_id)
        async with self._reserve_lock:  # concurrent uuids must not
            # read the same `taken` set and race to one id
            existing = self.node_uuid_map.get(node_uuid)
            if existing is not None:
                return existing
            taken = set(self.members_table.node_ids()) | set(
                self.node_uuid_map.values()
            )
            nid = max(taken, default=-1) + 1
            await self.replicate_cmd_local(
                CmdType.reserve_node_id,
                ReserveNodeIdCmd(node_uuid=node_uuid, node_id=nid),
            )
            # the STM mapping is authoritative: a cross-leader race is
            # resolved by its deterministic remap on apply
            return self.node_uuid_map.get(node_uuid, nid)

    async def join_node_local(self, cmd: RegisterNodeCmd) -> int:
        """Leader side of a node join (members_manager.cc
        handle_join_request): replicate the registration, then add the
        node to raft group 0's voter set if it isn't one yet."""
        if self.consensus is None or not self.is_leader:
            raise NotLeaderError(self.leader_id)
        # version gate (handle_join_request): a build below the ACTIVE
        # cluster version cannot replay feature-gated controller
        # commands (e.g. MigrationDoneCmd) — admitting it would wedge
        # its state machine mid-replay
        if int(cmd.logical_version) < self.features.cluster_version:
            raise TopicError(
                "invalid_request",
                f"node {cmd.node_id} build version {cmd.logical_version} "
                f"< active cluster version {self.features.cluster_version}",
            )
        joiner_uuid = str(getattr(cmd, "cluster_uuid", "") or "")
        if joiner_uuid and self.cluster_uuid and joiner_uuid != self.cluster_uuid:
            # wrong-cluster guard (cluster_discovery.cc UUID check)
            raise TopicError(
                "invalid_cluster",
                f"node {cmd.node_id} believes cluster "
                f"{joiner_uuid[:8]}…, this is {self.cluster_uuid[:8]}…",
            )
        base = await self.replicate_cmd_local(CmdType.register_node, cmd)
        nid = int(cmd.node_id)
        voters = list(self.consensus.config.voters)
        if nid not in voters:
            await self.consensus.change_configuration(voters + [nid])
        return base

    async def join_cluster(
        self,
        rpc_addr: tuple[str, int],
        kafka_addr: tuple[str, int],
        rack: str = "",
        timeout: float = 15.0,
    ) -> None:
        """Joiner side (cluster_discovery.cc): announce this node's
        endpoints to the cluster through any seed, retrying around
        leadership placement. Seeds also call this to register their
        own addresses (idempotent upsert)."""
        cmd = RegisterNodeCmd(
            node_id=self.node_id,
            rpc_host=rpc_addr[0],
            rpc_port=int(rpc_addr[1]),
            kafka_host=kafka_addr[0],
            kafka_port=int(kafka_addr[1]),
            rack=rack,
            # override = mixed-version testing seam (the reference's
            # redpanda_installer runs real old builds; here the build
            # ADVERTISES an older feature level instead)
            logical_version=self.local_logical_version,
            cluster_uuid=self.cluster_uuid,
        )
        deadline = asyncio.get_event_loop().time() + timeout
        payload = cmd.encode()
        while True:
            if self.is_leader:
                await self.join_node_local(cmd)
                return
            last_err = "no seed reachable"
            for seed in self.seeds:
                if seed == self.node_id:
                    continue
                try:
                    raw = await self._send(seed, JOIN_NODE, payload, 5.0)
                except Exception as e:
                    last_err = f"seed {seed}: {e}"
                    continue
                reply = _TopicReply.decode(raw)
                if reply.code == "":
                    if reply.revision >= 0:
                        await self.topic_table.wait_revision(
                            reply.revision,
                            max(
                                0.01,
                                deadline
                                - asyncio.get_event_loop().time(),
                            ),
                        )
                    return
                if reply.code == "invalid_request":
                    # PERMANENT: the version gate (build too old for
                    # the active cluster) — retrying cannot succeed,
                    # and a silently-unregistered broker serves nothing
                    raise TopicError(reply.code, f"join: {reply.message}")
                last_err = reply.code
            if asyncio.get_event_loop().time() > deadline:
                raise TopicError("request_timed_out", f"join: {last_err}")
            await asyncio.sleep(0.1)

    async def decommission_node(self, node_id: int) -> None:
        """Mark draining; the leader's drain pass then moves every
        replica off it (members_backend.cc reallocation loop)."""
        if node_id not in self.members_table:
            raise TopicError("unknown_server_error", f"no node {node_id}")
        await self.replicate_cmd(
            CmdType.decommission_node, DecommissionNodeCmd(node_id=node_id)
        )

    async def set_maintenance(self, node_id: int, on: bool) -> None:
        """Maintenance mode (members_manager maintenance_mode_cmd):
        replicated flag; the leader's maintenance pass then transfers
        leaderships away and the balancers mute the node. Replicas
        stay — disable restores normal placement with zero movement."""
        from .commands import SetMaintenanceCmd

        ep = self.members_table.get(node_id)
        if ep is None:
            raise TopicError("broker_not_available", f"node {node_id} unknown")
        if on and ep.state == MembershipState.draining:
            raise TopicError(
                "invalid_request", f"node {node_id} is decommissioning"
            )
        await self.replicate_cmd(
            CmdType.set_maintenance, SetMaintenanceCmd(node_id=node_id, on=on)
        )

    async def recommission_node(self, node_id: int) -> None:
        await self.replicate_cmd(
            CmdType.recommission_node, RecommissionNodeCmd(node_id=node_id)
        )

    async def move_partition_replicas(
        self, topic: str, partition: int, replicas: list[int], ns: str = DEFAULT_NS
    ) -> None:
        """Reassign one partition's replica set
        (topics_frontend.cc move_partition_replicas)."""
        md = self.topic_table.get(TopicNamespace(ns, topic))
        if md is None:
            raise TopicError("unknown_topic_or_partition", topic)
        if partition not in md.assignments:
            raise TopicError("unknown_topic_or_partition", f"{topic}/{partition}")
        if not replicas or len(set(replicas)) != len(replicas):
            raise TopicError(
                "invalid_replication_factor",
                f"replica set must be non-empty and distinct: {replicas}",
            )
        for r in replicas:
            if r not in self.members_table:
                raise TopicError("unknown_server_error", f"no node {r}")
        await self.replicate_cmd(
            CmdType.move_replicas,
            MoveReplicasCmd(
                ns=ns, topic=topic, partition=partition, replicas=replicas
            ),
        )

    # -- cluster config frontend ---------------------------------------
    async def set_cluster_config(
        self, upserts: dict[str, str], removes: list[str] | None = None
    ) -> None:
        """Validate then replicate a config delta; every node's stm
        applies it and fires local bindings (config_frontend.cc)."""
        from ..config import ConfigError

        removes = list(removes or [])
        for name, raw in upserts.items():
            try:
                self.cluster_config.validate(name, raw)
            except ConfigError as e:
                raise TopicError("invalid_config", str(e)) from None
        for name in removes:
            if name not in self.cluster_config.properties():
                raise TopicError("invalid_config", f"unknown property {name}")
        await self.replicate_cmd(
            CmdType.config_set,
            ConfigSetCmd(upserts=dict(upserts), removes=removes),
        )

    # -- security frontends -------------------------------------------
    async def create_user(self, user: str, credential_raw: bytes) -> None:
        await self.replicate_cmd(
            CmdType.create_user,
            CreateUserCmd(user=user, credential=credential_raw),
        )

    async def delete_user(self, user: str) -> None:
        await self.replicate_cmd(CmdType.delete_user, DeleteUserCmd(user=user))

    async def create_acls(self, bindings: list[AclBinding]) -> None:
        await self.replicate_cmd(
            CmdType.create_acls,
            CreateAclsCmd(
                bindings=[AclBindingE.from_binding(b).encode() for b in bindings]
            ),
        )

    async def delete_acls(self, flt: AclFilter) -> list[AclBinding]:
        """Replicates the delete; returns the bindings that matched
        LOCALLY at call time (the response preview — the authoritative
        removal happens in every node's stm apply)."""
        matched = self.acls.describe(flt)
        await self.replicate_cmd(
            CmdType.delete_acls,
            DeleteAclsCmd(
                resource_type=int(flt.resource_type),
                pattern_type=int(flt.pattern_type),
                resource_name=flt.resource_name,
                principal=flt.principal,
                host=flt.host,
                operation=int(flt.operation),
                permission=int(flt.permission),
            ),
        )
        return matched

    # -- topic mutation frontends -------------------------------------
    async def update_topic_config(
        self,
        topic: str,
        set_configs: dict[str, str | None],
        remove_configs: list[str],
        ns: str = DEFAULT_NS,
    ) -> None:
        await self.replicate_cmd(
            CmdType.update_topic,
            UpdateTopicConfigCmd(
                ns=ns,
                topic=topic,
                set_configs=set_configs,
                remove_configs=remove_configs,
            ),
        )

    async def create_partitions(
        self, topic: str, new_total: int, ns: str = DEFAULT_NS
    ) -> None:
        """Grow partition count; allocation happens on the leader, so
        the routed command ships empty assignments (the leader branch
        of the REPLICATE_CMD service allocates + fills them in)."""
        if self.topic_table.get(TopicNamespace(ns, topic)) is None:
            raise TopicError("unknown_topic_or_partition", topic)
        await self.replicate_cmd(
            CmdType.create_partitions,
            CreatePartitionsCmd(
                ns=ns, topic=topic, new_total=new_total, assignments=[]
            ),
            local=lambda: self._create_partitions_local(ns, topic, new_total),
        )

    async def _create_partitions_local(
        self, ns: str, topic: str, new_total: int
    ) -> int:
        if self.consensus is None or not self.is_leader:
            raise NotLeaderError(self.leader_id)
        async with self._create_lock:
            md = self.topic_table.get(TopicNamespace(ns, topic))
            if md is None:
                raise TopicError("unknown_topic_or_partition", topic)
            if new_total <= md.partition_count:
                raise TopicError(
                    "invalid_partitions",
                    f"new count {new_total} <= current {md.partition_count}",
                )
            add = new_total - md.partition_count
            next_group = max(
                self._local_next_group, self.topic_table.next_group_id
            )
            try:
                assignments = self.allocator.allocate(
                    add,
                    md.replication_factor,
                    next_group,
                    exclude=self._muted_nodes(),
                )
            except AllocationError:
                # soft maintenance mute: same fallback as create_topic
                try:
                    assignments = self.allocator.allocate(
                        add,
                        md.replication_factor,
                        next_group,
                        exclude=self._draining_nodes(),
                    )
                except AllocationError as e:
                    raise TopicError(
                        "invalid_replication_factor", str(e)
                    ) from None
            self._local_next_group = next_group + add
            cmd = CreatePartitionsCmd(
                ns=ns,
                topic=topic,
                new_total=new_total,
                assignments=[
                    PartitionAssignmentE(
                        partition=md.partition_count + i,
                        group=a.group,
                        replicas=a.replicas,
                    )
                    for i, a in enumerate(assignments)
                ],
            )
            batch = encode_command(CmdType.create_partitions, cmd)
            try:
                base, _ = await self.consensus.replicate(batch, acks=-1)
            except Exception:
                for a in assignments:
                    self.allocator.account(a.replicas, sign=-1)
                raise
            for a in assignments:
                self.allocator.account(a.replicas, sign=-1)
            await self.topic_table.wait_revision(base)
            return base

    async def allocate_producer_id_local(self) -> int:
        """Leader-side id allocation: the command's committed offset is
        the id (see AllocateProducerIdCmd)."""
        if self.consensus is None or not self.is_leader:
            raise NotLeaderError(self.leader_id)
        batch = encode_command(
            CmdType.allocate_producer_id, AllocateProducerIdCmd()
        )
        base, _ = await self.consensus.replicate(batch, acks=-1)
        return base

    async def allocate_producer_id(self, timeout: float = 10.0) -> int:
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            if self.is_leader:
                return await self.allocate_producer_id_local()
            leader = await self.wait_leader(
                max(0.01, deadline - asyncio.get_event_loop().time())
            )
            raw = await self._send(leader, ALLOCATE_PRODUCER_ID, b"", 5.0)
            reply = _IdReply.decode(raw)
            if reply.code == "":
                return int(reply.id)
            if asyncio.get_event_loop().time() > deadline:
                raise TopicError("request_timed_out", "id allocation failed")
            await asyncio.sleep(0.05)

    async def delete_topic_local(self, ns: str, topic: str) -> None:
        if self.consensus is None or not self.is_leader:
            raise NotLeaderError(self.leader_id)
        tp = TopicNamespace(ns, topic)
        if not self.topic_table.contains(tp):
            raise TopicError("unknown_topic_or_partition", str(tp))
        batch = encode_command(
            CmdType.delete_topic, DeleteTopicCmd(ns=ns, topic=topic)
        )
        base, _ = await self.consensus.replicate(batch, acks=-1)
        await self.topic_table.wait_revision(base)

    async def delete_topic(
        self, topic: str, ns: str = DEFAULT_NS, timeout: float = 10.0
    ) -> None:
        req = _TopicReq(
            ns=ns, topic=topic, partitions=0, replication_factor=1, config={}
        )
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            if self.is_leader:
                await self.delete_topic_local(ns, topic)
                return
            leader = await self.wait_leader(
                max(0.01, deadline - asyncio.get_event_loop().time())
            )
            raw = await self._send(leader, DELETE_TOPIC, req.encode(), 5.0)
            reply = _TopicReply.decode(raw)
            if reply.code == "":
                return
            if reply.code == "not_controller":
                if asyncio.get_event_loop().time() > deadline:
                    raise TopicError("request_timed_out", "controller moved")
                await asyncio.sleep(0.05)
                continue
            raise TopicError(reply.code, reply.message)

    # -- backend reconciliation --------------------------------------
    # entries of raft0 history a boot may replay before we compact
    # (controller_stm.h maybe_write_snapshot; every node snapshots its
    # own raft0 locally — the trigger needs no coordination)
    SNAPSHOT_MAX_REPLAY = 1024

    def _maybe_snapshot(self) -> None:
        """Write a controller snapshot + prefix-truncate raft0 once the
        replayable history behind the applied offset exceeds the
        threshold. Runs on EVERY node (each keeps its own raft0 copy
        bounded), exactly like per-node data-partition snapshots."""
        c, stm = self.consensus, self.stm
        if c is None or stm is None or stm.last_applied < 0:
            return
        if stm.last_applied - c._snap_index < self.SNAPSHOT_MAX_REPLAY:
            return
        try:
            c.write_snapshot(last_included=stm.last_applied)
        except Exception:
            logger.exception("node %d: controller snapshot failed", self.node_id)

    def _shard_for_new(self, d) -> int:
        """Worker shard that should own a new partition, or 0 (local).

        The policy lives in the placement layer now
        (PlacementTable.assign): internal/coordinator topics keep the
        shard-0 path, every default-namespace data partition spreads —
        replicated groups included (the raft shard seam forwards their
        inbound RPC; RP_PLACEMENT_PIN=1 restores the v1 shard-0 pin
        for A/B baselines)."""
        if self.shard_router is None:
            return 0
        return self._shards.assign(
            d.ntp, d.group, list(d.replicas), self.node_id
        )

    async def _backend_loop(self) -> None:
        """Turn topic_table deltas into local partition create/remove
        (reference: cluster/controller_backend.{h,cc}); periodically
        runs the leader-only drain pass for decommissioning nodes."""
        while not self._closed:
            deltas = self.topic_table.drain_deltas()
            if not deltas:
                try:
                    await self.topic_table.wait_change(timeout=1.0)
                except Exception:
                    pass
                await self._move_repair_pass()
                self._maybe_snapshot()
                if self.is_leader:
                    await self._bootstrap_pass()
                    await self._maintenance_pass()
                    await self._feature_pass()
                    await self._migration_pass()
                    await self._drain_pass()
                    self._balance_ticks += 1
                    if self._balance_ticks >= 5:  # ~5s of idle ticks
                        self._balance_ticks = 0
                        await self._leader_balance_pass()
                        await self._partition_balance_pass()
                continue
            for d in deltas:
                try:
                    if d.kind == "add" and self.node_id in d.replicas:
                        shard = self._shard_for_new(d)
                        if shard:
                            # shard-owned: create on the worker shard
                            # and record ownership. Single-voter groups
                            # elect themselves instantly — advertise us
                            # as leader so metadata doesn't wait; for
                            # replicated groups the real leader arrives
                            # via the worker's leader-hint relay
                            # (ssx/sharded_broker.py placement service)
                            await self.shard_router.create_partition(
                                shard,
                                d.ntp,
                                d.group,
                                d.replicas,
                                self._log_config_for(d.ntp),
                            )
                            self._shards.insert(d.ntp, d.group, shard)
                            if (
                                self.leaders_table is not None
                                and list(d.replicas) == [self.node_id]
                            ):
                                self.leaders_table.update(d.ntp, self.node_id)
                            continue
                        p = await self._pm.manage(
                            d.ntp,
                            d.group,
                            d.replicas,
                            log_config=self._log_config_for(d.ntp),
                        )
                        self._shards.insert(d.ntp, d.group)
                        row = p.consensus.row
                        self._shards.bind_lane(
                            d.group, row,
                            chip=self._gm.arrays.chip_of(row),
                        )
                        if self.on_partition_added is not None:
                            await self.on_partition_added(d.ntp, p)
                    elif d.kind == "del" and self.node_id in d.replicas:
                        shard = self._shards.shard_for(d.ntp)
                        self._shards.erase(d.ntp, d.group)
                        if shard and self.shard_router is not None:
                            await self.shard_router.remove_partition(
                                shard, d.ntp
                            )
                        else:
                            await self._pm.remove(d.ntp)
                    elif d.kind == "cfg":
                        p = self._pm.get(d.ntp)
                        if p is not None:
                            p.log.config = self._log_config_for(d.ntp)
                    elif d.kind == "move":
                        await self._reconcile_move(d)
                    elif d.kind == "purge":
                        # reconfiguration is final (finish_move
                        # committed): losers drop their local replica
                        if (
                            self.node_id not in d.replicas
                            and self._pm.get(d.ntp) is not None
                        ):
                            t = self._move_tasks.pop(d.ntp, None)
                            if t is not None:
                                t.cancel()
                            self._shards.erase(d.ntp, d.group)
                            await self._pm.remove(d.ntp)
                except Exception:
                    logger.exception(
                        "node %d: reconciliation failed for %s", self.node_id, d.ntp
                    )

    async def _reconcile_move(self, d) -> None:
        """One node's share of a replica move. Gaining nodes create the
        raft instance against the OLD replica set (they are not voters
        yet — the group leader's joint reconfiguration adds them); every
        hosting node then runs a convergence task that (a) retries
        change_configuration whenever it is the leader and the config
        is stale, and (b) removes the local replica once the final
        config excludes this node. Reference: controller_backend.cc
        update stages + raft change_configuration."""
        if self.node_id in d.replicas:
            if self._pm.get(d.ntp) is None:
                p = await self._pm.manage(
                    d.ntp,
                    d.group,
                    d.old_replicas,
                    log_config=self._log_config_for(d.ntp),
                )
                self._shards.insert(d.ntp, d.group)
                row = p.consensus.row
                self._shards.bind_lane(
                    d.group, row, chip=self._gm.arrays.chip_of(row)
                )
        if self._pm.get(d.ntp) is None:
            return  # not hosting; nothing to converge
        prev = self._move_tasks.pop(d.ntp, None)
        if prev is not None:
            prev.cancel()
        self._move_tasks[d.ntp] = asyncio.ensure_future(
            self._converge_move(d.ntp, d.group, list(d.replicas))
        )

    async def _converge_move(
        self, ntp, group: int, target: list[int], timeout: float = 30.0
    ) -> None:
        """Drive the data group's raft config to `target`, then report
        completion through the controller log (finish_move) so losing
        nodes purge safely. A node being REMOVED may never see the
        final config batch (the leader drops it from the replication
        set at append time) — it simply waits here until the purge
        delta deletes its partition and the task with it."""
        deadline = asyncio.get_event_loop().time() + timeout
        want = set(target)
        while not self._closed:
            p = self._pm.get(ntp)
            if p is None:
                self._move_tasks.pop(ntp, None)
                return
            c = p.consensus
            last_cfg_offset = (
                c._config_history[-1][0] if c._config_history else -1
            )
            done = (
                not c.config.is_joint()
                and set(c.config.voters) == want
                and c.commit_index >= last_cfg_offset
            )
            if done:
                if c.is_leader():
                    # only the group leader reports: it KNOWS the final
                    # config committed (its own commit_index covers it)
                    try:
                        await self.replicate_cmd(
                            CmdType.finish_move,
                            FinishMoveCmd(
                                ns=ntp.ns,
                                topic=ntp.topic,
                                partition=ntp.partition,
                                replicas=target,
                            ),
                        )
                        self._move_tasks.pop(ntp, None)
                        return
                    except Exception as e:
                        logger.info(
                            "g%d move: finish report failed: %s", group, e
                        )
                elif self.node_id not in want:
                    # safe self-removal: our own commit_index covers the
                    # final config batch, so the new replica set has
                    # committed it — unlike the stuck-joint case (which
                    # waits for the leader's finish_move → purge), no
                    # committed entry can depend on this copy anymore
                    self._move_tasks.pop(ntp, None)
                    self._shards.erase(ntp, group)
                    await self._pm.remove(ntp)
                    return
                else:
                    self._move_tasks.pop(ntp, None)
                    return
            elif c.is_leader():
                try:
                    await c.change_configuration(target)
                except Exception as e:
                    logger.info(
                        "g%d move: reconfig attempt failed: %s", group, e
                    )
            if asyncio.get_event_loop().time() > deadline:
                logger.warning("g%d move to %s: convergence timed out", group, target)
                self._move_tasks.pop(ntp, None)
                return
            await asyncio.sleep(0.1)

    def _muted_nodes(self) -> set[int]:
        """Nodes no leadership or new replicas should land on:
        decommissioning (draining) plus maintenance."""
        return {
            nid
            for nid in self.members_table.node_ids()
            if (ep := self.members_table.get(nid)) is not None
            and ep.state
            in (MembershipState.draining, MembershipState.maintenance)
        }

    def _draining_nodes(self) -> set[int]:
        return {
            nid
            for nid in self.members_table.node_ids()
            if self.members_table.is_draining(nid)
        }

    async def _move_repair_pass(self) -> None:
        """Level-triggered repair (controller_backend reconciliation
        fibers): any hosted partition whose raft config disagrees with
        the topic-table assignment gets a (re)spawned convergence task.
        Heals moves whose delta-driven task timed out or died with the
        process — the assignment in raft0 is the durable intent."""
        scanned = 0
        for ntp, p in list(self._pm.partitions().items()):
            scanned += 1
            if (scanned & 127) == 0:
                # cooperative yield: at 1k hosted partitions this scan
                # is ~2ms of inline dict/set work per tick — run as one
                # chunk it lands squarely in produce tail latency
                await asyncio.sleep(0)
            md = self.topic_table.get(ntp.tp_ns)
            if md is None:
                continue
            a = md.assignments.get(ntp.partition)
            if a is None:
                continue
            want = set(a.replicas)
            c = p.consensus
            converged = not c.config.is_joint() and set(c.config.voters) == want
            stale_local = converged and self.node_id not in want
            if (not converged or stale_local) and ntp not in self._move_tasks:
                self._move_tasks[ntp] = asyncio.ensure_future(
                    self._converge_move(ntp, a.group, list(a.replicas))
                )

    @property
    def local_logical_version(self) -> int:
        """The feature level this node advertises (override = the
        mixed-version test seam)."""
        return (
            self._logical_version_override
            if self._logical_version_override is not None
            else LATEST_LOGICAL_VERSION
        )

    def _feature_barrier_ready(self, tag: str) -> bool:
        """Auto-enter predicate for feature:<name>:<version> tags."""
        try:
            need = int(tag.rsplit(":", 1)[1])
        except (IndexError, ValueError):
            return False
        return self.local_logical_version >= need

    async def _feature_pass(self) -> None:
        """Leader-only: activate features the whole membership now
        supports (feature_manager.cc maybe_update_active_version). The
        active cluster version is min(member logical versions) over
        REGISTERED members — unregistered seeds hold activation back
        since their build level is unknown."""
        regs = self.members_table.registered()
        if not regs or len(regs) < len(self.members_table.node_ids()):
            return
        versions = [ep.logical_version for ep in regs.values()]
        pending = self.features.pending_activations(versions)
        if not pending:
            return
        cluster_version = min(versions)
        now = asyncio.get_event_loop().time()
        if now < self._barrier_defer_until:
            return  # a recent incomplete barrier: don't stall every tick
        for f in pending:
            # rendezvous BEFORE activating (feature_barrier): the
            # version table proves members advertised support at
            # registration; the barrier proves they are alive and
            # ready NOW. A down node defers activation to a later pass.
            tag = f"feature:{f.name}:{f.required_version}"
            if not await self.barrier.enter(tag, timeout=1.5):
                self._barrier_defer_until = (
                    asyncio.get_event_loop().time() + 5.0
                )
                logger.info(
                    "feature_manager: barrier %s incomplete; deferring",
                    tag,
                )
                return
            try:
                await self.replicate_cmd_local(
                    CmdType.feature_update,
                    FeatureUpdateCmd(
                        name=f.name,
                        state="active",
                        cluster_version=cluster_version,
                    ),
                )
                logger.info(
                    "feature_manager: activated %s (cluster version %d)",
                    f.name,
                    cluster_version,
                )
            except Exception:
                logger.warning(
                    "feature_manager: activation of %s failed; will retry",
                    f.name,
                    exc_info=True,
                )
                return

    async def _migration_pass(self) -> None:
        """Leader-only: run feature-gated one-shot migrations that have
        not yet replicated a completion marker (migrations/ driven by
        feature activation). apply() is idempotent; the marker only
        lands after it succeeds."""
        from .migrations import registered

        for m in registered():
            if m.name in self.migrations_done:
                continue
            if not self.features.is_active(m.feature):
                continue
            try:
                await m.apply(self)
                await self.replicate_cmd_local(
                    CmdType.migration_done, MigrationDoneCmd(name=m.name)
                )
                logger.info("migration %s completed", m.name)
            except Exception:
                logger.warning(
                    "migration %s failed; will retry", m.name, exc_info=True
                )
                return

    async def _leader_balance_pass(self) -> None:
        """Leader-only greedy leadership rebalancing
        (cluster/leader_balancer.cc): when the most-loaded node leads
        at least 2 more partitions than the least-loaded, ask it to
        hand one suitable leadership over. One transfer per pass keeps
        churn bounded; repeated passes converge."""
        if not self.leader_balancer_enabled or self.leaders_table is None:
            return
        alive = set(self.members_table.node_ids())
        muted = self._muted_nodes()
        counts: dict[int, int] = {
            n: 0 for n in alive if n not in muted
        }
        led: dict[int, list] = {n: [] for n in counts}
        for tp_ns, md in self.topic_table.topics().items():
            for a in md.assignments.values():
                ntp = NTP(tp_ns.ns, tp_ns.topic, a.partition)
                # locally-hosted replicas know their leader
                # authoritatively (heartbeats); the gossip table covers
                # partitions this node doesn't host
                local = self._pm.get(ntp)
                if local is not None and local.consensus.leader_id is not None:
                    leader = int(local.consensus.leader_id)
                else:
                    leader = self.leaders_table.get(ntp)
                if leader in counts:
                    counts[leader] += 1
                    led[leader].append((ntp, a))
        if len(counts) < 2:
            return
        from ..raft import types as rt

        hot = max(counts, key=counts.get)
        # best candidate: among partitions the hot node leads, the
        # replica with the FEWEST leaderships that can actually take
        # this one (the globally-coldest node may host none of them)
        best = None  # (target_count, ntp, assignment, target)
        for ntp, a in led[hot]:
            eligible = [
                r
                for r in a.replicas
                if r != hot and r in counts
            ]
            if not eligible:
                continue
            target = min(eligible, key=lambda r: counts[r])
            if best is None or counts[target] < best[0]:
                best = (counts[target], ntp, a, target)
        if best is None or counts[hot] - best[0] < 2:
            return
        _tc, ntp, a, cold = best
        try:
            if hot == self.node_id:
                p = self._pm.get(ntp)
                if p is None or not p.consensus.is_leader():
                    return  # stale view; recount next pass
                await p.consensus.transfer_leadership(cold)
            else:
                req = rt.TransferLeadershipRequest(
                    group=a.group, target=cold
                ).encode()
                raw = await self._send(hot, rt.TRANSFER_LEADERSHIP, req, 5.0)
                reply = rt.TransferLeadershipReply.decode(raw)
                if not reply.success:
                    return
            logger.info(
                "leader_balancer: moved %s leadership %d -> %d (counts %s)",
                ntp,
                hot,
                cold,
                counts,
            )
        except Exception:
            pass

    async def _partition_balance_pass(self) -> None:  # muted-aware
        """Leader-only: even out REPLICA counts across active members
        (cluster/partition_balancer_backend.cc, count-based subset).
        When the most-loaded node holds 2+ more replicas than the
        least-loaded, move ONE replica of one partition — the move
        machinery (joint reconfiguration + finish_move purge) does the
        rest. Joins therefore pull existing data onto new nodes without
        an operator issuing moves."""
        if not self.partition_balancer_enabled:
            return
        if self.topic_table.updates_in_progress:
            # cluster-wide in-flight bound (replicated via move/finish
            # commands, so EVERY controller leader sees it — the local
            # converge-task dict only exists on hosting nodes)
            return
        draining = self._muted_nodes()  # decommissioning OR maintenance
        active = [
            n
            for n in self.members_table.node_ids()
            if n not in draining and self.members_table.get(n) is not None
        ]
        if len(active) < 2:
            return
        counts = {n: 0 for n in active}
        assignments = []
        for tp_ns, md in self.topic_table.topics().items():
            for a in md.assignments.values():
                assignments.append((tp_ns, a))
                for r in a.replicas:
                    if r in counts:
                        counts[r] += 1
        hot = max(counts, key=counts.get)
        if counts[hot] - min(counts.values()) < 2:
            return
        for tp_ns, a in assignments:
            if hot not in a.replicas:
                continue
            # rack-aware target via the same constraint logic the
            # drain path uses — never trade balance for rack diversity
            target = self.allocator.pick_replacement(
                a.replicas, exclude=draining
            )
            if target is None or counts[hot] - counts.get(target, 0) < 2:
                continue
            new = [target if r == hot else r for r in a.replicas]
            try:
                await self.move_partition_replicas(
                    tp_ns.topic, a.partition, new, ns=tp_ns.ns
                )
                logger.info(
                    "partition_balancer: moving %s/%d replica %d -> %d "
                    "(counts %s)",
                    tp_ns.topic,
                    a.partition,
                    hot,
                    target,
                    counts,
                )
            except Exception:
                logger.exception(
                    "partition_balancer: move %s/%d failed",
                    tp_ns.topic,
                    a.partition,
                )
            return

    async def _maintenance_pass(self) -> None:
        """Leader-only: transfer ONE leadership per pass off each
        maintenance-mode node (drain_manager.cc leadership drain —
        replicas stay put, unlike decommission's replica moves)."""
        maint = {
            nid
            for nid in self.members_table.node_ids()
            if (ep := self.members_table.get(nid)) is not None
            and ep.state == MembershipState.maintenance
        }
        if not maint or self.leaders_table is None:
            return
        from ..raft import types as rt

        muted = self._muted_nodes()
        transferred: set[int] = set()
        for tp_ns, md in self.topic_table.topics().items():
            for a in md.assignments.values():
                ntp = NTP(tp_ns.ns, tp_ns.topic, a.partition)
                local = self._pm.get(ntp)
                if local is not None and local.consensus.leader_id is not None:
                    leader = int(local.consensus.leader_id)
                else:
                    leader = self.leaders_table.get(ntp)
                if leader not in maint or leader in transferred:
                    continue
                targets = [r for r in a.replicas if r not in muted]
                for target in targets:
                    # try each candidate: a single dead replica must
                    # not block the drain when a healthy one exists
                    try:
                        if leader == self.node_id:
                            p = self._pm.get(ntp)
                            if p is None or not p.consensus.is_leader():
                                break
                            await p.consensus.transfer_leadership(target)
                        else:
                            req = rt.TransferLeadershipRequest(
                                group=a.group, target=target
                            ).encode()
                            await self._send(
                                leader, rt.TRANSFER_LEADERSHIP, req, 5.0
                            )
                        transferred.add(leader)
                        break
                    except Exception:
                        logger.info(
                            "maintenance drain: transfer %s %d->%d failed",
                            ntp, leader, target,
                        )
                        continue

    async def _drain_pass(self) -> None:
        """Leader-only: move replicas off draining nodes, one partition
        per draining node per pass (members_backend.cc incremental
        reallocation)."""
        draining = [
            nid
            for nid in self.members_table.node_ids()
            if self.members_table.is_draining(nid)
        ]
        if not draining:
            return
        muted = self._muted_nodes()  # supersets draining; computed once
        for nid in draining:
            moved = False
            for tp_ns, md in list(self.topic_table.topics().items()):
                if moved:
                    break
                for a in md.assignments.values():
                    if nid not in a.replicas:
                        continue
                    repl = self.allocator.pick_replacement(
                        a.replicas, exclude=muted
                    )
                    if repl is None:
                        continue  # this partition is stuck; try others
                    new = [repl if r == nid else r for r in a.replicas]
                    try:
                        await self.move_partition_replicas(
                            tp_ns.topic, a.partition, new, ns=tp_ns.ns
                        )
                    except Exception:
                        logger.exception(
                            "drain: move %s/%d failed", tp_ns.topic, a.partition
                        )
                    moved = True  # one move per node per pass
                    break

    def _log_config_for(self, ntp: NTP):
        from ..storage.log import LogConfig

        md = self.topic_table.get(ntp.tp_ns)
        out = LogConfig.from_topic_config(md.config if md else {})
        # cluster-level default applies when the topic sets nothing
        # (configuration.cc delete_retention_ms default)
        if out.retention_ms is None and (
            md is None or "retention.ms" not in md.config
        ):
            if out.deletion_enabled:
                out.retention_ms = int(
                    self.cluster_config.get("default_topic_retention_ms")
                )
        return out


async def discover_node_id(
    send,  # async (node, method, payload, timeout) -> bytes
    seeds: list[int],
    node_uuid: str,
    timeout: float = 15.0,
) -> int:
    """Pre-start node-id discovery (cluster_discovery.cc): a node
    configured without an id asks the seeds for its reservation before
    constructing the broker. Retries around leadership placement; the
    reservation is idempotent (keyed by node_uuid)."""
    import asyncio as _asyncio

    deadline = _asyncio.get_event_loop().time() + timeout
    payload = node_uuid.encode()
    last = "no seed reachable"
    while _asyncio.get_event_loop().time() < deadline:
        for seed in seeds:
            try:
                raw = await send(seed, ASSIGN_NODE_ID, payload, 5.0)
            except Exception as e:
                last = f"seed {seed}: {e}"
                continue
            reply = _TopicReply.decode(raw)
            if reply.code == "" and reply.revision >= 0:
                return int(reply.revision)
            last = str(reply.code)
        await _asyncio.sleep(0.1)
    raise TimeoutError(f"node-id discovery failed: {last}")
