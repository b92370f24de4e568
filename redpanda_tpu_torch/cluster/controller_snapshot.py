"""Controller snapshot: bounded raft0 replay.

Reference: src/v/cluster/controller_snapshot.h:211 (the serde envelope
aggregating every controller table) and controller_stm.h's
maybe_write_snapshot — without it the controller log is replayed from
genesis on every boot and grows without bound.

The snapshot rides the generic raft snapshot container
(raft/snapshot.py SnapshotPayload + storage/snapshot.py file format):
`ControllerSnapshotter` registers as a snapshot contributor on raft
group 0, serializing every table the ControllerStm owns — topics,
members, credentials, ACLs, cluster config, features, migrations —
at the STM's applied offset. write_snapshot() then prefix-truncates
raft0, and a restarting node restores the tables from the blob and
replays only the log suffix. The same blob streams to stranded
followers via INSTALL_SNAPSHOT, exactly like data partitions.

The allocator is NOT serialized: its usage counts are a pure function
of (members, topic assignments), so restore rebuilds it — one less
table to keep bit-compatible.
"""

from __future__ import annotations

import logging

from ..models.fundamental import NTP, TopicNamespace
from ..security.acl import AclBindingE
from ..security.scram import decode_credential, encode_credential
from ..utils import serde
from .members import MembershipState
from .topic_table import PartitionAssignment, TopicMetadata

logger = logging.getLogger("cluster.controller_snapshot")


class _AssignmentE(serde.Envelope):
    SERDE_FIELDS = [
        ("partition", serde.i32),
        ("group", serde.i64),
        ("replicas", serde.vector(serde.i32)),
    ]


class _TopicE(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition_count", serde.i32),
        ("replication_factor", serde.i32),
        ("revision", serde.i64),
        ("config", serde.mapping(serde.string, serde.optional(serde.string))),
        ("assignments", serde.vector(_AssignmentE.serde())),
    ]


class _MemberE(serde.Envelope):
    SERDE_FIELDS = [
        ("node_id", serde.i32),
        ("rpc_host", serde.string),
        ("rpc_port", serde.i32),
        ("kafka_host", serde.string),
        ("kafka_port", serde.i32),
        ("state", serde.string),
        ("rack", serde.string),
        ("logical_version", serde.i32),
    ]


class _UserE(serde.Envelope):
    SERDE_FIELDS = [
        ("name", serde.string),
        ("credentials", serde.vector(serde.bytes_t)),  # _CredentialE each
    ]


class _MoveE(serde.Envelope):
    """An in-progress replica move (updates_in_progress entry)."""

    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
        ("old_replicas", serde.vector(serde.i32)),
    ]


class ControllerSnapshotE(serde.Envelope):
    """The aggregate (controller_snapshot.h:211 controller_snapshot)."""

    SERDE_FIELDS = [
        ("applied_offset", serde.i64),
        ("topics", serde.vector(_TopicE.serde())),
        ("next_group_id", serde.i64),
        ("topics_revision", serde.i64),
        ("moves", serde.vector(_MoveE.serde())),
        ("members", serde.vector(_MemberE.serde())),
        ("users", serde.vector(_UserE.serde())),
        ("acls", serde.vector(serde.bytes_t)),  # AclBindingE each
        ("config_raws", serde.mapping(serde.string, serde.string)),
        ("config_version", serde.i64),
        ("features", serde.mapping(serde.string, serde.string)),
        ("cluster_version", serde.i64),
        ("migrations", serde.vector(serde.string)),
        # v2: cluster genesis (bootstrap_backend state)
        ("cluster_uuid", serde.string),
        ("node_uuid_map", serde.mapping(serde.string, serde.i32)),
    ]

    SERDE_VERSION = 2
    SERDE_DEFAULTS = {"cluster_uuid": "", "node_uuid_map": {}}


class ControllerSnapshotter:
    """raft0 snapshot contributor (capture/restore seam).

    Registered under the name "controller" before the STM starts, so a
    boot with a local snapshot restores the tables and the STM resumes
    replay at last_included + 1 (bounded replay)."""

    def __init__(self, controller) -> None:
        self._c = controller

    # -- capture ------------------------------------------------------
    def capture_snapshot(self, upto: int) -> bytes:
        c = self._c
        tt = c.topic_table
        topics = []
        for tp_ns, md in sorted(
            tt.topics().items(), key=lambda kv: (kv[0].ns, kv[0].topic)
        ):
            topics.append(
                _TopicE(
                    ns=tp_ns.ns,
                    topic=tp_ns.topic,
                    partition_count=md.partition_count,
                    replication_factor=md.replication_factor,
                    revision=md.revision,
                    config=dict(md.config),
                    assignments=[
                        _AssignmentE(
                            partition=a.partition,
                            group=a.group,
                            replicas=[int(r) for r in a.replicas],
                        )
                        for a in md.assignments.values()
                    ],
                )
            )
        members = [
            _MemberE(
                node_id=e.node_id,
                rpc_host=e.rpc_addr[0],
                rpc_port=int(e.rpc_addr[1]),
                kafka_host=e.kafka_addr[0],
                kafka_port=int(e.kafka_addr[1]),
                state=e.state.value,
                rack=e.rack,
                logical_version=int(e.logical_version),
            )
            for e in sorted(
                c.members_table.registered().values(),
                key=lambda e: e.node_id,
            )
        ]
        users = [
            _UserE(
                name=u,
                credentials=[
                    encode_credential(cred)
                    for cred in c.credentials._users[u].values()
                ],
            )
            for u in c.credentials.users()
        ]
        acls = [
            AclBindingE.from_binding(b).encode()
            for b in sorted(
                c.acls.all(),
                key=lambda b: (
                    int(b.resource_type),
                    b.resource_name,
                    b.principal,
                    int(b.operation),
                ),
            )
        ]
        moves = [
            _MoveE(
                ns=ntp.ns,
                topic=ntp.topic,
                partition=int(ntp.partition),
                old_replicas=[int(r) for r in old],
            )
            for ntp, old in sorted(
                tt.updates_in_progress.items(),
                key=lambda kv: (kv[0].ns, kv[0].topic, kv[0].partition),
            )
        ]
        return ControllerSnapshotE(
            applied_offset=int(upto),
            topics=topics,
            next_group_id=int(tt.next_group_id),
            topics_revision=int(tt.revision),
            moves=moves,
            members=members,
            users=users,
            acls=acls,
            config_raws=dict(c.cluster_config.raw_overrides()),
            config_version=int(c.cluster_config.version),
            features=dict(c.features._state),
            cluster_version=int(c.features.cluster_version),
            migrations=sorted(c.migrations_done),
            cluster_uuid=c.cluster_uuid,
            node_uuid_map=dict(c.node_uuid_map),
        ).encode()

    # -- restore ------------------------------------------------------
    def restore_snapshot(self, blob: bytes, last_included: int) -> None:
        """Authoritative restore: a follower far enough behind receives
        this via INSTALL_SNAPSHOT at runtime, so every store is REPLACED
        (a merge would resurrect deleted users/acls/overrides)."""
        c = self._c
        snap = ControllerSnapshotE.decode(blob)
        tt = c.topic_table
        tt._topics.clear()
        c.credentials._users.clear()
        c.acls._bindings.clear()
        c.members_table._nodes.clear()
        c.migrations_done.clear()
        c.features._state.clear()
        c.allocator._counts.clear()
        c.allocator._racks.clear()
        stale_cfg = [
            k
            for k in c.cluster_config.raw_overrides()
            if k not in dict(snap.config_raws)
        ]
        if stale_cfg:
            c.cluster_config.apply({}, stale_cfg)
        for t in snap.topics:
            tp_ns = TopicNamespace(t.ns, t.topic)
            tt._topics[tp_ns] = TopicMetadata(
                tp_ns=tp_ns,
                partition_count=int(t.partition_count),
                replication_factor=int(t.replication_factor),
                revision=int(t.revision),
                assignments={
                    int(a.partition): PartitionAssignment(
                        partition=int(a.partition),
                        group=int(a.group),
                        replicas=[int(r) for r in a.replicas],
                    )
                    for a in t.assignments
                },
                config=dict(t.config),
            )
        tt.next_group_id = int(snap.next_group_id)
        tt.revision = int(snap.topics_revision)
        tt.updates_in_progress = {
            NTP(m.ns, m.topic, int(m.partition)): [
                int(r) for r in m.old_replicas
            ]
            for m in snap.moves
        }
        for m in snap.members:
            c.members_table.apply_register(
                int(m.node_id),
                (m.rpc_host, int(m.rpc_port)),
                (m.kafka_host, int(m.kafka_port)),
                rack=m.rack,
                logical_version=int(m.logical_version),
            )
            c.members_table.apply_state(
                int(m.node_id), MembershipState(m.state)
            )
        for u in snap.users:
            for raw in u.credentials:
                c.credentials.put(u.name, decode_credential(raw))
        c.acls.add(AclBindingE.decode(raw).to_binding() for raw in snap.acls)
        c.cluster_config.apply(dict(snap.config_raws), [])
        c.cluster_config.version = int(snap.config_version)
        for name, state in snap.features.items():
            c.features.apply(name, state, 0)
        c.features.cluster_version = max(
            c.features.cluster_version, int(snap.cluster_version)
        )
        c.migrations_done.update(snap.migrations)
        c.cluster_uuid = str(snap.cluster_uuid)
        c.node_uuid_map.clear()
        c.node_uuid_map.update(
            {str(k): int(v) for k, v in dict(snap.node_uuid_map).items()}
        )
        # the allocator is derived state: rebuild from members + topics
        alloc = c.allocator
        for m in snap.members:
            alloc.register_node(int(m.node_id), rack=m.rack)
        for md in tt.topics().values():
            for a in md.assignments.values():
                alloc.account(list(a.replicas))
        # the backend reconciles DELTAS, not table state (edge-driven),
        # and snapshot restore bypasses the apply path that emits them:
        # re-emit an add per restored assignment so local partitions
        # materialize. partition_manager.manage() is idempotent, so the
        # runtime install-snapshot case (partitions already live) is a
        # no-op per existing ntp.
        from .topic_table import Delta

        for md in tt.topics().values():
            for a in md.assignments.values():
                tt._pending_deltas.append(
                    Delta(
                        "add",
                        NTP(md.tp_ns.ns, md.tp_ns.topic, a.partition),
                        a.group,
                        list(a.replicas),
                    )
                )
        # resume STM replay after the snapshot boundary
        if c.stm is not None:
            c.stm.last_applied = max(c.stm.last_applied, int(last_included))
        else:
            c._stm_start_applied = int(last_included)
        tt._notify()
        logger.info(
            "controller snapshot restored at %d: %d topics, %d members, "
            "%d users",
            last_included,
            len(snap.topics),
            len(snap.members),
            len(snap.users),
        )
