"""Controller commands replicated through raft group 0.

Reference: src/v/cluster/commands.h — typed commands serialized into
`controller`-type record batches on the controller log; each record
carries (cmd_type key, envelope value). The controller_stm decodes and
applies them to the in-memory tables on every node.
"""

from __future__ import annotations

import enum

from ..models.fundamental import CONTROLLER_NTP
from ..models.record import RecordBatch, RecordBatchBuilder, RecordBatchType
from ..utils import serde


class CmdType(enum.IntEnum):
    create_topic = 0
    delete_topic = 1
    update_topic = 2
    create_user = 3
    delete_user = 4
    update_user = 5
    create_acls = 6
    delete_acls = 7
    config_set = 8
    allocate_producer_id = 9
    create_partitions = 10
    register_node = 11
    decommission_node = 12
    recommission_node = 13
    move_replicas = 14
    finish_move = 15
    feature_update = 16
    migration_done = 17
    set_maintenance = 18
    bootstrap_cluster = 19
    reserve_node_id = 20


class BootstrapClusterCmd(serde.Envelope):
    """One-shot cluster genesis (reference: cluster/bootstrap_backend.cc
    apply of bootstrap_cluster_cmd): the first raft0 leader replicates
    the cluster UUID; first write wins, replays no-op."""

    SERDE_FIELDS = [
        ("cluster_uuid", serde.string),
        ("founding_nodes", serde.vector(serde.i32)),
    ]


class ReserveNodeIdCmd(serde.Envelope):
    """node_uuid -> node_id reservation (members_manager.cc
    apply_update of add_node_cmd's id allocation): a node without a
    configured id presents its stable node UUID; retries are idempotent
    because the mapping is keyed by UUID."""

    SERDE_FIELDS = [
        ("node_uuid", serde.string),
        ("node_id", serde.i32),
    ]


class PartitionAssignmentE(serde.Envelope):
    SERDE_FIELDS = [
        ("partition", serde.i32),
        ("group", serde.i64),
        ("replicas", serde.vector(serde.i32)),
    ]


class CreateTopicCmd(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition_count", serde.i32),
        ("replication_factor", serde.i16),
        ("revision", serde.i64),
        ("assignments", serde.vector(PartitionAssignmentE.serde())),
        ("config", serde.mapping(serde.string, serde.optional(serde.string))),
    ]


class DeleteTopicCmd(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
    ]


class AllocateProducerIdCmd(serde.Envelope):
    """Producer-id allocation (reference: cluster/id_allocator_stm).

    Carries no payload: the committed controller-log offset of this
    command IS the allocated id — unique and durable with zero table
    state, where the reference replicates an explicit counter."""

    SERDE_FIELDS = []


class UpdateTopicConfigCmd(serde.Envelope):
    """Topic config overrides (reference: update_topic_properties_cmd).
    `set_configs` merge in; names in `remove_configs` revert to
    defaults."""

    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("set_configs", serde.mapping(serde.string, serde.optional(serde.string))),
        ("remove_configs", serde.vector(serde.string)),
    ]


class CreatePartitionsCmd(serde.Envelope):
    """Grow a topic's partition count (create_partition_cmd)."""

    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("new_total", serde.i32),
        ("assignments", serde.vector(PartitionAssignmentE.serde())),
    ]


class CreateUserCmd(serde.Envelope):
    """SCRAM credential upsert (user_management_cmd). `credential` is
    an encoded security.scram._CredentialE."""

    SERDE_FIELDS = [
        ("user", serde.string),
        ("credential", serde.bytes_t),
    ]


class DeleteUserCmd(serde.Envelope):
    SERDE_FIELDS = [("user", serde.string)]


class CreateAclsCmd(serde.Envelope):
    """Bindings are encoded security.acl.AclBindingE envelopes."""

    SERDE_FIELDS = [("bindings", serde.vector(serde.bytes_t))]


class DeleteAclsCmd(serde.Envelope):
    """Filter fields mirror security.acl.AclFilter; empty string for
    name/principal/host means 'any'."""

    SERDE_FIELDS = [
        ("resource_type", serde.u8),
        ("pattern_type", serde.u8),
        ("resource_name", serde.optional(serde.string)),
        ("principal", serde.optional(serde.string)),
        ("host", serde.optional(serde.string)),
        ("operation", serde.u8),
        ("permission", serde.u8),
    ]


class ConfigSetCmd(serde.Envelope):
    """Cluster-config mutation (cluster_config_delta_cmd): string
    key/values validated at the frontend, applied by every node's stm."""

    SERDE_FIELDS = [
        ("upserts", serde.mapping(serde.string, serde.string)),
        ("removes", serde.vector(serde.string)),
    ]


class RegisterNodeCmd(serde.Envelope):
    """Node join / address (re)registration (reference:
    members_manager.cc apply_update of add_node_cmd /
    update_node_cfg_cmd — one idempotent upsert here)."""

    SERDE_VERSION = 3  # v2 appended rack; v3 cluster_uuid
    SERDE_FIELDS = [
        ("node_id", serde.i32),
        ("rpc_host", serde.string),
        ("rpc_port", serde.i32),
        ("kafka_host", serde.string),
        ("kafka_port", serde.i32),
        ("rack", serde.string),  # "" = unlabeled
        # highest feature level this build understands (feature_table.h
        # latest_version): the cluster's active version is the MINIMUM
        # across members, so features activate only when every node can
        # serve them
        ("logical_version", serde.i32),
        # the cluster UUID the joiner believes it is joining; "" =
        # unknown (fresh node). A non-empty mismatch is rejected so a
        # node cannot accidentally join the wrong cluster.
        ("cluster_uuid", serde.string),
    ]
    SERDE_DEFAULTS = {"rack": "", "logical_version": 1, "cluster_uuid": ""}


class DecommissionNodeCmd(serde.Envelope):
    """Mark a node draining (decommission_node_cmd); replica moves off
    it are driven by the controller leader's drain loop."""

    SERDE_FIELDS = [("node_id", serde.i32)]


class RecommissionNodeCmd(serde.Envelope):
    SERDE_FIELDS = [("node_id", serde.i32)]


class SetMaintenanceCmd(serde.Envelope):
    """Enable/disable maintenance mode (maintenance_mode_cmd):
    leadership drains off the node, balancers mute it, replicas stay."""

    SERDE_FIELDS = [("node_id", serde.i32), ("on", serde.boolean)]


class MoveReplicasCmd(serde.Envelope):
    """Reassign one partition's replica set (move_partition_replicas_cmd).
    Applies to the topic table immediately; the raft group's joint
    reconfiguration is reconciled by the hosting nodes."""

    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
        ("replicas", serde.vector(serde.i32)),
    ]


class FinishMoveCmd(serde.Envelope):
    """Reported by the data group's leader once the raft
    reconfiguration onto `replicas` is final and committed
    (finish_moving_partition_replicas_cmd). Only now may losing nodes
    delete their local replica — removing earlier could destroy a
    committed entry's last surviving copy if the new set elects a
    laggard."""

    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
        ("replicas", serde.vector(serde.i32)),
    ]


class FeatureUpdateCmd(serde.Envelope):
    """Cluster feature activation (feature_update_cmd): replicated by
    the controller leader once every member's logical version supports
    the feature."""

    SERDE_FIELDS = [
        ("name", serde.string),
        ("state", serde.string),  # "active" | "disabled"
        ("cluster_version", serde.i32),
    ]


class MigrationDoneCmd(serde.Envelope):
    """One-shot cluster migration completion marker (migrations/):
    replicated by the leader after the migration applied so it never
    re-runs, across failovers and on replaying nodes."""

    SERDE_FIELDS = [("name", serde.string)]


CMD_CLASSES = {
    CmdType.create_topic: CreateTopicCmd,
    CmdType.delete_topic: DeleteTopicCmd,
    CmdType.allocate_producer_id: AllocateProducerIdCmd,
    CmdType.update_topic: UpdateTopicConfigCmd,
    CmdType.create_partitions: CreatePartitionsCmd,
    CmdType.create_user: CreateUserCmd,
    CmdType.delete_user: DeleteUserCmd,
    CmdType.create_acls: CreateAclsCmd,
    CmdType.delete_acls: DeleteAclsCmd,
    CmdType.config_set: ConfigSetCmd,
    CmdType.register_node: RegisterNodeCmd,
    CmdType.decommission_node: DecommissionNodeCmd,
    CmdType.recommission_node: RecommissionNodeCmd,
    CmdType.move_replicas: MoveReplicasCmd,
    CmdType.finish_move: FinishMoveCmd,
    CmdType.feature_update: FeatureUpdateCmd,
    CmdType.migration_done: MigrationDoneCmd,
    CmdType.set_maintenance: SetMaintenanceCmd,
    CmdType.bootstrap_cluster: BootstrapClusterCmd,
    CmdType.reserve_node_id: ReserveNodeIdCmd,
}


def encode_command(cmd_type: CmdType, cmd: serde.Envelope) -> RecordBatch:
    """One command → one controller record batch."""
    b = RecordBatchBuilder(
        RecordBatchType.topic_management_cmd, base_offset=0
    )
    b.add(key=bytes([int(cmd_type)]), value=cmd.encode())
    return b.build()


def decode_commands(batch: RecordBatch) -> list[tuple[CmdType, serde.Envelope]]:
    out = []
    for rec in batch.records():
        cmd_type = CmdType(rec.key[0])
        cls = CMD_CLASSES[cmd_type]
        out.append((cmd_type, cls.decode(rec.value)))
    return out
