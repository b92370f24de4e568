"""ACL / config / partition-admin / leader-epoch handlers.

Reference: src/v/kafka/server/handlers/{describe_acls,create_acls,
delete_acls,describe_configs,alter_configs,incremental_alter_configs,
offset_for_leader_epoch,create_partitions}.cc.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..models.fundamental import DEFAULT_NS, TopicNamespace, kafka_ntp
from ..security.acl import (
    AclBinding,
    AclFilter,
    AclOperation,
    AclPatternType,
    AclPermission,
    AclResourceType,
)
from .protocol import ErrorCode, Msg
from .protocol.admin_apis import (
    ALTER_CONFIGS,
    ALTER_PARTITION_REASSIGNMENTS,
    CREATE_ACLS,
    CREATE_PARTITIONS,
    DELETE_ACLS,
    DELETE_RECORDS,
    DESCRIBE_ACLS,
    DESCRIBE_CONFIGS,
    DESCRIBE_LOG_DIRS,
    DESCRIBE_PRODUCERS,
    INCREMENTAL_ALTER_CONFIGS,
    LIST_PARTITION_REASSIGNMENTS,
    OFFSET_DELETE,
    OFFSET_FOR_LEADER_EPOCH,
)

if TYPE_CHECKING:  # pragma: no cover
    from .server import KafkaServer

# ConfigResource types (Kafka wire)
_RES_TOPIC = 2
_RES_BROKER = 4

# defaults surfaced by DescribeConfigs when a topic has no override
TOPIC_CONFIG_DEFAULTS: dict[str, str] = {
    "cleanup.policy": "delete",
    "compression.type": "producer",
    "retention.ms": "604800000",
    "retention.bytes": "-1",
    "segment.bytes": "134217728",
    "min.insync.replicas": "1",
    "max.message.bytes": "1048576",
}

BROKER_CONFIG: dict[str, str] = {
    "log.dirs": "<data-dir>",
    "num.network.threads": "1",
    "auto.create.topics.enable": "false",
}


def install(server: "KafkaServer") -> None:
    h = AdminHandlers(server)
    server._handlers.update(
        {
            DESCRIBE_ACLS.key: h.describe_acls,
            CREATE_ACLS.key: h.create_acls,
            DELETE_ACLS.key: h.delete_acls,
            DESCRIBE_CONFIGS.key: h.describe_configs,
            ALTER_CONFIGS.key: h.alter_configs,
            INCREMENTAL_ALTER_CONFIGS.key: h.incremental_alter_configs,
            OFFSET_FOR_LEADER_EPOCH.key: h.offset_for_leader_epoch,
            CREATE_PARTITIONS.key: h.create_partitions,
            DELETE_RECORDS.key: h.delete_records,
            OFFSET_DELETE.key: h.offset_delete,
            DESCRIBE_LOG_DIRS.key: h.describe_log_dirs,
            ALTER_PARTITION_REASSIGNMENTS.key: h.alter_partition_reassignments,
            LIST_PARTITION_REASSIGNMENTS.key: h.list_partition_reassignments,
            DESCRIBE_PRODUCERS.key: h.describe_producers,
        }
    )


def _filter_from(req_or_row, v1: bool) -> AclFilter:
    """Raises ValueError on out-of-range enum values (newer clients send
    operations/resource types we don't model); callers map that to
    invalid_request rather than dropping the connection."""
    # v0 has no pattern-type field and means LITERAL (plus the implicit
    # wildcard name), not ANY — a v0 filter must not match PREFIXED
    # bindings it cannot represent
    pt = getattr(req_or_row, "pattern_type_filter", 3) if v1 else 3
    return AclFilter(
        resource_type=AclResourceType(req_or_row.resource_type_filter or 1),
        pattern_type=AclPatternType(pt or 1),
        resource_name=req_or_row.resource_name_filter,
        principal=req_or_row.principal_filter,
        host=req_or_row.host_filter,
        operation=AclOperation(req_or_row.operation or 1),
        permission=AclPermission(req_or_row.permission_type or 1),
    )


class AdminHandlers:
    def __init__(self, server: "KafkaServer"):
        self.server = server

    @property
    def controller(self):
        return self.server.broker.controller

    # -- acls ---------------------------------------------------------
    async def describe_acls(self, hdr, req) -> Msg:
        if not self.server.authorize(
            AclOperation.describe, AclResourceType.cluster, "kafka-cluster"
        ):
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.cluster_authorization_failed),
                error_message=None,
                resources=[],
            )
        try:
            flt = _filter_from(req, hdr.api_version >= 1)
        except ValueError as e:
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.invalid_request),
                error_message=str(e),
                resources=[],
            )
        by_resource: dict[tuple, list[AclBinding]] = {}
        for b in self.controller.acls.describe(flt):
            by_resource.setdefault(
                (int(b.resource_type), b.resource_name, int(b.pattern_type)), []
            ).append(b)
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            error_message=None,
            resources=[
                Msg(
                    resource_type=rt,
                    resource_name=name,
                    pattern_type=pt,
                    acls=[
                        Msg(
                            principal=b.principal,
                            host=b.host,
                            operation=int(b.operation),
                            permission_type=int(b.permission),
                        )
                        for b in rows
                    ],
                )
                for (rt, name, pt), rows in sorted(by_resource.items())
            ],
        )

    async def create_acls(self, hdr, req) -> Msg:
        from ..cluster.controller import TopicError

        if not self.server.authorize(
            AclOperation.alter, AclResourceType.cluster, "kafka-cluster"
        ):
            return Msg(
                throttle_time_ms=0,
                results=[
                    Msg(
                        error_code=int(ErrorCode.cluster_authorization_failed),
                        error_message=None,
                    )
                    for _ in req.creations
                ],
            )
        bindings = []
        rows = []
        for c in req.creations:
            try:
                rt = AclResourceType(c.resource_type)
                pt = AclPatternType(getattr(c, "resource_pattern_type", 3) or 3)
                op = AclOperation(c.operation)
                perm = AclPermission(c.permission_type)
                # filter-only wildcards (ANY/MATCH) describe nothing the
                # authorizer can evaluate — a binding stored with them
                # would be silently dead, so reject at creation like
                # create_acls.cc does
                if (
                    rt in (AclResourceType.any,)
                    or pt in (AclPatternType.any, AclPatternType.match)
                    or op == AclOperation.any
                    or perm == AclPermission.any
                ):
                    raise ValueError(
                        "filter-only enum value in ACL binding"
                    )
                bindings.append(
                    AclBinding(
                        rt,
                        pt,
                        c.resource_name,
                        c.principal,
                        c.host,
                        op,
                        perm,
                    )
                )
                rows.append(Msg(error_code=0, error_message=None))
            except ValueError as e:
                rows.append(
                    Msg(
                        error_code=int(ErrorCode.invalid_request),
                        error_message=str(e),
                    )
                )
        if bindings:
            try:
                await self.controller.create_acls(bindings)
            except (TopicError, TimeoutError):
                rows = [
                    Msg(
                        error_code=int(ErrorCode.request_timed_out),
                        error_message=None,
                    )
                    for _ in req.creations
                ]
        return Msg(throttle_time_ms=0, results=rows)

    async def delete_acls(self, hdr, req) -> Msg:
        from ..cluster.controller import TopicError

        if not self.server.authorize(
            AclOperation.alter, AclResourceType.cluster, "kafka-cluster"
        ):
            return Msg(
                throttle_time_ms=0,
                filter_results=[
                    Msg(
                        error_code=int(ErrorCode.cluster_authorization_failed),
                        error_message=None,
                        matching_acls=[],
                    )
                    for _ in req.filters
                ],
            )
        out = []
        for f in req.filters:
            try:
                flt = _filter_from(f, hdr.api_version >= 1)
            except ValueError as e:
                out.append(
                    Msg(
                        error_code=int(ErrorCode.invalid_request),
                        error_message=str(e),
                        matching_acls=[],
                    )
                )
                continue
            try:
                matched = await self.controller.delete_acls(flt)
                out.append(
                    Msg(
                        error_code=0,
                        error_message=None,
                        matching_acls=[
                            Msg(
                                error_code=0,
                                error_message=None,
                                resource_type=int(b.resource_type),
                                resource_name=b.resource_name,
                                pattern_type=int(b.pattern_type),
                                principal=b.principal,
                                host=b.host,
                                operation=int(b.operation),
                                permission_type=int(b.permission),
                            )
                            for b in matched
                        ],
                    )
                )
            except (TopicError, TimeoutError):
                out.append(
                    Msg(
                        error_code=int(ErrorCode.request_timed_out),
                        error_message=None,
                        matching_acls=[],
                    )
                )
        return Msg(throttle_time_ms=0, filter_results=out)

    # -- configs ------------------------------------------------------
    def _topic_configs(self, name: str) -> dict[str, tuple[str | None, bool]]:
        """name -> (value, is_default)."""
        md = self.controller.topic_table.get(TopicNamespace(DEFAULT_NS, name))
        if md is None:
            return {}
        out = {k: (v, True) for k, v in TOPIC_CONFIG_DEFAULTS.items()}
        for k, v in md.config.items():
            out[k] = (v, False)
        return out

    async def describe_configs(self, hdr, req) -> Msg:
        results = []
        for r in req.resources:
            if not self.server.authorize(
                AclOperation.describe_configs,
                AclResourceType.topic
                if r.resource_type == _RES_TOPIC
                else AclResourceType.cluster,
                r.resource_name if r.resource_type == _RES_TOPIC else "kafka-cluster",
            ):
                results.append(
                    Msg(
                        error_code=int(
                            ErrorCode.topic_authorization_failed
                            if r.resource_type == _RES_TOPIC
                            else ErrorCode.cluster_authorization_failed
                        ),
                        error_message=None,
                        resource_type=r.resource_type,
                        resource_name=r.resource_name,
                        configs=[],
                    )
                )
                continue
            if r.resource_type == _RES_TOPIC:
                cfg = self._topic_configs(r.resource_name)
                if not cfg:
                    results.append(
                        Msg(
                            error_code=int(ErrorCode.unknown_topic_or_partition),
                            error_message=None,
                            resource_type=r.resource_type,
                            resource_name=r.resource_name,
                            configs=[],
                        )
                    )
                    continue
            elif r.resource_type == _RES_BROKER:
                cfg = {k: (v, True) for k, v in BROKER_CONFIG.items()}
            else:
                results.append(
                    Msg(
                        error_code=int(ErrorCode.invalid_request),
                        error_message=f"resource type {r.resource_type}",
                        resource_type=r.resource_type,
                        resource_name=r.resource_name,
                        configs=[],
                    )
                )
                continue
            wanted = (
                set(r.configuration_keys)
                if r.configuration_keys is not None
                else None
            )
            results.append(
                Msg(
                    error_code=0,
                    error_message=None,
                    resource_type=r.resource_type,
                    resource_name=r.resource_name,
                    configs=[
                        Msg(
                            name=k,
                            value=v,
                            read_only=False,
                            is_default=is_default,
                            config_source=5 if is_default else 1,
                            is_sensitive=False,
                            synonyms=[],
                        )
                        for k, (v, is_default) in sorted(cfg.items())
                        if wanted is None or k in wanted
                    ],
                )
            )
        return Msg(throttle_time_ms=0, results=results)

    async def _alter_topic(self, name: str, sets, removes) -> int:
        from ..cluster.controller import TopicError

        try:
            await self.controller.update_topic_config(
                name, set_configs=sets, remove_configs=removes
            )
            return 0
        except TopicError as e:
            from .server import _topic_error_code

            return _topic_error_code(e.code)
        except TimeoutError:
            return int(ErrorCode.request_timed_out)

    async def alter_configs(self, hdr, req) -> Msg:
        out = []
        for r in req.resources:
            if r.resource_type != _RES_TOPIC:
                out.append(
                    Msg(
                        error_code=int(ErrorCode.invalid_request),
                        error_message="only topic configs are alterable",
                        resource_type=r.resource_type,
                        resource_name=r.resource_name,
                    )
                )
                continue
            if not self.server.authorize(
                AclOperation.alter_configs,
                AclResourceType.topic,
                r.resource_name,
            ):
                out.append(
                    Msg(
                        error_code=int(ErrorCode.topic_authorization_failed),
                        error_message=None,
                        resource_type=r.resource_type,
                        resource_name=r.resource_name,
                    )
                )
                continue
            code = 0
            if not req.validate_only:
                # AlterConfigs semantics: the FULL config set is
                # replaced — unlisted overrides revert to defaults
                sets = {c.name: c.value for c in r.configs}
                current = self._topic_configs(r.resource_name)
                removes = [
                    k
                    for k, (_v, is_default) in current.items()
                    if not is_default and k not in sets
                ]
                code = await self._alter_topic(r.resource_name, sets, removes)
            out.append(
                Msg(
                    error_code=code,
                    error_message=None,
                    resource_type=r.resource_type,
                    resource_name=r.resource_name,
                )
            )
        return Msg(throttle_time_ms=0, responses=out)

    async def incremental_alter_configs(self, hdr, req) -> Msg:
        out = []
        for r in req.resources:
            if r.resource_type != _RES_TOPIC:
                out.append(
                    Msg(
                        error_code=int(ErrorCode.invalid_request),
                        error_message="only topic configs are alterable",
                        resource_type=r.resource_type,
                        resource_name=r.resource_name,
                    )
                )
                continue
            if not self.server.authorize(
                AclOperation.alter_configs,
                AclResourceType.topic,
                r.resource_name,
            ):
                out.append(
                    Msg(
                        error_code=int(ErrorCode.topic_authorization_failed),
                        error_message=None,
                        resource_type=r.resource_type,
                        resource_name=r.resource_name,
                    )
                )
                continue
            sets: dict[str, str | None] = {}
            removes: list[str] = []
            bad = False
            for c in r.configs:
                if c.config_operation == 0:  # SET
                    sets[c.name] = c.value
                elif c.config_operation == 1:  # DELETE
                    removes.append(c.name)
                else:  # APPEND/SUBTRACT (list configs) unsupported
                    bad = True
            if bad:
                out.append(
                    Msg(
                        error_code=int(ErrorCode.invalid_request),
                        error_message="unsupported config operation",
                        resource_type=r.resource_type,
                        resource_name=r.resource_name,
                    )
                )
                continue
            code = 0
            if not req.validate_only:
                code = await self._alter_topic(r.resource_name, sets, removes)
            out.append(
                Msg(
                    error_code=code,
                    error_message=None,
                    resource_type=r.resource_type,
                    resource_name=r.resource_name,
                )
            )
        return Msg(throttle_time_ms=0, responses=out)

    # -- offsets / partitions -----------------------------------------
    async def offset_for_leader_epoch(self, hdr, req) -> Msg:
        topics = []
        for t in req.topics:
            parts = []
            for p in t.partitions:
                partition = self.server.broker.partition_manager.get(
                    kafka_ntp(t.topic, p.partition)
                )
                if partition is None or not partition.is_leader:
                    parts.append(
                        Msg(
                            error_code=int(ErrorCode.not_leader_for_partition),
                            partition=p.partition,
                            leader_epoch=-1,
                            end_offset=-1,
                        )
                    )
                    continue
                epoch, end = partition.offset_for_leader_epoch(p.leader_epoch)
                parts.append(
                    Msg(
                        error_code=0,
                        partition=p.partition,
                        leader_epoch=epoch,
                        end_offset=end,
                    )
                )
            topics.append(Msg(topic=t.topic, partitions=parts))
        return Msg(topics=topics)

    async def create_partitions(self, hdr, req) -> Msg:
        from ..cluster.controller import TopicError
        from .server import _topic_error_code

        out = []
        for t in req.topics:
            if not self.server.authorize(
                AclOperation.alter, AclResourceType.topic, t.name
            ):
                out.append(
                    Msg(
                        name=t.name,
                        error_code=int(ErrorCode.topic_authorization_failed),
                        error_message=None,
                    )
                )
                continue
            code, message = 0, None
            if t.assignments is not None:
                code = int(ErrorCode.invalid_request)
                message = "manual assignments not supported"
            elif not req.validate_only:
                try:
                    await self.controller.create_partitions(t.name, t.count)
                except TopicError as e:
                    code, message = _topic_error_code(e.code), e.message
                except TimeoutError:
                    code = int(ErrorCode.request_timed_out)
            out.append(Msg(name=t.name, error_code=code, error_message=message))
        return Msg(throttle_time_ms=0, results=out)

    async def delete_records(self, hdr, req) -> Msg:
        """Kafka DeleteRecords (handlers/delete_records.cc): advance a
        partition's log start; a replicated marker carries the floor to
        every replica. Feature-gated: in a mixed-version cluster an
        older node would mis-handle the floor marker, so the API stays
        off until every member's build supports it."""
        if not self.controller.features.is_active("delete_records"):
            return Msg(
                throttle_time_ms=0,
                topics=[
                    Msg(
                        name=t.name,
                        partitions=[
                            Msg(
                                partition_index=p.partition_index,
                                low_watermark=-1,
                                error_code=int(ErrorCode.unsupported_version),
                            )
                            for p in t.partitions
                        ],
                    )
                    for t in req.topics
                ],
            )
        topics = []
        for t in req.topics:
            parts = []
            authorized = self.server.authorize(
                AclOperation.remove, AclResourceType.topic, t.name
            )
            for p in t.partitions:
                if not authorized:
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            low_watermark=-1,
                            error_code=int(
                                ErrorCode.topic_authorization_failed
                            ),
                        )
                    )
                    continue
                partition = self.server.broker.partition_manager.get(
                    kafka_ntp(t.name, p.partition_index)
                )
                if partition is None:
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            low_watermark=-1,
                            error_code=int(
                                ErrorCode.unknown_topic_or_partition
                            ),
                        )
                    )
                    continue
                if (
                    partition.log.config.compaction_enabled
                    or t.name.startswith("__")
                ):
                    # compacted/internal topics protect key history and
                    # coordinator state (delete_records.cc POLICY_VIOLATION)
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            low_watermark=-1,
                            error_code=int(ErrorCode.policy_violation),
                        )
                    )
                    continue
                if not partition.is_leader:
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            low_watermark=-1,
                            error_code=int(
                                ErrorCode.not_leader_for_partition
                            ),
                        )
                    )
                    continue
                try:
                    low = await partition.delete_records(
                        int(p.offset),
                        timeout=max(req.timeout_ms / 1000.0, 1.0),
                    )
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            low_watermark=low,
                            error_code=0,
                        )
                    )
                except ValueError:
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            low_watermark=-1,
                            error_code=int(ErrorCode.offset_out_of_range),
                        )
                    )
                except Exception as e:
                    from ..raft.consensus import NotLeaderError

                    code = (
                        ErrorCode.not_leader_for_partition
                        if isinstance(e, NotLeaderError)
                        else ErrorCode.request_timed_out
                    )
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            low_watermark=-1,
                            error_code=int(code),
                        )
                    )
            topics.append(Msg(name=t.name, partitions=parts))
        return Msg(throttle_time_ms=0, topics=topics)

    async def offset_delete(self, hdr, req) -> Msg:
        """OffsetDelete (handlers/offset_delete.cc): drop committed
        group offsets for specific partitions."""
        from ..security.acl import AclOperation as Op

        def all_err(code: int) -> Msg:
            return Msg(
                error_code=code,
                throttle_time_ms=0,
                topics=[],
            )

        if not self.server.authorize(
            Op.remove, AclResourceType.group, req.group_id
        ):
            return all_err(int(ErrorCode.group_authorization_failed))
        coordinator = self.server.broker.group_coordinator
        g, code = await coordinator.get_group(req.group_id)
        if code:
            return all_err(code)
        items = [
            (t.name, p.partition_index)
            for t in req.topics
            for p in t.partitions
        ]
        per_part = await coordinator.delete_offsets(g, items)
        by_topic: dict[str, list[Msg]] = {}
        for (topic, pid), ecode in per_part.items():
            by_topic.setdefault(topic, []).append(
                Msg(partition_index=pid, error_code=ecode)
            )
        return Msg(
            error_code=0,
            throttle_time_ms=0,
            topics=[
                Msg(name=topic, partitions=parts)
                for topic, parts in by_topic.items()
            ],
        )

    # -- log dirs / reassignments / producers -------------------------
    async def describe_log_dirs(self, hdr, req) -> Msg:
        """DescribeLogDirs (handlers/describe_log_dirs.cc): one logical
        log dir per broker; reports on-disk size of each locally hosted
        replica and its flush lag."""
        if not self.server.authorize(
            AclOperation.describe, AclResourceType.cluster, "kafka-cluster"
        ):
            body = Msg(throttle_time_ms=0, results=[])
            if hdr.api_version >= 3:
                body.error_code = int(ErrorCode.cluster_authorization_failed)
            return body
        broker = self.server.broker
        local = broker.partition_manager.partitions()
        wanted: dict[str, set[int] | None] | None = None
        if req.topics is not None:
            wanted = {t.topic: set(t.partitions) for t in req.topics}
        by_topic: dict[str, list[Msg]] = {}
        for ntp, p in sorted(local.items(), key=lambda kv: str(kv[0])):
            if ntp.ns != DEFAULT_NS:
                continue
            if wanted is not None:
                sel = wanted.get(ntp.topic)
                if sel is None or (sel and ntp.partition not in sel):
                    continue
            offs = p.log.offsets()
            by_topic.setdefault(ntp.topic, []).append(
                Msg(
                    partition_index=ntp.partition,
                    partition_size=p.log.size_bytes(),
                    offset_lag=max(0, offs.dirty_offset - offs.committed_offset),
                    is_future_key=False,
                )
            )
        body = Msg(
            throttle_time_ms=0,
            results=[
                Msg(
                    error_code=0,
                    log_dir=broker.config.data_dir,
                    topics=[
                        Msg(name=t, partitions=parts)
                        for t, parts in by_topic.items()
                    ],
                )
            ],
        )
        if hdr.api_version >= 3:
            body.error_code = 0
        return body

    async def alter_partition_reassignments(self, hdr, req) -> Msg:
        """AlterPartitionReassignments (handlers/
        alter_partition_reassignments.cc): replicas=[...] starts a
        replica move through the controller; replicas=null cancels an
        in-flight move by moving back to the pre-move set."""
        from ..cluster.controller import TopicError
        from .server import _topic_error_code

        if not self.server.authorize(
            AclOperation.alter, AclResourceType.cluster, "kafka-cluster"
        ):
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.cluster_authorization_failed),
                error_message=None,
                responses=[],
            )
        table = self.controller.topic_table
        out = []
        for t in req.topics:
            parts = []
            for p in t.partitions:
                code, message = 0, None
                ntp = kafka_ntp(t.name, p.partition_index)
                try:
                    if p.replicas is not None:
                        await self.controller.move_partition_replicas(
                            t.name, p.partition_index, [int(r) for r in p.replicas]
                        )
                    else:
                        prev = table.updates_in_progress.get(ntp)
                        if prev is None:
                            code = int(ErrorCode.no_reassignment_in_progress)
                        else:
                            await self.controller.move_partition_replicas(
                                t.name, p.partition_index, list(prev)
                            )
                except TopicError as e:
                    code, message = _topic_error_code(e.code), e.message
                except TimeoutError:
                    code = int(ErrorCode.request_timed_out)
                parts.append(
                    Msg(
                        partition_index=p.partition_index,
                        error_code=code,
                        error_message=message,
                    )
                )
            out.append(Msg(name=t.name, partitions=parts))
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            error_message=None,
            responses=out,
        )

    async def list_partition_reassignments(self, hdr, req) -> Msg:
        """ListPartitionReassignments: the replicated
        updates_in_progress view names every converging move; adding/
        removing are the deltas vs the pre-move set."""
        if not self.server.authorize(
            AclOperation.describe, AclResourceType.cluster, "kafka-cluster"
        ):
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.cluster_authorization_failed),
                error_message=None,
                topics=[],
            )
        table = self.controller.topic_table
        wanted: dict[str, set[int]] | None = None
        if req.topics is not None:
            wanted = {t.name: set(t.partition_indexes) for t in req.topics}
        by_topic: dict[str, list[Msg]] = {}
        for ntp, prev in sorted(
            table.updates_in_progress.items(), key=lambda kv: str(kv[0])
        ):
            if ntp.ns != DEFAULT_NS:
                continue
            if wanted is not None:
                sel = wanted.get(ntp.topic)
                if sel is None or (sel and ntp.partition not in sel):
                    continue
            md = table.get(TopicNamespace(ntp.ns, ntp.topic))
            if md is None or ntp.partition not in md.assignments:
                continue
            cur = md.assignments[ntp.partition].replicas
            adding = [r for r in cur if r not in prev]
            removing = [r for r in prev if r not in cur]
            if not adding and not removing:
                continue  # a cancel converging back: nothing to report
            # KIP-455: replicas is the FULL current set — target union
            # the replicas still being dropped
            by_topic.setdefault(ntp.topic, []).append(
                Msg(
                    partition_index=ntp.partition,
                    replicas=list(cur) + removing,
                    adding_replicas=adding,
                    removing_replicas=removing,
                )
            )
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            error_message=None,
            topics=[
                Msg(name=t, partitions=parts) for t, parts in by_topic.items()
            ],
        )

    async def describe_producers(self, hdr, req) -> Msg:
        """DescribeProducers (handlers/describe_producers.cc): the
        partition leader reports its producer-state table plus each
        producer's open-transaction start offset from the tx tracker."""
        broker = self.server.broker
        out_topics = []
        for t in req.topics:
            parts = []
            authorized = self.server.authorize(
                AclOperation.read, AclResourceType.topic, t.name
            )
            for pid_idx in t.partition_indexes:
                ntp = kafka_ntp(t.name, pid_idx)
                if not authorized:
                    parts.append(
                        Msg(
                            partition_index=pid_idx,
                            error_code=int(ErrorCode.topic_authorization_failed),
                            error_message=None,
                            active_producers=[],
                        )
                    )
                    continue
                md = self.controller.topic_table.get(ntp.tp_ns)
                if md is None or ntp.partition not in md.assignments:
                    parts.append(
                        Msg(
                            partition_index=pid_idx,
                            error_code=int(
                                ErrorCode.unknown_topic_or_partition
                            ),
                            error_message=None,
                            active_producers=[],
                        )
                    )
                    continue
                p = broker.partition_manager.get(ntp)
                if p is None or not p.is_leader:
                    parts.append(
                        Msg(
                            partition_index=pid_idx,
                            error_code=int(ErrorCode.not_leader_for_partition),
                            error_message=None,
                            active_producers=[],
                        )
                    )
                    continue
                producers = []
                for pid, epoch, last_seq in p.producers.snapshot():
                    open_tx = p.tx.open.get(pid)
                    producers.append(
                        Msg(
                            producer_id=pid,
                            producer_epoch=epoch,
                            last_sequence=last_seq,
                            last_timestamp=-1,
                            coordinator_epoch=-1,
                            current_txn_start_offset=(
                                open_tx[1] if open_tx is not None else -1
                            ),
                        )
                    )
                parts.append(
                    Msg(
                        partition_index=pid_idx,
                        error_code=0,
                        error_message=None,
                        active_producers=producers,
                    )
                )
            out_topics.append(Msg(name=t.name, partitions=parts))
        return Msg(throttle_time_ms=0, topics=out_topics)
