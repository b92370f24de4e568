"""Consumer-group + topic-admin API schemas.

Reference: src/v/kafka/protocol/schemata/{find_coordinator,join_group,
heartbeat,leave_group,sync_group,describe_groups,list_groups,
offset_commit,offset_fetch,delete_groups,delete_topics}_*.json and the
corresponding handlers (kafka/server/handlers/handlers.h:62-101).
"""

from __future__ import annotations

from .apis import register
from .schema import Api, Array, F

FIND_COORDINATOR = register(
    Api(
        key=10,
        name="find_coordinator",
        versions=(0, 2),
        flex_since=None,  # flex at v3
        request=[
            F("key", "string"),
            F("key_type", "int8", versions=(1, None)),  # 0=group, 1=txn
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(1, None)),
            F("error_code", "int16"),
            F("error_message", "string", versions=(1, None), nullable=(1, None), default=None),
            F("node_id", "int32"),
            F("host", "string"),
            F("port", "int32"),
        ],
    )
)

_PROTOCOL = [F("name", "string"), F("metadata", "bytes")]

JOIN_GROUP = register(
    Api(
        key=11,
        name="join_group",
        versions=(0, 5),
        flex_since=None,  # flex at v6
        request=[
            F("group_id", "string"),
            F("session_timeout_ms", "int32"),
            F("rebalance_timeout_ms", "int32", versions=(1, None), default=-1),
            F("member_id", "string"),
            F("group_instance_id", "string", versions=(5, None), nullable=(5, None), default=None),
            F("protocol_type", "string"),
            F("protocols", Array(_PROTOCOL)),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(2, None)),
            F("error_code", "int16"),
            F("generation_id", "int32"),
            F("protocol_name", "string"),
            F("leader", "string"),
            F("member_id", "string"),
            F(
                "members",
                Array(
                    [
                        F("member_id", "string"),
                        F("group_instance_id", "string", versions=(5, None), nullable=(5, None), default=None),
                        F("metadata", "bytes"),
                    ]
                ),
            ),
        ],
    )
)

HEARTBEAT = register(
    Api(
        key=12,
        name="heartbeat",
        versions=(0, 3),
        flex_since=None,  # flex at v4
        request=[
            F("group_id", "string"),
            F("generation_id", "int32"),
            F("member_id", "string"),
            F("group_instance_id", "string", versions=(3, None), nullable=(3, None), default=None),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(1, None)),
            F("error_code", "int16"),
        ],
    )
)

LEAVE_GROUP = register(
    Api(
        key=13,
        name="leave_group",
        versions=(0, 4),
        flex_since=4,
        request=[
            F("group_id", "string"),
            F("member_id", "string", versions=(0, 2)),
            # v3+ (KIP-345): batched removals, each addressable by
            # member id OR group.instance.id (admin removal of a
            # static member that is not running)
            F(
                "members",
                Array(
                    [
                        F("member_id", "string"),
                        F(
                            "group_instance_id",
                            "string",
                            nullable=(3, None),
                            default=None,
                        ),
                    ]
                ),
                versions=(3, None),
                default=[],
            ),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(1, None)),
            F("error_code", "int16"),
            F(
                "members",
                Array(
                    [
                        F("member_id", "string"),
                        F(
                            "group_instance_id",
                            "string",
                            nullable=(3, None),
                            default=None,
                        ),
                        F("error_code", "int16"),
                    ]
                ),
                versions=(3, None),
                default=[],
            ),
        ],
    )
)

SYNC_GROUP = register(
    Api(
        key=14,
        name="sync_group",
        versions=(0, 3),
        flex_since=None,  # flex at v4
        request=[
            F("group_id", "string"),
            F("generation_id", "int32"),
            F("member_id", "string"),
            F("group_instance_id", "string", versions=(3, None), nullable=(3, None), default=None),
            F(
                "assignments",
                Array([F("member_id", "string"), F("assignment", "bytes")]),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(1, None)),
            F("error_code", "int16"),
            F("assignment", "bytes"),
        ],
    )
)

DESCRIBE_GROUPS = register(
    Api(
        key=15,
        name="describe_groups",
        versions=(0, 4),
        flex_since=None,  # flex at v5
        request=[
            F("groups", Array("string")),
            F("include_authorized_operations", "bool", versions=(3, None)),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(1, None)),
            F(
                "groups",
                Array(
                    [
                        F("error_code", "int16"),
                        F("group_id", "string"),
                        F("group_state", "string"),
                        F("protocol_type", "string"),
                        F("protocol_data", "string"),
                        F(
                            "members",
                            Array(
                                [
                                    F("member_id", "string"),
                                    F("group_instance_id", "string", versions=(4, None), nullable=(4, None), default=None),
                                    F("client_id", "string"),
                                    F("client_host", "string"),
                                    F("member_metadata", "bytes"),
                                    F("member_assignment", "bytes"),
                                ]
                            ),
                        ),
                        F("authorized_operations", "int32", versions=(3, None), default=-2147483648),
                    ]
                ),
            ),
        ],
    )
)

LIST_GROUPS = register(
    Api(
        key=16,
        name="list_groups",
        versions=(0, 2),
        flex_since=None,  # flex at v3
        request=[],
        response=[
            F("throttle_time_ms", "int32", versions=(1, None)),
            F("error_code", "int16"),
            F(
                "groups",
                Array(
                    [F("group_id", "string"), F("protocol_type", "string")]
                ),
            ),
        ],
    )
)

OFFSET_COMMIT = register(
    Api(
        key=8,
        name="offset_commit",
        versions=(0, 5),
        flex_since=None,  # flex at v8
        request=[
            F("group_id", "string"),
            F("generation_id", "int32", versions=(1, None), default=-1),
            F("member_id", "string", versions=(1, None), default=""),
            F("retention_time_ms", "int64", versions=(2, 4), default=-1),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("partition_index", "int32"),
                                    F("committed_offset", "int64"),
                                    F("commit_timestamp", "int64", versions=(1, 1), default=-1),
                                    F("committed_metadata", "string", nullable=(0, None), default=None),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(3, None)),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("partition_index", "int32"),
                                    F("error_code", "int16"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

OFFSET_FETCH = register(
    Api(
        key=9,
        name="offset_fetch",
        versions=(0, 5),
        flex_since=None,  # flex at v6
        request=[
            F("group_id", "string"),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F("partition_indexes", Array("int32")),
                    ]
                ),
                nullable=(2, None),
                default=None,  # null (v2+) = all topics with offsets
            ),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(3, None)),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("partition_index", "int32"),
                                    F("committed_offset", "int64"),
                                    F("committed_leader_epoch", "int32", versions=(5, None), default=-1),
                                    F("metadata", "string", nullable=(0, None), default=None),
                                    F("error_code", "int16"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
            F("error_code", "int16", versions=(2, None)),
        ],
    )
)

DELETE_GROUPS = register(
    Api(
        key=42,
        name="delete_groups",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[F("groups_names", Array("string"))],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "results",
                Array([F("group_id", "string"), F("error_code", "int16")]),
            ),
        ],
    )
)

INIT_PRODUCER_ID = register(
    Api(
        key=22,
        name="init_producer_id",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[
            F("transactional_id", "string", nullable=(0, None), default=None),
            F("transaction_timeout_ms", "int32", default=60000),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16"),
            F("producer_id", "int64", default=-1),
            F("producer_epoch", "int16"),
        ],
    )
)

DELETE_TOPICS = register(
    Api(
        key=20,
        name="delete_topics",
        versions=(0, 3),
        flex_since=None,  # flex at v4
        request=[
            F("topic_names", Array("string")),
            F("timeout_ms", "int32"),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(1, None)),
            F(
                "responses",
                Array([F("name", "string"), F("error_code", "int16")]),
            ),
        ],
    )
)
