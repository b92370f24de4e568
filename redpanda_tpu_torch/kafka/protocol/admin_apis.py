"""SASL / ACL / config / partition-admin API schemas.

Reference: src/v/kafka/protocol/schemata/{sasl_handshake,
sasl_authenticate,describe_acls,create_acls,delete_acls,
describe_configs,alter_configs,incremental_alter_configs,
offset_for_leader_epoch,create_partitions}_*.json and handlers
(kafka/server/handlers/handlers.h:62-101).
"""

from __future__ import annotations

from .apis import register
from .schema import Api, Array, F

SASL_HANDSHAKE = register(
    Api(
        key=17,
        name="sasl_handshake",
        versions=(0, 1),
        flex_since=None,
        request=[F("mechanism", "string")],
        response=[
            F("error_code", "int16"),
            F("mechanisms", Array("string")),
        ],
    )
)

SASL_AUTHENTICATE = register(
    Api(
        key=36,
        name="sasl_authenticate",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[F("auth_bytes", "bytes")],
        response=[
            F("error_code", "int16"),
            F("error_message", "string", nullable=(0, None), default=None),
            F("auth_bytes", "bytes"),
            F("session_lifetime_ms", "int64", versions=(1, None)),
        ],
    )
)

_ACL_ROW = [
    F("principal", "string"),
    F("host", "string"),
    F("operation", "int8"),
    F("permission_type", "int8"),
]

DESCRIBE_ACLS = register(
    Api(
        key=29,
        name="describe_acls",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[
            F("resource_type_filter", "int8"),
            F("resource_name_filter", "string", nullable=(0, None), default=None),
            F("pattern_type_filter", "int8", versions=(1, None), default=3),
            F("principal_filter", "string", nullable=(0, None), default=None),
            F("host_filter", "string", nullable=(0, None), default=None),
            F("operation", "int8"),
            F("permission_type", "int8"),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16"),
            F("error_message", "string", nullable=(0, None), default=None),
            F(
                "resources",
                Array(
                    [
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                        F("pattern_type", "int8", versions=(1, None), default=3),
                        F("acls", Array(_ACL_ROW)),
                    ]
                ),
            ),
        ],
    )
)

CREATE_ACLS = register(
    Api(
        key=30,
        name="create_acls",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[
            F(
                "creations",
                Array(
                    [
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                        F("resource_pattern_type", "int8", versions=(1, None), default=3),
                        F("principal", "string"),
                        F("host", "string"),
                        F("operation", "int8"),
                        F("permission_type", "int8"),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "results",
                Array(
                    [
                        F("error_code", "int16"),
                        F("error_message", "string", nullable=(0, None), default=None),
                    ]
                ),
            ),
        ],
    )
)

DELETE_ACLS = register(
    Api(
        key=31,
        name="delete_acls",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[
            F(
                "filters",
                Array(
                    [
                        F("resource_type_filter", "int8"),
                        F("resource_name_filter", "string", nullable=(0, None), default=None),
                        F("pattern_type_filter", "int8", versions=(1, None), default=3),
                        F("principal_filter", "string", nullable=(0, None), default=None),
                        F("host_filter", "string", nullable=(0, None), default=None),
                        F("operation", "int8"),
                        F("permission_type", "int8"),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "filter_results",
                Array(
                    [
                        F("error_code", "int16"),
                        F("error_message", "string", nullable=(0, None), default=None),
                        F(
                            "matching_acls",
                            Array(
                                [
                                    F("error_code", "int16"),
                                    F("error_message", "string", nullable=(0, None), default=None),
                                    F("resource_type", "int8"),
                                    F("resource_name", "string"),
                                    F("pattern_type", "int8", versions=(1, None), default=3),
                                    F("principal", "string"),
                                    F("host", "string"),
                                    F("operation", "int8"),
                                    F("permission_type", "int8"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

DESCRIBE_CONFIGS = register(
    Api(
        key=32,
        name="describe_configs",
        versions=(0, 1),
        flex_since=None,
        request=[
            F(
                "resources",
                Array(
                    [
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                        F(
                            "configuration_keys",
                            Array("string"),
                            nullable=(0, None),
                            default=None,
                        ),
                    ]
                ),
            ),
            F("include_synonyms", "bool", versions=(1, None), default=False),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "results",
                Array(
                    [
                        F("error_code", "int16"),
                        F("error_message", "string", nullable=(0, None), default=None),
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                        F(
                            "configs",
                            Array(
                                [
                                    F("name", "string"),
                                    F("value", "string", nullable=(0, None), default=None),
                                    F("read_only", "bool"),
                                    F("is_default", "bool", versions=(0, 0)),
                                    F("config_source", "int8", versions=(1, None), default=-1),
                                    F("is_sensitive", "bool"),
                                    F(
                                        "synonyms",
                                        Array(
                                            [
                                                F("name", "string"),
                                                F("value", "string", nullable=(1, None), default=None),
                                                F("source", "int8"),
                                            ]
                                        ),
                                        versions=(1, None),
                                    ),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

ALTER_CONFIGS = register(
    Api(
        key=33,
        name="alter_configs",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[
            F(
                "resources",
                Array(
                    [
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                        F(
                            "configs",
                            Array(
                                [
                                    F("name", "string"),
                                    F("value", "string", nullable=(0, None), default=None),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
            F("validate_only", "bool"),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "responses",
                Array(
                    [
                        F("error_code", "int16"),
                        F("error_message", "string", nullable=(0, None), default=None),
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                    ]
                ),
            ),
        ],
    )
)

INCREMENTAL_ALTER_CONFIGS = register(
    Api(
        key=44,
        name="incremental_alter_configs",
        versions=(0, 0),
        flex_since=None,  # flex at v1
        request=[
            F(
                "resources",
                Array(
                    [
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                        F(
                            "configs",
                            Array(
                                [
                                    F("name", "string"),
                                    F("config_operation", "int8"),
                                    F("value", "string", nullable=(0, None), default=None),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
            F("validate_only", "bool"),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "responses",
                Array(
                    [
                        F("error_code", "int16"),
                        F("error_message", "string", nullable=(0, None), default=None),
                        F("resource_type", "int8"),
                        F("resource_name", "string"),
                    ]
                ),
            ),
        ],
    )
)

DELETE_RECORDS = register(
    Api(
        key=21,
        name="delete_records",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[
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
                                    F("offset", "int64"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
            F("timeout_ms", "int32"),
        ],
        response=[
            F("throttle_time_ms", "int32"),
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
                                    F("low_watermark", "int64"),
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

OFFSET_DELETE = register(
    Api(
        key=47,
        name="offset_delete",
        versions=(0, 0),
        flex_since=None,
        request=[
            F("group_id", "string"),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "partitions",
                            Array([F("partition_index", "int32")]),
                        ),
                    ]
                ),
            ),
        ],
        response=[
            F("error_code", "int16"),
            F("throttle_time_ms", "int32"),
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

OFFSET_FOR_LEADER_EPOCH = register(
    Api(
        key=23,
        name="offset_for_leader_epoch",
        versions=(0, 2),
        flex_since=None,  # flex at v4
        request=[
            F(
                "topics",
                Array(
                    [
                        F("topic", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("partition", "int32"),
                                    F(
                                        "current_leader_epoch",
                                        "int32",
                                        versions=(2, None),
                                        default=-1,
                                    ),
                                    F("leader_epoch", "int32"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32", versions=(2, None), default=0),
            F(
                "topics",
                Array(
                    [
                        F("topic", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("error_code", "int16"),
                                    F("partition", "int32"),
                                    F("leader_epoch", "int32", versions=(1, None), default=-1),
                                    F("end_offset", "int64"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

CREATE_PARTITIONS = register(
    Api(
        key=37,
        name="create_partitions",
        versions=(0, 1),
        flex_since=None,  # flex at v2
        request=[
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F("count", "int32"),
                        F(
                            "assignments",
                            Array([F("broker_ids", Array("int32"))]),
                            nullable=(0, None),
                            default=None,
                        ),
                    ]
                ),
            ),
            F("timeout_ms", "int32"),
            F("validate_only", "bool"),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "results",
                Array(
                    [
                        F("name", "string"),
                        F("error_code", "int16"),
                        F("error_message", "string", nullable=(0, None), default=None),
                    ]
                ),
            ),
        ],
    )
)


DESCRIBE_LOG_DIRS = register(
    Api(
        key=35,
        name="describe_log_dirs",
        versions=(0, 3),
        flex_since=2,
        request=[
            F(
                "topics",
                Array(
                    [
                        F("topic", "string"),
                        F("partitions", Array("int32")),
                    ]
                ),
                nullable=(0, None),
                default=None,
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16", versions=(3, None), default=0),
            F(
                "results",
                Array(
                    [
                        F("error_code", "int16"),
                        F("log_dir", "string"),
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
                                                F("partition_size", "int64"),
                                                F("offset_lag", "int64"),
                                                F("is_future_key", "bool"),
                                            ]
                                        ),
                                    ),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

ALTER_PARTITION_REASSIGNMENTS = register(
    Api(
        key=45,
        name="alter_partition_reassignments",
        versions=(0, 0),
        flex_since=0,
        request=[
            F("timeout_ms", "int32"),
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
                                    F(
                                        "replicas",
                                        Array("int32"),
                                        nullable=(0, None),
                                        default=None,
                                    ),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16"),
            F("error_message", "string", nullable=(0, None), default=None),
            F(
                "responses",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("partition_index", "int32"),
                                    F("error_code", "int16"),
                                    F(
                                        "error_message",
                                        "string",
                                        nullable=(0, None),
                                        default=None,
                                    ),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

LIST_PARTITION_REASSIGNMENTS = register(
    Api(
        key=46,
        name="list_partition_reassignments",
        versions=(0, 0),
        flex_since=0,
        request=[
            F("timeout_ms", "int32"),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F("partition_indexes", Array("int32")),
                    ]
                ),
                nullable=(0, None),
                default=None,
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16"),
            F("error_message", "string", nullable=(0, None), default=None),
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
                                    F("replicas", Array("int32")),
                                    F("adding_replicas", Array("int32")),
                                    F("removing_replicas", Array("int32")),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

DESCRIBE_PRODUCERS = register(
    Api(
        key=61,
        name="describe_producers",
        versions=(0, 0),
        flex_since=0,
        request=[
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F("partition_indexes", Array("int32")),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
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
                                    F(
                                        "error_message",
                                        "string",
                                        nullable=(0, None),
                                        default=None,
                                    ),
                                    F(
                                        "active_producers",
                                        Array(
                                            [
                                                F("producer_id", "int64"),
                                                F("producer_epoch", "int32"),
                                                F("last_sequence", "int32", default=-1),
                                                F("last_timestamp", "int64", default=-1),
                                                F("coordinator_epoch", "int32"),
                                                F(
                                                    "current_txn_start_offset",
                                                    "int64",
                                                    default=-1,
                                                ),
                                            ]
                                        ),
                                    ),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)
