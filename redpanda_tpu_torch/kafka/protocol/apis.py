"""Kafka API message schemas.

Reference: src/v/kafka/protocol/schemata/*.json (78 schemata, 39
request/response pairs, from Kafka's upstream message definitions)
compiled by generator.py. Declared here with the same version gating;
`handlers.h:62-101` is the corresponding dispatch inventory.

Version ranges advertised are what the codec genuinely round-trips;
clients negotiate down via ApiVersions (and the UNSUPPORTED_VERSION
fallback for ApiVersions itself, like the reference
kafka/server/protocol_utils.cc behavior).
"""

from __future__ import annotations

from .schema import Api, Array, F

# ---------------------------------------------------------------- Produce (0)

PRODUCE = Api(
    key=0,
    name="produce",
    versions=(0, 9),
    flex_since=9,
    request=[
        F("transactional_id", "string", versions=(3, None), nullable=(3, None), default=None),
        F("acks", "int16"),
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
                                F("index", "int32"),
                                F("records", "records", nullable=(0, None)),
                            ]
                        ),
                    ),
                ]
            ),
        ),
    ],
    response=[
        F(
            "responses",
            Array(
                [
                    F("name", "string"),
                    F(
                        "partition_responses",
                        Array(
                            [
                                F("index", "int32"),
                                F("error_code", "int16"),
                                F("base_offset", "int64"),
                                F("log_append_time_ms", "int64", versions=(2, None), default=-1),
                                F("log_start_offset", "int64", versions=(5, None), default=-1),
                                F(
                                    "record_errors",
                                    Array(
                                        [
                                            F("batch_index", "int32"),
                                            F(
                                                "batch_index_error_message",
                                                "string",
                                                nullable=(8, None),
                                                default=None,
                                            ),
                                        ]
                                    ),
                                    versions=(8, None),
                                ),
                                F("error_message", "string", versions=(8, None), nullable=(8, None), default=None),
                            ]
                        ),
                    ),
                ]
            ),
        ),
        F("throttle_time_ms", "int32", versions=(1, None)),
    ],
)

# ------------------------------------------------------------------ Fetch (1)

FETCH = Api(
    key=1,
    name="fetch",
    versions=(0, 11),
    flex_since=None,  # flex starts at v12 (topic ids), above our range
    request=[
        F("replica_id", "int32", default=-1),
        F("max_wait_ms", "int32"),
        F("min_bytes", "int32"),
        F("max_bytes", "int32", versions=(3, None), default=0x7FFFFFFF),
        F("isolation_level", "int8", versions=(4, None)),
        F("session_id", "int32", versions=(7, None)),
        F("session_epoch", "int32", versions=(7, None), default=-1),
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
                                F("current_leader_epoch", "int32", versions=(9, None), default=-1),
                                F("fetch_offset", "int64"),
                                F("log_start_offset", "int64", versions=(5, None), default=-1),
                                F("partition_max_bytes", "int32"),
                            ]
                        ),
                    ),
                ]
            ),
        ),
        F(
            "forgotten_topics_data",
            Array([F("topic", "string"), F("partitions", Array("int32"))]),
            versions=(7, None),
        ),
        F("rack_id", "string", versions=(11, None), default=""),
    ],
    response=[
        F("throttle_time_ms", "int32", versions=(1, None)),
        F("error_code", "int16", versions=(7, None)),
        F("session_id", "int32", versions=(7, None)),
        F(
            "responses",
            Array(
                [
                    F("topic", "string"),
                    F(
                        "partitions",
                        Array(
                            [
                                F("partition_index", "int32"),
                                F("error_code", "int16"),
                                F("high_watermark", "int64"),
                                F("last_stable_offset", "int64", versions=(4, None), default=-1),
                                F("log_start_offset", "int64", versions=(5, None), default=-1),
                                F(
                                    "aborted_transactions",
                                    Array(
                                        [
                                            F("producer_id", "int64"),
                                            F("first_offset", "int64"),
                                        ]
                                    ),
                                    versions=(4, None),
                                    nullable=(4, None),
                                    default=None,
                                ),
                                F("preferred_read_replica", "int32", versions=(11, None), default=-1),
                                F("records", "records", nullable=(0, None)),
                            ]
                        ),
                    ),
                ]
            ),
        ),
    ],
)

# ------------------------------------------------------------ ListOffsets (2)

LIST_OFFSETS = Api(
    key=2,
    name="list_offsets",
    versions=(0, 5),
    flex_since=None,  # flex at v6
    request=[
        F("replica_id", "int32", default=-1),
        F("isolation_level", "int8", versions=(2, None)),
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
                                F("current_leader_epoch", "int32", versions=(4, None), default=-1),
                                F("timestamp", "int64"),
                                F("max_num_offsets", "int32", versions=(0, 0), default=1),
                            ]
                        ),
                    ),
                ]
            ),
        ),
    ],
    response=[
        F("throttle_time_ms", "int32", versions=(2, None)),
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
                                F("old_style_offsets", Array("int64"), versions=(0, 0)),
                                F("timestamp", "int64", versions=(1, None), default=-1),
                                F("offset", "int64", versions=(1, None), default=-1),
                                F("leader_epoch", "int32", versions=(4, None), default=-1),
                            ]
                        ),
                    ),
                ]
            ),
        ),
    ],
)

# --------------------------------------------------------------- Metadata (3)

METADATA = Api(
    key=3,
    name="metadata",
    versions=(0, 9),
    flex_since=9,
    request=[
        F(
            "topics",
            Array([F("name", "string")]),
            nullable=(1, None),
            default=None,
        ),
        F("allow_auto_topic_creation", "bool", versions=(4, None), default=True),
        F("include_cluster_authorized_operations", "bool", versions=(8, None)),
        F("include_topic_authorized_operations", "bool", versions=(8, None)),
    ],
    response=[
        F("throttle_time_ms", "int32", versions=(3, None)),
        F(
            "brokers",
            Array(
                [
                    F("node_id", "int32"),
                    F("host", "string"),
                    F("port", "int32"),
                    F("rack", "string", versions=(1, None), nullable=(1, None), default=None),
                ]
            ),
        ),
        F("cluster_id", "string", versions=(2, None), nullable=(2, None), default=None),
        F("controller_id", "int32", versions=(1, None), default=-1),
        F(
            "topics",
            Array(
                [
                    F("error_code", "int16"),
                    F("name", "string"),
                    F("is_internal", "bool", versions=(1, None)),
                    F(
                        "partitions",
                        Array(
                            [
                                F("error_code", "int16"),
                                F("partition_index", "int32"),
                                F("leader_id", "int32"),
                                F("leader_epoch", "int32", versions=(7, None), default=-1),
                                F("replica_nodes", Array("int32")),
                                F("isr_nodes", Array("int32")),
                                F("offline_replicas", Array("int32"), versions=(5, None)),
                            ]
                        ),
                    ),
                    F("topic_authorized_operations", "int32", versions=(8, None), default=-2147483648),
                ]
            ),
        ),
        F("cluster_authorized_operations", "int32", versions=(8, None), default=-2147483648),
    ],
)

# ------------------------------------------------------------ ApiVersions (18)

API_VERSIONS = Api(
    key=18,
    name="api_versions",
    versions=(0, 3),
    flex_since=3,
    request=[
        F("client_software_name", "string", versions=(3, None), default=""),
        F("client_software_version", "string", versions=(3, None), default=""),
    ],
    response=[
        F("error_code", "int16"),
        F(
            "api_keys",
            Array(
                [
                    F("api_key", "int16"),
                    F("min_version", "int16"),
                    F("max_version", "int16"),
                ]
            ),
        ),
        F("throttle_time_ms", "int32", versions=(1, None)),
    ],
)

# ----------------------------------------------------------- CreateTopics (19)

CREATE_TOPICS = Api(
    key=19,
    name="create_topics",
    versions=(0, 4),
    flex_since=None,  # flex at v5
    request=[
        F(
            "topics",
            Array(
                [
                    F("name", "string"),
                    F("num_partitions", "int32"),
                    F("replication_factor", "int16"),
                    F(
                        "assignments",
                        Array(
                            [
                                F("partition_index", "int32"),
                                F("broker_ids", Array("int32")),
                            ]
                        ),
                    ),
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
        F("timeout_ms", "int32"),
        F("validate_only", "bool", versions=(1, None)),
    ],
    response=[
        F("throttle_time_ms", "int32", versions=(2, None)),
        F(
            "topics",
            Array(
                [
                    F("name", "string"),
                    F("error_code", "int16"),
                    F("error_message", "string", versions=(1, None), nullable=(1, None), default=None),
                ]
            ),
        ),
    ],
)


ALL_APIS: list[Api] = [
    PRODUCE,
    FETCH,
    LIST_OFFSETS,
    METADATA,
    API_VERSIONS,
    CREATE_TOPICS,
]

API_BY_KEY: dict[int, Api] = {a.key: a for a in ALL_APIS}


def register(api: Api) -> Api:
    """Add an API to the dispatch registry (used by later handler waves)."""
    ALL_APIS.append(api)
    API_BY_KEY[api.key] = api
    return api
