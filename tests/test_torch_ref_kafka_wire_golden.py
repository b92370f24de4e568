"""tests/test_kafka_wire_golden.py run on the port: all 190 cases, with
imports pointed at redpanda_tpu_torch. The port's protocol codec is held
to the same spec-built bytes and to the same frozen corpus under
tests/corpus/kafka_wire (read, never written: RP_WIRE_CORPUS_WRITE stays
unset). Nothing is left out.

Golden wire-byte vectors for the Kafka protocol codec.

Every vector's bytes are constructed HERE by an independent,
deliberately-primitive encoder written straight from the public Kafka
protocol specification (big-endian primitives, int16-length strings,
int32-count arrays; flexible versions: compact strings/arrays as
unsigned-varint length+1, empty tagged-field sections as 0x00). The
project codec (kafka/protocol/schema.py) never touches these bytes'
construction — so a bug that is self-consistent between our encoder
and decoder still fails here, byte-exactly.

This is the offline substitute for the reference's external-client
certification matrix (tests/rptest/services/kgo_verifier_services.py:25
runs franz-go/sarama/librdkafka against the broker; no such client is
installable in this environment). The vectors are also frozen under
tests/corpus/kafka_wire/*.bin — drift against the corpus fails too.
"""

import os
import struct

import pytest

from redpanda_tpu_torch.kafka.protocol import Msg
from redpanda_tpu_torch.kafka.protocol.apis import (
    API_VERSIONS,
    CREATE_TOPICS,
    FETCH,
    LIST_OFFSETS,
    METADATA,
    PRODUCE,
)
from redpanda_tpu_torch.kafka.protocol.admin_apis import (
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
    SASL_AUTHENTICATE,
    SASL_HANDSHAKE,
)
from redpanda_tpu_torch.kafka.protocol.group_apis import (
    DELETE_GROUPS,
    DELETE_TOPICS,
    DESCRIBE_GROUPS,
    FIND_COORDINATOR,
    HEARTBEAT,
    INIT_PRODUCER_ID,
    JOIN_GROUP,
    LEAVE_GROUP,
    LIST_GROUPS,
    OFFSET_COMMIT,
    OFFSET_FETCH,
    SYNC_GROUP,
)
from redpanda_tpu_torch.kafka.protocol.tx_apis import (
    ADD_OFFSETS_TO_TXN,
    ADD_PARTITIONS_TO_TXN,
    DESCRIBE_TRANSACTIONS,
    END_TXN,
    LIST_TRANSACTIONS,
    TXN_OFFSET_COMMIT,
)

CORPUS = os.path.join(os.path.dirname(__file__), "corpus", "kafka_wire")


# ---- independent spec encoder (kept intentionally primitive) --------
def i8(v): return struct.pack(">b", v)
def i16(v): return struct.pack(">h", v)
def i32(v): return struct.pack(">i", v)
def i64(v): return struct.pack(">q", v)
def boolean(v): return b"\x01" if v else b"\x00"


def s16(v):  # STRING / NULLABLE_STRING
    if v is None:
        return i16(-1)
    b = v.encode()
    return i16(len(b)) + b


def b32(v):  # BYTES / NULLABLE_BYTES (and non-flex RECORDS)
    if v is None:
        return i32(-1)
    return i32(len(v)) + v


def arr(items):  # ARRAY (int32 count)
    if items is None:
        return i32(-1)
    return i32(len(items)) + b"".join(items)


def uv(n):  # UNSIGNED_VARINT
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def cs(v):  # COMPACT_STRING / COMPACT_NULLABLE_STRING
    if v is None:
        return uv(0)
    b = v.encode()
    return uv(len(b) + 1) + b


def cb(v):  # COMPACT_BYTES (and flex RECORDS)
    if v is None:
        return uv(0)
    return uv(len(v) + 1) + v


def carr(items):  # COMPACT_ARRAY
    if items is None:
        return uv(0)
    return uv(len(items) + 1) + b"".join(items)


TAG0 = b"\x00"  # empty tagged-field section

_RECORDS = b"\x00" * 61 + b"fake-record-batch"  # opaque to the codec


# ---- the vectors ----------------------------------------------------
# (name, api, version, "request"|"response", msg fields, golden bytes)
VECTORS = [
    (
        "api_versions_req_v0",
        API_VERSIONS, 0, "request",
        {},
        b"",
    ),
    (
        "api_versions_req_v3_flex",
        API_VERSIONS, 3, "request",
        {"client_software_name": "rp", "client_software_version": "3.0"},
        cs("rp") + cs("3.0") + TAG0,
    ),
    (
        "api_versions_resp_v0",
        API_VERSIONS, 0, "response",
        {
            "error_code": 0,
            "api_keys": [
                {"api_key": 0, "min_version": 0, "max_version": 9},
                {"api_key": 18, "min_version": 0, "max_version": 3},
            ],
        },
        i16(0)
        + arr([i16(0) + i16(0) + i16(9), i16(18) + i16(0) + i16(3)]),
    ),
    (
        "api_versions_resp_v3_flex",
        API_VERSIONS, 3, "response",
        {
            "error_code": 0,
            "api_keys": [
                {"api_key": 0, "min_version": 0, "max_version": 9},
            ],
            "throttle_time_ms": 5,
        },
        i16(0)
        + carr([i16(0) + i16(0) + i16(9) + TAG0])
        + i32(5)
        + TAG0,
    ),
    (
        "produce_resp_v9_flex",
        PRODUCE, 9, "response",
        {
            "responses": [
                {
                    "name": "t",
                    "partition_responses": [
                        {
                            "index": 1,
                            "error_code": 0,
                            "base_offset": 77,
                            "log_append_time_ms": -1,
                            "log_start_offset": 0,
                            "record_errors": [],
                            "error_message": None,
                        }
                    ],
                }
            ],
            "throttle_time_ms": 0,
        },
        carr([
            cs("t")
            + carr([
                i32(1) + i16(0) + i64(77) + i64(-1) + i64(0)
                + carr([]) + cs(None) + TAG0
            ])
            + TAG0
        ])
        + i32(0)
        + TAG0,
    ),
    (
        "metadata_req_v1_null_topics",
        METADATA, 1, "request",
        {"topics": None},
        i32(-1),
    ),
    (
        "metadata_req_v1_one_topic",
        METADATA, 1, "request",
        {"topics": [{"name": "events"}]},
        arr([s16("events")]),
    ),
    (
        "metadata_req_v9_flex",
        METADATA, 9, "request",
        {
            "topics": [{"name": "t"}],
            "allow_auto_topic_creation": False,
            "include_cluster_authorized_operations": False,
            "include_topic_authorized_operations": True,
        },
        carr([cs("t") + TAG0])
        + boolean(False) + boolean(False) + boolean(True) + TAG0,
    ),
    (
        "metadata_resp_v1",
        METADATA, 1, "response",
        {
            "brokers": [
                {"node_id": 0, "host": "h0", "port": 9092, "rack": None},
            ],
            "controller_id": 0,
            "topics": [
                {
                    "error_code": 0,
                    "name": "t",
                    "is_internal": False,
                    "partitions": [
                        {
                            "error_code": 0,
                            "partition_index": 0,
                            "leader_id": 0,
                            "replica_nodes": [0, 1],
                            "isr_nodes": [0],
                        }
                    ],
                }
            ],
        },
        arr([i32(0) + s16("h0") + i32(9092) + s16(None)])
        + i32(0)
        + arr([
            i16(0) + s16("t") + boolean(False)
            + arr([
                i16(0) + i32(0) + i32(0)
                + arr([i32(0), i32(1)]) + arr([i32(0)])
            ])
        ]),
    ),
    (
        "produce_req_v3",
        PRODUCE, 3, "request",
        {
            "transactional_id": None,
            "acks": -1,
            "timeout_ms": 30000,
            "topics": [
                {
                    "name": "t",
                    "partitions": [{"index": 0, "records": _RECORDS}],
                }
            ],
        },
        s16(None) + i16(-1) + i32(30000)
        + arr([s16("t") + arr([i32(0) + b32(_RECORDS)])]),
    ),
    (
        "produce_req_v9_flex",
        PRODUCE, 9, "request",
        {
            "transactional_id": "txn-1",
            "acks": 1,
            "timeout_ms": 1000,
            "topics": [
                {
                    "name": "t",
                    "partitions": [{"index": 2, "records": _RECORDS}],
                }
            ],
        },
        cs("txn-1") + i16(1) + i32(1000)
        + carr([
            cs("t")
            + carr([i32(2) + cb(_RECORDS) + TAG0])
            + TAG0
        ])
        + TAG0,
    ),
    (
        "produce_resp_v3",
        PRODUCE, 3, "response",
        {
            "responses": [
                {
                    "name": "t",
                    "partition_responses": [
                        {
                            "index": 0,
                            "error_code": 0,
                            "base_offset": 42,
                            "log_append_time_ms": -1,
                        }
                    ],
                }
            ],
            "throttle_time_ms": 0,
        },
        arr([s16("t") + arr([i32(0) + i16(0) + i64(42) + i64(-1)])])
        + i32(0),
    ),
    (
        "fetch_req_v11",
        FETCH, 11, "request",
        {
            "replica_id": -1,
            "max_wait_ms": 500,
            "min_bytes": 1,
            "max_bytes": 1 << 20,
            "isolation_level": 1,
            "session_id": 0,
            "session_epoch": -1,
            "topics": [
                {
                    "topic": "t",
                    "partitions": [
                        {
                            "partition": 5,
                            "current_leader_epoch": -1,
                            "fetch_offset": 100,
                            "log_start_offset": -1,
                            "partition_max_bytes": 65536,
                        }
                    ],
                }
            ],
            "forgotten_topics_data": [],
            "rack_id": "rack-a",
        },
        i32(-1) + i32(500) + i32(1) + i32(1 << 20) + i8(1) + i32(0)
        + i32(-1)
        + arr([
            s16("t")
            + arr([i32(5) + i32(-1) + i64(100) + i64(-1) + i32(65536)])
        ])
        + arr([])
        + s16("rack-a"),
    ),
    (
        "list_offsets_req_v1",
        LIST_OFFSETS, 1, "request",
        {
            "replica_id": -1,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {"partition_index": 0, "timestamp": -1}
                    ],
                }
            ],
        },
        i32(-1) + arr([s16("t") + arr([i32(0) + i64(-1)])]),
    ),
    (
        "list_offsets_resp_v1",
        LIST_OFFSETS, 1, "response",
        {
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "error_code": 0,
                            "timestamp": -1,
                            "offset": 7,
                        }
                    ],
                }
            ],
        },
        arr([s16("t") + arr([i32(0) + i16(0) + i64(-1) + i64(7)])]),
    ),
    (
        "create_topics_req_v2",
        CREATE_TOPICS, 2, "request",
        {
            "topics": [
                {
                    "name": "new-t",
                    "num_partitions": 3,
                    "replication_factor": 1,
                    "assignments": [],
                    "configs": [
                        {"name": "cleanup.policy", "value": "compact"}
                    ],
                }
            ],
            "timeout_ms": 10000,
            "validate_only": False,
        },
        arr([
            s16("new-t") + i32(3) + i16(1) + arr([])
            + arr([s16("cleanup.policy") + s16("compact")])
        ])
        + i32(10000) + boolean(False),
    ),
    (
        "find_coordinator_req_v1",
        FIND_COORDINATOR, 1, "request",
        {"key": "my-group", "key_type": 0},
        s16("my-group") + i8(0),
    ),
    (
        "find_coordinator_resp_v1",
        FIND_COORDINATOR, 1, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "error_message": None,
            "node_id": 1,
            "host": "broker-1",
            "port": 9092,
        },
        i32(0) + i16(0) + s16(None) + i32(1) + s16("broker-1") + i32(9092),
    ),
    (
        "join_group_req_v2",
        JOIN_GROUP, 2, "request",
        {
            "group_id": "g",
            "session_timeout_ms": 10000,
            "rebalance_timeout_ms": 30000,
            "member_id": "",
            "protocol_type": "consumer",
            "protocols": [{"name": "range", "metadata": b"\x00\x01"}],
        },
        s16("g") + i32(10000) + i32(30000) + s16("") + s16("consumer")
        + arr([s16("range") + b32(b"\x00\x01")]),
    ),
    (
        "heartbeat_req_v1",
        HEARTBEAT, 1, "request",
        {"group_id": "g", "generation_id": 5, "member_id": "m-1"},
        s16("g") + i32(5) + s16("m-1"),
    ),
    (
        "heartbeat_resp_v1",
        HEARTBEAT, 1, "response",
        {"throttle_time_ms": 0, "error_code": 27},
        i32(0) + i16(27),
    ),
    (
        "leave_group_req_v1",
        LEAVE_GROUP, 1, "request",
        {"group_id": "g", "member_id": "m-1"},
        s16("g") + s16("m-1"),
    ),
    (
        "leave_group_req_v4_flex",
        LEAVE_GROUP, 4, "request",
        {
            "group_id": "g",
            "members": [
                {"member_id": "m-1", "group_instance_id": None},
                {"member_id": "m-2", "group_instance_id": "static-2"},
            ],
        },
        cs("g")
        + carr([
            cs("m-1") + cs(None) + TAG0,
            cs("m-2") + cs("static-2") + TAG0,
        ])
        + TAG0,
    ),
    (
        "sync_group_req_v1",
        SYNC_GROUP, 1, "request",
        {
            "group_id": "g",
            "generation_id": 1,
            "member_id": "leader",
            "assignments": [
                {"member_id": "leader", "assignment": b"\x00\x03abc"}
            ],
        },
        s16("g") + i32(1) + s16("leader")
        + arr([s16("leader") + b32(b"\x00\x03abc")]),
    ),
    (
        "offset_commit_req_v2",
        OFFSET_COMMIT, 2, "request",
        {
            "group_id": "g",
            "generation_id": 3,
            "member_id": "m",
            "retention_time_ms": -1,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "committed_offset": 123,
                            "committed_metadata": None,
                        }
                    ],
                }
            ],
        },
        s16("g") + i32(3) + s16("m") + i64(-1)
        + arr([s16("t") + arr([i32(0) + i64(123) + s16(None)])]),
    ),
    (
        "offset_fetch_req_v1",
        OFFSET_FETCH, 1, "request",
        {
            "group_id": "g",
            "topics": [{"name": "t", "partition_indexes": [0, 1]}],
        },
        s16("g") + arr([s16("t") + arr([i32(0), i32(1)])]),
    ),
    (
        "offset_fetch_resp_v1",
        OFFSET_FETCH, 1, "response",
        {
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "committed_offset": 99,
                            "metadata": None,
                            "error_code": 0,
                        }
                    ],
                }
            ],
        },
        arr([s16("t") + arr([i32(0) + i64(99) + s16(None) + i16(0)])]),
    ),
    (
        "sasl_handshake_req_v1",
        SASL_HANDSHAKE, 1, "request",
        {"mechanism": "SCRAM-SHA-256"},
        s16("SCRAM-SHA-256"),
    ),
    (
        "sasl_handshake_resp_v1",
        SASL_HANDSHAKE, 1, "response",
        {
            "error_code": 0,
            "mechanisms": ["SCRAM-SHA-256", "SCRAM-SHA-512"],
        },
        i16(0) + arr([s16("SCRAM-SHA-256"), s16("SCRAM-SHA-512")]),
    ),
    (
        "init_producer_id_req_v1",
        INIT_PRODUCER_ID, 1, "request",
        {"transactional_id": None, "transaction_timeout_ms": 60000},
        s16(None) + i32(60000),
    ),
    (
        "init_producer_id_resp_v1",
        INIT_PRODUCER_ID, 1, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "producer_id": 4000,
            "producer_epoch": 0,
        },
        i32(0) + i16(0) + i64(4000) + i16(0),
    ),
    (
        "delete_topics_req_v1",
        DELETE_TOPICS, 1, "request",
        {"topic_names": ["a", "b"], "timeout_ms": 5000},
        arr([s16("a"), s16("b")]) + i32(5000),
    ),
    (
        "add_partitions_to_txn_req_v0",
        ADD_PARTITIONS_TO_TXN, 0, "request",
        {
            "transactional_id": "txn-1",
            "producer_id": 4000,
            "producer_epoch": 0,
            "topics": [{"name": "t", "partitions": [0, 1]}],
        },
        s16("txn-1") + i64(4000) + i16(0)
        + arr([s16("t") + arr([i32(0), i32(1)])]),
    ),
    # ---- round-4 completion: every registered API pinned ------------
    # Fetch (1) response v11: full partition shape incl. aborted txns
    (
        "fetch_resp_v11",
        FETCH, 11, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "session_id": 77,
            "responses": [
                {
                    "topic": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "error_code": 0,
                            "high_watermark": 100,
                            "last_stable_offset": 100,
                            "log_start_offset": 0,
                            "aborted_transactions": [
                                {"producer_id": 4000, "first_offset": 50},
                            ],
                            "preferred_read_replica": -1,
                            "records": _RECORDS,
                        }
                    ],
                }
            ],
        },
        i32(0) + i16(0) + i32(77)
        + arr([
            s16("t")
            + arr([
                i32(0) + i16(0) + i64(100) + i64(100) + i64(0)
                + arr([i64(4000) + i64(50)])
                + i32(-1)
                + b32(_RECORDS)
            ])
        ]),
    ),
    # OffsetCommit (8) response v2
    (
        "offset_commit_resp_v2",
        OFFSET_COMMIT, 2, "response",
        {
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {"partition_index": 0, "error_code": 0},
                    ],
                }
            ],
        },
        arr([s16("t") + arr([i32(0) + i16(0)])]),
    ),
    # JoinGroup (11) response v2 and v5 (group_instance_id)
    (
        "join_group_resp_v2",
        JOIN_GROUP, 2, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "generation_id": 3,
            "protocol_name": "range",
            "leader": "m1",
            "member_id": "m1",
            "members": [
                {"member_id": "m1", "metadata": b"\x01"},
            ],
        },
        i32(0) + i16(0) + i32(3) + s16("range") + s16("m1") + s16("m1")
        + arr([s16("m1") + b32(b"\x01")]),
    ),
    (
        "join_group_resp_v5",
        JOIN_GROUP, 5, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "generation_id": 3,
            "protocol_name": "range",
            "leader": "m1",
            "member_id": "m2",
            "members": [
                {
                    "member_id": "m1",
                    "group_instance_id": None,
                    "metadata": b"",
                },
            ],
        },
        i32(0) + i16(0) + i32(3) + s16("range") + s16("m1") + s16("m2")
        + arr([s16("m1") + s16(None) + b32(b"")]),
    ),
    # LeaveGroup (13) response v3 (members array) and v4 flex
    (
        "leave_group_resp_v3",
        LEAVE_GROUP, 3, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "members": [
                {
                    "member_id": "m1",
                    "group_instance_id": None,
                    "error_code": 0,
                },
            ],
        },
        i32(0) + i16(0) + arr([s16("m1") + s16(None) + i16(0)]),
    ),
    (
        "leave_group_resp_v4_flex",
        LEAVE_GROUP, 4, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "members": [
                {
                    "member_id": "m1",
                    "group_instance_id": "i1",
                    "error_code": 0,
                },
            ],
        },
        i32(0) + i16(0)
        + carr([cs("m1") + cs("i1") + i16(0) + TAG0])
        + TAG0,
    ),
    # SyncGroup (14) response v1
    (
        "sync_group_resp_v1",
        SYNC_GROUP, 1, "response",
        {"throttle_time_ms": 0, "error_code": 0, "assignment": b"\x05\x06"},
        i32(0) + i16(0) + b32(b"\x05\x06"),
    ),
    # CreateTopics (19) response v2
    (
        "create_topics_resp_v2",
        CREATE_TOPICS, 2, "response",
        {
            "throttle_time_ms": 0,
            "topics": [
                {"name": "t", "error_code": 0, "error_message": None},
            ],
        },
        i32(0) + arr([s16("t") + i16(0) + s16(None)]),
    ),
    # DeleteTopics (20) response v1
    (
        "delete_topics_resp_v1",
        DELETE_TOPICS, 1, "response",
        {
            "throttle_time_ms": 0,
            "responses": [{"name": "t", "error_code": 0}],
        },
        i32(0) + arr([s16("t") + i16(0)]),
    ),
    # AddPartitionsToTxn (24) response v0
    (
        "add_partitions_to_txn_resp_v0",
        ADD_PARTITIONS_TO_TXN, 0, "response",
        {
            "throttle_time_ms": 0,
            "results": [
                {
                    "name": "t",
                    "results": [
                        {"partition_index": 0, "error_code": 0},
                        {"partition_index": 1, "error_code": 0},
                    ],
                }
            ],
        },
        i32(0)
        + arr([
            s16("t") + arr([i32(0) + i16(0), i32(1) + i16(0)])
        ]),
    ),
    # DescribeGroups (15): v0 (minimal) and v4 (group_instance_id)
    (
        "describe_groups_req_v0",
        DESCRIBE_GROUPS, 0, "request",
        {"groups": ["g1", "g2"]},
        arr([s16("g1"), s16("g2")]),
    ),
    (
        "describe_groups_req_v4",
        DESCRIBE_GROUPS, 4, "request",
        {"groups": ["g1"], "include_authorized_operations": True},
        arr([s16("g1")]) + boolean(True),
    ),
    (
        "describe_groups_resp_v0",
        DESCRIBE_GROUPS, 0, "response",
        {
            "groups": [
                {
                    "error_code": 0,
                    "group_id": "g1",
                    "group_state": "Stable",
                    "protocol_type": "consumer",
                    "protocol_data": "range",
                    "members": [
                        {
                            "member_id": "m1",
                            "client_id": "c1",
                            "client_host": "/10.0.0.1",
                            "member_metadata": b"\x01\x02",
                            "member_assignment": b"\x03",
                        }
                    ],
                }
            ],
        },
        arr([
            i16(0) + s16("g1") + s16("Stable") + s16("consumer")
            + s16("range")
            + arr([
                s16("m1") + s16("c1") + s16("/10.0.0.1")
                + b32(b"\x01\x02") + b32(b"\x03")
            ])
        ]),
    ),
    (
        "describe_groups_resp_v4",
        DESCRIBE_GROUPS, 4, "response",
        {
            "throttle_time_ms": 0,
            "groups": [
                {
                    "error_code": 0,
                    "group_id": "g1",
                    "group_state": "Empty",
                    "protocol_type": "consumer",
                    "protocol_data": "",
                    "members": [
                        {
                            "member_id": "m1",
                            "group_instance_id": None,
                            "client_id": "c1",
                            "client_host": "h",
                            "member_metadata": b"",
                            "member_assignment": b"",
                        }
                    ],
                    "authorized_operations": -2147483648,
                }
            ],
        },
        i32(0)
        + arr([
            i16(0) + s16("g1") + s16("Empty") + s16("consumer") + s16("")
            + arr([
                s16("m1") + s16(None) + s16("c1") + s16("h")
                + b32(b"") + b32(b"")
            ])
            + i32(-2147483648)
        ]),
    ),
    # ListGroups (16): v0 and v2
    (
        "list_groups_req_v0",
        LIST_GROUPS, 0, "request",
        {},
        b"",
    ),
    (
        "list_groups_resp_v2",
        LIST_GROUPS, 2, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "groups": [
                {"group_id": "g1", "protocol_type": "consumer"},
            ],
        },
        i32(0) + i16(0) + arr([s16("g1") + s16("consumer")]),
    ),
    # DeleteRecords (21): v0 request + response
    (
        "delete_records_req_v0",
        DELETE_RECORDS, 0, "request",
        {
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {"partition_index": 0, "offset": 42},
                    ],
                }
            ],
            "timeout_ms": 30000,
        },
        arr([s16("t") + arr([i32(0) + i64(42)])]) + i32(30000),
    ),
    (
        "delete_records_resp_v1",
        DELETE_RECORDS, 1, "response",
        {
            "throttle_time_ms": 0,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "low_watermark": 42,
                            "error_code": 0,
                        },
                    ],
                }
            ],
        },
        i32(0) + arr([s16("t") + arr([i32(0) + i64(42) + i16(0)])]),
    ),
    # OffsetForLeaderEpoch (23): v0 and v2 (current_leader_epoch added)
    (
        "offset_for_leader_epoch_req_v0",
        OFFSET_FOR_LEADER_EPOCH, 0, "request",
        {
            "topics": [
                {
                    "topic": "t",
                    "partitions": [
                        {"partition": 3, "leader_epoch": 7},
                    ],
                }
            ],
        },
        arr([s16("t") + arr([i32(3) + i32(7)])]),
    ),
    (
        "offset_for_leader_epoch_req_v2",
        OFFSET_FOR_LEADER_EPOCH, 2, "request",
        {
            "topics": [
                {
                    "topic": "t",
                    "partitions": [
                        {
                            "partition": 3,
                            "current_leader_epoch": 9,
                            "leader_epoch": 7,
                        },
                    ],
                }
            ],
        },
        arr([s16("t") + arr([i32(3) + i32(9) + i32(7)])]),
    ),
    (
        "offset_for_leader_epoch_resp_v2",
        OFFSET_FOR_LEADER_EPOCH, 2, "response",
        {
            "throttle_time_ms": 0,
            "topics": [
                {
                    "topic": "t",
                    "partitions": [
                        {
                            "error_code": 0,
                            "partition": 3,
                            "leader_epoch": 7,
                            "end_offset": 1000,
                        },
                    ],
                }
            ],
        },
        i32(0) + arr([s16("t") + arr([i16(0) + i32(3) + i32(7) + i64(1000)])]),
    ),
    # AddOffsetsToTxn (25): v0 both directions
    (
        "add_offsets_to_txn_req_v0",
        ADD_OFFSETS_TO_TXN, 0, "request",
        {
            "transactional_id": "txn-1",
            "producer_id": 4000,
            "producer_epoch": 1,
            "group_id": "g1",
        },
        s16("txn-1") + i64(4000) + i16(1) + s16("g1"),
    ),
    (
        "add_offsets_to_txn_resp_v0",
        ADD_OFFSETS_TO_TXN, 0, "response",
        {"throttle_time_ms": 0, "error_code": 0},
        i32(0) + i16(0),
    ),
    # EndTxn (26): v1 both directions
    (
        "end_txn_req_v1",
        END_TXN, 1, "request",
        {
            "transactional_id": "txn-1",
            "producer_id": 4000,
            "producer_epoch": 1,
            "committed": True,
        },
        s16("txn-1") + i64(4000) + i16(1) + boolean(True),
    ),
    (
        "end_txn_resp_v1",
        END_TXN, 1, "response",
        {"throttle_time_ms": 0, "error_code": 0},
        i32(0) + i16(0),
    ),
    # TxnOffsetCommit (28): v0 and v2 (committed_leader_epoch)
    (
        "txn_offset_commit_req_v0",
        TXN_OFFSET_COMMIT, 0, "request",
        {
            "transactional_id": "txn-1",
            "group_id": "g1",
            "producer_id": 4000,
            "producer_epoch": 1,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "committed_offset": 5,
                            "committed_metadata": None,
                        },
                    ],
                }
            ],
        },
        s16("txn-1") + s16("g1") + i64(4000) + i16(1)
        + arr([s16("t") + arr([i32(0) + i64(5) + s16(None)])]),
    ),
    (
        "txn_offset_commit_req_v2",
        TXN_OFFSET_COMMIT, 2, "request",
        {
            "transactional_id": "txn-1",
            "group_id": "g1",
            "producer_id": 4000,
            "producer_epoch": 1,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "committed_offset": 5,
                            "committed_leader_epoch": 2,
                            "committed_metadata": "meta",
                        },
                    ],
                }
            ],
        },
        s16("txn-1") + s16("g1") + i64(4000) + i16(1)
        + arr([s16("t") + arr([i32(0) + i64(5) + i32(2) + s16("meta")])]),
    ),
    (
        "txn_offset_commit_resp_v0",
        TXN_OFFSET_COMMIT, 0, "response",
        {
            "throttle_time_ms": 0,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {"partition_index": 0, "error_code": 0},
                    ],
                }
            ],
        },
        i32(0) + arr([s16("t") + arr([i32(0) + i16(0)])]),
    ),
    # DescribeAcls (29): v1 (pattern_type added) both directions
    (
        "describe_acls_req_v1",
        DESCRIBE_ACLS, 1, "request",
        {
            "resource_type_filter": 2,
            "resource_name_filter": "t",
            "pattern_type_filter": 3,
            "principal_filter": None,
            "host_filter": None,
            "operation": 1,
            "permission_type": 1,
        },
        i8(2) + s16("t") + i8(3) + s16(None) + s16(None) + i8(1) + i8(1),
    ),
    (
        "describe_acls_resp_v1",
        DESCRIBE_ACLS, 1, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "error_message": None,
            "resources": [
                {
                    "resource_type": 2,
                    "resource_name": "t",
                    "pattern_type": 3,
                    "acls": [
                        {
                            "principal": "User:alice",
                            "host": "*",
                            "operation": 2,
                            "permission_type": 3,
                        }
                    ],
                }
            ],
        },
        i32(0) + i16(0) + s16(None)
        + arr([
            i8(2) + s16("t") + i8(3)
            + arr([s16("User:alice") + s16("*") + i8(2) + i8(3)])
        ]),
    ),
    # CreateAcls (30): v1 both directions
    (
        "create_acls_req_v1",
        CREATE_ACLS, 1, "request",
        {
            "creations": [
                {
                    "resource_type": 2,
                    "resource_name": "t",
                    "resource_pattern_type": 3,
                    "principal": "User:alice",
                    "host": "*",
                    "operation": 2,
                    "permission_type": 3,
                }
            ],
        },
        arr([
            i8(2) + s16("t") + i8(3) + s16("User:alice") + s16("*")
            + i8(2) + i8(3)
        ]),
    ),
    (
        "create_acls_resp_v1",
        CREATE_ACLS, 1, "response",
        {
            "throttle_time_ms": 0,
            "results": [{"error_code": 0, "error_message": None}],
        },
        i32(0) + arr([i16(0) + s16(None)]),
    ),
    # DeleteAcls (31): v1 both directions
    (
        "delete_acls_req_v1",
        DELETE_ACLS, 1, "request",
        {
            "filters": [
                {
                    "resource_type_filter": 2,
                    "resource_name_filter": None,
                    "pattern_type_filter": 1,
                    "principal_filter": "User:bob",
                    "host_filter": None,
                    "operation": 1,
                    "permission_type": 1,
                }
            ],
        },
        arr([i8(2) + s16(None) + i8(1) + s16("User:bob") + s16(None)
             + i8(1) + i8(1)]),
    ),
    (
        "delete_acls_resp_v1",
        DELETE_ACLS, 1, "response",
        {
            "throttle_time_ms": 0,
            "filter_results": [
                {
                    "error_code": 0,
                    "error_message": None,
                    "matching_acls": [
                        {
                            "error_code": 0,
                            "error_message": None,
                            "resource_type": 2,
                            "resource_name": "t",
                            "pattern_type": 3,
                            "principal": "User:bob",
                            "host": "*",
                            "operation": 1,
                            "permission_type": 3,
                        }
                    ],
                }
            ],
        },
        i32(0)
        + arr([
            i16(0) + s16(None)
            + arr([
                i16(0) + s16(None) + i8(2) + s16("t") + i8(3)
                + s16("User:bob") + s16("*") + i8(1) + i8(3)
            ])
        ]),
    ),
    # DescribeConfigs (32): v1 (synonyms/config_source) both directions
    (
        "describe_configs_req_v1",
        DESCRIBE_CONFIGS, 1, "request",
        {
            "resources": [
                {
                    "resource_type": 2,
                    "resource_name": "t",
                    "configuration_keys": ["retention.ms"],
                }
            ],
            "include_synonyms": False,
        },
        arr([i8(2) + s16("t") + arr([s16("retention.ms")])])
        + boolean(False),
    ),
    (
        "describe_configs_resp_v1",
        DESCRIBE_CONFIGS, 1, "response",
        {
            "throttle_time_ms": 0,
            "results": [
                {
                    "error_code": 0,
                    "error_message": None,
                    "resource_type": 2,
                    "resource_name": "t",
                    "configs": [
                        {
                            "name": "retention.ms",
                            "value": "604800000",
                            "read_only": False,
                            "config_source": 5,
                            "is_sensitive": False,
                            "synonyms": [],
                        }
                    ],
                }
            ],
        },
        i32(0)
        + arr([
            i16(0) + s16(None) + i8(2) + s16("t")
            + arr([
                s16("retention.ms") + s16("604800000") + boolean(False)
                + i8(5) + boolean(False) + arr([])
            ])
        ]),
    ),
    # AlterConfigs (33): v0 both directions
    (
        "alter_configs_req_v0",
        ALTER_CONFIGS, 0, "request",
        {
            "resources": [
                {
                    "resource_type": 2,
                    "resource_name": "t",
                    "configs": [
                        {"name": "retention.ms", "value": "1000"},
                    ],
                }
            ],
            "validate_only": False,
        },
        arr([i8(2) + s16("t") + arr([s16("retention.ms") + s16("1000")])])
        + boolean(False),
    ),
    (
        "alter_configs_resp_v0",
        ALTER_CONFIGS, 0, "response",
        {
            "throttle_time_ms": 0,
            "responses": [
                {
                    "error_code": 0,
                    "error_message": None,
                    "resource_type": 2,
                    "resource_name": "t",
                }
            ],
        },
        i32(0) + arr([i16(0) + s16(None) + i8(2) + s16("t")]),
    ),
    # DescribeLogDirs (35): v0 non-flex and v2 flex (boundary pair)
    (
        "describe_log_dirs_req_v0",
        DESCRIBE_LOG_DIRS, 0, "request",
        {
            "topics": [{"topic": "t", "partitions": [0, 1]}],
        },
        arr([s16("t") + arr([i32(0), i32(1)])]),
    ),
    (
        "describe_log_dirs_req_v2_flex",
        DESCRIBE_LOG_DIRS, 2, "request",
        {
            "topics": [{"topic": "t", "partitions": [0]}],
        },
        carr([cs("t") + carr([i32(0)]) + TAG0]) + TAG0,
    ),
    (
        "describe_log_dirs_resp_v2_flex",
        DESCRIBE_LOG_DIRS, 2, "response",
        {
            "throttle_time_ms": 0,
            "results": [
                {
                    "error_code": 0,
                    "log_dir": "/data",
                    "topics": [
                        {
                            "name": "t",
                            "partitions": [
                                {
                                    "partition_index": 0,
                                    "partition_size": 1024,
                                    "offset_lag": 0,
                                    "is_future_key": False,
                                }
                            ],
                        }
                    ],
                }
            ],
        },
        i32(0)
        + carr([
            i16(0) + cs("/data")
            + carr([
                cs("t")
                + carr([i32(0) + i64(1024) + i64(0) + boolean(False) + TAG0])
                + TAG0
            ])
            + TAG0
        ])
        + TAG0,
    ),
    # SaslAuthenticate (36): v1 (session_lifetime_ms) both directions
    (
        "sasl_authenticate_req_v1",
        SASL_AUTHENTICATE, 1, "request",
        {"auth_bytes": b"\x00user\x00pass"},
        b32(b"\x00user\x00pass"),
    ),
    (
        "sasl_authenticate_resp_v1",
        SASL_AUTHENTICATE, 1, "response",
        {
            "error_code": 0,
            "error_message": None,
            "auth_bytes": b"",
            "session_lifetime_ms": 3600000,
        },
        i16(0) + s16(None) + b32(b"") + i64(3600000),
    ),
    # CreatePartitions (37): v0 both directions
    (
        "create_partitions_req_v0",
        CREATE_PARTITIONS, 0, "request",
        {
            "topics": [
                {
                    "name": "t",
                    "count": 6,
                    "assignments": [{"broker_ids": [1, 2]}],
                }
            ],
            "timeout_ms": 30000,
            "validate_only": False,
        },
        arr([s16("t") + i32(6) + arr([arr([i32(1), i32(2)])])])
        + i32(30000) + boolean(False),
    ),
    (
        "create_partitions_resp_v0",
        CREATE_PARTITIONS, 0, "response",
        {
            "throttle_time_ms": 0,
            "results": [
                {"name": "t", "error_code": 0, "error_message": None},
            ],
        },
        i32(0) + arr([s16("t") + i16(0) + s16(None)]),
    ),
    # DeleteGroups (42): v0 both directions
    (
        "delete_groups_req_v0",
        DELETE_GROUPS, 0, "request",
        {"groups_names": ["g1", "g2"]},
        arr([s16("g1"), s16("g2")]),
    ),
    (
        "delete_groups_resp_v0",
        DELETE_GROUPS, 0, "response",
        {
            "throttle_time_ms": 0,
            "results": [{"group_id": "g1", "error_code": 0}],
        },
        i32(0) + arr([s16("g1") + i16(0)]),
    ),
    # IncrementalAlterConfigs (44): v0 both directions
    (
        "incremental_alter_configs_req_v0",
        INCREMENTAL_ALTER_CONFIGS, 0, "request",
        {
            "resources": [
                {
                    "resource_type": 2,
                    "resource_name": "t",
                    "configs": [
                        {
                            "name": "retention.ms",
                            "config_operation": 0,
                            "value": "1000",
                        },
                    ],
                }
            ],
            "validate_only": False,
        },
        arr([
            i8(2) + s16("t")
            + arr([s16("retention.ms") + i8(0) + s16("1000")])
        ])
        + boolean(False),
    ),
    (
        "incremental_alter_configs_resp_v0",
        INCREMENTAL_ALTER_CONFIGS, 0, "response",
        {
            "throttle_time_ms": 0,
            "responses": [
                {
                    "error_code": 0,
                    "error_message": None,
                    "resource_type": 2,
                    "resource_name": "t",
                }
            ],
        },
        i32(0) + arr([i16(0) + s16(None) + i8(2) + s16("t")]),
    ),
    # AlterPartitionReassignments (45): flex-from-v0 both directions
    (
        "alter_partition_reassignments_req_v0_flex",
        ALTER_PARTITION_REASSIGNMENTS, 0, "request",
        {
            "timeout_ms": 60000,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {"partition_index": 0, "replicas": [1, 2, 3]},
                    ],
                }
            ],
        },
        i32(60000)
        + carr([
            cs("t")
            + carr([i32(0) + carr([i32(1), i32(2), i32(3)]) + TAG0])
            + TAG0
        ])
        + TAG0,
    ),
    (
        "alter_partition_reassignments_resp_v0_flex",
        ALTER_PARTITION_REASSIGNMENTS, 0, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "error_message": None,
            "responses": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "error_code": 0,
                            "error_message": None,
                        },
                    ],
                }
            ],
        },
        i32(0) + i16(0) + cs(None)
        + carr([
            cs("t") + carr([i32(0) + i16(0) + cs(None) + TAG0]) + TAG0
        ])
        + TAG0,
    ),
    # ListPartitionReassignments (46): flex-from-v0 both directions
    (
        "list_partition_reassignments_req_v0_flex",
        LIST_PARTITION_REASSIGNMENTS, 0, "request",
        {
            "timeout_ms": 60000,
            "topics": None,
        },
        i32(60000) + carr(None) + TAG0,
    ),
    (
        "list_partition_reassignments_resp_v0_flex",
        LIST_PARTITION_REASSIGNMENTS, 0, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "error_message": None,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "replicas": [1, 2],
                            "adding_replicas": [3],
                            "removing_replicas": [],
                        },
                    ],
                }
            ],
        },
        i32(0) + i16(0) + cs(None)
        + carr([
            cs("t")
            + carr([
                i32(0) + carr([i32(1), i32(2)]) + carr([i32(3)])
                + carr([]) + TAG0
            ])
            + TAG0
        ])
        + TAG0,
    ),
    # OffsetDelete (47): v0 both directions
    (
        "offset_delete_req_v0",
        OFFSET_DELETE, 0, "request",
        {
            "group_id": "g1",
            "topics": [
                {"name": "t", "partitions": [{"partition_index": 0}]},
            ],
        },
        s16("g1") + arr([s16("t") + arr([i32(0)])]),
    ),
    (
        "offset_delete_resp_v0",
        OFFSET_DELETE, 0, "response",
        {
            "error_code": 0,
            "throttle_time_ms": 0,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {"partition_index": 0, "error_code": 0},
                    ],
                }
            ],
        },
        i16(0) + i32(0) + arr([s16("t") + arr([i32(0) + i16(0)])]),
    ),
    # DescribeProducers (61): flex-from-v0 both directions
    (
        "describe_producers_req_v0_flex",
        DESCRIBE_PRODUCERS, 0, "request",
        {
            "topics": [{"name": "t", "partition_indexes": [0]}],
        },
        carr([cs("t") + carr([i32(0)]) + TAG0]) + TAG0,
    ),
    (
        "describe_producers_resp_v0_flex",
        DESCRIBE_PRODUCERS, 0, "response",
        {
            "throttle_time_ms": 0,
            "topics": [
                {
                    "name": "t",
                    "partitions": [
                        {
                            "partition_index": 0,
                            "error_code": 0,
                            "error_message": None,
                            "active_producers": [
                                {
                                    "producer_id": 4000,
                                    "producer_epoch": 1,
                                    "last_sequence": 10,
                                    "last_timestamp": 1690000000000,
                                    "coordinator_epoch": 0,
                                    "current_txn_start_offset": -1,
                                }
                            ],
                        }
                    ],
                }
            ],
        },
        i32(0)
        + carr([
            cs("t")
            + carr([
                i32(0) + i16(0) + cs(None)
                + carr([
                    i64(4000) + i32(1) + i32(10) + i64(1690000000000)
                    + i32(0) + i64(-1) + TAG0
                ])
                + TAG0
            ])
            + TAG0
        ])
        + TAG0,
    ),
    # DescribeTransactions (65): flex-from-v0 both directions
    (
        "describe_transactions_req_v0_flex",
        DESCRIBE_TRANSACTIONS, 0, "request",
        {"transactional_ids": ["txn-1"]},
        carr([cs("txn-1")]) + TAG0,
    ),
    (
        "describe_transactions_resp_v0_flex",
        DESCRIBE_TRANSACTIONS, 0, "response",
        {
            "throttle_time_ms": 0,
            "transaction_states": [
                {
                    "error_code": 0,
                    "transactional_id": "txn-1",
                    "transaction_state": "Ongoing",
                    "transaction_timeout_ms": 60000,
                    "transaction_start_time_ms": 1690000000000,
                    "producer_id": 4000,
                    "producer_epoch": 1,
                    "topics": [
                        {"topic": "t", "partitions": [0, 1]},
                    ],
                }
            ],
        },
        i32(0)
        + carr([
            i16(0) + cs("txn-1") + cs("Ongoing") + i32(60000)
            + i64(1690000000000) + i64(4000) + i16(1)
            + carr([cs("t") + carr([i32(0), i32(1)]) + TAG0])
            + TAG0
        ])
        + TAG0,
    ),
    # ListTransactions (66): flex-from-v0 both directions
    (
        "list_transactions_req_v0_flex",
        LIST_TRANSACTIONS, 0, "request",
        {"state_filters": [], "producer_id_filters": []},
        carr([]) + carr([]) + TAG0,
    ),
    (
        "list_transactions_resp_v0_flex",
        LIST_TRANSACTIONS, 0, "response",
        {
            "throttle_time_ms": 0,
            "error_code": 0,
            "unknown_state_filters": [],
            "transaction_states": [
                {
                    "transactional_id": "txn-1",
                    "producer_id": 4000,
                    "transaction_state": "Ongoing",
                }
            ],
        },
        i32(0) + i16(0) + carr([])
        + carr([cs("txn-1") + i64(4000) + cs("Ongoing") + TAG0])
        + TAG0,
    ),
]


def _subset_eq(expected, actual, path=""):
    """Every field in `expected` must decode to the same value."""
    if isinstance(expected, dict):
        for k, v in expected.items():
            assert k in actual, f"{path}.{k} missing from decode"
            _subset_eq(v, actual[k], f"{path}.{k}")
    elif isinstance(expected, list):
        assert len(expected) == len(actual), f"{path} length"
        for i, (e, a) in enumerate(zip(expected, actual)):
            _subset_eq(e, a, f"{path}[{i}]")
    else:
        got = bytes(actual) if isinstance(actual, (bytes, memoryview)) else actual
        assert expected == got, f"{path}: {expected!r} != {got!r}"


def _codec_bytes(api, version, direction, fields):
    msg = Msg(fields)
    if direction == "request":
        return api.encode_request(msg, version)
    return api.encode_response(msg, version)


@pytest.mark.parametrize(
    "name,api,version,direction,fields,golden",
    VECTORS,
    ids=[v[0] for v in VECTORS],
)
def test_encode_byte_exact(name, api, version, direction, fields, golden):
    assert _codec_bytes(api, version, direction, fields) == golden, (
        f"{name}: encoder drifted from the Kafka wire spec"
    )


@pytest.mark.parametrize(
    "name,api,version,direction,fields,golden",
    VECTORS,
    ids=[v[0] for v in VECTORS],
)
def test_decode_field_exact(name, api, version, direction, fields, golden):
    if direction == "request":
        decoded = api.decode_request(golden, version)
    else:
        decoded = api.decode_response(golden, version)
    _subset_eq(fields, decoded, name)


def test_corpus_frozen():
    """The golden bytes are also frozen on disk: a change to either the
    spec-builder above or the corpus files must be deliberate (set
    RP_WIRE_CORPUS_WRITE=1 to regenerate). A MISSING file fails — if it
    silently regenerated, a builder edit plus a lost file would defeat
    the two-party drift guard."""
    regen = os.environ.get("RP_WIRE_CORPUS_WRITE")
    if regen:
        os.makedirs(CORPUS, exist_ok=True)
    for name, _api, _v, _d, _f, golden in VECTORS:
        path = os.path.join(CORPUS, f"{name}.bin")
        if regen:
            with open(path, "wb") as f:
                f.write(golden)
        assert os.path.exists(path), (
            f"corpus file missing: {name}.bin (RP_WIRE_CORPUS_WRITE=1 "
            "to create deliberately)"
        )
        with open(path, "rb") as f:
            assert f.read() == golden, f"corpus drift: {name}"


def test_coverage_floor():
    """VERDICT r4 #3: EVERY registered API has golden vectors — zero
    APIs vector-free, and every API with a request schema has a
    request vector (responses likewise). Prints the per-API coverage
    table the verdict asked for on failure."""
    import redpanda_tpu_torch.kafka.protocol.apis as _apis
    import redpanda_tpu_torch.kafka.protocol.admin_apis as _admin
    import redpanda_tpu_torch.kafka.protocol.group_apis as _group
    import redpanda_tpu_torch.kafka.protocol.tx_apis as _tx

    registered = {}
    for mod in (_apis, _admin, _group, _tx):
        for v in vars(mod).values():
            if hasattr(v, "key") and hasattr(v, "encode_request"):
                registered[v.key] = v

    cover: dict[int, dict] = {
        k: {"name": a.name, "request": set(), "response": set()}
        for k, a in registered.items()
    }
    for _name, api, version, direction, _f, _g in VECTORS:
        cover[api.key][direction].add(version)

    table = "\n".join(
        f"{k:>3} {c['name']:<32} req={sorted(c['request'])} "
        f"resp={sorted(c['response'])}"
        for k, c in sorted(cover.items())
    )
    missing = [
        f"{k} {c['name']}: no {d} vectors"
        for k, c in sorted(cover.items())
        for d in ("request", "response")
        if not c[d]
    ]
    # list_groups v0-2 requests are empty-bodied at v0 (vector exists);
    # every API must have at least one vector in EACH direction
    assert not missing, f"vector-free APIs:\n" + "\n".join(missing) + (
        "\n\ncoverage table:\n" + table
    )
    assert len(cover) >= 40, table
    # flex and non-flex both exercised
    assert any(
        v[1].flex_since is not None and v[2] >= v[1].flex_since
        for v in VECTORS
    )
    assert any(
        v[1].flex_since is None or v[2] < v[1].flex_since for v in VECTORS
    )
