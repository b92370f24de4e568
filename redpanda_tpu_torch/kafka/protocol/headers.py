"""Request/response header codecs + error codes.

Reference: src/v/kafka/protocol/types.h (request_header),
kafka/server/protocol_utils.cc (header parse), kafka/protocol/errors.h
(error_code enum).

Header-version rules follow Kafka: flexible request versions use
header v2 (classic nullable client_id + tagged fields — client_id is
NOT compact, a wire quirk), flexible responses header v1; the
ApiVersions response always uses header v0 so old clients can parse
the UNSUPPORTED_VERSION downgrade reply.
"""

from __future__ import annotations

import dataclasses
import enum

from .apis import API_BY_KEY, API_VERSIONS
from .wire import Reader, Writer


class ErrorCode(enum.IntEnum):
    none = 0
    offset_out_of_range = 1
    corrupt_message = 2
    unknown_topic_or_partition = 3
    invalid_fetch_size = 4
    leader_not_available = 5
    not_leader_for_partition = 6
    request_timed_out = 7
    broker_not_available = 8
    replica_not_available = 9
    message_too_large = 10
    network_exception = 13
    coordinator_load_in_progress = 14
    coordinator_not_available = 15
    not_coordinator = 16
    invalid_topic_exception = 17
    record_list_too_large = 18
    not_enough_replicas = 19
    not_enough_replicas_after_append = 20
    invalid_required_acks = 21
    illegal_generation = 22
    inconsistent_group_protocol = 23
    invalid_group_id = 24
    unknown_member_id = 25
    invalid_session_timeout = 26
    rebalance_in_progress = 27
    invalid_commit_offset_size = 28
    topic_authorization_failed = 29
    group_authorization_failed = 30
    cluster_authorization_failed = 31
    invalid_timestamp = 32
    unsupported_sasl_mechanism = 33
    illegal_sasl_state = 34
    unsupported_version = 35
    topic_already_exists = 36
    invalid_partitions = 37
    invalid_replication_factor = 38
    invalid_replica_assignment = 39
    invalid_config = 40
    not_controller = 41
    invalid_request = 42
    unsupported_for_message_format = 43
    policy_violation = 44
    out_of_order_sequence_number = 45
    duplicate_sequence_number = 46
    invalid_producer_epoch = 47
    invalid_txn_state = 48
    invalid_producer_id_mapping = 49
    invalid_transaction_timeout = 50
    concurrent_transactions = 51
    transaction_coordinator_fenced = 52
    transactional_id_authorization_failed = 53
    security_disabled = 54
    operation_not_attempted = 55
    kafka_storage_error = 56
    unknown_server_error = -1
    non_empty_group = 68
    fenced_instance_id = 82
    group_id_not_found = 69
    fetch_session_id_not_found = 70
    invalid_fetch_session_epoch = 71
    member_id_required = 79
    preferred_leader_not_available = 80
    group_max_size_reached = 81
    group_subscribed_to_topic = 86
    unstable_offset_commit = 88
    sasl_authentication_failed = 58
    no_reassignment_in_progress = 85
    producer_fenced = 90
    transactional_id_not_found = 105


@dataclasses.dataclass(slots=True)
class RequestHeader:
    api_key: int
    api_version: int
    correlation_id: int
    client_id: str | None


def request_header_version(api_key: int, api_version: int) -> int:
    api = API_BY_KEY.get(api_key)
    if api is not None and api.flexible(api_version):
        return 2
    return 1


def response_header_version(api_key: int, api_version: int) -> int:
    if api_key == API_VERSIONS.key:
        return 0  # always parseable by v0 clients
    api = API_BY_KEY.get(api_key)
    if api is not None and api.flexible(api_version):
        return 1
    return 0


def decode_request_header(r: Reader) -> RequestHeader:
    api_key = r.read_int16()
    api_version = r.read_int16()
    correlation_id = r.read_int32()
    client_id = r.read_nullable_string()
    if request_header_version(api_key, api_version) >= 2:
        r.skip_tagged_fields()
    return RequestHeader(api_key, api_version, correlation_id, client_id)


def encode_request_header(hdr: RequestHeader) -> bytes:
    w = Writer()
    w.write_int16(hdr.api_key)
    w.write_int16(hdr.api_version)
    w.write_int32(hdr.correlation_id)
    w.write_nullable_string(hdr.client_id)
    if request_header_version(hdr.api_key, hdr.api_version) >= 2:
        w.write_empty_tagged_fields()
    return w.build()


def encode_response_header(
    api_key: int, api_version: int, correlation_id: int
) -> bytes:
    w = Writer()
    w.write_int32(correlation_id)
    if response_header_version(api_key, api_version) >= 1:
        w.write_empty_tagged_fields()
    return w.build()
