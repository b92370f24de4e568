"""tests/test_kafka_protocol.py run on the port: all 27 cases, with
imports pointed at redpanda_tpu_torch. Nothing is left out.

Kafka wire protocol codec tests.

Reference test model: kafka/protocol/tests (request/response
round-trips across versions, flex and non-flex encodings).
"""

import pytest

from redpanda_tpu_torch.kafka.protocol import (
    API_VERSIONS,
    CREATE_TOPICS,
    FETCH,
    LIST_OFFSETS,
    METADATA,
    PRODUCE,
    Msg,
    Reader,
    RequestHeader,
    Writer,
    decode_request_header,
    encode_request_header,
)
from redpanda_tpu_torch.kafka.protocol.wire import encode_uvarint


def test_varint_roundtrip():
    for v in [0, 1, 127, 128, 300, 2**31 - 1]:
        r = Reader(encode_uvarint(v))
        assert r.read_uvarint() == v
    w = Writer()
    for v in [0, -1, 1, -64, 64, 2**31 - 1, -(2**31)]:
        w.write_varint(v)
    r = Reader(w.build())
    for v in [0, -1, 1, -64, 64, 2**31 - 1, -(2**31)]:
        assert r.read_varint() == v


def test_strings_classic_and_compact():
    w = Writer()
    w.write_string("hello")
    w.write_nullable_string(None)
    w.write_compact_string("world")
    w.write_compact_nullable_string(None)
    r = Reader(w.build())
    assert r.read_string() == "hello"
    assert r.read_nullable_string() is None
    assert r.read_compact_string() == "world"
    assert r.read_compact_nullable_string() is None


@pytest.mark.parametrize("version", [0, 1, 2, 3])
def test_api_versions_roundtrip(version):
    resp = Msg(
        error_code=0,
        api_keys=[
            Msg(api_key=0, min_version=0, max_version=9),
            Msg(api_key=18, min_version=0, max_version=3),
        ],
        throttle_time_ms=0,
    )
    raw = API_VERSIONS.encode_response(resp, version)
    back = API_VERSIONS.decode_response(raw, version)
    assert back.error_code == 0
    assert len(back.api_keys) == 2
    assert back.api_keys[1].max_version == 3


@pytest.mark.parametrize("version", [0, 3, 5, 7, 8, 9])
def test_produce_request_roundtrip(version):
    req = Msg(
        transactional_id=None,
        acks=-1,
        timeout_ms=30000,
        topics=[
            Msg(
                name="t1",
                partitions=[Msg(index=0, records=b"\x01\x02\x03\x04")],
            )
        ],
    )
    raw = PRODUCE.encode_request(req, version)
    back = PRODUCE.decode_request(raw, version)
    assert back.acks == -1
    assert back.timeout_ms == 30000
    assert back.topics[0].name == "t1"
    assert bytes(back.topics[0].partitions[0].records) == b"\x01\x02\x03\x04"


@pytest.mark.parametrize("version", [1, 4, 7, 11])
def test_fetch_request_roundtrip(version):
    req = Msg(
        replica_id=-1,
        max_wait_ms=500,
        min_bytes=1,
        max_bytes=1 << 20,
        isolation_level=0,
        session_id=0,
        session_epoch=-1,
        topics=[
            Msg(
                topic="t1",
                partitions=[
                    Msg(
                        partition=3,
                        current_leader_epoch=-1,
                        fetch_offset=42,
                        log_start_offset=0,
                        partition_max_bytes=1 << 20,
                    )
                ],
            )
        ],
        forgotten_topics_data=[],
        rack_id="",
    )
    raw = FETCH.encode_request(req, version)
    back = FETCH.decode_request(raw, version)
    assert back.max_wait_ms == 500
    assert back.topics[0].partitions[0].fetch_offset == 42


@pytest.mark.parametrize("version", [0, 1, 5, 9])
def test_metadata_roundtrip(version):
    resp = Msg(
        throttle_time_ms=0,
        brokers=[Msg(node_id=1, host="localhost", port=9092, rack=None)],
        cluster_id="c1",
        controller_id=1,
        topics=[
            Msg(
                error_code=0,
                name="t1",
                is_internal=False,
                partitions=[
                    Msg(
                        error_code=0,
                        partition_index=0,
                        leader_id=1,
                        leader_epoch=1,
                        replica_nodes=[1, 2, 3],
                        isr_nodes=[1, 2],
                        offline_replicas=[],
                    )
                ],
            )
        ],
    )
    raw = METADATA.encode_response(resp, version)
    back = METADATA.decode_response(raw, version)
    assert back.brokers[0].host == "localhost"
    t = back.topics[0]
    assert t.name == "t1"
    assert t.partitions[0].replica_nodes == [1, 2, 3]
    # null topics (all) round-trips on v1+
    if version >= 1:
        raw = METADATA.encode_request(Msg(topics=None), version)
        assert METADATA.decode_request(raw, version).topics is None


@pytest.mark.parametrize("version", [1, 2, 5])
def test_list_offsets_roundtrip(version):
    req = Msg(
        replica_id=-1,
        isolation_level=0,
        topics=[
            Msg(
                name="t1",
                partitions=[
                    Msg(partition_index=0, current_leader_epoch=-1, timestamp=-1)
                ],
            )
        ],
    )
    raw = LIST_OFFSETS.encode_request(req, version)
    back = LIST_OFFSETS.decode_request(raw, version)
    assert back.topics[0].partitions[0].timestamp == -1


@pytest.mark.parametrize("version", [0, 2, 4])
def test_create_topics_roundtrip(version):
    req = Msg(
        topics=[
            Msg(
                name="t1",
                num_partitions=3,
                replication_factor=1,
                assignments=[],
                configs=[Msg(name="retention.ms", value="1000")],
            )
        ],
        timeout_ms=10000,
        validate_only=False,
    )
    raw = CREATE_TOPICS.encode_request(req, version)
    back = CREATE_TOPICS.decode_request(raw, version)
    assert back.topics[0].num_partitions == 3
    assert back.topics[0].configs[0].value == "1000"


def test_request_header_roundtrip():
    for key, ver in [(0, 7), (18, 3), (3, 9)]:
        hdr = RequestHeader(key, ver, 123, "cli")
        raw = encode_request_header(hdr)
        back = decode_request_header(Reader(raw))
        assert back == hdr
