"""tests/test_produce_fast.py run on the port: all 44 cases, with imports
pointed at redpanda_tpu_torch (the native produce parse is the port's
`utils.native`). Nothing is left out.

Byte-parity of the hand-rolled produce fast codec against the
generic schema codec, across the supported version range. The generic
codec is golden-vector validated (test_kafka_wire_golden), so equality
transfers those guarantees to the fast path."""

import os

import pytest

from redpanda_tpu_torch.kafka.protocol import produce_fast as pf
from redpanda_tpu_torch.kafka.protocol.apis import PRODUCE
from redpanda_tpu_torch.kafka.protocol.schema import Msg

RECORDS = os.urandom(257)
VERSIONS = list(range(3, 10))


def _flex(v):
    return PRODUCE.flexible(v)


@pytest.mark.parametrize("v", VERSIONS)
@pytest.mark.parametrize("txid", [None, "tx-7"])
def test_request_encode_parity(v, txid):
    msg = Msg(
        transactional_id=txid,
        acks=-1,
        timeout_ms=30000,
        topics=[
            Msg(name="topic-a", partitions=[Msg(index=42, records=RECORDS)])
        ],
    )
    generic = PRODUCE.encode_request(msg, v)
    fast = pf.encode_request_single(
        v, _flex(v), txid, -1, 30000, "topic-a", 42, RECORDS
    )
    assert fast == generic, f"v{v} txid={txid}"


@pytest.mark.parametrize("v", VERSIONS)
def test_request_decode_parity(v):
    msg = Msg(
        transactional_id=None,
        acks=1,
        timeout_ms=5000,
        topics=[
            Msg(name="t", partitions=[Msg(index=3, records=RECORDS)])
        ],
    )
    wire = PRODUCE.encode_request(msg, v)
    fast = pf.decode_request(wire, v, _flex(v))
    generic = PRODUCE.decode_request(wire, v)
    assert fast is not None
    assert fast.transactional_id == generic.transactional_id
    assert fast.acks == generic.acks
    assert fast.timeout_ms == generic.timeout_ms
    assert len(fast.topics) == 1
    ft, gt = fast.topics[0], generic.topics[0]
    assert ft.name == gt.name
    fp, gp = ft.partitions[0], gt.partitions[0]
    assert fp.index == gp.index
    assert bytes(fp.records) == bytes(gp.records)


def test_request_decode_bails_on_multi_shapes():
    v = 7
    multi_topic = Msg(
        transactional_id=None,
        acks=-1,
        timeout_ms=1000,
        topics=[
            Msg(name="a", partitions=[Msg(index=0, records=RECORDS)]),
            Msg(name="b", partitions=[Msg(index=0, records=RECORDS)]),
        ],
    )
    assert pf.decode_request(
        PRODUCE.encode_request(multi_topic, v), v, False
    ) is None
    multi_part = Msg(
        transactional_id=None,
        acks=-1,
        timeout_ms=1000,
        topics=[
            Msg(
                name="a",
                partitions=[
                    Msg(index=0, records=RECORDS),
                    Msg(index=1, records=RECORDS),
                ],
            )
        ],
    )
    assert pf.decode_request(
        PRODUCE.encode_request(multi_part, v), v, False
    ) is None
    assert pf.decode_request(b"\x00", 7, False) is None


@pytest.mark.parametrize("v", VERSIONS)
@pytest.mark.parametrize("err,base", [(0, 12345), (6, -1)])
def test_response_encode_parity(v, err, base):
    msg = Msg(
        responses=[
            Msg(
                name="topic-a",
                partition_responses=[
                    Msg(
                        index=42,
                        error_code=err,
                        base_offset=base,
                        log_append_time_ms=-1,
                        log_start_offset=0 if not err else -1,
                        record_errors=[],
                        error_message=None,
                    )
                ],
            )
        ],
        throttle_time_ms=0,
    )
    generic = PRODUCE.encode_response(msg, v)
    fast = pf.encode_response_single(
        v, _flex(v), "topic-a", 42, err, base,
        log_start_offset=0 if not err else -1,
    )
    assert fast == generic, f"v{v} err={err}"


@pytest.mark.parametrize("v", VERSIONS)
def test_response_decode_parity(v):
    wire = pf.encode_response_single(v, _flex(v), "t", 9, 0, 777,
                                     log_start_offset=5)
    out = pf.decode_response_single(wire, v, _flex(v))
    assert out == (0, 777)
    generic = PRODUCE.decode_response(wire, v)
    pr = generic.responses[0].partition_responses[0]
    assert (pr.error_code, pr.base_offset) == out


def test_response_decode_bails_on_record_errors():
    v = 9
    msg = Msg(
        responses=[
            Msg(
                name="t",
                partition_responses=[
                    Msg(
                        index=0,
                        error_code=87,
                        base_offset=-1,
                        log_append_time_ms=-1,
                        log_start_offset=-1,
                        record_errors=[
                            Msg(batch_index=0,
                                batch_index_error_message="bad")
                        ],
                        error_message="invalid",
                    )
                ],
            )
        ],
        throttle_time_ms=0,
    )
    wire = PRODUCE.encode_response(msg, v)
    assert pf.decode_response_single(wire, v, _flex(v)) is None
