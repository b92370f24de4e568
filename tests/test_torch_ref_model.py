"""tests/test_model.py (the reference's data-model tests) run on the port.

The reference file is copied with its imports pointed at
redpanda_tpu_torch. Carried: every case. Left out: nothing. One
setting differs: `batch_crcs` / `verify_batch_crcs` default to the
card in the port, so an autouse fixture sets RP_CRC_BACKEND=host, the
reference's default (the device CRC is held by test_torch_crc32c.py).
"""

import pytest

from redpanda_tpu_torch.compression import CompressionType
from redpanda_tpu_torch.models import (
    NTP,
    CrcMismatch,
    Record,
    RecordBatch,
    RecordBatchBuilder,
    RecordBatchType,
    batch_crcs,
    verify_batch_crcs,
)
from redpanda_tpu_torch.utils.iobuf import IOBufParser


@pytest.fixture(autouse=True)
def _host_crc(monkeypatch):
    # the reference's batch_crcs runs the host CRC unless
    # RP_CRC_BACKEND=device; the port's takes the card unless
    # RP_CRC_BACKEND=host
    monkeypatch.setenv("RP_CRC_BACKEND", "host")


def make_batch(n=3, base_offset=100, compression=CompressionType.none, ts=1_700_000_000_000):
    b = RecordBatchBuilder(
        RecordBatchType.raft_data,
        base_offset=base_offset,
        compression=compression,
        timestamp_ms=ts,
    )
    for i in range(n):
        b.add(
            f"value-{i}".encode(),
            key=f"key-{i}".encode(),
            headers=[(b"h1", b"v1")],
            timestamp_ms=ts + i,
        )
    return b.build()


class TestRecordRoundtrip:
    def test_record_encode_decode(self):
        rec = Record(
            attributes=0,
            timestamp_delta=5,
            offset_delta=2,
            key=b"k",
            value=b"v" * 100,
            headers=[],
        )
        out = Record.decode(IOBufParser(rec.encode()))
        assert out == rec

    def test_null_key_value(self):
        rec = Record(key=None, value=None)
        out = Record.decode(IOBufParser(rec.encode()))
        assert out.key is None and out.value is None


class TestRecordBatch:
    def test_build_and_read(self):
        batch = make_batch(5)
        assert batch.record_count == 5
        assert batch.base_offset == 100
        assert batch.last_offset == 104
        recs = batch.records()
        assert [r.value for r in recs] == [f"value-{i}".encode() for i in range(5)]
        assert recs[0].headers[0].key == b"h1"

    def test_dual_crc_valid(self):
        batch = make_batch()
        assert batch.verify_crc()

    def test_header_crc_detects_header_tamper(self):
        batch = make_batch()
        batch.header.base_offset += 1
        assert not batch.verify_crc()

    def test_body_crc_detects_payload_tamper(self):
        batch = make_batch()
        batch.body = batch.body[:-1] + bytes([batch.body[-1] ^ 0xFF])
        assert batch.header.header_crc == batch.header.compute_header_crc()
        assert batch.header.crc != batch.compute_crc()

    def test_internal_serialize_roundtrip(self):
        batch = make_batch(4)
        data = batch.serialize()
        out = RecordBatch.deserialize(data)
        assert out.header == batch.header
        assert out.body == batch.body
        assert out.verify_crc()

    @pytest.mark.parametrize(
        "ctype",
        [CompressionType.none, CompressionType.lz4, CompressionType.zstd, CompressionType.snappy, CompressionType.gzip],
    )
    def test_compressed_batches(self, ctype):
        batch = make_batch(50, compression=ctype)
        assert batch.header.compression == ctype
        assert batch.verify_crc()
        recs = batch.records()
        assert len(recs) == 50
        assert recs[49].value == b"value-49"


class TestKafkaWire:
    def test_wire_roundtrip(self):
        batch = make_batch(3)
        wire = batch.to_kafka_wire()
        out = RecordBatch.from_kafka_wire(wire)
        assert out.header.crc == batch.header.crc
        assert out.body == batch.body
        assert out.header.base_offset == batch.header.base_offset
        assert out.header.record_count == 3
        assert out.verify_crc()

    def test_wire_layout(self):
        # field positions must match the Kafka v2 batch spec
        batch = make_batch(1, base_offset=7)
        wire = batch.to_kafka_wire()
        assert int.from_bytes(wire[0:8], "big") == 7  # base_offset
        batch_length = int.from_bytes(wire[8:12], "big")
        assert batch_length == len(wire) - 12
        assert wire[16] == 2  # magic
        crc = int.from_bytes(wire[17:21], "big")
        assert crc == batch.header.crc & 0xFFFFFFFF

    def test_wire_crc_rejects_corruption(self):
        batch = make_batch(2)
        wire = bytearray(batch.to_kafka_wire())
        wire[-1] ^= 0x01
        with pytest.raises(CrcMismatch):
            RecordBatch.from_kafka_wire(bytes(wire))

    def test_crc_covers_attributes_onward(self):
        # flipping a bit in the attributes must invalidate the Kafka crc
        batch = make_batch(2)
        wire = bytearray(batch.to_kafka_wire())
        wire[22] ^= 0x40  # attributes high byte region
        with pytest.raises(CrcMismatch):
            RecordBatch.from_kafka_wire(bytes(wire))


class TestBatchedValidation:
    def test_batch_crcs_matches_scalar(self):
        batches = [make_batch(i + 1, base_offset=i * 10) for i in range(16)]
        crcs = batch_crcs(batches)
        for i, b in enumerate(batches):
            assert int(crcs[i]) == b.header.crc & 0xFFFFFFFF
        assert verify_batch_crcs(batches)

    def test_detects_bad_batch(self):
        batches = [make_batch(2) for _ in range(4)]
        batches[2].body = b"\x00" + batches[2].body[1:]
        assert not verify_batch_crcs(batches)


class TestNTP:
    def test_str(self):
        ntp = NTP("kafka", "orders", 3)
        assert str(ntp) == "{kafka/orders/3}"
        assert str(ntp.tp_ns) == "kafka/orders"
