"""tests/test_native_records.py run on the port: the native record
walker/builder (native/records.cc, loaded by utils/native.py) against
the port's pure-Python wire codec (models/record.py), byte for byte.

The reference file is copied with its imports pointed at
redpanda_tpu_torch. Carried: every case. Left out: nothing.
"""

import random

import pytest

from redpanda_tpu_torch.models.record import (
    _DESC_W,
    Record,
    RecordBatch,
    RecordBatchBuilder,
    RecordHeader,
    parse_record_descriptors,
)
from redpanda_tpu_torch.utils import native
from redpanda_tpu_torch.utils.iobuf import IOBufParser

pytestmark = pytest.mark.skipif(
    native.load() is None, reason="native library unavailable"
)


def _rand_record(rng: random.Random):
    key = None if rng.random() < 0.3 else rng.randbytes(rng.randrange(0, 40))
    val = None if rng.random() < 0.1 else rng.randbytes(rng.randrange(0, 200))
    hdrs = []
    if rng.random() < 0.25:
        hdrs = [
            (rng.randbytes(rng.randrange(1, 8)), rng.randbytes(rng.randrange(0, 20)))
            for _ in range(rng.randrange(1, 4))
        ]
    ts = rng.randrange(-5, 1000)
    return ts, key, val, hdrs


def test_differential_encode_decode():
    rng = random.Random(7)
    for trial in range(100):
        recs = [_rand_record(rng) for _ in range(rng.randrange(1, 50))]
        builder = RecordBatchBuilder(timestamp_ms=1000)
        for ts, k, v, h in recs:
            builder.add(v, key=k, headers=h, timestamp_ms=1000 + ts)
        batch = builder.build()

        py_raw = b"".join(
            Record(0, ts, i, k, v, [RecordHeader(a, c) for a, c in h]).encode()
            for i, (ts, k, v, h) in enumerate(recs)
        )
        assert batch.body == py_raw, f"encode mismatch trial {trial}"

        parser = IOBufParser(batch.body)
        want = [Record.decode(parser) for _ in range(len(recs))]
        assert batch.records() == want, f"decode mismatch trial {trial}"


def test_descriptor_fields_match_python_decode():
    builder = RecordBatchBuilder(timestamp_ms=50)
    builder.add(b"v0", key=b"alpha", timestamp_ms=53)
    builder.add(None, key=None, timestamp_ms=49)
    builder.add(b"", key=b"", headers=[(b"h", b"x")], timestamp_ms=50)
    batch = builder.build()
    data = batch.body
    desc = parse_record_descriptors(data, 3)
    assert desc is not None and len(desc) == 3 * _DESC_W

    parser = IOBufParser(data)
    for i in range(3):
        want = Record.decode(parser)
        o = i * _DESC_W
        assert desc[o + 2] == want.attributes
        assert desc[o + 3] == want.timestamp_delta
        assert desc[o + 4] == want.offset_delta == i
        key = data[desc[o + 5] : desc[o + 5] + desc[o + 6]] if desc[o + 6] >= 0 else None
        val = data[desc[o + 7] : desc[o + 7] + desc[o + 8]] if desc[o + 8] >= 0 else None
        assert key == want.key and val == want.value
        assert desc[o + 10] == len(want.headers)
    # verbatim slice property: concatenated [rec_off, end_off) spans
    # reproduce the body exactly
    assert b"".join(
        data[desc[o] : desc[o + 1]] for o in range(0, len(desc), _DESC_W)
    ) == data


def test_malformed_rejection():
    batch = RecordBatchBuilder(timestamp_ms=5).add(b"hello", key=b"k").build()
    for cut in range(len(batch.body)):
        with pytest.raises(ValueError):
            parse_record_descriptors(batch.body[:cut], 1)
    with pytest.raises(ValueError):
        parse_record_descriptors(b"\xff" * 12, 1)  # overlong varint
    # trailing bytes after the last record are IGNORED — identical to
    # the pure-Python decoder, so both hosts accept the same inputs
    desc = parse_record_descriptors(batch.body + b"\x00", 1)
    assert desc is not None and len(desc) == _DESC_W


def test_hostile_record_count_bounded():
    """record_count comes from the (CRC-covered but writer-controlled)
    batch header: a huge value must NOT size an allocation, and a
    negative one decodes to [] like the Python range() path."""
    body = b"\x01\x02\x03"
    with pytest.raises(ValueError):
        parse_record_descriptors(body, 2**31 - 1)
    with pytest.raises(ValueError):
        parse_record_descriptors(body, 10**9)
    assert parse_record_descriptors(body, -5) == []
    assert parse_record_descriptors(body, 0) == []
