"""Hand-rolled produce codec for the single-topic/single-partition
case — the produce hot shape (one batch to one partition per request).

The generic schema walker (schema.py _encode_value/_decode_value) costs
~25 µs per direction per message on this path; these straight-line
struct packs cost ~3 µs. Byte-for-byte parity with the generic codec is
asserted by tests/test_produce_fast.py across the full version range,
so the golden-vector guarantees transfer.

Reference shape: src/v/kafka/server/handlers/produce.cc builds its
response directly too (no generic walker on the reference hot path).
"""

from __future__ import annotations

import struct

from ...utils import native as native_mod
from .headers import RequestHeader
from .schema import Msg
from .wire import Reader, encode_uvarint

_HDR_NONFLEX = struct.Struct(">hi")  # acks, timeout_ms
_PART_NONFLEX = struct.Struct(">ii")  # partitions count=1, index
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")

# -- request ----------------------------------------------------------


def encode_request_single(
    version: int,
    flexible: bool,
    transactional_id: str | None,
    acks: int,
    timeout_ms: int,
    topic: str,
    index: int,
    records: bytes,
) -> bytes | None:
    """Encoded produce request body for one topic/partition, or None
    when the version is outside the supported fast range."""
    if version < 3 or version > 9:
        return None
    name = topic.encode()
    parts = []
    if not flexible:
        if transactional_id is None:
            parts.append(b"\xff\xff")
        else:
            t = transactional_id.encode()
            parts.append(_I16.pack(len(t)) + t)
        parts.append(_HDR_NONFLEX.pack(acks, timeout_ms))
        parts.append(_I32.pack(1))  # topics count
        parts.append(_I16.pack(len(name)) + name)
        parts.append(_PART_NONFLEX.pack(1, index))
        parts.append(_I32.pack(len(records)))
        parts.append(records)
        return b"".join(parts)
    # flexible (v9): compact encodings + tagged-field terminators
    if transactional_id is None:
        parts.append(b"\x00")
    else:
        t = transactional_id.encode()
        parts.append(encode_uvarint(len(t) + 1) + t)
    parts.append(_HDR_NONFLEX.pack(acks, timeout_ms))
    parts.append(b"\x02")  # topics compact count 1+1
    parts.append(encode_uvarint(len(name) + 1) + name)
    parts.append(b"\x02")  # partitions compact count
    parts.append(_I32.pack(index))
    parts.append(encode_uvarint(len(records) + 1))
    parts.append(records)
    parts.append(b"\x00")  # partition tags
    parts.append(b"\x00")  # topic tags
    parts.append(b"\x00")  # top-level tags
    return b"".join(parts)


def decode_request(data, version: int, flexible: bool) -> Msg | None:
    """Decode a produce request if it has exactly one topic with one
    partition (the hot shape); None → caller falls back to the generic
    decoder. Matches schema.Api.decode_request field-for-field."""
    if version < 3 or version > 9:
        return None
    r = Reader(data)
    try:
        if flexible:
            txid = r.read_compact_nullable_string()
        else:
            txid = r.read_nullable_string()
        acks = r.read_int16()
        timeout_ms = r.read_int32()
        ntopics = r.read_array_len(flexible)
        if ntopics != 1:
            return None
        name = (
            r.read_compact_string() if flexible else r.read_string()
        )
        nparts = r.read_array_len(flexible)
        if nparts != 1:
            return None
        index = r.read_int32()
        records = r.read_records(flexible)
        if flexible:
            r.skip_tagged_fields()  # partition
            r.skip_tagged_fields()  # topic
            r.skip_tagged_fields()  # top level
        if r.remaining:
            return None  # trailing bytes: not the shape we expect
    except Exception:
        return None
    return Msg(
        transactional_id=txid,
        acks=acks,
        timeout_ms=timeout_ms,
        topics=[
            Msg(
                name=name,
                partitions=[Msg(index=index, records=records)],
            )
        ],
    )


def native_ready() -> bool:
    """Probe for the C produce frontend (RP_NATIVE / RP_NATIVE_PRODUCE
    escape hatches honored per call by utils/native.py)."""
    return native_mod.produce_frame_ready()


def decode_request_native(frame) -> tuple[RequestHeader, Msg] | None:
    """One C call over the whole request frame (header + body +
    per-batch wire CRC verification, native/produce_frame.cc). Returns
    (RequestHeader, Msg) for the hot single-topic/single-partition
    non-transactional shape with every batch CRC already verified
    (the partition Msg carries `_crc_ok=True` so the dispatch loop
    skips its per-batch verify pass), or None → the caller runs the
    header decode + generic/fast Python decoders, which reproduce the
    exact error semantics for every punt (corrupt batches must fail in
    dispatch order, unusual shapes take the schema walker, etc.)."""
    if not native_mod.produce_frame_ready():
        return None
    if not isinstance(frame, bytes):
        frame = bytes(frame)
    desc = native_mod.produce_frame(frame)
    if desc is None:
        return None
    (
        version, correlation_id, _flexible, cid_off, cid_len,
        acks, timeout_ms, topic_off, topic_len, index,
        rec_off, rec_len, _nbatches,
    ) = desc
    try:
        client_id = (
            None if cid_off < 0
            else frame[cid_off : cid_off + cid_len].decode("utf-8")
        )
        name = frame[topic_off : topic_off + topic_len].decode("utf-8")
    except UnicodeDecodeError:
        return None  # generic path reproduces the decode error
    hdr = RequestHeader(0, version, correlation_id, client_id)
    partition = Msg(
        index=index,
        records=memoryview(frame)[rec_off : rec_off + rec_len],
    )
    partition._crc_ok = True
    req = Msg(
        transactional_id=None,
        acks=acks,
        timeout_ms=timeout_ms,
        topics=[Msg(name=name, partitions=[partition])],
    )
    return hdr, req


# -- response ---------------------------------------------------------


def encode_response_single(
    version: int,
    flexible: bool,
    topic: str,
    index: int,
    error_code: int,
    base_offset: int,
    log_start_offset: int = -1,
) -> bytes | None:
    """Encoded produce response body for one topic/partition success or
    plain-error shape (no record_errors / error_message detail)."""
    if version < 3 or version > 9:
        return None
    name = topic.encode()
    parts = []
    if not flexible:
        parts.append(_I32.pack(1))
        parts.append(_I16.pack(len(name)) + name)
        parts.append(_I32.pack(1))
    else:
        parts.append(b"\x02")
        parts.append(encode_uvarint(len(name) + 1) + name)
        parts.append(b"\x02")
    parts.append(_I32.pack(index))
    parts.append(_I16.pack(error_code))
    parts.append(_I64.pack(base_offset))
    parts.append(_I64.pack(-1))  # log_append_time_ms (v2+)
    if version >= 5:
        parts.append(_I64.pack(log_start_offset))
    if version >= 8:
        if flexible:
            parts.append(b"\x01")  # record_errors: compact empty
            parts.append(b"\x00")  # error_message: compact null
        else:
            parts.append(_I32.pack(0))  # record_errors: empty array
            parts.append(b"\xff\xff")  # error_message: null
    if flexible:
        parts.append(b"\x00")  # partition tags
        parts.append(b"\x00")  # topic tags
    parts.append(_I32.pack(0))  # throttle_time_ms (v1+)
    if flexible:
        parts.append(b"\x00")  # top-level tags
    return b"".join(parts)


def decode_response_single(data, version: int, flexible: bool):
    """(error_code, base_offset) from a single-partition produce
    response, or None → generic decode (multi-partition, record-error
    detail, unexpected shape)."""
    if version < 3 or version > 9:
        return None
    r = Reader(data)
    try:
        if r.read_array_len(flexible) != 1:
            return None
        if flexible:
            r.read_compact_string()
        else:
            r.read_string()
        if r.read_array_len(flexible) != 1:
            return None
        r.read_int32()  # index
        error_code = r.read_int16()
        base_offset = r.read_int64()
        r.read_int64()  # log_append_time
        if version >= 5:
            r.read_int64()  # log_start_offset
        if version >= 8:
            n_err = r.read_array_len(flexible)
            if n_err != 0:
                return None  # per-record errors: caller wants detail
            if flexible:
                if r.read_compact_nullable_string() is not None:
                    return None
            else:
                if r.read_nullable_string() is not None:
                    return None
    except Exception:
        return None
    return error_code, base_offset
