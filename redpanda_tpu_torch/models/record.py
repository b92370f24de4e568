"""Record / record-batch data model with dual CRC.

Reference: src/v/model/record.h — `record`, `record_batch`,
`record_batch_header` carrying two checksums:

* `crc` — the Kafka-compatible CRC-32C over the batch body exactly as
  it appears on the Kafka wire from the `attributes` field onward
  (reference: model/record.h:398-400, model/record_utils.h:23-31).
* `header_crc` — CRC-32C over the *internal* batch header fields
  (little-endian), protecting the broker-side metadata the Kafka CRC
  does not cover (reference: model/record.h:392, recompute at
  model/record.h:659-660).

The on-disk / internal representation here is: a fixed 69-byte
little-endian internal header followed by the body (the Kafka v2
records section, possibly compressed). Conversion to/from the Kafka
wire batch framing (base_offset/batch_length/leader_epoch/magic + the
CRC-covered section) is loss-free; the CRC-covered section is stored
verbatim so produce → store → fetch never recomputes payload bytes.

Batched validation: `batch_crcs` stages many bodies into one padded
uint8 matrix for the host native batch CRC (and, through the same
layout, the device kernel in ops.crc32c) — the
`record_batch_crc_checker` (reference: model/record.h:763-781) turned
into one vectorized call.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import time
from typing import Iterable, Sequence

import numpy as np

from .. import compression as compression_mod
from ..compression import CompressionType
from ..utils import crc as crc_mod
from ..utils import native as native_mod
from ..utils import vint
from ..utils.iobuf import IOBufParser

# Width of one native record descriptor row (native/records.cc
# RP_REC_DESC_WIDTH): [rec_off, end_off, attrs, ts_delta, offset_delta,
# key_off, key_len, val_off, val_len, hdr_off, hdr_count].
_DESC_W = 11


class RecordBatchType(enum.IntEnum):
    """Reference: src/v/model/record_batch_types.h:21-41."""

    raft_data = 1
    raft_configuration = 2
    controller = 3
    kvstore = 4
    checkpoint = 5
    topic_management_cmd = 6
    ghost_batch = 7
    id_allocator = 8
    tx_prepare = 9
    tx_fence = 10
    tm_update = 11
    user_management_cmd = 12
    acl_management_cmd = 13
    group_prepare_tx = 14
    group_commit_tx = 15
    group_abort_tx = 16
    node_management_cmd = 17
    data_policy_management_cmd = 18
    archival_metadata = 19
    cluster_config_cmd = 20
    feature_update = 21
    cluster_bootstrap_cmd = 22


# attribute bit layout (Kafka batch attributes, i16)
_COMPRESSION_MASK = 0x07
_TIMESTAMP_TYPE_BIT = 1 << 3
_TRANSACTIONAL_BIT = 1 << 4
_CONTROL_BIT = 1 << 5

# internal header: header_crc | size_bytes | base_offset | type | crc |
# attrs | last_offset_delta | first_timestamp | max_timestamp |
# producer_id | producer_epoch | base_sequence | record_count | term
_HDR = struct.Struct("<IiqbIhiqqqhiiq")
HEADER_SIZE = _HDR.size  # 69 bytes

# Kafka wire: fixed section after batch_length field
_KAFKA_WIRE = struct.Struct(">qiibIhiqqqhii")
KAFKA_BATCH_OVERHEAD = _KAFKA_WIRE.size  # 61: base_offset..record_count
# bytes after the batch_length field, excluding records
_KAFKA_AFTER_LEN = KAFKA_BATCH_OVERHEAD - 12  # minus base_offset+batch_length
# the crc-covered prefix rebuilt from header fields (attributes onward)
_CRC_PREFIX = struct.Struct(">hiqqqhii")


@dataclasses.dataclass(slots=True)
class RecordHeader:
    key: bytes
    value: bytes


@dataclasses.dataclass(slots=True)
class Record:
    """One record inside a batch (reference: model/record.h record)."""

    attributes: int = 0
    timestamp_delta: int = 0
    offset_delta: int = 0
    key: bytes | None = None
    value: bytes | None = None
    headers: list[RecordHeader] = dataclasses.field(default_factory=list)

    def encode(self) -> bytes:
        body = bytearray()
        body += bytes([self.attributes & 0xFF])
        body += vint.encode(self.timestamp_delta)
        body += vint.encode(self.offset_delta)
        if self.key is None:
            body += vint.encode(-1)
        else:
            body += vint.encode(len(self.key))
            body += self.key
        if self.value is None:
            body += vint.encode(-1)
        else:
            body += vint.encode(len(self.value))
            body += self.value
        body += vint.encode(len(self.headers))
        for h in self.headers:
            body += vint.encode(len(h.key))
            body += h.key
            body += vint.encode(len(h.value))
            body += h.value
        return bytes(vint.encode(len(body))) + bytes(body)

    @staticmethod
    def decode(parser: IOBufParser) -> "Record":
        length = parser.read_vint()
        end = parser.pos() + length
        attrs = parser.read(1)[0]
        ts_delta = parser.read_vint()
        off_delta = parser.read_vint()
        klen = parser.read_vint()
        key = parser.read(klen) if klen >= 0 else None
        vlen = parser.read_vint()
        value = parser.read(vlen) if vlen >= 0 else None
        hcount = parser.read_vint()
        headers = []
        for _ in range(hcount):
            hklen = parser.read_vint()
            hk = parser.read(hklen) if hklen >= 0 else b""
            hvlen = parser.read_vint()
            hv = parser.read(hvlen) if hvlen >= 0 else b""
            headers.append(RecordHeader(hk, hv))
        if parser.pos() != end:
            raise ValueError(
                f"record length mismatch: declared {length}, consumed {parser.pos() - (end - length)}"
            )
        return Record(attrs, ts_delta, off_delta, key, value, headers)


@dataclasses.dataclass(slots=True)
class RecordBatchHeader:
    """Internal batch header (reference: model/record.h:370-420)."""

    header_crc: int = 0
    size_bytes: int = 0
    base_offset: int = 0
    type: RecordBatchType = RecordBatchType.raft_data
    crc: int = 0
    attrs: int = 0
    last_offset_delta: int = 0
    first_timestamp: int = 0
    max_timestamp: int = 0
    producer_id: int = -1
    producer_epoch: int = -1
    base_sequence: int = -1
    record_count: int = 0
    term: int = -1  # raft term (reference: ctx.term), maps to leader_epoch

    @property
    def last_offset(self) -> int:
        return self.base_offset + self.last_offset_delta

    @property
    def compression(self) -> CompressionType:
        return CompressionType(self.attrs & _COMPRESSION_MASK)

    @property
    def is_transactional(self) -> bool:
        return bool(self.attrs & _TRANSACTIONAL_BIT)

    @property
    def is_control(self) -> bool:
        return bool(self.attrs & _CONTROL_BIT)

    def pack(self) -> bytes:
        return _HDR.pack(
            self.header_crc,
            self.size_bytes,
            self.base_offset,
            int(self.type),
            self.crc & 0xFFFFFFFF,
            self.attrs,
            self.last_offset_delta,
            self.first_timestamp,
            self.max_timestamp,
            self.producer_id,
            self.producer_epoch,
            self.base_sequence,
            self.record_count,
            self.term,
        )

    @staticmethod
    def unpack(data: bytes) -> "RecordBatchHeader":
        f = _HDR.unpack(data[:HEADER_SIZE])
        return RecordBatchHeader(
            header_crc=f[0],
            size_bytes=f[1],
            base_offset=f[2],
            type=RecordBatchType(f[3]),
            crc=f[4],
            attrs=f[5],
            last_offset_delta=f[6],
            first_timestamp=f[7],
            max_timestamp=f[8],
            producer_id=f[9],
            producer_epoch=f[10],
            base_sequence=f[11],
            record_count=f[12],
            term=f[13],
        )

    def compute_header_crc(self) -> int:
        """CRC-32C over the internal header minus the header_crc field
        itself (reference: model/record_utils.cc crc_record_batch_header)."""
        return crc_mod.crc32c(self.pack()[4:])

    def crc_prefix(self) -> bytes:
        """The Kafka-wire bytes between the crc field and the records
        section — what the Kafka `crc` covers together with the body."""
        return _CRC_PREFIX.pack(
            self.attrs,
            self.last_offset_delta,
            self.first_timestamp,
            self.max_timestamp,
            self.producer_id,
            self.producer_epoch,
            self.base_sequence,
            self.record_count,
        )


class RecordBatch:
    """Header + body (records section bytes, possibly compressed).

    CONTRACT: a batch handed to the storage layer (log.append /
    log.append_exactly) must be FINALIZED — body crc already computed
    over the current body (builder.build() and the produce adapter do
    this; call finalize_crcs() after any manual body edit). The append
    path rewrites only base_offset/term (header crc) and does NOT
    recompute the body crc; a stale body crc persists to disk and
    surfaces as a distant recovery/fetch CRC mismatch. The debug file
    sanitizer (RP_FILE_SANITIZER=1) enforces this at the call site."""

    __slots__ = ("header", "body", "finalized", "_ser", "_ser_key")

    def __init__(self, header: RecordBatchHeader, body: bytes):
        self.header = header
        self.body = body
        # cheap always-on storage-contract guard: set by
        # finalize_crcs() / deserialize (wire bytes carry valid CRCs);
        # checked by log.append so a batch whose body was mutated after
        # build can't persist a stale body crc silently
        self.finalized = False
        # serialize() memo (leader dispatch serializes the same batch
        # once per follower); keyed on the header fields the append
        # path may rewrite, so offset reassignment invalidates it
        self._ser: bytes | None = None
        self._ser_key = None

    # -- integrity ---------------------------------------------------
    def compute_crc(self) -> int:
        """Kafka-compatible batch CRC (reference: model/record.h:398)."""
        return crc_mod.crc32c(self.body, crc_mod.crc32c(self.header.crc_prefix()))

    def verify_crc(self) -> bool:
        return (
            self.header.header_crc == self.header.compute_header_crc()
            and self.header.crc == self.compute_crc()
        )

    def finalize_crcs(self) -> "RecordBatch":
        self.header.crc = self.compute_crc()
        self.header.header_crc = self.header.compute_header_crc()
        self.finalized = True
        return self

    # -- sizes / offsets --------------------------------------------
    @property
    def base_offset(self) -> int:
        return self.header.base_offset

    @property
    def last_offset(self) -> int:
        return self.header.last_offset

    @property
    def record_count(self) -> int:
        return self.header.record_count

    def size_bytes(self) -> int:
        return HEADER_SIZE + len(self.body)

    # -- internal (on-disk) serialization ---------------------------
    def serialize(self) -> bytes:
        h = self.header
        key = (h.base_offset, h.term, h.header_crc)
        if self._ser is not None and self._ser_key == key:
            return self._ser
        h.size_bytes = self.size_bytes()
        out = h.pack() + self.body
        if self.finalized:
            # finalized batches are immutable by contract (and offset
            # rewrites bump header_crc, changing the key)
            self._ser, self._ser_key = out, key
        return out

    @staticmethod
    def deserialize(data: bytes | IOBufParser) -> "RecordBatch":
        parser = data if isinstance(data, IOBufParser) else IOBufParser(data)
        header = RecordBatchHeader.unpack(parser.read(HEADER_SIZE))
        if header.size_bytes < HEADER_SIZE:
            raise ValueError(f"corrupt size_bytes {header.size_bytes}")
        body = parser.read(header.size_bytes - HEADER_SIZE)
        b = RecordBatch(header, body)
        b.finalized = True  # wire bytes carry the leader's computed CRCs
        return b

    # -- Kafka wire framing (reference: kafka/protocol/kafka_batch_adapter) --
    def to_kafka_wire(self) -> bytes:
        h = self.header
        batch_length = _KAFKA_AFTER_LEN + len(self.body)
        fixed = _KAFKA_WIRE.pack(
            h.base_offset,
            batch_length,
            max(-1, min(h.term, 2**31 - 1)),  # partition_leader_epoch
            2,  # magic v2
            h.crc & 0xFFFFFFFF,
            h.attrs,
            h.last_offset_delta,
            h.first_timestamp,
            h.max_timestamp,
            h.producer_id,
            h.producer_epoch,
            h.base_sequence,
            h.record_count,
        )
        return fixed + self.body

    @staticmethod
    def from_kafka_wire(parser: IOBufParser | bytes, verify: bool = True) -> "RecordBatch":
        """Adapt one Kafka wire batch to the internal form, verifying the
        Kafka CRC (reference: kafka/protocol/kafka_batch_adapter.cc:99-123)."""
        if not isinstance(parser, IOBufParser):
            parser = IOBufParser(parser)
        fixed = parser.read(KAFKA_BATCH_OVERHEAD)
        f = _KAFKA_WIRE.unpack(fixed)
        (
            base_offset,
            batch_length,
            leader_epoch,
            magic,
            wire_crc,
            attrs,
            last_offset_delta,
            first_timestamp,
            max_timestamp,
            producer_id,
            producer_epoch,
            base_sequence,
            record_count,
        ) = f
        if magic != 2:
            raise ValueError(f"unsupported batch magic {magic}")
        if batch_length < _KAFKA_AFTER_LEN:
            raise ValueError(f"batch_length {batch_length} shorter than fixed section")
        body = parser.read(batch_length - _KAFKA_AFTER_LEN)
        header = RecordBatchHeader(
            base_offset=base_offset,
            type=RecordBatchType.raft_data,
            crc=wire_crc,
            attrs=attrs,
            last_offset_delta=last_offset_delta,
            first_timestamp=first_timestamp,
            max_timestamp=max_timestamp,
            producer_id=producer_id,
            producer_epoch=producer_epoch,
            base_sequence=base_sequence,
            record_count=record_count,
            term=leader_epoch,
        )
        batch = RecordBatch(header, body)
        if verify and batch.compute_crc() != wire_crc:
            raise CrcMismatch(
                f"kafka batch crc mismatch: wire={wire_crc:#x} computed={batch.compute_crc():#x}"
            )
        header.size_bytes = batch.size_bytes()
        header.header_crc = header.compute_header_crc()
        batch.finalized = True  # wire crc verified (or caller opted out)
        return batch

    # -- broker-side recompression (compression.type topic config) ----
    def recompressed(
        self, ctype: "CompressionType", verify_crc: int | None = None
    ) -> "RecordBatch":
        """A copy of this (uncompressed) batch with the records section
        compressed as `ctype` — the broker-side recompression real
        Kafka performs when a topic sets compression.type and the
        producer sent uncompressed data.

        Behind the registry gate (RP_CODEC_BACKEND=device) an LZ4 body
        <= 64 KiB takes the fused card path (ops/fused.crc_lz4_fused):
        ONE upload yields the Kafka CRC (validated against `verify_crc`,
        replacing the host verify pass) AND the compressed block. It
        runs on ops.default_device, the card, and raises on a
        machine without one. Everything else runs the host codec
        registry. The call is synchronous, one batch per call."""
        import os

        if self.header.compression == ctype:
            # nothing to transcode — but the caller delegated CRC
            # verification here, so it must still happen
            if verify_crc is not None and self.compute_crc() != (
                verify_crc & 0xFFFFFFFF
            ):
                raise CrcMismatch(
                    f"kafka batch crc mismatch: wire={verify_crc:#x}"
                )
            return self
        if self.header.compression != CompressionType.none:
            # producer used a DIFFERENT codec than the topic demands:
            # verify, decompress, then fall through to recompression
            # (Kafka's LogValidator deep-recompresses on codec mismatch)
            if verify_crc is not None and self.compute_crc() != (
                verify_crc & 0xFFFFFFFF
            ):
                raise CrcMismatch(
                    f"kafka batch crc mismatch: wire={verify_crc:#x}"
                )
            plain_hdr = dataclasses.replace(
                self.header, attrs=self.header.attrs & ~_COMPRESSION_MASK
            )
            plain = RecordBatch(plain_hdr, self._records_body())
            plain.header.size_bytes = plain.size_bytes()
            plain.finalize_crcs()
            if ctype == CompressionType.none:
                return plain  # compression.type=uncompressed
            return plain.recompressed(ctype)
        body = self.body if isinstance(self.body, bytes) else bytes(self.body)
        frame = None
        if (
            ctype == CompressionType.lz4
            and len(body) <= 65536
            and os.environ.get("RP_CODEC_BACKEND") == "device"
        ):
            from ..compression import lz4_codec
            from ..ops.fused import crc_lz4_fused

            crcs, blocks = crc_lz4_fused(
                [self.header.crc_prefix()], [body]
            )
            if verify_crc is not None and int(crcs[0]) != (
                verify_crc & 0xFFFFFFFF
            ):
                raise CrcMismatch(
                    f"kafka batch crc mismatch (device): "
                    f"wire={verify_crc:#x} computed={int(crcs[0]):#x}"
                )
            frame = lz4_codec.frame_from_blocks([blocks[0]], [body])
        else:
            if verify_crc is not None and self.compute_crc() != (
                verify_crc & 0xFFFFFFFF
            ):
                raise CrcMismatch(
                    f"kafka batch crc mismatch: wire={verify_crc:#x}"
                )
            frame = compression_mod.compress(body, ctype)
        header = dataclasses.replace(
            self.header,
            attrs=(self.header.attrs & ~_COMPRESSION_MASK) | int(ctype),
        )
        out = RecordBatch(header, frame)
        out.header.size_bytes = out.size_bytes()
        return out.finalize_crcs()

    # -- records access ---------------------------------------------
    def _records_body(self) -> bytes:
        data = self.body
        ctype = self.header.compression
        if ctype != CompressionType.none:
            data = compression_mod.uncompress(data, ctype)
        return data if isinstance(data, bytes) else bytes(data)

    def records(self) -> list[Record]:
        """Decode records (decompressing the body if needed).

        Hot path (compaction key scans, STM replay, command decode)
        dispatches to the native walker — one C call per batch — and
        builds the objects from its descriptor rows; pure Python is the
        fallback (reference keeps this loop native too:
        model/record_utils.cc parse_one_record).
        """
        data = self._records_body()
        count = self.header.record_count
        desc = parse_record_descriptors(data, count)
        if desc is None:
            parser = IOBufParser(data)
            return [Record.decode(parser) for _ in range(count)]
        out: list[Record] = []
        for i in range(count):
            o = i * _DESC_W
            key_len = desc[o + 6]
            val_len = desc[o + 8]
            key = data[desc[o + 5] : desc[o + 5] + key_len] if key_len >= 0 else None
            value = data[desc[o + 7] : desc[o + 7] + val_len] if val_len >= 0 else None
            headers: list[RecordHeader] = []
            if desc[o + 10] > 0:
                hp = IOBufParser(data[desc[o + 9] : desc[o + 1]])
                for _ in range(hp.read_vint()):
                    hklen = hp.read_vint()
                    hk = hp.read(hklen) if hklen >= 0 else b""
                    hvlen = hp.read_vint()
                    hv = hp.read(hvlen) if hvlen >= 0 else b""
                    headers.append(RecordHeader(hk, hv))
            out.append(
                Record(desc[o + 2], desc[o + 3], desc[o + 4], key, value, headers)
            )
        return out

    def __repr__(self) -> str:  # pragma: no cover
        h = self.header
        return (
            f"RecordBatch(type={h.type.name}, base={h.base_offset}, "
            f"n={h.record_count}, bytes={self.size_bytes()})"
        )


class CrcMismatch(ValueError):
    pass


# -- span walk / header peek (zero-copy fetch plane) -----------------
# The BLESSED helpers for the kafka fetch hot path (rplint RPL023):
# peek the few internal-header fields fetch filtering needs straight
# out of a raw [header|body] span (bytes/memoryview) and convert spans
# to Kafka wire form without ever constructing RecordBatch objects.
# The body — the CRC-covered records section — is byte-identical
# between the on-disk form and the Kafka wire form; only the fixed
# section differs (69-byte little-endian internal header vs 61-byte
# big-endian wire section), so conversion is one struct repack plus a
# body copy, done ONCE per span and cached (storage.batch_cache wire
# plane). Thereafter serving a fetch is an 8-byte base-offset patch.

_PEEK_SIZE = struct.Struct("<i")  # size_bytes @ 4
_PEEK_BASE = struct.Struct("<q")  # base_offset @ 8
_PEEK_DELTA = struct.Struct("<i")  # last_offset_delta @ 23
_WIRE_BASE = struct.Struct(">q")  # kafka wire base_offset @ 0
_WIRE_LEN = struct.Struct(">i")  # kafka wire batch_length @ 8
_WIRE_CRC = struct.Struct(">I")  # kafka wire crc @ 17
# wire offset where the CRC-covered section (attributes..records) starts
KAFKA_CRC_START = 21

# in-place kafka-wire base-offset stamp (buf, pos, kafka_base) — the
# fetch path's per-span translation primitive
pack_wire_base = _WIRE_BASE.pack_into


def peek_size_bytes(buf, pos: int = 0) -> int:
    """Internal-header size_bytes (whole span length) at `pos`."""
    return _PEEK_SIZE.unpack_from(buf, pos + 4)[0]


def peek_base_offset(buf, pos: int = 0) -> int:
    return _PEEK_BASE.unpack_from(buf, pos + 8)[0]


def peek_type(buf, pos: int = 0) -> int:
    """Batch type as a raw int (compare against RecordBatchType values
    without constructing the enum on the hot path)."""
    return buf[pos + 16]


def peek_last_offset(buf, pos: int = 0) -> int:
    return (
        _PEEK_BASE.unpack_from(buf, pos + 8)[0]
        + _PEEK_DELTA.unpack_from(buf, pos + 23)[0]
    )


class WireSpan:
    """One batch in Kafka wire form, carrying the header fields the
    fetch path filters/translates on. `wire` holds the RAFT base
    offset in its first 8 bytes; patch_base() stamps a translated
    base into a fresh copy (the kafka body CRC starts at attributes,
    so the patch needs no payload recompute)."""

    __slots__ = ("base_offset", "last_offset", "batch_type", "wire")

    def __init__(self, base_offset: int, last_offset: int, batch_type: int, wire: bytes):
        self.base_offset = base_offset
        self.last_offset = last_offset
        self.batch_type = batch_type
        self.wire = wire

    def size_bytes(self) -> int:
        """Internal (on-disk) span size — the wire form is 8 bytes
        shorter than the internal header, and budget accounting must
        match the decoded path byte-for-byte."""
        return len(self.wire) + HEADER_SIZE - KAFKA_BATCH_OVERHEAD

    def patch_base(self, kafka_base: int) -> bytes:
        """Span bytes with the translated base stamped in. ONE copy
        (the returned bytearray); callers hand it straight to a join
        or a buffer writer, never mutate it afterwards."""
        if kafka_base == self.base_offset:
            return self.wire
        w = bytearray(self.wire)
        _WIRE_BASE.pack_into(w, 0, kafka_base)
        return w

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"WireSpan(base={self.base_offset}, last={self.last_offset}, "
            f"type={self.batch_type}, bytes={len(self.wire)})"
        )


def span_to_wire(span) -> WireSpan:
    """Convert one internal [header|body] span (bytes/memoryview) to a
    WireSpan. The body is stored verbatim; the fixed section is
    repacked from the internal header fields — byte-identical to
    RecordBatch.deserialize(span).to_kafka_wire()."""
    (
        _header_crc,
        size_bytes,
        base_offset,
        btype,
        crc,
        attrs,
        last_offset_delta,
        first_timestamp,
        max_timestamp,
        producer_id,
        producer_epoch,
        base_sequence,
        record_count,
        term,
    ) = _HDR.unpack_from(span, 0)
    body_len = size_bytes - HEADER_SIZE
    # single allocation: pack the fixed section in place, slice-assign
    # the body straight out of the span view (one copy total)
    w = bytearray(KAFKA_BATCH_OVERHEAD + body_len)
    _KAFKA_WIRE.pack_into(
        w,
        0,
        base_offset,
        _KAFKA_AFTER_LEN + body_len,
        max(-1, min(term, 2**31 - 1)),  # partition_leader_epoch
        2,  # magic v2
        crc & 0xFFFFFFFF,
        attrs,
        last_offset_delta,
        first_timestamp,
        max_timestamp,
        producer_id,
        producer_epoch,
        base_sequence,
        record_count,
    )
    w[KAFKA_BATCH_OVERHEAD:] = span[HEADER_SIZE:size_bytes]
    return WireSpan(base_offset, base_offset + last_offset_delta, btype, w)


def walk_kafka_wire(wire) -> list[tuple[int, int]]:
    """(start, end) byte ranges of each batch in a concatenated Kafka
    wire records blob (fetch-response splitting for verify-on-read).
    Stops at the first malformed length rather than raising — a torn
    tail means the preceding complete batches are still checkable."""
    out: list[tuple[int, int]] = []
    pos = 0
    n = len(wire)
    while pos + 12 <= n:
        blen = _WIRE_LEN.unpack_from(wire, pos + 8)[0]
        end = pos + 12 + blen
        if blen < _KAFKA_AFTER_LEN or end > n:
            break
        out.append((pos, end))
        pos = end
    return out


def wire_crc_payloads(wire) -> tuple[list[bytes], list[int]]:
    """(crc-covered payloads, expected CRCs) for every batch in a
    concatenated Kafka wire blob — the staging step for the batched
    device verify (ops.crc32c), one matrix per fetch response."""
    payloads: list[bytes] = []
    expected: list[int] = []
    mv = memoryview(wire)
    for start, end in walk_kafka_wire(wire):
        payloads.append(bytes(mv[start + KAFKA_CRC_START : end]))
        expected.append(_WIRE_CRC.unpack_from(wire, start + 17)[0])
    return payloads, expected


def parse_record_descriptors(data: bytes, count: int) -> list[int] | None:
    """One native call → flat descriptor list (`_DESC_W` int64 slots per
    record, offsets into `data`); None when the native library is
    unavailable. Raises ValueError on malformed input. Lets scan-heavy
    callers (compaction's key map, verbatim record slicing) avoid
    materializing Record objects entirely."""
    if native_mod.load() is None:
        return None
    if count <= 0:
        # match the pure-Python decoder: range(count) is empty
        return []
    if count > len(data) // 7:
        # the header's record_count is corruption/attacker-controlled
        # and CRC only proves it was sent that way — bound the
        # descriptor allocation by the smallest possible wire record
        # (7 bytes) BEFORE sizing the array
        raise ValueError(f"record_count {count} impossible for {len(data)}-byte body")
    import ctypes

    desc = (ctypes.c_int64 * (count * _DESC_W))()
    rc = native_mod.parse_records(data, len(data), count, desc)
    if rc is None:
        return None
    if rc != 0:
        raise ValueError(f"malformed record body (native walker code {rc})")
    return list(desc)


class RecordBatchBuilder:
    """Builds a batch with correct offsets/timestamps/CRCs
    (reference: storage/record_batch_builder.{h,cc})."""

    def __init__(
        self,
        batch_type: RecordBatchType = RecordBatchType.raft_data,
        base_offset: int = 0,
        compression: CompressionType = CompressionType.none,
        producer_id: int = -1,
        producer_epoch: int = -1,
        base_sequence: int = -1,
        transactional: bool = False,
        control: bool = False,
        timestamp_ms: int | None = None,
    ):
        self._type = batch_type
        self._base_offset = base_offset
        self._compression = compression
        self._producer_id = producer_id
        self._producer_epoch = producer_epoch
        self._base_sequence = base_sequence
        self._transactional = transactional
        self._control = control
        self._base_ts = (
            timestamp_ms if timestamp_ms is not None else int(time.time() * 1000)
        )
        self._max_ts = self._base_ts
        # (ts_delta, key, value, headers) — encoding is deferred to
        # build() so the whole batch goes through one native call when
        # no record carries headers (the common case).
        self._records: list[tuple[int, bytes | None, bytes | None, list]] = []

    def add(
        self,
        value: bytes | None,
        key: bytes | None = None,
        headers: Sequence[tuple[bytes, bytes]] = (),
        timestamp_ms: int | None = None,
    ) -> "RecordBatchBuilder":
        ts = timestamp_ms if timestamp_ms is not None else self._base_ts
        self._max_ts = max(self._max_ts, ts)
        self._records.append(
            (ts - self._base_ts, key, value, [RecordHeader(k, v) for k, v in headers])
        )
        return self

    def empty(self) -> bool:
        return not self._records

    def _encode_raw(self) -> bytes:
        if native_mod.load() is not None and not any(
            h for _, _, _, h in self._records
        ):
            import ctypes

            n = len(self._records)
            ts = (ctypes.c_int64 * n)(*(r[0] for r in self._records))
            key_lens = (ctypes.c_int64 * n)(
                *((-1 if r[1] is None else len(r[1])) for r in self._records)
            )
            val_lens = (ctypes.c_int64 * n)(
                *((-1 if r[2] is None else len(r[2])) for r in self._records)
            )
            keys = b"".join(r[1] for r in self._records if r[1] is not None)
            vals = b"".join(r[2] for r in self._records if r[2] is not None)
            cap = 64 * n + len(keys) + len(vals)
            out = ctypes.create_string_buffer(cap)
            written = native_mod.encode_records(
                n, ts, keys, key_lens, vals, val_lens, out, cap
            )
            if written is not None and written > 0:
                return out.raw[:written]
            # fall through to Python on the (impossible) bound miss
        return b"".join(
            Record(
                attributes=0,
                timestamp_delta=ts_delta,
                offset_delta=i,
                key=key,
                value=value,
                headers=headers,
            ).encode()
            for i, (ts_delta, key, value, headers) in enumerate(self._records)
        )

    def build(self) -> RecordBatch:
        if not self._records:
            raise ValueError("empty batch")
        raw = self._encode_raw()
        attrs = int(self._compression) & _COMPRESSION_MASK
        if self._transactional:
            attrs |= _TRANSACTIONAL_BIT
        if self._control:
            attrs |= _CONTROL_BIT
        body = (
            compression_mod.compress(raw, self._compression)
            if self._compression != CompressionType.none
            else raw
        )
        header = RecordBatchHeader(
            base_offset=self._base_offset,
            type=self._type,
            attrs=attrs,
            last_offset_delta=len(self._records) - 1,
            first_timestamp=self._base_ts,
            max_timestamp=self._max_ts,
            producer_id=self._producer_id,
            producer_epoch=self._producer_epoch,
            base_sequence=self._base_sequence,
            record_count=len(self._records),
        )
        batch = RecordBatch(header, body)
        batch.header.size_bytes = batch.size_bytes()
        return batch.finalize_crcs()


def batch_crcs(batches: Iterable[RecordBatch]) -> np.ndarray:
    """Compute Kafka CRCs for many batches in one call — the batched
    `record_batch_crc_checker` (reference: model/record.h:763-781).

    Stages (crc_prefix + body) rows into a padded uint8 matrix: the
    layout consumed both by the host native path and the device kernel
    (ops.crc32c.crc32c_device)."""
    payloads = [b.header.crc_prefix() + b.body for b in batches]
    if not payloads:
        return np.zeros(0, dtype=np.uint32)
    stride = max(len(p) for p in payloads)
    mat = np.zeros((len(payloads), stride), dtype=np.uint8)
    lens = np.zeros(len(payloads), dtype=np.uint64)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    import os

    if os.environ.get("RP_CRC_BACKEND") != "host":
        # the CUDA kernel (ops.crc32c) is the default on the port: the
        # card is locally attached, so the one host->device copy of the
        # staged rows is cheap; RP_CRC_BACKEND=host opts back into the
        # native host path
        from ..ops.crc32c import crc32c_batch_device

        return crc32c_batch_device(mat, lens)
    return crc_mod.crc32c_batch(mat, lens)


def verify_batch_crcs(batches: Sequence[RecordBatch]) -> bool:
    got = batch_crcs(batches)
    return all(
        int(got[i]) == (b.header.crc & 0xFFFFFFFF) for i, b in enumerate(batches)
    )
