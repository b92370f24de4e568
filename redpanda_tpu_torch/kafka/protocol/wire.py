"""Kafka wire-format primitives.

Reference: src/v/kafka/protocol/{wire.h,batch_reader.h} — big-endian
primitive codecs, classic and "compact" (flexible-version) strings,
bytes and arrays, zig-zag varints, and tagged fields (KIP-482).

Everything here is host-side request/response plumbing; payload-sized
blobs (record sets) are sliced out as memoryviews without copying so
the produce path can hand batch bodies straight to the batched CRC
kernel (ops.crc32c / models.record.batch_crcs).
"""

from __future__ import annotations

import struct
import uuid as uuid_mod

_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_F64 = struct.Struct(">d")


class WireError(ValueError):
    pass


def encode_uvarint(value: int) -> bytes:
    if value < 0:
        raise WireError(f"uvarint must be non-negative: {value}")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_varint(value: int) -> bytes:
    # zig-zag (protobuf-style), as used by Kafka records and tagged fields
    return encode_uvarint((value << 1) ^ (value >> 63) if value < 0 else value << 1)


class Reader:
    """Big-endian cursor over one request frame."""

    __slots__ = ("_buf", "_pos")

    def __init__(self, data: bytes | bytearray | memoryview):
        self._buf = memoryview(data)
        self._pos = 0

    @property
    def remaining(self) -> int:
        return len(self._buf) - self._pos

    def _take(self, n: int) -> memoryview:
        if self.remaining < n:
            raise WireError(f"short read: need {n}, have {self.remaining}")
        view = self._buf[self._pos : self._pos + n]
        self._pos += n
        return view

    def read_bool(self) -> bool:
        return self._take(1)[0] != 0

    def read_int8(self) -> int:
        return _I8.unpack(self._take(1))[0]

    def read_int16(self) -> int:
        return _I16.unpack(self._take(2))[0]

    def read_int32(self) -> int:
        return _I32.unpack(self._take(4))[0]

    def read_int64(self) -> int:
        return _I64.unpack(self._take(8))[0]

    def read_uint16(self) -> int:
        return _U16.unpack(self._take(2))[0]

    def read_uint32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def read_float64(self) -> float:
        return _F64.unpack(self._take(8))[0]

    def read_uuid(self) -> uuid_mod.UUID:
        return uuid_mod.UUID(bytes=bytes(self._take(16)))

    def read_uvarint(self) -> int:
        value = 0
        shift = 0
        while True:
            b = self._take(1)[0]
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise WireError("uvarint too long")

    def read_varint(self) -> int:
        v = self.read_uvarint()
        return (v >> 1) ^ -(v & 1)

    def read_raw(self, n: int) -> memoryview:
        return self._take(n)

    # -- strings / bytes --
    def read_string(self) -> str:
        n = self.read_int16()
        if n < 0:
            raise WireError("null for non-nullable string")
        return str(self._take(n), "utf-8")

    def read_nullable_string(self) -> str | None:
        n = self.read_int16()
        if n < 0:
            return None
        return str(self._take(n), "utf-8")

    def read_compact_string(self) -> str:
        n = self.read_uvarint()
        if n == 0:
            raise WireError("null for non-nullable compact string")
        return str(self._take(n - 1), "utf-8")

    def read_compact_nullable_string(self) -> str | None:
        n = self.read_uvarint()
        if n == 0:
            return None
        return str(self._take(n - 1), "utf-8")

    def read_bytes(self) -> bytes:
        n = self.read_int32()
        if n < 0:
            raise WireError("null for non-nullable bytes")
        return bytes(self._take(n))

    def read_nullable_bytes(self) -> bytes | None:
        n = self.read_int32()
        if n < 0:
            return None
        return bytes(self._take(n))

    def read_compact_bytes(self) -> bytes:
        n = self.read_uvarint()
        if n == 0:
            raise WireError("null for non-nullable compact bytes")
        return bytes(self._take(n - 1))

    def read_compact_nullable_bytes(self) -> bytes | None:
        n = self.read_uvarint()
        if n == 0:
            return None
        return bytes(self._take(n - 1))

    # record sets: length-prefixed blob, sliced without copy
    def read_records(self, flexible: bool) -> memoryview | None:
        if flexible:
            n = self.read_uvarint()
            if n == 0:
                return None
            return self._take(n - 1)
        n = self.read_int32()
        if n < 0:
            return None
        return self._take(n)

    def read_array_len(self, flexible: bool) -> int:
        if flexible:
            return self.read_uvarint() - 1
        return self.read_int32()

    def skip_tagged_fields(self) -> dict[int, bytes]:
        tags: dict[int, bytes] = {}
        count = self.read_uvarint()
        for _ in range(count):
            tag = self.read_uvarint()
            size = self.read_uvarint()
            tags[tag] = bytes(self._take(size))
        return tags


class Writer:
    """Appending big-endian encoder."""

    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def build(self) -> bytes:
        return b"".join(self._parts)

    def size(self) -> int:
        return sum(len(p) for p in self._parts)

    def write_raw(self, data: bytes | memoryview) -> None:
        self._parts.append(bytes(data))

    def write_bool(self, v: bool) -> None:
        self._parts.append(b"\x01" if v else b"\x00")

    def write_int8(self, v: int) -> None:
        self._parts.append(_I8.pack(v))

    def write_int16(self, v: int) -> None:
        self._parts.append(_I16.pack(v))

    def write_int32(self, v: int) -> None:
        self._parts.append(_I32.pack(v))

    def write_int64(self, v: int) -> None:
        self._parts.append(_I64.pack(v))

    def write_uint16(self, v: int) -> None:
        self._parts.append(_U16.pack(v))

    def write_uint32(self, v: int) -> None:
        self._parts.append(_U32.pack(v))

    def write_float64(self, v: float) -> None:
        self._parts.append(_F64.pack(v))

    def write_uuid(self, v) -> None:
        if isinstance(v, uuid_mod.UUID):
            self._parts.append(v.bytes)
        else:
            self._parts.append(bytes(v))

    def write_uvarint(self, v: int) -> None:
        self._parts.append(encode_uvarint(v))

    def write_varint(self, v: int) -> None:
        self._parts.append(encode_varint(v))

    def write_string(self, v: str) -> None:
        raw = v.encode("utf-8")
        self.write_int16(len(raw))
        self._parts.append(raw)

    def write_nullable_string(self, v: str | None) -> None:
        if v is None:
            self.write_int16(-1)
        else:
            self.write_string(v)

    def write_compact_string(self, v: str) -> None:
        raw = v.encode("utf-8")
        self.write_uvarint(len(raw) + 1)
        self._parts.append(raw)

    def write_compact_nullable_string(self, v: str | None) -> None:
        if v is None:
            self.write_uvarint(0)
        else:
            self.write_compact_string(v)

    def write_bytes(self, v: bytes) -> None:
        self.write_int32(len(v))
        self._parts.append(bytes(v))

    def write_nullable_bytes(self, v: bytes | None) -> None:
        if v is None:
            self.write_int32(-1)
        else:
            self.write_bytes(v)

    def write_compact_bytes(self, v: bytes) -> None:
        self.write_uvarint(len(v) + 1)
        self._parts.append(bytes(v))

    def write_compact_nullable_bytes(self, v: bytes | None) -> None:
        if v is None:
            self.write_uvarint(0)
        else:
            self.write_compact_bytes(v)

    def write_records(
        self, v: bytes | bytearray | memoryview | None, flexible: bool
    ) -> None:
        # appended WITHOUT normalizing to bytes: records is the one
        # MB-scale field, the fetch plane hands a freshly-built buffer
        # it never mutates, and the final join accepts any bytes-like —
        # normalizing here would re-copy every fetched byte
        if flexible:
            if v is None:
                self.write_uvarint(0)
            else:
                self.write_uvarint(len(v) + 1)
                self._parts.append(v)
        else:
            if v is None:
                self.write_int32(-1)
            else:
                self.write_int32(len(v))
                self._parts.append(v)

    def write_array_len(self, n: int, flexible: bool) -> None:
        if flexible:
            self.write_uvarint(n + 1)
        else:
            self.write_int32(n)

    def write_empty_tagged_fields(self) -> None:
        self._parts.append(b"\x00")
