"""Zig-zag varint codec (reference: src/v/utils/vint.h).

Used by the record wire format (record length/attributes/deltas —
reference src/v/model/record.h) and identical to Kafka's protobuf-style
varints: unsigned LEB128 of the zig-zag encoding for signed values.
"""

from __future__ import annotations


def zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else (v << 1)


def zigzag_decode(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def encode_unsigned(u: int) -> bytes:
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode(v: int) -> bytes:
    """Signed vint (zig-zag + LEB128)."""
    return encode_unsigned(zigzag_encode(v))


def decode_unsigned(buf, offset: int = 0) -> tuple[int, int]:
    """-> (value, bytes_consumed)."""
    result = 0
    shift = 0
    pos = offset
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos - offset
        shift += 7
        if shift > 63:
            raise ValueError("vint too long")


def decode(buf, offset: int = 0) -> tuple[int, int]:
    u, n = decode_unsigned(buf, offset)
    return zigzag_decode(u), n


def size_of(v: int) -> int:
    return len(encode(v))
