"""LZ4 as Kafka carries it (compression.type=lz4): the LZ4 frame format
(magic 0x184D2204, independent blocks of at most 64 KiB) around LZ4
blocks, in plain Python.

The encoder is what the benchmark's producers use where they compress
themselves: a greedy compressor over a table of 4-byte sequences, the
frame as Kafka's Java producer writes it (no content checksum). The
decoder is the reference's: it reads any frame the LZ4 frame format
allows (content size, block and content checksums), and refuses one
whose checksums, sizes or offsets are wrong.
"""

from __future__ import annotations

import struct

MAGIC = 0x184D2204
MIN_MATCH, LAST_LITERALS, MF_LIMIT = 4, 5, 12
MAX_BLOCK = 1 << 16

_P1, _P2, _P3, _P4, _P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data, seed: int = 0) -> int:
    """xxHash32, the frame's header and content checksum."""
    data = bytes(data)
    n, i = len(data), 0
    if n >= 16:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M, (seed - _P1) & _M]
        words = struct.unpack_from(f"<{(n // 16) * 4}I", data)
        for k in range(0, len(words), 4):
            for lane in range(4):
                v[lane] = (_rotl((v[lane] + words[k + lane] * _P2) & _M, 13) * _P1) & _M
        i = (n // 16) * 16
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 4 <= n:
        (w,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + w * _P3) & _M, 17) * _P4) & _M
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M, 11) * _P1) & _M
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h


def _length(out: bytearray, n: int) -> None:
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)


def _sequence(out: bytearray, literals, match: int, offset: int) -> None:
    lit = len(literals)
    token = (min(lit, 15) << 4) | (min(match - MIN_MATCH, 15) if match else 0)
    out.append(token)
    if lit >= 15:
        _length(out, lit - 15)
    out += literals
    if match:
        out += struct.pack("<H", offset)
        if match - MIN_MATCH >= 15:
            _length(out, match - MIN_MATCH - 15)


def compress_block(src: bytes) -> bytes:
    """One LZ4 block: greedy matches of at least 4 bytes within 64 KiB
    back, the last match ending 5 bytes before the end and starting 12
    before it, as the block format requires."""
    n = len(src)
    out, seen = bytearray(), {}
    anchor = i = 0
    limit = n - MF_LIMIT
    while i < limit:
        key = src[i : i + 4]
        ref = seen.get(key)
        seen[key] = i
        if ref is None or i - ref > 0xFFFF:
            i += 1
            continue
        m, most = MIN_MATCH, n - LAST_LITERALS - i
        while m < most and src[ref + m] == src[i + m]:
            m += 1
        _sequence(out, src[anchor:i], m, i - ref)
        i += m
        anchor = i
    _sequence(out, src[anchor:], 0, 0)
    return bytes(out)


def decompress_block(src, max_out: int = MAX_BLOCK) -> bytes:
    """Decode one LZ4 block of at most `max_out` bytes."""
    src = bytes(src)
    out = bytearray()
    i, n = 0, len(src)
    while True:
        if i >= n:
            raise ValueError("lz4 block ends inside a sequence")
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4 literals run past the block")
        out += src[i : i + lit]
        i += lit
        if i == n:
            break
        if i + 2 > n:
            raise ValueError("lz4 offset runs past the block")
        (off,) = struct.unpack_from("<H", src, i)
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += MIN_MATCH
        start = len(out) - off
        if off == 0 or start < 0:
            raise ValueError(f"lz4 match offset {off} outside the output")
        if off >= ml:
            out += out[start : start + ml]
        else:
            pattern = bytes(out[start:])
            out += (pattern * (ml // off + 1))[:ml]
        if len(out) > max_out:
            raise ValueError("lz4 block decodes past its limit")
    if len(out) > max_out:
        raise ValueError("lz4 block decodes past its limit")
    return bytes(out)


def compress_frame(data: bytes) -> bytes:
    """An LZ4 frame of independent 64 KiB blocks, no checksums but the
    header's (Kafka's Java producer writes this shape)."""
    desc = bytes([0x60, 4 << 4])  # version 1, independent blocks; 64 KiB
    out = bytearray(struct.pack("<I", MAGIC) + desc + bytes([(xxh32(desc) >> 8) & 0xFF]))
    for off in range(0, len(data), MAX_BLOCK):
        raw = data[off : off + MAX_BLOCK]
        comp = compress_block(raw)
        if len(comp) >= len(raw):
            out += struct.pack("<I", len(raw) | 0x80000000) + raw
        else:
            out += struct.pack("<I", len(comp)) + comp
    out += struct.pack("<I", 0)
    return bytes(out)


def decompress_frame(data) -> bytes:
    """Decode one LZ4 frame, checking every checksum it carries."""
    data = bytes(data)
    if len(data) < 7 or struct.unpack_from("<I", data, 0)[0] != MAGIC:
        raise ValueError("not an lz4 frame")
    flg, bd = data[4], data[5]
    if flg >> 6 != 1:
        raise ValueError(f"lz4 frame version {flg >> 6}")
    block_sum, size_present, content_sum, dict_id = flg & 0x10, flg & 0x08, flg & 0x04, flg & 0x01
    desc_len = 2 + (8 if size_present else 0) + (4 if dict_id else 0)
    desc = data[4 : 4 + desc_len]
    if (xxh32(desc) >> 8) & 0xFF != data[4 + desc_len]:
        raise ValueError("lz4 frame header checksum")
    max_block = 1 << (8 + 2 * ((bd >> 4) & 7))
    pos = 5 + desc_len
    out = bytearray()
    while True:
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if size == 0:
            break
        raw, size = size & 0x80000000, size & 0x7FFFFFFF
        if size > max_block or pos + size > len(data):
            raise ValueError("lz4 block size")
        block = data[pos : pos + size]
        pos += size
        if block_sum:
            if struct.unpack_from("<I", data, pos)[0] != xxh32(block):
                raise ValueError("lz4 block checksum")
            pos += 4
        out += block if raw else decompress_block(block, max_block)
    if content_sum:
        if struct.unpack_from("<I", data, pos)[0] != xxh32(out):
            raise ValueError("lz4 content checksum")
        pos += 4
    if size_present and struct.unpack_from("<Q", data, 6)[0] != len(out):
        raise ValueError("lz4 content size")
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the lz4 frame")
    return bytes(out)
