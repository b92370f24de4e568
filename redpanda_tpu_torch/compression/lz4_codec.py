"""LZ4 frame codec over the system liblz4, via ctypes.

Reference: src/v/compression/internal/lz4_frame_compressor.{h,cc} uses
the LZ4F frame API. We bind the stable block primitives
(LZ4_compress_default / LZ4_decompress_safe) from liblz4.so.1 and
implement the LZ4 *frame* format (magic 0x184D2204, FLG/BD descriptor,
xxh32 header/content checksums) ourselves — the frame format is what
Kafka clients produce/expect for compression.type=lz4.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct

from ..utils.hash import xxh32_fast as xxh32

_MAGIC = 0x184D2204
_MAX_BLOCK = 4 << 20  # BD code 7 → 4 MB blocks

_lz4: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lz4
    if _lz4 is None:
        name = ctypes.util.find_library("lz4") or "liblz4.so.1"
        lib = ctypes.CDLL(name)
        lib.LZ4_compressBound.restype = ctypes.c_int
        lib.LZ4_compressBound.argtypes = [ctypes.c_int]
        lib.LZ4_compress_default.restype = ctypes.c_int
        lib.LZ4_compress_default.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.LZ4_decompress_safe.restype = ctypes.c_int
        lib.LZ4_decompress_safe.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        _lz4 = lib
    return _lz4


def compress_block(data: bytes) -> bytes:
    """Raw LZ4 block compression (no framing)."""
    lib = _load()
    bound = lib.LZ4_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.LZ4_compress_default(data, out, len(data), bound)
    if n <= 0:
        raise RuntimeError("LZ4 block compression failed")
    return out.raw[:n]


def decompress_block(data: bytes, uncompressed_size: int) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(uncompressed_size)
    n = lib.LZ4_decompress_safe(data, out, len(data), uncompressed_size)
    if n < 0:
        raise RuntimeError(f"LZ4 block decompression failed ({n})")
    return out.raw[:n]


def _write_frame(bd_code: int, pairs, content: bytes | None = None) -> bytes:
    """Shared LZ4 frame writer: v1, block-independent, content
    checksum, no block checksums/content size. `pairs` yields
    (raw_chunk, compressed_block); a block that did not shrink is
    stored raw with the high bit set. Pass `content` when the caller
    already holds the contiguous payload (skips re-joining chunks for
    the checksum)."""
    out = bytearray()
    out += struct.pack("<I", _MAGIC)
    flg = (1 << 6) | (1 << 5) | (1 << 2)
    desc = bytes([flg, bd_code << 4])
    out += desc + bytes([(xxh32(desc) >> 8) & 0xFF])
    chunks = [] if content is None else None
    for raw, comp in pairs:
        if chunks is not None:
            chunks.append(raw)
        if len(comp) >= len(raw):
            out += struct.pack("<I", len(raw) | 0x80000000)
            out += raw
        else:
            out += struct.pack("<I", len(comp))
            out += comp
    out += struct.pack("<I", 0)  # end mark
    out += struct.pack(
        "<I", xxh32(content if content is not None else b"".join(chunks))
    )
    return bytes(out)


def compress_frame(data: bytes) -> bytes:
    """LZ4 frame: independent 4MB blocks (matches client defaults)."""
    return _write_frame(
        7,  # 4 MB max block
        (
            (data[off : off + _MAX_BLOCK], compress_block(data[off : off + _MAX_BLOCK]))
            for off in range(0, len(data), _MAX_BLOCK)
        ),
        content=data,
    )


def frame_from_blocks(
    blocks: "list[bytes]", raw_chunks: "list[bytes]"
) -> bytes:
    """Assemble an LZ4 frame from PRE-COMPRESSED 64 KiB-max blocks
    (the device kernel's output) plus their raw chunks. Wire-compatible
    with decompress_frame and any client."""
    return _write_frame(4, zip(raw_chunks, blocks))  # 64 KiB max block


def decompress_frame(data: bytes) -> bytes:
    if len(data) < 7:
        raise ValueError("short lz4 frame")
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad lz4 frame magic {magic:#x}")
    pos = 4
    flg = data[pos]
    bd = data[pos + 1]
    version = (flg >> 6) & 0x3
    if version != 1:
        raise ValueError(f"unsupported lz4 frame version {version}")
    block_checksum = bool(flg & (1 << 4))
    content_size_present = bool(flg & (1 << 3))
    content_checksum = bool(flg & (1 << 2))
    dict_id = bool(flg & 1)
    desc_len = 2 + (8 if content_size_present else 0) + (4 if dict_id else 0)
    desc = data[pos : pos + desc_len]
    hc = data[pos + desc_len]
    if ((xxh32(desc) >> 8) & 0xFF) != hc:
        raise ValueError("lz4 frame header checksum mismatch")
    pos += desc_len + 1
    max_block = 1 << (8 + 2 * ((bd >> 4) & 0x7))
    chunks = []
    while True:
        (raw_size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if raw_size == 0:
            break
        is_uncompressed = bool(raw_size & 0x80000000)
        size = raw_size & 0x7FFFFFFF
        block = data[pos : pos + size]
        pos += size
        if block_checksum:
            (bc,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if xxh32(block) != bc:
                raise ValueError("lz4 block checksum mismatch")
        if is_uncompressed:
            chunks.append(block)
        else:
            chunks.append(decompress_block(block, max_block))
    result = b"".join(chunks)
    if content_checksum:
        (cc,) = struct.unpack_from("<I", data, pos)
        if xxh32(result) != cc:
            raise ValueError("lz4 content checksum mismatch")
    return result
