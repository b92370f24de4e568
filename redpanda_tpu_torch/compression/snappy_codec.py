"""Snappy codec over the system libsnappy, via ctypes.

Reference: src/v/compression/internal/snappy_java_compressor.{h,cc} —
Kafka's snappy payloads use the snappy-java ("xerial") stream framing:
an 8-byte magic + two big-endian int32s (version/compat), then
[int32-BE chunk length][raw snappy block] repeated, 32 KiB of
uncompressed data per chunk. Raw block helpers are also exported for
the standard (non-java) framing.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct

_MAGIC = b"\x82SNAPPY\x00"
_DEFAULT_VERSION = 1
_MIN_COMPAT = 1
_BLOCK = 32 * 1024

_snappy: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _snappy
    if _snappy is None:
        name = ctypes.util.find_library("snappy") or "libsnappy.so.1"
        lib = ctypes.CDLL(name)
        lib.snappy_max_compressed_length.restype = ctypes.c_size_t
        lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
        lib.snappy_compress.restype = ctypes.c_int
        lib.snappy_compress.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.snappy_uncompress.restype = ctypes.c_int
        lib.snappy_uncompress.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.snappy_uncompressed_length.restype = ctypes.c_int
        lib.snappy_uncompressed_length.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _snappy = lib
    return _snappy


def compress_raw(data: bytes) -> bytes:
    lib = _load()
    out_len = ctypes.c_size_t(lib.snappy_max_compressed_length(len(data)))
    out = ctypes.create_string_buffer(out_len.value)
    rc = lib.snappy_compress(data, len(data), out, ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"snappy_compress failed ({rc})")
    return out.raw[: out_len.value]


def decompress_raw(data: bytes) -> bytes:
    lib = _load()
    n = ctypes.c_size_t(0)
    rc = lib.snappy_uncompressed_length(data, len(data), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"snappy_uncompressed_length failed ({rc})")
    out = ctypes.create_string_buffer(n.value)
    rc = lib.snappy_uncompress(data, len(data), out, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"snappy_uncompress failed ({rc})")
    return out.raw[: n.value]


def xerial_header() -> bytes:
    """The snappy-java stream header (shared with the device backend,
    which supplies its own raw blocks)."""
    return _MAGIC + struct.pack(">ii", _DEFAULT_VERSION, _MIN_COMPAT)


def compress_java(data: bytes) -> bytes:
    out = bytearray(xerial_header())
    for off in range(0, len(data), _BLOCK):
        chunk = compress_raw(data[off : off + _BLOCK])
        out += struct.pack(">i", len(chunk))
        out += chunk
    if not data:
        chunk = compress_raw(b"")
        out += struct.pack(">i", len(chunk))
        out += chunk
    return bytes(out)


def decompress_java(data: bytes) -> bytes:
    if not data.startswith(_MAGIC):
        # Not xerial-framed: fall back to a raw snappy block, which some
        # clients send (the reference tolerates both).
        return decompress_raw(data)
    pos = len(_MAGIC) + 8
    chunks = []
    while pos < len(data):
        (n,) = struct.unpack_from(">i", data, pos)
        pos += 4
        chunks.append(decompress_raw(data[pos : pos + n]))
        pos += n
    return b"".join(chunks)
