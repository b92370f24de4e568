"""zstd frames decoded by the system's libzstd through ctypes (the
card's machine has libzstd but no `zstandard` module). The library is
independent of the program under test, which encodes on the card."""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = None
_UNKNOWN, _ERROR = (1 << 64) - 1, (1 << 64) - 2


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        _lib = lib
    return _lib


def decompress(frame, limit: int = 1 << 20) -> bytes:
    """Decode one zstd frame that declares its content size (every frame
    the broker writes does), of at most `limit` bytes."""
    lib = _load()
    frame = bytes(frame)
    size = lib.ZSTD_getFrameContentSize(frame, len(frame))
    if size in (_UNKNOWN, _ERROR) or size > limit:
        raise ValueError(f"zstd frame content size {size}")
    out = ctypes.create_string_buffer(max(int(size), 1))
    n = lib.ZSTD_decompress(out, int(size), frame, len(frame))
    if lib.ZSTD_isError(n):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(n).decode()}")
    if n != size:
        raise ValueError(f"zstd frame decoded {n} bytes, declared {size}")
    return out.raw[:n]


def compress(data: bytes, level: int = 3) -> bytes:
    """libzstd's own frame (the tests' known vectors)."""
    lib = _load()
    out = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
    n = lib.ZSTD_compress(out, len(out), data, len(data), level)
    if lib.ZSTD_isError(n):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(n).decode()}")
    return out.raw[:n]
