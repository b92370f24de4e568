"""CRC-32C (Castagnoli) and CRC-32 host API.

Mirrors the reference hashing layer (src/v/hashing/crc32c.h:15-46,
src/v/hashing/crc32.h:14): an extendable CRC object usable over
fragmented buffers, plus one-shot helpers. The hot path dispatches to
the native C++ library (SSE4.2 crc32 instruction); a numpy table-driven
fallback keeps pure-Python environments working.

The same polynomial/table constants feed the device-side batched kernel
in redpanda_tpu.ops.crc32c.
"""

from __future__ import annotations

import zlib

import numpy as np

from . import native

_POLY = 0x82F63B78  # reflected CRC-32C polynomial


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (_POLY ^ (c >> 1)) if (c & 1) else (c >> 1)
        table[n] = c
    return table


_TABLE = _make_table()


def _crc32c_py(crc: int, data: bytes) -> int:
    """Table-driven fallback, vectorized column-wise where possible."""
    c = crc ^ 0xFFFFFFFF
    t = _TABLE
    for b in data:
        c = int(t[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """Extend CRC-32C `crc` over `data` (init 0 == fresh checksum)."""
    v = native.crc32c(data, crc)
    if v is not None:
        return v
    return _crc32c_py(crc, data)


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A, B) given crc(A), crc(B) and len(B)."""
    v = native.crc32c_combine(crc1, crc2, len2)
    if v is not None:
        return v
    # GF(2) matrix method (zlib crc32_combine scheme).
    if len2 == 0:
        return crc1
    odd = [0] * 32
    odd[0] = _POLY
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1

    def times(mat, vec):
        s = 0
        i = 0
        while vec:
            if vec & 1:
                s ^= mat[i]
            vec >>= 1
            i += 1
        return s

    def square(mat):
        return [times(mat, mat[n]) for n in range(32)]

    even = square(odd)
    odd = square(even)
    while True:
        even = square(odd)
        if len2 & 1:
            crc1 = times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = square(even)
        if len2 & 1:
            crc1 = times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def crc32c_batch(bufs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """CRC-32C of `n` padded rows — host (native) reference for the
    device kernel. bufs: [n, stride] uint8; lens: [n] uint64."""
    import ctypes

    bufs = np.ascontiguousarray(bufs, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.uint64)
    n, stride = bufs.shape
    if n and int(lens.max()) > stride:
        raise ValueError(f"lens.max()={int(lens.max())} exceeds stride={stride}")
    out = np.zeros(n, dtype=np.uint32)
    if native.crc32c_batch(
        bufs.ctypes.data_as(ctypes.c_char_p),
        stride,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n,
    ):
        return out
    return np.array(
        [crc32c(bufs[i, : int(lens[i])].tobytes()) for i in range(n)],
        dtype=np.uint32,
    )


class Crc32c:
    """Stateful extendable CRC-32C, the `crc::crc32c` equivalent."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0

    def extend(self, data: bytes | bytearray | memoryview) -> "Crc32c":
        self._value = crc32c(bytes(data), self._value)
        return self

    def extend_int(self, value: int, size: int, signed: bool = True) -> "Crc32c":
        """Extend over a little-endian fixed-width integer (the reference
        hashes raw struct fields this way for header_crc)."""
        return self.extend(value.to_bytes(size, "little", signed=signed))

    def extend_int_be(self, value: int, size: int, signed: bool = True) -> "Crc32c":
        return self.extend(value.to_bytes(size, "big", signed=signed))

    def value(self) -> int:
        return self._value


def crc32(data: bytes, crc: int = 0) -> int:
    """Plain CRC-32 (zlib polynomial) — used by the RPC frame header
    (reference: src/v/rpc/types.h:238 header_checksum)."""
    return zlib.crc32(data, crc)
