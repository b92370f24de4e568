"""CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), the checksum
of Kafka's record batches: one row in plain Python, many rows at once
in NumPy (a column at a time over every row still that long)."""

from __future__ import annotations

import numpy as np

POLY = 0x82F63B78


def _table() -> list:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        out.append(c)
    return out


TABLE = _table()
_TABLE_NP = np.array(TABLE, dtype=np.uint32)


def crc32c(data) -> int:
    """CRC-32C of one buffer."""
    c = 0xFFFFFFFF
    t = TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c_rows(rows, block: int = 2048) -> list:
    """CRC-32C of each buffer in `rows`, in their order."""
    rows = [bytes(r) for r in rows]
    out = [0] * len(rows)
    order = sorted(range(len(rows)), key=lambda i: -len(rows[i]))
    for start in range(0, len(order), block):
        idx = order[start : start + block]
        lens = np.array([len(rows[i]) for i in idx], dtype=np.int64)
        width = int(lens[0]) if len(idx) else 0
        mat = np.zeros((len(idx), width), dtype=np.uint8)
        for r, i in enumerate(idx):
            mat[r, : lens[r]] = np.frombuffer(rows[i], dtype=np.uint8)
        # rows still this long at column j: lengths run descending
        active =len(idx) - np.searchsorted(lens[::-1], np.arange(width), side="right")
        crc = np.full(len(idx), 0xFFFFFFFF, dtype=np.uint32)
        for j in range(width):
            k = int(active[j])
            c = crc[:k]
            crc[:k] = _TABLE_NP[(c ^ mat[:k, j]) & 0xFF] ^ (c >> 8)
        crc ^= np.uint32(0xFFFFFFFF)
        for r, i in enumerate(idx):
            out[i] = int(crc[r])
    return out
