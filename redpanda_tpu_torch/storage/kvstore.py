"""Per-shard durable key-value store (reference: src/v/storage/kvstore.h:91-169).

Holds small critical state: raft vote/term records, offset-translator
checkpoints, storage markers, controller bits — keyed by a key_space
enum exactly like the reference (kvstore.h:93). Writes append to a WAL
segment; once the WAL passes a threshold the full map is snapshotted
(storage.snapshot format) and the WAL truncated. Recovery = load
snapshot + replay WAL (kvstore.h:165-169).

WAL entry framing (little-endian):
  [entry_crc u32][len u32] [keyspace u8][key_len u16][key]
  [val_len i32 (-1 = tombstone)][val]
entry_crc covers everything after the crc field. Torn tails are
detected by crc/length and dropped.
"""

from __future__ import annotations

import enum
import os
import struct
import threading
from typing import Iterator

from ..utils.crc import crc32c
from . import dirsync
from . import snapshot as snap


class KeySpace(enum.IntEnum):
    """Reference: storage/kvstore.h:93-101."""

    testing = 0
    consensus = 1
    storage = 2
    controller = 3
    offset_translator = 4
    usage = 5
    group_coordinator = 6


_ENTRY_HDR = struct.Struct("<II")


def _encode_entry(ks: int, key: bytes, value: bytes | None) -> bytes:
    body = struct.pack("<BH", ks, len(key)) + key
    if value is None:
        body += struct.pack("<i", -1)
    else:
        body += struct.pack("<i", len(value)) + value
    return _ENTRY_HDR.pack(crc32c(body), len(body)) + body


class KvStoreClosed(RuntimeError):
    """Write attempted after close() (shutdown-racing fibers)."""


class KvStore:
    """Synchronous core; the shard runtime calls it from its executor."""

    SNAPSHOT_FILE = "kvstore.snapshot"
    WAL_FILE = "kvstore.wal"

    def __init__(self, data_dir: str, wal_threshold: int = 8 * 1024 * 1024):
        self._dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._wal_threshold = wal_threshold
        self._map: dict[tuple[int, bytes], bytes] = {}
        self._lock = threading.RLock()
        self._recover()
        self._wal = open(self._wal_path, "ab")
        # first open creates the WAL: its dir entry must be durable
        # before any acked write lands in it
        dirsync.fsync_dir(self._dir)

    # -- paths -------------------------------------------------------
    @property
    def _snap_path(self) -> str:
        return os.path.join(self._dir, self.SNAPSHOT_FILE)

    @property
    def _wal_path(self) -> str:
        return os.path.join(self._dir, self.WAL_FILE)

    # -- recovery ----------------------------------------------------
    def _recover(self) -> None:
        if os.path.exists(self._snap_path):
            _, payload = snap.read_snapshot(self._snap_path)
            self._map = dict(self._decode_snapshot(payload))
        if os.path.exists(self._wal_path):
            valid_end = 0
            with open(self._wal_path, "rb") as f:
                data = f.read()
            pos = 0
            while pos + _ENTRY_HDR.size <= len(data):
                crc, length = _ENTRY_HDR.unpack_from(data, pos)
                body = data[pos + _ENTRY_HDR.size : pos + _ENTRY_HDR.size + length]
                if len(body) < length or crc32c(body) != crc:
                    break  # torn tail
                self._apply_body(body)
                pos += _ENTRY_HDR.size + length
                valid_end = pos
            if valid_end < len(data):
                with open(self._wal_path, "r+b") as f:
                    f.truncate(valid_end)

    def _apply_body(self, body: bytes) -> None:
        ks, key_len = struct.unpack_from("<BH", body, 0)
        key = body[3 : 3 + key_len]
        (val_len,) = struct.unpack_from("<i", body, 3 + key_len)
        if val_len < 0:
            self._map.pop((ks, key), None)
        else:
            off = 3 + key_len + 4
            self._map[(ks, key)] = body[off : off + val_len]

    # -- snapshot codec ---------------------------------------------
    @staticmethod
    def _encode_snapshot(items: dict[tuple[int, bytes], bytes]) -> bytes:
        out = bytearray(struct.pack("<I", len(items)))
        for (ks, key), value in items.items():
            out += struct.pack("<BH", ks, len(key)) + key
            out += struct.pack("<I", len(value)) + value
        return bytes(out)

    @staticmethod
    def _decode_snapshot(payload: bytes) -> Iterator[tuple[tuple[int, bytes], bytes]]:
        (count,) = struct.unpack_from("<I", payload, 0)
        pos = 4
        for _ in range(count):
            ks, key_len = struct.unpack_from("<BH", payload, pos)
            pos += 3
            key = payload[pos : pos + key_len]
            pos += key_len
            (val_len,) = struct.unpack_from("<I", payload, pos)
            pos += 4
            value = payload[pos : pos + val_len]
            pos += val_len
            yield (ks, key), value

    # -- API (kvstore.h:103-140) -------------------------------------
    def get(self, ks: KeySpace, key: bytes) -> bytes | None:
        with self._lock:
            return self._map.get((int(ks), key))

    def put(self, ks: KeySpace, key: bytes, value: bytes) -> None:
        with self._lock:
            if self._wal.closed:
                # fibers racing a shutdown (election loops persisting
                # vote state while the broker stops) must fail with a
                # clear signal, not "write to closed file" noise — and
                # the in-memory map must NOT diverge from the WAL
                raise KvStoreClosed("kvstore is closed")
            self._map[(int(ks), key)] = value
            self._append_wal(_encode_entry(int(ks), key, value))

    def remove(self, ks: KeySpace, key: bytes) -> None:
        with self._lock:
            if self._wal.closed:
                raise KvStoreClosed("kvstore is closed")
            self._map.pop((int(ks), key), None)
            self._append_wal(_encode_entry(int(ks), key, None))

    def items(self, ks: KeySpace) -> list[tuple[bytes, bytes]]:
        with self._lock:
            return [(k, v) for (s, k), v in self._map.items() if s == int(ks)]

    def _append_wal(self, entry: bytes) -> None:
        self._wal.write(entry)
        self._wal.flush()
        os.fsync(self._wal.fileno())
        if self._wal.tell() >= self._wal_threshold:
            self._roll_snapshot()

    def _roll_snapshot(self) -> None:
        snap.write_snapshot(self._snap_path, b"", self._encode_snapshot(self._map))
        self._wal.close()
        self._wal = open(self._wal_path, "wb")

    def flush_snapshot(self) -> None:
        """Force a snapshot+WAL-reset (used on clean shutdown)."""
        with self._lock:
            self._roll_snapshot()

    def close(self) -> None:
        with self._lock:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
