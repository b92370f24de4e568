"""Generic snapshot file format (reference: src/v/storage/snapshot.{h,cc}).

Layout (all little-endian):
  [magic u32][version u32][metadata_len u32][metadata_crc u32]
  [header_crc u32]  — crc32c over the 4 fields above
  [metadata bytes][payload bytes]

Metadata is opaque to this layer (raft snapshot metadata, kvstore
markers, stm state headers all ride in it). The payload follows
unframed; readers know its extent from the file size. Used by raft
snapshots, kvstore snapshots, and STM snapshots, like the reference's
single shared format.
"""

from __future__ import annotations

import os
import struct

from ..utils.crc import crc32c

_MAGIC = 0x5350414E  # "NAPS"
_VERSION = 1
_HDR = struct.Struct("<IIII")


class SnapshotCorruption(ValueError):
    pass


def write_snapshot(path: str, metadata: bytes, payload: bytes) -> None:
    """Atomic snapshot write (tmp + rename + dir fsync)."""
    fixed = _HDR.pack(_MAGIC, _VERSION, len(metadata), crc32c(metadata))
    header_crc = crc32c(fixed)
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        f.write(fixed)
        f.write(struct.pack("<I", header_crc))
        f.write(metadata)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def read_snapshot(path: str) -> tuple[bytes, bytes]:
    """-> (metadata, payload); raises SnapshotCorruption on damage."""
    with open(path, "rb") as f:
        fixed = f.read(_HDR.size)
        if len(fixed) < _HDR.size:
            raise SnapshotCorruption("truncated snapshot header")
        magic, version, meta_len, meta_crc = _HDR.unpack(fixed)
        if magic != _MAGIC:
            raise SnapshotCorruption(f"bad snapshot magic {magic:#x}")
        if version != _VERSION:
            raise SnapshotCorruption(f"unsupported snapshot version {version}")
        (header_crc,) = struct.unpack("<I", f.read(4))
        if crc32c(fixed) != header_crc:
            raise SnapshotCorruption("snapshot header crc mismatch")
        metadata = f.read(meta_len)
        if len(metadata) < meta_len:
            raise SnapshotCorruption("truncated snapshot metadata")
        if crc32c(metadata) != meta_crc:
            raise SnapshotCorruption("snapshot metadata crc mismatch")
        payload = f.read()
    return metadata, payload
