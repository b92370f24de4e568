"""RPC wire frame (reference: src/v/rpc/types.h:226-270).

The reference uses a fixed 26-byte header carrying version, compression
flag, payload size, method id ("meta"), correlation id, a crc32 of the
header and an xxhash64 of the payload. Ours is a fixed 24-byte header
with the same information content, both checksums crc32c (one hot
kernel instead of two):

    magic      u8   = 0xA7
    version    u8   = 0 (frame format version)
    status     u8   (0 ok on requests; response status otherwise)
    flags      u8   (bit 0: payload compressed — reserved)
    method_id  u32  le
    correlation u32 le
    payload_size u32 le
    payload_crc  u32 le  crc32c over payload bytes
    header_crc   u32 le  crc32c over the preceding 20 bytes
"""

from __future__ import annotations

import struct

from ..utils.crc import crc32c
from ..utils.iobuf import IOBuf

MAGIC = 0xA7
FRAME_VERSION = 0
HEADER_SIZE = 24
_HEAD = struct.Struct("<BBBBIIII")


class Status:
    OK = 0
    METHOD_NOT_FOUND = 1
    SERVICE_ERROR = 2
    BAD_CHECKSUM = 3
    TIMEOUT = 4


class RpcError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"rpc status={status} {message}")
        self.status = status
        self.message = message


class FrameHeader:
    __slots__ = ("status", "flags", "method_id", "correlation", "payload_size", "payload_crc")

    def __init__(
        self,
        method_id: int,
        correlation: int,
        payload_size: int,
        payload_crc: int,
        status: int = Status.OK,
        flags: int = 0,
    ):
        self.status = status
        self.flags = flags
        self.method_id = method_id
        self.correlation = correlation
        self.payload_size = payload_size
        self.payload_crc = payload_crc

    def pack(self) -> bytes:
        head = _HEAD.pack(
            MAGIC,
            FRAME_VERSION,
            self.status,
            self.flags,
            self.method_id,
            self.correlation,
            self.payload_size,
            self.payload_crc,
        )
        return head + struct.pack("<I", crc32c(head))

    @staticmethod
    def unpack(data: bytes) -> "FrameHeader":
        if len(data) != HEADER_SIZE:
            raise RpcError(Status.BAD_CHECKSUM, "short header")
        (magic, version, status, flags, method_id, corr, size, pcrc) = _HEAD.unpack(
            data[:20]
        )
        (hcrc,) = struct.unpack("<I", data[20:24])
        if magic != MAGIC or version != FRAME_VERSION:
            raise RpcError(Status.BAD_CHECKSUM, "bad magic/version")
        if crc32c(data[:20]) != hcrc:
            raise RpcError(Status.BAD_CHECKSUM, "header crc mismatch")
        return FrameHeader(method_id, corr, size, pcrc, status=status, flags=flags)


def make_frame(
    method_id: int,
    correlation: int,
    payload: "bytes | IOBuf",
    status: int = Status.OK,
) -> IOBuf:
    """Frame without linearizing: the payload CRC extends over the
    fragments (reference: crc_extend_iobuf) and the result is an IOBuf
    of [header, *payload fragments] — writers emit the fragments
    straight into the socket buffer, skipping the header+payload
    concatenation copy a multi-MB append payload would otherwise pay."""
    buf = payload if isinstance(payload, IOBuf) else IOBuf(payload)
    crc = 0
    for frag in buf.fragments():
        crc = crc32c(_frag_bytes(frag), crc)
    hdr = FrameHeader(method_id, correlation, len(buf), crc, status=status)
    out = IOBuf(hdr.pack())
    out.append(buf)
    return out


def _frag_bytes(frag: memoryview) -> bytes:
    """Fragment as bytes WITHOUT copying when the view spans a whole
    bytes object (the common append case; sub-range shares copy)."""
    base = frag.obj
    if isinstance(base, bytes) and len(frag) == len(base):
        return base
    return frag.tobytes()


def write_frame(writer, frame: IOBuf) -> None:
    """Emit a frame's fragments into an asyncio StreamWriter — one
    copy into the transport buffer, no linearization first."""
    for frag in frame.fragments():
        writer.write(frag)


def verify_payload(hdr: FrameHeader, payload: bytes) -> None:
    if crc32c(payload) != hdr.payload_crc:
        raise RpcError(Status.BAD_CHECKSUM, "payload crc mismatch")
