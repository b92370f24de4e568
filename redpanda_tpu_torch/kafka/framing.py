"""Connection request framing: the native-wrapper seam for the
KafkaServer read loop.

A Kafka connection is a stream of `[i32 size][payload]` frames whose
payload leads with `api_key i16 | api_version i16 | correlation i32`.
The historical loop did readexactly(4) + struct.unpack + readexactly
(size) per frame — four coroutine suspensions and two Python-level
parses per request, which is what caps connection scale long before
the replication plane does. FrameScanner replaces it: the reader
feeds raw socket reads in, and one scan() call splits EVERYTHING
buffered into complete frames (native rp_frame_scan when the library
is loaded, a struct.unpack_from twin otherwise), carrying partial
frames across reads and rejecting oversize/garbage size prefixes
before any per-frame allocation.

This module is where per-frame struct math and buffer reassembly are
ALLOWED — rplint RPL022 keeps both out of kafka/server.py's hot read
loop, so the seam stays the single place the two implementations can
diverge (and tests/test_kafka_frontend.py holds them byte-equal).

Escape hatch: RP_NATIVE_FRAME=0 pins the pure-Python twin (checked
per scan, so tests can flip it at runtime).
"""

from __future__ import annotations

import struct

from ..utils import native

# payload header: api_key i16 | api_version i16 | correlation i32
_HDR = struct.Struct(">ihhi")  # size prefix + the 8-byte header floor
_SIZE = struct.Struct(">i")

# a size prefix below the 8-byte header floor cannot frame a request
_MIN_FRAME = 8


class FrameError(Exception):
    """Oversize or garbage size prefix — the connection must close."""


class FrameScanner:
    """Incremental frame splitter for one connection.

    feed() appends a raw socket read; scan() returns every complete
    frame buffered so far as (payload, api_key, api_version,
    correlation_id) tuples and keeps any trailing partial frame for
    the next round. scan() raises FrameError on a size prefix that is
    below the header floor or above max_frame.
    """

    __slots__ = ("_buf", "max_frame")

    def __init__(self, max_frame: int):
        self._buf = bytearray()
        self.max_frame = max_frame

    @property
    def buffered(self) -> int:
        """Bytes held for the next scan (partial-frame resume state)."""
        return len(self._buf)

    def feed(self, data: bytes) -> None:
        try:
            self._buf += data
        except BufferError:
            # a stack sampler that captured the native-call frame can
            # briefly pin a buffer export (see utils/native.frame_scan);
            # re-home instead of resizing the exported object
            self._buf = bytearray(self._buf) + data

    def scan(self) -> list[tuple[bytes, int, int, int]]:
        if not self._buf:
            return []
        if native.frame_scan_ready():
            out = self._scan_native()
            if out is not None:
                return out
        return self._scan_python()

    # -- native leg ------------------------------------------------
    def _scan_native(self) -> list[tuple[bytes, int, int, int]] | None:
        frames: list[tuple[bytes, int, int, int]] = []
        row_n = native.FS_ROW_N
        while True:
            res = native.frame_scan(self._buf, self.max_frame)
            if res is None:  # library vanished mid-connection
                return frames if frames else None
            n, rows, consumed = res
            if n < 0:
                raise FrameError("oversize or garbage size prefix")
            if n:
                # bulk-read the descriptor table: one memoryview
                # tolist() beats 5n ctypes __getitem__ calls ~10x —
                # per-element readback was costing more than the C
                # scan itself
                with memoryview(rows) as rv:
                    # ctypes exports format "<q", which tolist()
                    # rejects; a byte-cast round trip makes it native
                    vals = rv.cast("B").cast("q")[: n * row_n].tolist()
                it = iter(vals)  # 5-at-a-time row walk, no index math
                with memoryview(self._buf) as mv:
                    frames.extend(
                        (bytes(mv[off : off + ln]), key, ver, corr)
                        for off, ln, key, ver, corr in zip(
                            it, it, it, it, it
                        )
                    )
            if consumed:
                try:
                    del self._buf[:consumed]
                except BufferError:
                    # see feed(): never resize a briefly-pinned buffer
                    with memoryview(self._buf) as mv:
                        self._buf = bytearray(mv[consumed:])
            if n < native.FS_MAX_FRAMES or not self._buf:
                return frames
            # descriptor table filled: more frames may remain buffered

    # -- pure-Python twin ------------------------------------------
    def _scan_python(self) -> list[tuple[bytes, int, int, int]]:
        buf = self._buf
        frames: list[tuple[bytes, int, int, int]] = []
        pos = 0
        n = len(buf)
        max_frame = self.max_frame
        with memoryview(buf) as mv:
            while n - pos >= 4:
                if n - pos >= 4 + _MIN_FRAME:
                    size, key, ver, corr = _HDR.unpack_from(buf, pos)
                else:
                    (size,) = _SIZE.unpack_from(buf, pos)
                    key = ver = corr = None
                if size < _MIN_FRAME or size > max_frame:
                    raise FrameError("oversize or garbage size prefix")
                if n - pos - 4 < size:
                    break  # partial frame: resume after the next feed
                frames.append(
                    (bytes(mv[pos + 4 : pos + 4 + size]), key, ver, corr)
                )
                pos += 4 + size
        if pos:
            del buf[:pos]
        return frames
