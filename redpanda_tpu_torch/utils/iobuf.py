"""Fragmented zero-copy buffer — the data plane's universal currency.

Reference: src/v/bytes/iobuf.h:40 (`class iobuf`) and
src/v/bytes/iobuf_parser.h. The reference's iobuf is a list of
refcounted fragments supporting O(1) append/share/trim without copying
the payload. Python's buffer protocol gives us the same shape:
fragments are `memoryview`s over immutable bytes; `share()` returns a
sub-range view without copying; only `to_bytes()` linearizes.

The host RPC/storage paths move IOBufs; the device path stages a batch
of them into one padded uint8 array (ops.crc32c / ops.codecs).
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator


class IOBuf:
    __slots__ = ("_frags", "_size")

    def __init__(self, data: bytes | bytearray | memoryview | None = None):
        self._frags: list[memoryview] = []
        self._size = 0
        if data:
            self.append(data)

    # -- construction ------------------------------------------------
    def append(self, data: "bytes | bytearray | memoryview | IOBuf") -> "IOBuf":
        if isinstance(data, IOBuf):
            self._frags.extend(data._frags)
            self._size += data._size
            return self
        mv = memoryview(data).cast("B")
        if len(mv):
            self._frags.append(mv)
            self._size += len(mv)
        return self

    @staticmethod
    def of(*parts: bytes) -> "IOBuf":
        buf = IOBuf()
        for p in parts:
            buf.append(p)
        return buf

    # -- queries -----------------------------------------------------
    def __len__(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    def fragments(self) -> Iterator[memoryview]:
        return iter(self._frags)

    def num_fragments(self) -> int:
        return len(self._frags)

    # -- zero-copy ops ----------------------------------------------
    def share(self, pos: int, length: int) -> "IOBuf":
        """Sub-range view [pos, pos+length) sharing underlying memory
        (reference: iobuf::share)."""
        if pos < 0 or length < 0 or pos + length > self._size:
            raise IndexError("share out of range")
        out = IOBuf()
        skip = pos
        need = length
        for frag in self._frags:
            if need == 0:
                break
            if skip >= len(frag):
                skip -= len(frag)
                continue
            take = min(len(frag) - skip, need)
            out.append(frag[skip : skip + take])
            skip = 0
            need -= take
        return out

    def trim_front(self, n: int) -> None:
        if n > self._size:
            raise IndexError("trim_front past end")
        self._size -= n
        while n:
            frag = self._frags[0]
            if n >= len(frag):
                n -= len(frag)
                self._frags.pop(0)
            else:
                self._frags[0] = frag[n:]
                n = 0

    def trim_back(self, n: int) -> None:
        if n > self._size:
            raise IndexError("trim_back past end")
        self._size -= n
        while n:
            frag = self._frags[-1]
            if n >= len(frag):
                n -= len(frag)
                self._frags.pop()
            else:
                self._frags[-1] = frag[: len(frag) - n]
                n = 0

    def copy(self) -> "IOBuf":
        return self.share(0, self._size)

    # -- linearization ----------------------------------------------
    def to_bytes(self) -> bytes:
        if len(self._frags) == 1:
            return bytes(self._frags[0])
        return b"".join(bytes(f) for f in self._frags)

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, IOBuf):
            return self.to_bytes() == other.to_bytes()
        if isinstance(other, (bytes, bytearray)):
            return self.to_bytes() == bytes(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.to_bytes())

    def __repr__(self) -> str:  # pragma: no cover
        return f"IOBuf(size={self._size}, frags={len(self._frags)})"


class IOBufParser:
    """Sequential reader over an IOBuf (reference: bytes/iobuf_parser.h).

    Walks fragments in place with a cursor — no up-front linearization;
    a read only copies when it straddles a fragment boundary.

    Contiguous inputs (raw bytes / a single-fragment IOBuf — the RPC
    and produce paths hand whole frames in) take a dedicated fast
    path: one memoryview + one integer cursor, so read() is a slice
    and a cursor add, and skip() advances without copying. Fragmented
    inputs keep the full (_frag_idx, _frag_off) bookkeeping.
    """

    __slots__ = ("_frags", "_frag_idx", "_frag_off", "_pos", "_size", "_mv")

    def __init__(self, buf: "IOBuf | bytes | bytearray | memoryview"):
        if isinstance(buf, IOBuf):
            self._frags = list(buf.fragments())
            self._size = len(buf)
        else:
            mv = memoryview(buf).cast("B")
            self._frags = [mv] if len(mv) else []
            self._size = len(mv)
        self._frag_idx = 0
        self._frag_off = 0
        self._pos = 0
        # _frag_idx/_frag_off stay untouched (and unread) on this path
        self._mv = self._frags[0] if len(self._frags) == 1 else None

    def bytes_left(self) -> int:
        return self._size - self._pos

    def read(self, n: int) -> bytes:
        mv = self._mv
        if mv is not None:
            pos = self._pos
            if 0 <= n <= self._size - pos:
                out = bytes(mv[pos : pos + n])
                self._pos = pos + n
                return out
            if n < 0:
                raise ValueError(f"negative read length {n}")
            raise EOFError(f"need {n} bytes, have {self._size - pos}")
        if n < 0:
            raise ValueError(f"negative read length {n}")
        if self.bytes_left() < n:
            raise EOFError(f"need {n} bytes, have {self.bytes_left()}")
        frag = self._frags[self._frag_idx] if n else b""
        # fast path: entirely within the current fragment
        if n and self._frag_off + n <= len(frag):
            out = bytes(frag[self._frag_off : self._frag_off + n])
            self._frag_off += n
            if self._frag_off == len(frag):
                self._frag_idx += 1
                self._frag_off = 0
            self._pos += n
            return out
        parts = []
        need = n
        while need:
            frag = self._frags[self._frag_idx]
            take = min(len(frag) - self._frag_off, need)
            parts.append(bytes(frag[self._frag_off : self._frag_off + take]))
            self._frag_off += take
            if self._frag_off == len(frag):
                self._frag_idx += 1
                self._frag_off = 0
            need -= take
        self._pos += n
        return b"".join(parts)

    def peek(self, n: int) -> bytes:
        mv = self._mv
        if mv is not None:
            pos = self._pos
            return bytes(mv[pos : pos + min(n, self._size - pos)])
        saved = (self._frag_idx, self._frag_off, self._pos)
        try:
            return self.read(min(n, self.bytes_left()))
        finally:
            self._frag_idx, self._frag_off, self._pos = saved

    def _read_byte(self) -> int:
        if self._pos >= self._size:
            raise EOFError("vint past end of buffer")
        mv = self._mv
        if mv is not None:
            b = mv[self._pos]
            self._pos += 1
            return b
        frag = self._frags[self._frag_idx]
        b = frag[self._frag_off]
        self._frag_off += 1
        if self._frag_off == len(frag):
            self._frag_idx += 1
            self._frag_off = 0
        self._pos += 1
        return b

    def read_int(self, size: int, signed: bool = True, byteorder: str = "big") -> int:
        return int.from_bytes(self.read(size), byteorder, signed=signed)

    def read_unsigned_vint(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self._read_byte()
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                return result
            shift += 7
            if shift > 63:
                raise ValueError("vint too long")

    def read_vint(self) -> int:
        u = self.read_unsigned_vint()
        return (u >> 1) ^ -(u & 1)  # zigzag, inlined: hot per-record path

    def skip(self, n: int) -> None:
        mv = self._mv
        if mv is not None:  # advance the cursor, no copy
            if n < 0:
                raise ValueError(f"negative read length {n}")
            left = self._size - self._pos
            if left < n:
                raise EOFError(f"need {n} bytes, have {left}")
            self._pos += n
            return
        self.read(n)

    def pos(self) -> int:
        return self._pos
