"""Columnar segment-meta store for partition manifests.

Reference: src/v/cloud_storage/segment_meta_cstore.h +
src/v/utils/delta_for.h:213 — the reference keeps manifest segment
metadata in delta-for-compressed columns so 100k-segment manifests fit
in memory. Same idea here, shaped for the Python/numpy runtime:

  * rows append into a small numpy TAIL buffer (mutable, fast);
  * full tails freeze into immutable CHUNKS of delta+zigzag+varint
    packed bytes (one stream per column, concatenated) — ~25-35 B/row
    vs ~350 B for a list of SegmentMeta envelopes (measured);
  * queries bisect a per-chunk first-base_offset vector, then decode
    one chunk through a tiny LRU (sequential scans decode each chunk
    once; random lookups keep at most _DECODE_CACHE chunks live);
  * rare structural mutations (adjacent-merge replacement, retention
    trimming) decode everything, splice in plain Python, and rebuild —
    correctness over cleverness on the cold path.

The store is a MutableSequence of SegmentView objects carrying the
exact SegmentMeta attribute surface (including .name and .encode()),
so manifest/archiver/remote-reader code indexes, slices, iterates and
re-encodes without knowing rows are packed.
"""

from __future__ import annotations

from collections.abc import MutableSequence

import numpy as np

from .manifest import SegmentMeta

_FIELDS = (
    "base_offset",
    "last_offset",
    "term",
    "size_bytes",
    "base_timestamp",
    "max_timestamp",
    "delta_offset",
    "delta_offset_end",
    # appended in manifest v3 (device-zstd archival): MUST stay last —
    # _Chunk.kfirst hardcodes delta_offset at column index 6
    "size_compressed",
)
_NF = len(_FIELDS)
CHUNK = 1024
_DECODE_CACHE = 4


def _zigzag(v: np.ndarray) -> np.ndarray:
    # int64 wrap-around is intentional (mod-2^64 arithmetic inverts
    # exactly); the result is reinterpreted as uint64 for the varint
    return ((v.astype(np.int64) << 1) ^ (v.astype(np.int64) >> 63)).astype(
        np.uint64
    )


def _unzigzag(u: np.ndarray) -> np.ndarray:
    # all shifts in uint64: an arithmetic right-shift here would smear
    # the sign bit and corrupt any value with magnitude >= 2^62
    u = u.astype(np.uint64)
    return (
        (u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1)))
    ).astype(np.int64)


def _pack_varint(vals: np.ndarray) -> bytes:
    """LEB128 over a uint64 vector (vectorized byte-plane emission)."""
    u = vals.astype(np.uint64)
    out = bytearray()
    # scalar loop is fine: freezing happens once per CHUNK rows
    for v in u.tolist():
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def _unpack_varint(buf: memoryview, n: int) -> tuple[np.ndarray, int]:
    out = np.empty(n, np.uint64)
    pos = 0
    for i in range(n):
        shift = 0
        acc = 0
        while True:
            b = buf[pos]
            pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        out[i] = acc & 0xFFFFFFFFFFFFFFFF
    return out, pos


class _Chunk:
    """Immutable packed rows: per-column delta+zigzag varint streams."""

    __slots__ = ("n", "first_base", "kfirst", "blob", "_starts")

    def __init__(self, cols: np.ndarray):
        # cols: int64[_NF, n]
        self.n = cols.shape[1]
        self.first_base = int(cols[0, 0])
        # kafka = raft - delta (delta_offset is field index 6)
        self.kfirst = int(cols[0, 0] - cols[6, 0])
        parts = []
        starts = [0]
        pos = 0
        for f in range(_NF):
            col = cols[f]
            deltas = np.empty(self.n, np.int64)
            deltas[0] = col[0]
            deltas[1:] = col[1:] - col[:-1]
            blob = _pack_varint(_zigzag(deltas))
            parts.append(blob)
            pos += len(blob)
            starts.append(pos)
        self.blob = b"".join(parts)
        self._starts = starts

    def decode(self) -> np.ndarray:
        cols = np.empty((_NF, self.n), np.int64)
        mv = memoryview(self.blob)
        for f in range(_NF):
            u, _used = _unpack_varint(
                mv[self._starts[f] : self._starts[f + 1]], self.n
            )
            cols[f] = np.cumsum(_unzigzag(u))
        return cols

    def nbytes(self) -> int:
        return len(self.blob)


class SegmentView:
    """Row view with the SegmentMeta attribute/behavior surface."""

    __slots__ = ("_vals", "name_hint")

    def __init__(self, vals, name_hint: str):
        self._vals = vals  # length-_NF int sequence
        self.name_hint = name_hint

    def __getattr__(self, attr):
        try:
            return int(self._vals[_FIELDS.index(attr)])
        except ValueError:
            raise AttributeError(attr) from None

    @property
    def name(self) -> str:
        return self.name_hint or f"{self.base_offset}-{self.term}.seg"

    def to_meta(self) -> SegmentMeta:
        kw = {f: int(self._vals[i]) for i, f in enumerate(_FIELDS)}
        return SegmentMeta(name_hint=self.name_hint, **kw)

    def encode(self) -> bytes:
        return self.to_meta().encode()

    def _key(self):
        return tuple(int(v) for v in self._vals) + (self.name_hint,)

    def __eq__(self, other) -> bool:
        if isinstance(other, (SegmentView, SegmentMeta)):
            return self._key() == _key_of(other)
        return NotImplemented

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):  # pragma: no cover
        return f"SegmentView({self.base_offset}-{self.last_offset})"


def _key_of(m) -> tuple:
    if isinstance(m, SegmentView):
        return m._key()
    return tuple(int(getattr(m, f)) for f in _FIELDS) + (m.name_hint,)


class SegmentMetaStore(MutableSequence):
    """Delta-for columnar MutableSequence of segment metadata."""

    def __init__(self, metas=()):
        self._chunks: list[_Chunk] = []
        self._chunk_firsts: list[int] = []  # first base_offset per chunk
        # first KAFKA offset (base - delta) per chunk: kafka-space
        # queries bisect this without decoding cold chunks
        self._chunk_kfirsts: list[int] = []
        self._row_starts: list[int] = []  # cumulative row index per chunk
        self._frozen_n = 0  # rows in frozen chunks
        self._tail = np.empty((_NF, CHUNK), np.int64)
        self._tail_n = 0
        # sparse: row index -> non-empty name_hint
        self._names: dict[int, str] = {}
        self._cache: dict[int, np.ndarray] = {}  # chunk idx -> decoded
        for m in metas:
            self.append(m)

    def __eq__(self, other) -> bool:
        if isinstance(other, (SegmentMetaStore, list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    __hash__ = None  # mutable

    # -- size ---------------------------------------------------------
    def __len__(self) -> int:
        return self._frozen_n + self._tail_n

    def nbytes(self) -> int:
        return (
            sum(c.nbytes() for c in self._chunks)
            + self._tail.nbytes
            + sum(len(v) + 64 for v in self._names.values())
        )

    # -- row access ----------------------------------------------------
    def _chunk_cols(self, ci: int) -> np.ndarray:
        cols = self._cache.get(ci)
        if cols is None:
            cols = self._chunks[ci].decode()
            if len(self._cache) >= _DECODE_CACHE:
                self._cache.pop(next(iter(self._cache)))
            self._cache[ci] = cols
        return cols

    def _row(self, i: int) -> SegmentView:
        import bisect as _b

        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        name = self._names.get(i, "")
        if i >= self._frozen_n:
            return SegmentView(
                self._tail[:, i - self._frozen_n].copy(), name
            )
        ci = _b.bisect_right(self._row_starts, i) - 1
        return SegmentView(
            self._chunk_cols(ci)[:, i - self._row_starts[ci]], name
        )

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._row(j) for j in range(*i.indices(len(self)))]
        return self._row(i)

    def __iter__(self):
        for ci in range(len(self._chunks)):
            cols = self._chunk_cols(ci)
            base = self._row_starts[ci]
            for j in range(self._chunks[ci].n):
                yield SegmentView(
                    cols[:, j], self._names.get(base + j, "")
                )
        base = self._frozen_n
        for j in range(self._tail_n):
            yield SegmentView(
                self._tail[:, j].copy(), self._names.get(base + j, "")
            )

    # -- mutation -------------------------------------------------------
    def append(self, m) -> None:
        if self._tail_n == CHUNK:
            self._freeze_tail()
        j = self._tail_n
        for f_idx, f in enumerate(_FIELDS):
            self._tail[f_idx, j] = int(getattr(m, f))
        hint = getattr(m, "name_hint", "")
        if hint:
            self._names[len(self)] = hint
        self._tail_n += 1

    def _freeze_tail(self) -> None:
        cols = self._tail[:, : self._tail_n].copy()
        c = _Chunk(cols)
        self._row_starts.append(self._frozen_n)
        self._frozen_n += self._tail_n
        self._chunks.append(c)
        self._chunk_firsts.append(c.first_base)
        self._chunk_kfirsts.append(c.kfirst)
        self._tail_n = 0

    def _rebuild(self, metas: list) -> None:
        self.__init__(metas)

    def _reindex(self) -> None:
        self._row_starts = []
        self._chunk_firsts = []
        self._chunk_kfirsts = []
        pos = 0
        for c in self._chunks:
            self._row_starts.append(pos)
            self._chunk_firsts.append(c.first_base)
            self._chunk_kfirsts.append(c.kfirst)
            pos += c.n
        self._frozen_n = pos
        self._cache.clear()

    def _splice(self, start: int, stop: int, new_metas: list) -> None:
        """Replace rows [start, stop) with new_metas, rebuilding only
        the chunks that overlap the range (the archival REPLACE path
        applies one mutation per merge command — a whole-store rebuild
        per command is O(n^2) over a merge storm; the reference cstore
        splices in place, delta_for.h:213)."""
        import bisect as _b

        n = len(self)
        nch = len(self._chunks)
        # first/last structure touched; index nch denotes the tail
        if start >= self._frozen_n:
            ci0 = nch
        else:
            ci0 = _b.bisect_right(self._row_starts, start) - 1
        if stop <= start:
            ci1 = ci0
        elif stop > self._frozen_n:
            ci1 = nch
        else:
            ci1 = _b.bisect_right(self._row_starts, stop - 1) - 1
        region_start = (
            self._frozen_n if ci0 == nch else self._row_starts[ci0]
        )
        region_end = (
            n if ci1 == nch else self._row_starts[ci1] + self._chunks[ci1].n
        )
        metas = (
            [self._row(j).to_meta() for j in range(region_start, start)]
            + list(new_metas)
            + [self._row(j).to_meta() for j in range(stop, region_end)]
        )
        delta = len(new_metas) - (stop - start)
        # re-key sparse names: region names come back from the metas
        names: dict[int, str] = {}
        for k, v in self._names.items():
            if k < region_start:
                names[k] = v
            elif k >= region_end:
                names[k + delta] = v
        m_arr = np.empty((_NF, len(metas)), np.int64)
        for idx, m in enumerate(metas):
            for f_idx, f in enumerate(_FIELDS):
                m_arr[f_idx, idx] = int(getattr(m, f))
            hint = getattr(m, "name_hint", "")
            if hint:
                names[region_start + idx] = hint
        if ci1 == nch:
            # tail in region: full groups freeze, remainder is the tail
            nfreeze = (len(metas) // CHUNK) * CHUNK
        else:
            # tail untouched: all region rows freeze (a mid-store
            # partial chunk is fine — decode/row math is per-chunk n)
            nfreeze = len(metas)
        chunks = self._chunks[:ci0]
        for s in range(0, nfreeze, CHUNK):
            chunks.append(_Chunk(m_arr[:, s : min(s + CHUNK, nfreeze)]))
        if ci1 < nch:
            chunks.extend(self._chunks[ci1 + 1 :])
        self._chunks = chunks
        self._names = names
        self._reindex()
        if ci1 == nch:
            self._tail = np.empty((_NF, CHUNK), np.int64)
            self._tail_n = len(metas) - nfreeze
            self._tail[:, : self._tail_n] = m_arr[:, nfreeze:]
        # else: tail buffer unchanged

    @staticmethod
    def _as_meta(v):
        return v.to_meta() if isinstance(v, SegmentView) else v

    def __setitem__(self, i, value) -> None:
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step == 1:
                self._splice(
                    start, stop, [self._as_meta(v) for v in value]
                )
                return
            # extended slice: rare, full rebuild is fine
            metas = [m.to_meta() for m in self]
            metas[i] = [self._as_meta(v) for v in value]
            self._rebuild(metas)
            return
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        self._splice(i, i + 1, [self._as_meta(value)])

    def __delitem__(self, i) -> None:
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step == 1:
                self._splice(start, stop, [])
                return
            metas = [m.to_meta() for m in self]
            del metas[i]
            self._rebuild(metas)
            return
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        self._splice(i, i + 1, [])

    def insert(self, i, value) -> None:
        n = len(self)
        if i < 0:
            i = max(0, i + n)
        i = min(i, n)
        self._splice(i, i, [self._as_meta(value)])

    def clear(self) -> None:
        self._rebuild([])

    # -- queries (the manifest's hot surface) --------------------------
    def find_containing(self, raft_offset: int):
        """Segment view containing raft_offset, or None — O(log chunks
        + log CHUNK) without touching cold chunks."""
        if len(self) == 0:
            return None
        import bisect as _b

        if self._tail_n and raft_offset >= int(self._tail[0, 0]):
            t = self._tail[:, : self._tail_n]
            j = int(np.searchsorted(t[0], raft_offset, side="right")) - 1
            if j >= 0 and raft_offset <= int(t[1, j]):
                return SegmentView(
                    t[:, j].copy(),
                    self._names.get(self._frozen_n + j, ""),
                )
            return None
        ci = _b.bisect_right(self._chunk_firsts, raft_offset) - 1
        if ci < 0:
            return None
        cols = self._chunk_cols(ci)
        j = int(np.searchsorted(cols[0], raft_offset, side="right")) - 1
        if j >= 0 and raft_offset <= int(cols[1, j]):
            return SegmentView(
                cols[:, j], self._names.get(self._row_starts[ci] + j, "")
            )
        return None

    def index_of_base(self, base_offset: int) -> int | None:
        """Row index of the segment whose base_offset == base_offset,
        or None — O(log) without decoding cold chunks."""
        import bisect as _b

        if self._tail_n and base_offset >= int(self._tail[0, 0]):
            t = self._tail[0, : self._tail_n]
            j = int(np.searchsorted(t, base_offset))
            if j < self._tail_n and int(t[j]) == base_offset:
                return self._frozen_n + j
            return None
        ci = _b.bisect_right(self._chunk_firsts, base_offset) - 1
        if ci < 0:
            return None
        col = self._chunk_cols(ci)[0]
        j = int(np.searchsorted(col, base_offset))
        if j < len(col) and int(col[j]) == base_offset:
            return self._row_starts[ci] + j
        return None

    def find_kafka(self, kafka_offset: int):
        """(row_index, view) of the last segment whose kafka start
        (base_offset - delta_offset) is <= kafka_offset, or None —
        the remote reader's lookup, chunk-bisected in kafka space."""
        import bisect as _b

        if len(self) == 0:
            return None
        if self._tail_n:
            t = self._tail[:, : self._tail_n]
            kstarts = t[0] - t[6]
            if kafka_offset >= int(kstarts[0]):
                j = int(np.searchsorted(kstarts, kafka_offset, "right")) - 1
                return (
                    self._frozen_n + j,
                    SegmentView(
                        t[:, j].copy(),
                        self._names.get(self._frozen_n + j, ""),
                    ),
                )
        ci = _b.bisect_right(self._chunk_kfirsts, kafka_offset) - 1
        if ci < 0:
            return None  # below the first segment's kafka start
        cols = self._chunk_cols(ci)
        kstarts = cols[0] - cols[6]
        j = int(np.searchsorted(kstarts, kafka_offset, side="right")) - 1
        if j < 0:
            return None
        return (
            self._row_starts[ci] + j,
            SegmentView(
                cols[:, j], self._names.get(self._row_starts[ci] + j, "")
            ),
        )
