"""Raft↔Kafka offset translation
(reference: src/v/raft/offset_translator.{h,cc}, doc :26-35;
storage/offset_translator_state.{h,cc}).

Raft logs interleave configuration/control batches with data; Kafka
clients must see a gapless data offset space. The translator records
the raft offsets of every filtered (non-data) batch; translation
subtracts the number of filtered batches at-or-below the offset.
Checkpointed to the kvstore (offset_translator key space) like the
reference.
"""

from __future__ import annotations

import bisect

from ..models.record import RecordBatchType
from ..storage.kvstore import KeySpace, KvStore
from ..utils import serde

# batch types hidden from the Kafka offset space
FILTERED_TYPES = frozenset(
    t
    for t in RecordBatchType
    if t != RecordBatchType.raft_data
)


class _State(serde.Envelope):
    SERDE_FIELDS = [
        ("filtered", serde.vector(serde.i64)),  # raft offsets of filtered batches
        ("base", serde.i64),                     # offsets below base are gone
        ("base_delta", serde.i64),               # filtered entries dropped below base
    ]


class OffsetTranslator:
    def __init__(self, kvstore: KvStore | None = None, group_id: int = 0):
        self._kv = kvstore
        self._group = group_id
        self._filtered: list[int] = []
        self._base = 0
        # filtered entries already dropped by prefix truncation: they
        # still shift every later offset (the reference's
        # offset_translator_state keeps the same running delta)
        self._base_delta = 0
        if kvstore is not None:
            raw = kvstore.get(KeySpace.offset_translator, self._key())
            if raw is not None:
                st = _State.decode(raw)
                self._filtered = list(st.filtered)
                self._base = int(st.base)
                self._base_delta = int(st.base_delta)

    def _key(self) -> bytes:
        return f"ot/{self._group}".encode()

    def checkpoint(self) -> None:
        if self._kv is not None:
            self._kv.put(
                KeySpace.offset_translator,
                self._key(),
                _State(
                    filtered=self._filtered,
                    base=self._base,
                    base_delta=self._base_delta,
                ).encode(),
            )

    def track(self, batch_type: int, base_offset: int, last_offset: int) -> None:
        """Record a batch appended to the raft log."""
        if batch_type in FILTERED_TYPES:
            for off in range(base_offset, last_offset + 1):
                if not self._filtered or off > self._filtered[-1]:
                    self._filtered.append(off)

    def truncate(self, offset: int) -> None:
        """Suffix truncation: drop tracking at-or-after offset."""
        idx = bisect.bisect_left(self._filtered, offset)
        del self._filtered[idx:]

    def prefix_truncate(self, offset: int) -> None:
        idx = bisect.bisect_left(self._filtered, offset)
        self._base_delta += idx
        del self._filtered[:idx]
        self._base = max(self._base, offset)

    def capture_upto(self, offset: int) -> bytes:
        """Snapshot capture: state as it should look on a replica whose
        log starts at offset+1 — entries at-or-below the boundary fold
        into the running base delta (raft snapshot contributor)."""
        idx = bisect.bisect_right(self._filtered, offset)
        return _State(
            filtered=self._filtered[idx:],
            base=max(self._base, offset + 1),
            base_delta=self._base_delta + idx,
        ).encode()

    def restore(self, blob: bytes) -> None:
        st = _State.decode(blob)
        self._filtered = list(st.filtered)
        self._base = int(st.base)
        self._base_delta = int(st.base_delta)
        self.checkpoint()

    def to_kafka(self, raft_offset: int) -> int:
        """Raft offset → Kafka offset (delta = filtered ≤ offset,
        including entries dropped by prefix truncation — offsets must
        stay stable across retention)."""
        delta = self._base_delta + bisect.bisect_right(
            self._filtered, raft_offset
        )
        return raft_offset - delta

    def from_kafka(self, kafka_offset: int) -> int:
        """Kafka offset → raft offset (inverse mapping)."""
        # raft = kafka + (#filtered ≤ raft): fixed-point via bisect
        raft = kafka_offset + self._base_delta
        while True:
            delta = self._base_delta + bisect.bisect_right(self._filtered, raft)
            candidate = kafka_offset + delta
            if candidate == raft:
                return raft
            raft = candidate
