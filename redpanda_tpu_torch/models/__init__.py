"""Data model layer (reference: src/v/model/).

`record` / `record_batch` with dual CRC, plus the domain identifier
types. The consensus-state tensor model (struct-of-arrays over raft
groups) lives in `consensus_state` and is stepped by ops/ kernels.
"""

from .fundamental import (
    CONTROLLER_GROUP,
    CONTROLLER_NTP,
    DEFAULT_NS,
    NO_NODE,
    NO_OFFSET,
    NO_TERM,
    NTP,
    GroupId,
    NodeId,
    Offset,
    PartitionId,
    Term,
    TopicNamespace,
    kafka_ntp,
)
from .record import (
    HEADER_SIZE,
    KAFKA_BATCH_OVERHEAD,
    CrcMismatch,
    Record,
    RecordBatch,
    RecordBatchBuilder,
    RecordBatchHeader,
    RecordBatchType,
    RecordHeader,
    batch_crcs,
    verify_batch_crcs,
)

__all__ = [
    "CONTROLLER_GROUP",
    "CONTROLLER_NTP",
    "DEFAULT_NS",
    "NO_NODE",
    "NO_OFFSET",
    "NO_TERM",
    "NTP",
    "GroupId",
    "NodeId",
    "Offset",
    "PartitionId",
    "Term",
    "TopicNamespace",
    "kafka_ntp",
    "HEADER_SIZE",
    "KAFKA_BATCH_OVERHEAD",
    "CrcMismatch",
    "Record",
    "RecordBatch",
    "RecordBatchBuilder",
    "RecordBatchHeader",
    "RecordBatchType",
    "RecordHeader",
    "batch_crcs",
    "verify_batch_crcs",
]
