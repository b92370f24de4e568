"""Storage engine (reference: src/v/storage/).

kvstore (WAL + snapshot), segment log with sparse index and batch
cache, snapshot file format, per-shard StorageApi facade.
"""

from .batch_cache import BatchCache, BatchCacheIndex
from .kvstore import KeySpace, KvStore
from .log import Log, LogConfig, LogOffsets
from .log_manager import LogManager, StorageApi
from .segment import Segment
from .snapshot import SnapshotCorruption, read_snapshot, write_snapshot

__all__ = [
    "BatchCache",
    "BatchCacheIndex",
    "KeySpace",
    "KvStore",
    "Log",
    "LogConfig",
    "LogOffsets",
    "LogManager",
    "StorageApi",
    "Segment",
    "SnapshotCorruption",
    "read_snapshot",
    "write_snapshot",
]
