"""Tiered (object) storage layer.

Reference: src/v/cloud_storage/ (remote.h, partition_manifest.h,
remote_segment/remote_partition) and src/v/archival/
(ntp_archiver_service.h). Closed, committed log segments upload to an
object store; local retention then trims the local log, and fetches
below the local log start stream back from the uploaded segments.
"""

from .object_store import (
    CloudUnavailableError,
    FilesystemObjectStore,
    MemoryObjectStore,
    ObjectStore,
    RetryingStore,
    StoreError,
    StoreThrottled,
)
from .nemesis import NemesisObjectStore, StoreFaultSchedule, StoreRule
from .manifest import PartitionManifest, SegmentMeta, TopicManifest
from .archiver import NtpArchiver, ArchivalService
from .remote_partition import RemoteReader

__all__ = [
    "ArchivalService",
    "CloudUnavailableError",
    "NemesisObjectStore",
    "RetryingStore",
    "StoreFaultSchedule",
    "StoreRule",
    "StoreThrottled",
    "FilesystemObjectStore",
    "MemoryObjectStore",
    "NtpArchiver",
    "ObjectStore",
    "PartitionManifest",
    "RemoteReader",
    "SegmentMeta",
    "StoreError",
    "TopicManifest",
]
