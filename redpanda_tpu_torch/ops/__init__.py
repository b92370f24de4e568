"""CUDA kernels: batched consensus math and data-plane validation.

- quorum: the 50k-group reply fold, commit sweep and heartbeat gather
- health: the per-row partition-health reduction
- crc32c: batched record-batch CRC validation

Each module holds a kernel wrapper and its plain PyTorch version; the
sources live in `csrc/` and `_build` compiles them on first use.
"""

from .crc32c import crc32c_batch_device, crc32c_device
from .health import health_reduce, tick_frame_health
from .quorum import (
    build_heartbeats,
    fold_replies,
    heartbeat_tick,
    quorum_commit_step,
    tick_frame,
)

__all__ = [
    "build_heartbeats",
    "crc32c_batch_device",
    "crc32c_device",
    "fold_replies",
    "health_reduce",
    "heartbeat_tick",
    "quorum_commit_step",
    "tick_frame",
    "tick_frame_health",
]
