"""CUDA kernels: batched consensus math and data-plane validation.

- quorum: the 50k-group reply fold, commit sweep and heartbeat gather,
  and the follower-side commit and local-append rules
- health: the per-row partition-health reduction, alone and fused with
  the mesh frame's fleet totals
- crc32c: batched record-batch CRC validation
- cellparse, lz4, snappy: the cell-grid LZ77 parse and LZ4 / snappy
  block emission
- zstd: the huff0 literals encode (code lengths, canonical codes, four
  reversed bitstreams) and the huff0 stream decode of the zstd codec
- fused: CRC + LZ4 / snappy / zstd from one upload

Each module holds a kernel wrapper and its plain PyTorch version; the
sources live in `csrc/` and `_build` compiles them on first use.
"""

from .cellparse import cell_parse
from .crc32c import crc32c_batch_device, crc32c_device
from .fused import crc_lz4_fused, crc_snappy_fused, crc_zstd_fused
from .health import health_reduce, health_totals, tick_frame_health
from .lz4 import lz4_emit
from .quorum import (
    build_heartbeats,
    fold_replies,
    follower_commit_step,
    heartbeat_tick,
    local_append_update,
    quorum_commit_step,
    tick_frame,
)
from .snappy import snappy_emit
from .zstd import decode_streams, encode_chunks

__all__ = [
    "build_heartbeats",
    "cell_parse",
    "crc32c_batch_device",
    "crc32c_device",
    "crc_lz4_fused",
    "crc_snappy_fused",
    "crc_zstd_fused",
    "decode_streams",
    "encode_chunks",
    "fold_replies",
    "follower_commit_step",
    "health_reduce",
    "health_totals",
    "heartbeat_tick",
    "local_append_update",
    "lz4_emit",
    "quorum_commit_step",
    "snappy_emit",
    "tick_frame",
    "tick_frame_health",
]
