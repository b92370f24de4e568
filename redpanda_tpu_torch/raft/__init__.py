"""Raft state for the port: the per-shard struct-of-arrays
(`ShardGroupArrays`), its tick frame and the scalar oracles. The
per-group `Consensus` objects and the rest of the broker host tree are
not ported yet."""

from .shard_state import ShardGroupArrays
from .tick_frame import TickFrame

__all__ = ["ShardGroupArrays", "TickFrame"]
