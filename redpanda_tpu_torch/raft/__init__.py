"""Raft consensus — the heart of the framework (reference: src/v/raft/).

One `Consensus` object per partition handles log I/O, elections and
membership; all per-group *decision math* (quorum/commit/match state)
lives in a per-shard struct-of-arrays (`ShardGroupArrays`) stepped by
batched device kernels (ops.quorum) each heartbeat tick — the key
TPU-first inversion of the reference's per-group scalar loops
(SURVEY.md §2.11 P2, §3.3).
"""

from .configuration import GroupConfiguration
from .consensus import Consensus, Role
from .group_manager import GroupManager
from .shard_state import ShardGroupArrays
from .state_machine import StateMachine
from .offset_translator import OffsetTranslator
from .tick_frame import TickFrame

__all__ = [
    "GroupConfiguration",
    "Consensus",
    "Role",
    "GroupManager",
    "ShardGroupArrays",
    "StateMachine",
    "OffsetTranslator",
    "TickFrame",
]
