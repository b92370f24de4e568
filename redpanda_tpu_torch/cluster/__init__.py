"""Cluster control plane (reference: src/v/cluster/)."""

from .allocator import AllocationError, PartitionAllocator  # noqa: F401
from .commands import (  # noqa: F401
    CmdType,
    CreateTopicCmd,
    DeleteTopicCmd,
    decode_commands,
    encode_command,
)
from .controller import Controller, ControllerService, TopicError  # noqa: F401
from .metadata_cache import MetadataCache, PartitionLeadersTable  # noqa: F401
from .partition import Partition  # noqa: F401
from .partition_manager import PartitionManager  # noqa: F401
from .shard_table import ShardTable  # noqa: F401
from .topic_table import (  # noqa: F401
    Delta,
    PartitionAssignment,
    TopicMetadata,
    TopicTable,
)
