"""Consumer group coordinator (reference: src/v/kafka/server/group*)."""

from .group import Group, GroupState, JoinResult, Member, SyncResult  # noqa: F401
from .group_manager import (  # noqa: F401
    DEFAULT_OFFSETS_PARTITIONS,
    OFFSETS_TOPIC,
    GroupCoordinator,
)
