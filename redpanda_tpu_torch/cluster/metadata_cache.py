"""Leaders table + metadata cache
(reference: src/v/cluster/partition_leaders_table.{h,cc},
cluster/metadata_cache.{h,cc}).

Leadership hints for metadata responses: partitions hosted on this
node report their consensus' live leader; remote partitions use hints
recorded by metadata dissemination (stage-7 gossip) or stay unknown —
clients retry metadata on NOT_LEADER exactly as with the reference.
"""

from __future__ import annotations

from ..models.fundamental import NTP, TopicNamespace
from .partition_manager import PartitionManager
from .topic_table import TopicMetadata, TopicTable


class PartitionLeadersTable:
    def __init__(self):
        self._leaders: dict[NTP, int] = {}

    def update(self, ntp: NTP, leader: int | None) -> None:
        if leader is None or leader < 0:
            self._leaders.pop(ntp, None)
        else:
            self._leaders[ntp] = leader

    def get(self, ntp: NTP) -> int | None:
        return self._leaders.get(ntp)

    def items(self):
        return list(self._leaders.items())

    def clear(self) -> None:
        """Admin debug/reset_leaders: hints repopulate via
        dissemination + local raft callbacks."""
        self._leaders.clear()


class MetadataCache:
    def __init__(
        self,
        topic_table: TopicTable,
        partition_manager: PartitionManager,
        leaders: PartitionLeadersTable,
    ):
        self._topics = topic_table
        self._pm = partition_manager
        self._leaders = leaders

    def topics(self) -> dict[TopicNamespace, TopicMetadata]:
        return self._topics.topics()

    def get_topic(self, tp_ns: TopicNamespace) -> TopicMetadata | None:
        return self._topics.get(tp_ns)

    def leader_of(self, ntp: NTP) -> int | None:
        p = self._pm.get(ntp)
        if p is not None and p.leader_id is not None and p.leader_id >= 0:
            return int(p.leader_id)
        return self._leaders.get(ntp)
