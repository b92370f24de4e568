"""Per-shard ntp → partition registry
(reference: src/v/cluster/partition_manager.{h,cc}:60-90).

`manage()` creates the storage log + raft group + partition facade;
`remove()` tears them down — driven by controller_backend
reconciliation exactly like the reference.
"""

from __future__ import annotations

from typing import Optional

from ..models.fundamental import NTP
from ..raft.group_manager import GroupManager
from ..storage.log_manager import LogManager
from .partition import Partition


class PartitionManager:
    def __init__(self, log_manager: LogManager, group_manager: GroupManager):
        self._log_manager = log_manager
        self._group_manager = group_manager
        self._ntp_table: dict[NTP, Partition] = {}
        self._group_table: dict[int, Partition] = {}
        # per-BROKER producer.id.expiration.ms (cluster-config bound);
        # applied to every managed partition, new and existing
        self.producer_expiry_ms = Partition.producer_expiry_ms

    def get(self, ntp: NTP) -> Optional[Partition]:
        return self._ntp_table.get(ntp)

    def get_by_group(self, group_id: int) -> Optional[Partition]:
        return self._group_table.get(group_id)

    def partitions(self) -> dict[NTP, Partition]:
        return self._ntp_table

    async def manage(
        self,
        ntp: NTP,
        group_id: int,
        replicas: list[int],
        log_config=None,
    ) -> Partition:
        if ntp in self._ntp_table:
            return self._ntp_table[ntp]
        log = self._log_manager.manage(ntp, log_config)
        consensus = await self._group_manager.create_group(
            group_id, voters=replicas, log=log
        )
        # ntp-form ledger key: raft append rates land under the same
        # key the kafka produce/fetch hooks use for this partition
        consensus.ledger_key = f"{ntp.ns}/{ntp.topic}/{ntp.partition}"
        p = Partition(ntp, group_id, consensus)
        p.producer_expiry_ms = self.producer_expiry_ms
        self._ntp_table[ntp] = p
        self._group_table[group_id] = p
        return p

    async def remove(self, ntp: NTP) -> None:
        p = self._ntp_table.pop(ntp, None)
        if p is None:
            return
        self._group_table.pop(p.group_id, None)
        p.close()
        self._group_manager.probe.ledger.forget(
            f"{ntp.ns}/{ntp.topic}/{ntp.partition}"
        )
        await self._group_manager.remove_group(p.group_id)
        self._log_manager.remove(ntp)

    async def stop(self) -> None:
        for ntp in list(self._ntp_table):
            p = self._ntp_table.pop(ntp)
            self._group_table.pop(p.group_id, None)
            p.close()
