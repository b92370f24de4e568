"""Cluster health aggregation (reference:
src/v/cluster/health_monitor_backend.{h,cc}, health_monitor_types.h).

Combines the local liveness table (node_status), membership state, and
per-partition leadership/offset stats into one queryable report — the
payload the admin API's /v1/cluster/health_overview serves.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker


@dataclasses.dataclass(slots=True)
class NodeHealth:
    node_id: int
    is_alive: bool
    membership: str  # active | draining | unregistered-seed
    is_self: bool


@dataclasses.dataclass(slots=True)
class PartitionHealth:
    ntp: str
    group: int
    leader: int | None
    replicas: list[int]
    high_watermark: int | None  # local view; None when not hosted here


@dataclasses.dataclass(slots=True)
class HealthReport:
    controller_id: int | None
    nodes: list[NodeHealth]
    nodes_down: list[int]
    leaderless_partitions: list[str]
    partitions: list[PartitionHealth]


class HealthMonitor:
    def __init__(self, broker: "Broker"):
        self._b = broker

    def report(self) -> HealthReport:
        b = self._b
        ctrl = b.controller
        status = b.node_status
        nodes: list[NodeHealth] = []
        down: list[int] = []
        for nid in ctrl.members_table.node_ids():
            ep = ctrl.members_table.get(nid)
            alive = status.is_alive(nid)
            nodes.append(
                NodeHealth(
                    node_id=nid,
                    is_alive=alive,
                    membership=(
                        ep.state.value if ep is not None else "unregistered-seed"
                    ),
                    is_self=nid == b.node_id,
                )
            )
            if not alive:
                down.append(nid)
        partitions: list[PartitionHealth] = []
        leaderless: list[str] = []
        for tp_ns, md in ctrl.topic_table.topics().items():
            for a in md.assignments.values():
                from ..models.fundamental import NTP

                ntp = NTP(tp_ns.ns, tp_ns.topic, a.partition)
                leader = b.metadata_cache.leader_of(ntp)
                local = b.partition_manager.get(ntp)
                partitions.append(
                    PartitionHealth(
                        ntp=f"{tp_ns.ns}/{tp_ns.topic}/{a.partition}",
                        group=a.group,
                        leader=leader,
                        replicas=list(a.replicas),
                        high_watermark=(
                            local.high_watermark() if local is not None else None
                        ),
                    )
                )
                if leader is None:
                    leaderless.append(f"{tp_ns.ns}/{tp_ns.topic}/{a.partition}")
        return HealthReport(
            controller_id=ctrl.leader_id,
            nodes=nodes,
            nodes_down=down,
            leaderless_partitions=leaderless,
            partitions=partitions,
        )
