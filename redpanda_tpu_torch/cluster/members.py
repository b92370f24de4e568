"""Cluster membership table.

Reference: src/v/cluster/members_table.{h,cc} (node_id → broker
metadata, built purely from committed controller commands) and the
membership_state lifecycle of members_manager.h (active → draining →
removed). Every node converges to the same table by replaying raft
group 0, exactly like the topic table.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class MembershipState(enum.Enum):
    active = "active"
    draining = "draining"  # decommission: replicas move off, then removal
    # maintenance (members_manager.h maintenance mode): leaderships
    # drain off and the balancers won't place new ones, but replicas
    # STAY — the node returns with a disable, no data movement
    maintenance = "maintenance"


@dataclasses.dataclass(slots=True)
class BrokerEndpoint:
    node_id: int
    rpc_addr: tuple[str, int]
    kafka_addr: tuple[str, int]
    state: MembershipState = MembershipState.active
    rack: str = ""  # failure-domain label; "" = unlabeled
    logical_version: int = 1  # feature level this build supports


class MembersTable:
    def __init__(self):
        self._nodes: dict[int, BrokerEndpoint] = {}
        # seeds registered from static config before raft0 has a
        # leader; replaced by replicated registrations as they commit
        self._seed_ids: set[int] = set()

    def seed(self, node_id: int) -> None:
        """Static bootstrap entry (cluster_discovery.cc founding
        brokers): known by id only until a RegisterNodeCmd commits with
        its addresses."""
        self._seed_ids.add(node_id)

    def apply_register(
        self,
        node_id: int,
        rpc_addr: tuple[str, int],
        kafka_addr: tuple[str, int],
        rack: str = "",
        logical_version: int = 1,
    ) -> None:
        cur = self._nodes.get(node_id)
        state = cur.state if cur is not None else MembershipState.active
        self._nodes[node_id] = BrokerEndpoint(
            node_id, rpc_addr, kafka_addr, state, rack, logical_version
        )

    def apply_state(self, node_id: int, state: MembershipState) -> None:
        cur = self._nodes.get(node_id)
        if cur is not None:
            cur.state = state

    def get(self, node_id: int) -> Optional[BrokerEndpoint]:
        return self._nodes.get(node_id)

    def node_ids(self) -> list[int]:
        """All known members: replicated registrations plus seeds not
        yet registered."""
        return sorted(set(self._nodes) | self._seed_ids)

    def registered(self) -> dict[int, BrokerEndpoint]:
        return dict(self._nodes)

    def rpc_addr(self, node_id: int) -> Optional[tuple[str, int]]:
        e = self._nodes.get(node_id)
        return e.rpc_addr if e is not None else None

    def kafka_addr(self, node_id: int) -> Optional[tuple[str, int]]:
        e = self._nodes.get(node_id)
        return e.kafka_addr if e is not None else None

    def is_draining(self, node_id: int) -> bool:
        e = self._nodes.get(node_id)
        return e is not None and e.state == MembershipState.draining

    def __contains__(self, node_id: int) -> bool:
        return node_id in self._nodes or node_id in self._seed_ids
