"""Replica placement (reference: src/v/cluster/scheduling/partition_allocator.{h,cc}).

Counts-based scoring kept as a numpy vector over brokers (SURVEY §2.11
P8: allocation scoring is embarrassingly vectorizable): each replica
goes to the least-loaded eligible broker, leaders (first replica)
rotate round-robin so leadership spreads like the reference's
allocation_node round-robin.
"""

from __future__ import annotations

import numpy as np

from .topic_table import PartitionAssignment


class AllocationError(Exception):
    pass


class PartitionAllocator:
    def __init__(self):
        # broker id → running replica count (decremented on topic delete)
        self._counts: dict[int, int] = {}
        # broker id → rack label ("" = unlabeled)
        self._racks: dict[int, str] = {}
        self._rr = 0

    def register_node(self, node_id: int, rack: str = "") -> None:
        self._counts.setdefault(node_id, 0)
        # unconditional: a re-registration with no label CLEARS a stale
        # one (topology changes must not linger)
        if rack:
            self._racks[node_id] = rack
        else:
            self._racks.pop(node_id, None)

    def deregister_node(self, node_id: int) -> None:
        self._counts.pop(node_id, None)
        self._racks.pop(node_id, None)

    def account(self, replicas: list[int], sign: int = 1) -> None:
        for r in replicas:
            if r in self._counts:
                self._counts[r] += sign

    def pick_replacement(
        self, current: list[int], exclude: set[int]
    ) -> int | None:
        """Least-loaded registered node not already a replica and not
        excluded (draining/dead) — the drain loop's per-partition move
        target. Prefers racks not yet represented in the surviving
        replica set, so drains don't erode the diversity allocate()
        established (scheduling/constraints.cc distinct_nodes +
        least_allocated analog)."""
        candidates = [
            n
            for n in sorted(self._counts)
            if n not in current and n not in exclude
        ]
        if not candidates:
            return None
        survivor_racks = {
            self._racks[n]
            for n in current
            if n not in exclude and n in self._racks
        }
        diverse = [
            n
            for n in candidates
            if not self._racks.get(n) or self._racks[n] not in survivor_racks
        ]
        pool = diverse or candidates
        return min(pool, key=lambda n: self._counts[n])

    def allocate(
        self,
        partition_count: int,
        replication_factor: int,
        next_group: int,
        exclude: set[int] | None = None,
    ) -> list[PartitionAssignment]:
        """`exclude` removes draining/decommissioning nodes from
        eligibility — placing new replicas on a node being emptied
        would fight the drain loop (allocation_state.cc skips
        non-active members)."""
        nodes = sorted(n for n in self._counts if not exclude or n not in exclude)
        if replication_factor > len(nodes):
            raise AllocationError(
                f"replication factor {replication_factor} > {len(nodes)} brokers"
            )
        counts = np.array([self._counts[n] for n in nodes], dtype=np.int64)
        racks = [self._racks.get(n, "") for n in nodes]
        out: list[PartitionAssignment] = []
        for p in range(partition_count):
            # leader slot rotates; remaining replicas by load with a
            # rack-diversity constraint: prefer nodes whose rack is not
            # yet represented in the replica set
            # (scheduling/constraints.cc distinct_rack soft constraint)
            leader_pos = self._rr % len(nodes)
            self._rr += 1
            order = np.argsort(counts, kind="stable")
            replicas = [nodes[leader_pos]]
            used_racks = {racks[leader_pos]} if racks[leader_pos] else set()
            counts[leader_pos] += 1

            def eligible(idx, respect_racks):
                if nodes[idx] in replicas:
                    return False
                r = racks[idx]
                return not (respect_racks and r and r in used_racks)

            for respect_racks in (True, False):
                for i in order:
                    if len(replicas) == replication_factor:
                        break
                    if eligible(int(i), respect_racks):
                        replicas.append(nodes[int(i)])
                        if racks[int(i)]:
                            used_racks.add(racks[int(i)])
                        counts[int(i)] += 1
            out.append(
                PartitionAssignment(
                    partition=p, group=next_group + p, replicas=replicas
                )
            )
        for a in out:
            self.account(a.replicas)
        return out
