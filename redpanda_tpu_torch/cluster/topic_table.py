"""Authoritative topic/partition state (reference: src/v/cluster/topic_table.{h,cc}).

Built purely by applying committed controller commands, so every node
converges to the same table. `wait_revision` lets frontends block until
their own command has been applied locally (the reference's
replicate_and_wait → stm wait pattern, topics_frontend.cc:280).
"""

from __future__ import annotations

import asyncio
import dataclasses

from ..models.fundamental import NTP, TopicNamespace
from .commands import CmdType, CreateTopicCmd, DeleteTopicCmd


@dataclasses.dataclass(slots=True)
class PartitionAssignment:
    partition: int
    group: int
    replicas: list[int]


@dataclasses.dataclass(slots=True)
class TopicMetadata:
    tp_ns: TopicNamespace
    partition_count: int
    replication_factor: int
    revision: int
    assignments: dict[int, PartitionAssignment]
    config: dict[str, str | None]


@dataclasses.dataclass(slots=True)
class Delta:
    """One reconciliation unit emitted to controller_backend."""

    kind: str  # "add" | "del" | "cfg" | "move" | "purge"
    ntp: NTP
    group: int
    replicas: list[int]
    # "move" only: the replica set being replaced (new nodes bootstrap
    # their raft instance from it; the group leader reconfigures old→new)
    old_replicas: list[int] = dataclasses.field(default_factory=list)


class TopicTable:
    def __init__(self):
        self._topics: dict[TopicNamespace, TopicMetadata] = {}
        self.next_group_id = 1  # group 0 = controller
        self.revision = 0  # last applied controller revision (offset)
        self._pending_deltas: list[Delta] = []
        self._waiters: list[asyncio.Event] = []
        # replicated view of replica moves not yet finished (applied on
        # move_replicas, cleared on finish_move) — every node agrees,
        # so balancers can bound cluster-wide move concurrency. Maps
        # the moving ntp to the replica set being replaced, which is
        # what ListPartitionReassignments reports as removing_replicas
        # and what a reassignment cancel restores.
        self.updates_in_progress: dict[NTP, list[int]] = {}

    # -- queries -----------------------------------------------------
    def topics(self) -> dict[TopicNamespace, TopicMetadata]:
        return self._topics

    def get(self, tp_ns: TopicNamespace) -> TopicMetadata | None:
        return self._topics.get(tp_ns)

    def contains(self, tp_ns: TopicNamespace) -> bool:
        return tp_ns in self._topics

    def group_of(self, ntp: NTP) -> int | None:
        md = self._topics.get(ntp.tp_ns)
        if md is None:
            return None
        a = md.assignments.get(ntp.partition)
        return a.group if a else None

    # -- mutation (controller_stm only) ------------------------------
    def apply(self, cmd_type: CmdType, cmd, revision: int) -> None:
        if cmd_type == CmdType.create_topic:
            self._apply_create(cmd, revision)
        elif cmd_type == CmdType.delete_topic:
            self._apply_delete(cmd)
        elif cmd_type == CmdType.update_topic:
            self._apply_update_config(cmd)
        elif cmd_type == CmdType.create_partitions:
            self._apply_create_partitions(cmd)
        elif cmd_type == CmdType.move_replicas:
            self._apply_move(cmd)
        elif cmd_type == CmdType.finish_move:
            self._apply_finish_move(cmd)
        self.revision = revision
        self._notify()

    def _apply_finish_move(self, cmd) -> None:
        """The data group's reconfiguration is final: losers may purge
        their local replica (finish_moving_partition_replicas apply)."""
        md = self._topics.get(TopicNamespace(cmd.ns, cmd.topic))
        if md is None:
            return
        a = md.assignments.get(int(cmd.partition))
        if a is None:
            return
        if [int(r) for r in cmd.replicas] != a.replicas:
            # stale report from a superseded move: purging against it
            # would delete replicas the CURRENT assignment owns
            return
        self.updates_in_progress.pop(NTP(cmd.ns, cmd.topic, a.partition), None)
        self._pending_deltas.append(
            Delta(
                "purge",
                NTP(cmd.ns, cmd.topic, a.partition),
                a.group,
                [int(r) for r in cmd.replicas],
            )
        )

    def _apply_move(self, cmd) -> None:
        md = self._topics.get(TopicNamespace(cmd.ns, cmd.topic))
        if md is None:
            return
        a = md.assignments.get(int(cmd.partition))
        if a is None:
            return
        new = [int(r) for r in cmd.replicas]
        if new == a.replicas:
            return  # idempotent re-apply
        old = list(a.replicas)
        a.replicas = new
        ntp = NTP(cmd.ns, cmd.topic, a.partition)
        # the entry lives until finish_move: even a cancel (move back
        # to the original set) is still a converging reconfiguration,
        # and balancers bound cluster-wide concurrency on this map
        self.updates_in_progress.setdefault(ntp, old)
        self._pending_deltas.append(
            Delta("move", ntp, a.group, new, old_replicas=old)
        )

    def _apply_update_config(self, cmd) -> None:
        md = self._topics.get(TopicNamespace(cmd.ns, cmd.topic))
        if md is None:
            return
        md.config.update(dict(cmd.set_configs))
        for name in cmd.remove_configs:
            md.config.pop(name, None)
        # live-rebind storage knobs (retention/segment/cleanup.policy)
        # on every hosting node
        for a in md.assignments.values():
            self._pending_deltas.append(
                Delta(
                    "cfg",
                    NTP(cmd.ns, cmd.topic, a.partition),
                    a.group,
                    list(a.replicas),
                )
            )

    def _apply_create_partitions(self, cmd) -> None:
        md = self._topics.get(TopicNamespace(cmd.ns, cmd.topic))
        if md is None:
            return
        for a in cmd.assignments:
            if int(a.partition) in md.assignments:
                continue  # idempotent re-apply
            pa = PartitionAssignment(
                int(a.partition), int(a.group), list(a.replicas)
            )
            md.assignments[pa.partition] = pa
            self.next_group_id = max(self.next_group_id, pa.group + 1)
            self._pending_deltas.append(
                Delta(
                    "add",
                    NTP(cmd.ns, cmd.topic, pa.partition),
                    pa.group,
                    list(pa.replicas),
                )
            )
        md.partition_count = max(md.partition_count, int(cmd.new_total))

    def _apply_create(self, cmd: CreateTopicCmd, revision: int) -> None:
        tp_ns = TopicNamespace(cmd.ns, cmd.topic)
        if tp_ns in self._topics:
            return  # idempotent re-apply (snapshot + replay)
        assignments = {
            a.partition: PartitionAssignment(
                int(a.partition), int(a.group), list(a.replicas)
            )
            for a in cmd.assignments
        }
        self._topics[tp_ns] = TopicMetadata(
            tp_ns=tp_ns,
            partition_count=int(cmd.partition_count),
            replication_factor=int(cmd.replication_factor),
            revision=revision,
            assignments=assignments,
            config=dict(cmd.config),
        )
        for a in assignments.values():
            self.next_group_id = max(self.next_group_id, a.group + 1)
            self._pending_deltas.append(
                Delta(
                    "add",
                    NTP(cmd.ns, cmd.topic, a.partition),
                    a.group,
                    list(a.replicas),
                )
            )

    def _apply_delete(self, cmd: DeleteTopicCmd) -> None:
        tp_ns = TopicNamespace(cmd.ns, cmd.topic)
        md = self._topics.pop(tp_ns, None)
        if md is None:
            return
        # a topic deleted mid-move must not pin the in-progress set
        self.updates_in_progress = {
            ntp: prev
            for ntp, prev in self.updates_in_progress.items()
            if ntp.tp_ns != tp_ns
        }
        for a in md.assignments.values():
            self._pending_deltas.append(
                Delta(
                    "del",
                    NTP(cmd.ns, cmd.topic, a.partition),
                    a.group,
                    list(a.replicas),
                )
            )

    # -- delta stream (controller_backend) ---------------------------
    def drain_deltas(self) -> list[Delta]:
        out = self._pending_deltas
        self._pending_deltas = []
        return out

    def _notify(self) -> None:
        waiters, self._waiters = self._waiters, []
        for ev in waiters:
            ev.set()

    async def wait_revision(self, revision: int, timeout: float = 10.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while self.revision < revision:
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                raise TimeoutError(f"topic_table not at revision {revision}")
            ev = asyncio.Event()
            self._waiters.append(ev)
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                continue

    async def wait_change(self, timeout: float = 5.0) -> None:
        """Block until any table mutation (backend reconciliation tick)."""
        ev = asyncio.Event()
        self._waiters.append(ev)
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            self._waiters.remove(ev) if ev in self._waiters else None
