"""Consumer group rebalance state machine.

Reference: src/v/kafka/server/group.{h,cc} (996+3,640 LoC) — one
`Group` per group id living on its coordinator partition: the classic
Kafka protocol state machine Empty → PreparingRebalance →
CompletingRebalance → Stable, with member sessions, generation
numbers, protocol selection and leader-driven assignment distribution.

Pure control logic: persistence and partition leadership live in
group_manager.py (the reference splits identically: group.cc vs
group_manager.cc).
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import time
import uuid
from typing import Optional

from ..protocol import ErrorCode


class GroupState(enum.Enum):
    EMPTY = "Empty"
    PREPARING_REBALANCE = "PreparingRebalance"
    COMPLETING_REBALANCE = "CompletingRebalance"
    STABLE = "Stable"
    DEAD = "Dead"


@dataclasses.dataclass
class Member:
    member_id: str
    client_id: str
    client_host: str
    session_timeout_ms: int
    rebalance_timeout_ms: int
    protocols: list[tuple[str, bytes]]  # (name, metadata)
    assignment: bytes = b""
    last_heartbeat: float = dataclasses.field(default_factory=time.monotonic)
    # set when this member has (re)joined the current rebalance
    joined: bool = False
    # KIP-345 static membership: a restarting client presenting the
    # same group.instance.id takes over this member without a rebalance
    group_instance_id: Optional[str] = None

    def metadata_for(self, protocol: str) -> bytes:
        for name, md in self.protocols:
            if name == protocol:
                return md
        return b""


@dataclasses.dataclass
class JoinResult:
    error: int
    generation: int = -1
    protocol_name: str = ""
    leader: str = ""
    member_id: str = ""
    members: list[tuple[str, bytes]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SyncResult:
    error: int
    assignment: bytes = b""


class Group:
    def __init__(
        self,
        group_id: str,
        initial_rebalance_delay_s: float = 0.05,
    ):
        self.group_id = group_id
        self.state = GroupState.EMPTY
        self.generation = 0
        self.protocol_type: str = ""
        self.protocol: str = ""  # selected protocol name
        self.leader: Optional[str] = None
        self.members: dict[str, Member] = {}
        self.offsets: dict[tuple[str, int], tuple[int, str | None, int]] = {}
        # staged transactional offsets: producer_id -> (producer_epoch,
        # {(topic, part): (offset, metadata, ts)}) — materialized into
        # `offsets` by the tx coordinator's commit marker iff the
        # marker carries the same epoch, dropped on abort or when a
        # newer-epoch marker fences the stale staging
        # (reference: group.h pending_offset_commits per pid)
        self.pending_tx: dict[
            int, tuple[int, dict[tuple[str, int], tuple[int, str | None, int]]]
        ] = {}
        # producer_id -> highest epoch whose tx already completed here:
        # a zombie's TxnOffsetCommit below this is rejected
        self.tx_fences: dict[int, int] = {}
        self._initial_delay = initial_rebalance_delay_s
        # wall-clock when the group last became EMPTY (KIP-211 offset
        # retention starts here, not at commit time); None while live.
        # Maintained at the membership transitions, persisted in the
        # group metadata record so restarts don't reset the clock.
        self.empty_since: Optional[float] = None
        # serializes offset mutation+replication: a commit landing
        # inside a tombstone's replicate window must not be deleted
        self.offsets_lock = asyncio.Lock()
        self._join_done = asyncio.Event()  # fires when a rebalance completes
        self._sync_done = asyncio.Event()  # fires when leader assigns
        self._rebalance_task: Optional[asyncio.Task] = None
        # bumped on every persisted transition so the manager knows to
        # checkpoint metadata
        self.dirty = False

    # -- queries -----------------------------------------------------
    def is_empty(self) -> bool:
        return not self.members

    def member(self, member_id: str) -> Optional[Member]:
        return self.members.get(member_id)

    def static_member_id(self, instance_id: str) -> Optional[str]:
        for mid, m in self.members.items():
            if m.group_instance_id == instance_id:
                return mid
        return None

    def check_static(
        self, group_instance_id: Optional[str], member_id: str
    ) -> int:
        """KIP-345 fence: an operation naming a registered
        group.instance.id must come from the member currently holding
        it — a zombie using its pre-takeover member id gets
        FENCED_INSTANCE_ID, not UNKNOWN_MEMBER (so it stops retrying)."""
        if group_instance_id is None:
            return 0
        owner = self.static_member_id(group_instance_id)
        if owner is not None and owner != member_id:
            return int(ErrorCode.fenced_instance_id)
        return 0

    # -- join --------------------------------------------------------
    async def join(
        self,
        member_id: str,
        client_id: str,
        client_host: str,
        session_timeout_ms: int,
        rebalance_timeout_ms: int,
        protocol_type: str,
        protocols: list[tuple[str, bytes]],
        group_instance_id: Optional[str] = None,
    ) -> JoinResult:
        if self.state == GroupState.DEAD:
            return JoinResult(error=int(ErrorCode.unknown_member_id))
        if self.members and self.protocol_type != protocol_type:
            return JoinResult(error=int(ErrorCode.inconsistent_group_protocol))
        if self.members:
            # candidate protocols must intersect the group's
            common = self._common_protocols(extra=[p for p, _ in protocols])
            if not common:
                return JoinResult(
                    error=int(ErrorCode.inconsistent_group_protocol)
                )

        if group_instance_id is not None:
            registered = self.static_member_id(group_instance_id)
            if registered is not None:
                if member_id == "":
                    # static TAKEOVER (KIP-345): the restarting client
                    # inherits the registered member — new member id,
                    # same assignment/slot, and when the group is
                    # Stable with unchanged protocols, NO rebalance
                    return await self._static_takeover(
                        registered,
                        client_id,
                        client_host,
                        session_timeout_ms,
                        rebalance_timeout_ms,
                        protocols,
                    )
                if member_id != registered:
                    return JoinResult(error=int(ErrorCode.fenced_instance_id))

        if member_id == "":
            member_id = f"{client_id or 'member'}-{uuid.uuid4()}"
        elif member_id not in self.members:
            return JoinResult(error=int(ErrorCode.unknown_member_id))

        m = self.members.get(member_id)
        if (
            m is not None
            and self.state
            in (GroupState.STABLE, GroupState.COMPLETING_REBALANCE)
            and m.protocols == list(protocols)
            and member_id != self.leader
        ):
            # known follower rejoining with unchanged protocols: return
            # the current generation without forcing a group-wide
            # rebalance (Kafka semantics; only the leader, new members,
            # or changed metadata trigger one)
            m.last_heartbeat = time.monotonic()
            m.session_timeout_ms = session_timeout_ms
            m.rebalance_timeout_ms = rebalance_timeout_ms
            return self._join_result_for(member_id)
        if m is None:
            m = Member(
                member_id=member_id,
                client_id=client_id,
                client_host=client_host,
                session_timeout_ms=session_timeout_ms,
                rebalance_timeout_ms=rebalance_timeout_ms,
                protocols=list(protocols),
                group_instance_id=group_instance_id,
            )
            self.members[member_id] = m
            self.protocol_type = protocol_type
            self.empty_since = None
        else:
            m.protocols = list(protocols)
            m.session_timeout_ms = session_timeout_ms
            m.rebalance_timeout_ms = rebalance_timeout_ms
            if group_instance_id is not None:
                # (re)register the static mapping on ANY join carrying
                # an instance id — e.g. metadata replayed from a
                # pre-static-membership record lacks it, and the live
                # client's next rejoin must restore the registration
                m.group_instance_id = group_instance_id
                self.dirty = True
        m.last_heartbeat = time.monotonic()
        return await self._await_rebalance(member_id, rebalance_timeout_ms, m)

    async def _static_takeover(
        self,
        old_member_id: str,
        client_id: str,
        client_host: str,
        session_timeout_ms: int,
        rebalance_timeout_ms: int,
        protocols: list[tuple[str, bytes]],
    ) -> JoinResult:
        """Replace a static member's identity in place (reference /
        Kafka GroupMetadata.replaceStaticMember): the old member id is
        fenced, the new one inherits the slot + assignment, and a
        Stable group with unchanged protocols skips the rebalance."""
        old = self.members.pop(old_member_id)
        new_id = f"{client_id or 'member'}-{uuid.uuid4()}"
        m = Member(
            member_id=new_id,
            client_id=client_id,
            client_host=client_host,
            session_timeout_ms=session_timeout_ms,
            rebalance_timeout_ms=rebalance_timeout_ms,
            protocols=list(protocols),
            assignment=old.assignment,
            joined=old.joined,
            group_instance_id=old.group_instance_id,
        )
        self.members[new_id] = m
        if self.leader == old_member_id:
            self.leader = new_id
        self.dirty = True
        if (
            self.state == GroupState.STABLE
            and old.protocols == list(protocols)
        ):
            # same subscription: answer from the current generation;
            # the member fetches its inherited assignment via SyncGroup
            return self._join_result_for(new_id)
        # changed subscription (or mid-rebalance): fall into the
        # normal rebalance round under the NEW id
        return await self._await_rebalance(new_id, rebalance_timeout_ms, m)

    async def _await_rebalance(
        self, member_id: str, rebalance_timeout_ms: int, m: Member
    ) -> JoinResult:
        """Kick (or join) the preparing rebalance and wait for the
        timer to complete the round. The timer — not the joiner —
        finishes the rebalance so a burst of concurrent joins
        coalesces into one generation
        (group.initial.rebalance.delay semantics)."""
        self._start_rebalance()  # no-op if one is already preparing
        m.joined = True  # after the reset inside _start_rebalance
        join_done = self._join_done
        timeout = max(rebalance_timeout_ms, 5000) / 1000.0 + 5.0
        try:
            await asyncio.wait_for(join_done.wait(), timeout)
        except asyncio.TimeoutError:
            return JoinResult(error=int(ErrorCode.rebalance_in_progress))
        if member_id not in self.members:  # expired while waiting
            return JoinResult(error=int(ErrorCode.unknown_member_id))
        return self._join_result_for(member_id)

    def _join_result_for(self, member_id: str) -> JoinResult:
        is_leader = member_id == self.leader
        return JoinResult(
            error=0,
            generation=self.generation,
            protocol_name=self.protocol,
            leader=self.leader or "",
            member_id=member_id,
            members=(
                [
                    (mid, m.metadata_for(self.protocol))
                    for mid, m in self.members.items()
                ]
                if is_leader
                else []
            ),
        )

    def _start_rebalance(self) -> None:
        if self.state in (
            GroupState.PREPARING_REBALANCE,
        ):
            return
        self.state = GroupState.PREPARING_REBALANCE
        self._join_done = asyncio.Event()
        self._sync_done = asyncio.Event()
        for m in self.members.values():
            m.joined = False
        # the member triggering the rebalance counts as joined; others
        # must rejoin within the rebalance timeout or be evicted
        if self._rebalance_task is None or self._rebalance_task.done():
            self._rebalance_task = asyncio.ensure_future(
                self._rebalance_timer()
            )

    async def _rebalance_timer(self) -> None:
        # initial delay lets a burst of joiners coalesce into one
        # generation (group.initial.rebalance.delay analog)
        await asyncio.sleep(self._initial_delay)
        deadline = time.monotonic() + (
            max(
                (m.rebalance_timeout_ms for m in self.members.values()),
                default=5000,
            )
            / 1000.0
        )
        while time.monotonic() < deadline:
            if self.state != GroupState.PREPARING_REBALANCE:
                return
            if self.members and all(
                m.joined for m in self.members.values()
            ):
                break
            await asyncio.sleep(0.02)
        # evict stragglers that never rejoined
        for mid in [
            mid for mid, m in self.members.items() if not m.joined
        ]:
            del self.members[mid]
        if self.state == GroupState.PREPARING_REBALANCE:
            self._complete_rebalance()

    def _complete_rebalance(self) -> None:
        if self.state != GroupState.PREPARING_REBALANCE:
            return
        if not self.members:
            self.state = GroupState.EMPTY
            self.generation += 1
            self.leader = None
            self.protocol = ""
            self.dirty = True
            self._join_done.set()
            return
        self.generation += 1
        common = self._common_protocols()
        self.protocol = common[0] if common else ""
        if self.leader not in self.members:
            self.leader = next(iter(self.members))
        self.state = GroupState.COMPLETING_REBALANCE
        self.dirty = True
        self._join_done.set()

    def _common_protocols(self, extra: Optional[list[str]] = None) -> list[str]:
        """Protocol names supported by every member, in first-member
        preference order (the reference's vote)."""
        sets = [
            [name for name, _ in m.protocols] for m in self.members.values()
        ]
        if extra is not None:
            sets.append(extra)
        if not sets:
            return []
        first = sets[0]
        return [p for p in first if all(p in s for s in sets[1:])]

    # -- sync --------------------------------------------------------
    async def sync(
        self,
        member_id: str,
        generation: int,
        assignments: list[tuple[str, bytes]],
    ) -> SyncResult:
        m = self.members.get(member_id)
        if m is None:
            return SyncResult(error=int(ErrorCode.unknown_member_id))
        if generation != self.generation:
            return SyncResult(error=int(ErrorCode.illegal_generation))
        if self.state == GroupState.PREPARING_REBALANCE:
            return SyncResult(error=int(ErrorCode.rebalance_in_progress))
        if self.state == GroupState.STABLE:
            return SyncResult(error=0, assignment=m.assignment)
        if self.state != GroupState.COMPLETING_REBALANCE:
            return SyncResult(error=int(ErrorCode.unknown_member_id))

        if member_id == self.leader:
            by_member = dict(assignments)
            for mid, mm in self.members.items():
                mm.assignment = by_member.get(mid, b"")
            self.state = GroupState.STABLE
            self.dirty = True
            self._sync_done.set()
            return SyncResult(error=0, assignment=m.assignment)

        sync_done = self._sync_done
        try:
            await asyncio.wait_for(sync_done.wait(), 30.0)
        except asyncio.TimeoutError:
            return SyncResult(error=int(ErrorCode.rebalance_in_progress))
        if self.state != GroupState.STABLE or generation != self.generation:
            return SyncResult(error=int(ErrorCode.rebalance_in_progress))
        return SyncResult(error=0, assignment=m.assignment)

    # -- heartbeat / leave -------------------------------------------
    def heartbeat(self, member_id: str, generation: int) -> int:
        m = self.members.get(member_id)
        if m is None:
            return int(ErrorCode.unknown_member_id)
        if generation != self.generation:
            return int(ErrorCode.illegal_generation)
        m.last_heartbeat = time.monotonic()
        if self.state in (
            GroupState.PREPARING_REBALANCE,
            GroupState.COMPLETING_REBALANCE,
        ):
            # Kafka signals REBALANCE_IN_PROGRESS until the group is
            # Stable so members re-enter the join/sync cycle
            return int(ErrorCode.rebalance_in_progress)
        if self.state != GroupState.STABLE:
            return int(ErrorCode.unknown_member_id)
        return 0

    def leave(self, member_id: str) -> int:
        if member_id not in self.members:
            return int(ErrorCode.unknown_member_id)
        del self.members[member_id]
        if not self.members:
            self.empty_since = time.time()
            self.dirty = True
        if self.state in (
            GroupState.STABLE,
            GroupState.COMPLETING_REBALANCE,
        ):
            self._start_rebalance()
            for m in self.members.values():
                m.joined = False
        elif self.state == GroupState.PREPARING_REBALANCE and not self.members:
            self._complete_rebalance()
        if not self.members and self.state != GroupState.PREPARING_REBALANCE:
            self.state = GroupState.EMPTY
            self.dirty = True
        return 0

    # -- expiration --------------------------------------------------
    def expire_members(self) -> list[str]:
        """Evict members whose session timed out; returns evicted ids."""
        now = time.monotonic()
        expired = [
            mid
            for mid, m in self.members.items()
            if now - m.last_heartbeat > m.session_timeout_ms / 1000.0
        ]
        for mid in expired:
            self.leave(mid)
        return expired

    async def close(self) -> None:
        if self._rebalance_task is not None and not self._rebalance_task.done():
            self._rebalance_task.cancel()
            try:
                await self._rebalance_task
            except asyncio.CancelledError:
                pass
