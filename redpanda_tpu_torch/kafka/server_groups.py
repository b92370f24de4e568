"""Group/admin API handlers, installed into KafkaServer.

Reference: src/v/kafka/server/handlers/{find_coordinator,join_group,
heartbeat,leave_group,sync_group,describe_groups,list_groups,
offset_commit,offset_fetch,delete_groups,delete_topics}.cc and the
group_router (group_router.h:48) — requests for a group are served by
the leader of its coordinator partition; everything else answers
NOT_COORDINATOR so clients re-resolve.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..models.fundamental import DEFAULT_NS
from .protocol import ErrorCode, Msg
from .protocol.group_apis import (
    DELETE_GROUPS,
    DELETE_TOPICS,
    DESCRIBE_GROUPS,
    FIND_COORDINATOR,
    HEARTBEAT,
    INIT_PRODUCER_ID,
    JOIN_GROUP,
    LEAVE_GROUP,
    LIST_GROUPS,
    OFFSET_COMMIT,
    OFFSET_FETCH,
    SYNC_GROUP,
)

if TYPE_CHECKING:  # pragma: no cover
    from .server import KafkaServer


def install(server: "KafkaServer") -> None:
    h = GroupHandlers(server)
    server._handlers.update(
        {
            FIND_COORDINATOR.key: h.find_coordinator,
            JOIN_GROUP.key: h.join_group,
            SYNC_GROUP.key: h.sync_group,
            HEARTBEAT.key: h.heartbeat,
            LEAVE_GROUP.key: h.leave_group,
            OFFSET_COMMIT.key: h.offset_commit,
            OFFSET_FETCH.key: h.offset_fetch,
            DESCRIBE_GROUPS.key: h.describe_groups,
            LIST_GROUPS.key: h.list_groups,
            DELETE_GROUPS.key: h.delete_groups,
            DELETE_TOPICS.key: h.delete_topics,
            INIT_PRODUCER_ID.key: h.init_producer_id,
        }
    )


class GroupHandlers:
    def __init__(self, server: "KafkaServer"):
        self.server = server

    @property
    def coordinator(self):
        return self.server.broker.group_coordinator

    def _group_ok(self, group_id: str, operation=None) -> bool:
        from ..security.acl import AclOperation, AclResourceType

        return self.server.authorize(
            operation if operation is not None else AclOperation.read,
            AclResourceType.group,
            group_id,
        )

    async def find_coordinator(self, hdr, req) -> Msg:
        key_type = getattr(req, "key_type", 0) or 0
        if key_type == 1:  # transaction coordinator
            found = await self.server.broker.tx_coordinator.find_coordinator(
                req.key
            )
        elif key_type == 0:
            found = await self.coordinator.find_coordinator(req.key)
        else:
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.coordinator_not_available),
                error_message="unknown coordinator key type",
                node_id=-1,
                host="",
                port=-1,
            )
        if found is None:
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.coordinator_not_available),
                error_message=None,
                node_id=-1,
                host="",
                port=-1,
            )
        node, host, port = found
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            error_message=None,
            node_id=node,
            host=host,
            port=port,
        )

    async def join_group(self, hdr, req) -> Msg:
        def err(code: int) -> Msg:
            return Msg(
                throttle_time_ms=0,
                error_code=code,
                generation_id=-1,
                protocol_name="",
                leader="",
                member_id=req.member_id,
                members=[],
            )

        if not self._group_ok(req.group_id):
            return err(int(ErrorCode.group_authorization_failed))
        max_session = self.server.broker.controller.cluster_config.get(
            "group_session_timeout_max_ms"
        )
        if req.session_timeout_ms > max_session:
            return err(int(ErrorCode.invalid_session_timeout))
        g, code = await self.coordinator.get_group(req.group_id, create=True)
        if code:
            return err(code)
        res = await g.join(
            member_id=req.member_id,
            client_id=hdr.client_id or "",
            group_instance_id=getattr(req, "group_instance_id", None),
            client_host="",
            session_timeout_ms=req.session_timeout_ms,
            rebalance_timeout_ms=(
                req.rebalance_timeout_ms
                if req.rebalance_timeout_ms > 0
                else req.session_timeout_ms
            ),
            protocol_type=req.protocol_type,
            protocols=[(p.name, bytes(p.metadata)) for p in req.protocols],
        )
        if res.error:
            return err(res.error)
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            generation_id=res.generation,
            protocol_name=res.protocol_name,
            leader=res.leader,
            member_id=res.member_id,
            members=[
                Msg(
                    member_id=mid,
                    group_instance_id=(
                        g.members[mid].group_instance_id
                        if mid in g.members
                        else None
                    ),
                    metadata=md,
                )
                for mid, md in res.members
            ],
        )

    async def sync_group(self, hdr, req) -> Msg:
        if not self._group_ok(req.group_id):
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.group_authorization_failed),
                assignment=b"",
            )
        g, code = await self.coordinator.get_group(req.group_id)
        if code:
            return Msg(throttle_time_ms=0, error_code=code, assignment=b"")
        fence = g.check_static(
            getattr(req, "group_instance_id", None), req.member_id
        )
        if fence:
            return Msg(throttle_time_ms=0, error_code=fence, assignment=b"")
        res = await g.sync(
            member_id=req.member_id,
            generation=req.generation_id,
            assignments=[
                (a.member_id, bytes(a.assignment)) for a in req.assignments
            ],
        )
        if res.error == 0 and g.dirty:
            # persist the stable generation + assignments (the
            # reference writes the group metadata batch on sync)
            code = await self.coordinator.checkpoint_group(g)
            if code:
                return Msg(throttle_time_ms=0, error_code=code, assignment=b"")
        return Msg(
            throttle_time_ms=0, error_code=res.error, assignment=res.assignment
        )

    async def heartbeat(self, hdr, req) -> Msg:
        if not self._group_ok(req.group_id):
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.group_authorization_failed),
            )
        g, code = await self.coordinator.get_group(req.group_id)
        if code:
            return Msg(throttle_time_ms=0, error_code=code)
        fence = g.check_static(
            getattr(req, "group_instance_id", None), req.member_id
        )
        if fence:
            return Msg(throttle_time_ms=0, error_code=fence)
        return Msg(
            throttle_time_ms=0,
            error_code=g.heartbeat(req.member_id, req.generation_id),
        )

    async def leave_group(self, hdr, req) -> Msg:
        if not self._group_ok(req.group_id):
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.group_authorization_failed),
            )
        g, code = await self.coordinator.get_group(req.group_id)
        if code:
            return Msg(throttle_time_ms=0, error_code=code)
        if hdr.api_version >= 3:
            # batched removals, member id OR group.instance.id
            rows = []
            any_ok = False
            for entry in req.members:
                mid = entry.member_id or ""
                iid = entry.group_instance_id
                if iid is not None:
                    owner = g.static_member_id(iid)
                    if owner is None:
                        ec = int(ErrorCode.unknown_member_id)
                    elif mid and mid != owner:
                        ec = int(ErrorCode.fenced_instance_id)
                    else:
                        ec = g.leave(owner)
                else:
                    ec = g.leave(mid)
                any_ok = any_ok or ec == 0
                rows.append(
                    Msg(member_id=mid, group_instance_id=iid, error_code=ec)
                )
            if any_ok:
                await self.coordinator.checkpoint_group(g)
            return Msg(throttle_time_ms=0, error_code=0, members=rows)
        code = g.leave(req.member_id)
        if code == 0:
            await self.coordinator.checkpoint_group(g)
        return Msg(throttle_time_ms=0, error_code=code, members=[])

    async def offset_commit(self, hdr, req) -> Msg:
        def all_errors(code: int) -> Msg:
            return Msg(
                throttle_time_ms=0,
                topics=[
                    Msg(
                        name=t.name,
                        partitions=[
                            Msg(partition_index=p.partition_index, error_code=code)
                            for p in t.partitions
                        ],
                    )
                    for t in req.topics
                ],
            )

        if not self._group_ok(req.group_id):
            return all_errors(int(ErrorCode.group_authorization_failed))
        g, code = await self.coordinator.get_group(req.group_id, create=True)
        if code:
            return all_errors(code)
        # generation checks (group.cc offset_commit validation): a
        # simple consumer (generation -1, no member) may commit to an
        # empty group; a group member must match the live generation
        if req.generation_id >= 0 or req.member_id:
            if req.member_id not in g.members:
                return all_errors(int(ErrorCode.unknown_member_id))
            if req.generation_id != g.generation:
                return all_errors(int(ErrorCode.illegal_generation))
        elif g.members:
            return all_errors(int(ErrorCode.illegal_generation))
        items = [
            (t.name, p.partition_index, p.committed_offset, p.committed_metadata)
            for t in req.topics
            for p in t.partitions
        ]
        code = await self.coordinator.commit_offsets(g, items)
        return all_errors(code)

    async def offset_fetch(self, hdr, req) -> Msg:
        from ..security.acl import AclOperation

        if not self._group_ok(req.group_id, AclOperation.describe):
            return Msg(
                throttle_time_ms=0,
                topics=[],
                error_code=int(ErrorCode.group_authorization_failed),
            )
        g, code = await self.coordinator.get_group(req.group_id)
        if code in (
            int(ErrorCode.not_coordinator),
            int(ErrorCode.coordinator_load_in_progress),
        ):
            # retriable: the client must NOT interpret this as "no
            # committed offsets" and reset to its auto-offset policy
            return Msg(throttle_time_ms=0, topics=[], error_code=code)
        offsets = g.offsets if g is not None else {}
        if req.topics is None:
            by_topic: dict[str, list[int]] = {}
            for topic, part in sorted(offsets):
                by_topic.setdefault(topic, []).append(part)
            wanted = [(t, ps) for t, ps in by_topic.items()]
        else:
            wanted = [(t.name, list(t.partition_indexes)) for t in req.topics]
        topics = []
        for topic, parts in wanted:
            rows = []
            for part in parts:
                entry = offsets.get((topic, part))
                if entry is None:
                    rows.append(
                        Msg(
                            partition_index=part,
                            committed_offset=-1,
                            metadata=None,
                            error_code=0,
                        )
                    )
                else:
                    off, md, _ts = entry
                    rows.append(
                        Msg(
                            partition_index=part,
                            committed_offset=off,
                            metadata=md,
                            error_code=0,
                        )
                    )
            topics.append(Msg(name=topic, partitions=rows))
        return Msg(throttle_time_ms=0, topics=topics, error_code=0)

    async def describe_groups(self, hdr, req) -> Msg:
        from ..security.acl import AclOperation

        out = []
        for group_id in req.groups:
            if not self._group_ok(group_id, AclOperation.describe):
                out.append(
                    Msg(
                        error_code=int(ErrorCode.group_authorization_failed),
                        group_id=group_id,
                        group_state="",
                        protocol_type="",
                        protocol_data="",
                        members=[],
                    )
                )
                continue
            g, code = await self.coordinator.get_group(group_id)
            if code == int(ErrorCode.group_id_not_found):
                out.append(
                    Msg(
                        error_code=0,
                        group_id=group_id,
                        group_state="Dead",
                        protocol_type="",
                        protocol_data="",
                        members=[],
                    )
                )
                continue
            if code:
                out.append(
                    Msg(
                        error_code=code,
                        group_id=group_id,
                        group_state="",
                        protocol_type="",
                        protocol_data="",
                        members=[],
                    )
                )
                continue
            out.append(
                Msg(
                    error_code=0,
                    group_id=group_id,
                    group_state=g.state.value,
                    protocol_type=g.protocol_type,
                    protocol_data=g.protocol,
                    members=[
                        Msg(
                            member_id=m.member_id,
                            group_instance_id=m.group_instance_id,
                            client_id=m.client_id,
                            client_host=m.client_host,
                            member_metadata=m.metadata_for(g.protocol),
                            member_assignment=m.assignment,
                        )
                        for m in g.members.values()
                    ],
                )
            )
        return Msg(throttle_time_ms=0, groups=out)

    async def list_groups(self, hdr, req) -> Msg:
        groups = self.coordinator.local_groups()
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            groups=[
                Msg(group_id=g.group_id, protocol_type=g.protocol_type)
                for g in groups
            ],
        )

    async def delete_groups(self, hdr, req) -> Msg:
        from ..security.acl import AclOperation

        results = []
        for group_id in req.groups_names:
            if not self._group_ok(group_id, AclOperation.remove):
                results.append(
                    Msg(
                        group_id=group_id,
                        error_code=int(ErrorCode.group_authorization_failed),
                    )
                )
                continue
            code = await self.coordinator.delete_group(group_id)
            results.append(Msg(group_id=group_id, error_code=code))
        return Msg(throttle_time_ms=0, results=results)

    async def init_producer_id(self, hdr, req) -> Msg:
        """Producer id: idempotence-only ids come straight from the
        controller-log allocator (cluster/id_allocator_frontend.cc);
        transactional ids go through the tx coordinator, which fences
        the previous incarnation and bumps the epoch
        (tx_gateway_frontend.cc init_tm_tx)."""
        from ..cluster.controller import TopicError

        if req.transactional_id is not None:
            pid, epoch, code = (
                await self.server.broker.tx_coordinator.init_producer_id(
                    req.transactional_id,
                    getattr(req, "transaction_timeout_ms", 60000),
                )
            )
            return Msg(
                throttle_time_ms=0,
                error_code=code,
                producer_id=pid,
                producer_epoch=epoch,
            )
        try:
            pid = await self.server.broker.controller.allocate_producer_id()
        except (TopicError, TimeoutError):
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.coordinator_not_available),
                producer_id=-1,
                producer_epoch=-1,
            )
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            producer_id=pid,
            producer_epoch=0,
        )

    async def delete_topics(self, hdr, req) -> Msg:
        from ..cluster.controller import TopicError
        from .server import _topic_error_code

        from ..security.acl import AclOperation, AclResourceType

        out = []
        for name in req.topic_names:
            if not self.server.authorize(
                AclOperation.remove, AclResourceType.topic, name
            ):
                out.append(
                    Msg(
                        name=name,
                        error_code=int(ErrorCode.topic_authorization_failed),
                    )
                )
                continue
            code = 0
            try:
                await self.server.broker.controller.delete_topic(
                    name, ns=DEFAULT_NS, timeout=max(req.timeout_ms / 1000.0, 1.0)
                )
            except TopicError as e:
                code = _topic_error_code(e.code)
            except TimeoutError:
                code = int(ErrorCode.request_timed_out)
            out.append(Msg(name=name, error_code=code))
        return Msg(throttle_time_ms=0, responses=out)
