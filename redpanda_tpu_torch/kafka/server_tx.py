"""Transaction API handlers, installed into KafkaServer.

Reference: src/v/kafka/server/handlers/{add_partitions_to_txn,
add_offsets_to_txn,end_txn,txn_offset_commit}.cc — all four are
served by the leader of the transactional id's coordinator partition
(clients resolve it with FindCoordinator key_type=1); TxnOffsetCommit
alone goes to the GROUP coordinator, which stages the offsets until
the tx coordinator delivers the commit marker.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..models.fundamental import kafka_ntp
from ..security.acl import AclOperation, AclResourceType
from .protocol import ErrorCode, Msg
from .protocol.tx_apis import (
    ADD_OFFSETS_TO_TXN,
    ADD_PARTITIONS_TO_TXN,
    DESCRIBE_TRANSACTIONS,
    END_TXN,
    LIST_TRANSACTIONS,
    TXN_OFFSET_COMMIT,
)

if TYPE_CHECKING:  # pragma: no cover
    from .server import KafkaServer


def install(server: "KafkaServer") -> None:
    h = TxHandlers(server)
    server._handlers.update(
        {
            ADD_PARTITIONS_TO_TXN.key: h.add_partitions_to_txn,
            ADD_OFFSETS_TO_TXN.key: h.add_offsets_to_txn,
            END_TXN.key: h.end_txn,
            TXN_OFFSET_COMMIT.key: h.txn_offset_commit,
            DESCRIBE_TRANSACTIONS.key: h.describe_transactions,
            LIST_TRANSACTIONS.key: h.list_transactions,
        }
    )


class TxHandlers:
    def __init__(self, server: "KafkaServer"):
        self.server = server

    @property
    def tx(self):
        return self.server.broker.tx_coordinator

    async def add_partitions_to_txn(self, hdr, req) -> Msg:
        ntps = []
        known = self.server.broker.controller.topic_table
        unknown: set[tuple[str, int]] = set()
        for t in req.topics:
            for p in t.partitions:
                ntp = kafka_ntp(t.name, p)
                if known.group_of(ntp) is None:
                    unknown.add((t.name, p))
                else:
                    ntps.append(ntp)
        code = 0
        if ntps:
            code = await self.tx.add_partitions(
                req.transactional_id,
                req.producer_id,
                req.producer_epoch,
                ntps,
            )
        return Msg(
            throttle_time_ms=0,
            results=[
                Msg(
                    name=t.name,
                    results=[
                        Msg(
                            partition_index=p,
                            error_code=(
                                int(ErrorCode.unknown_topic_or_partition)
                                if (t.name, p) in unknown
                                else code
                            ),
                        )
                        for p in t.partitions
                    ],
                )
                for t in req.topics
            ],
        )

    async def add_offsets_to_txn(self, hdr, req) -> Msg:
        code = await self.tx.add_offsets(
            req.transactional_id,
            req.producer_id,
            req.producer_epoch,
            req.group_id,
        )
        return Msg(throttle_time_ms=0, error_code=code)

    async def end_txn(self, hdr, req) -> Msg:
        code = await self.tx.end_txn(
            req.transactional_id,
            req.producer_id,
            req.producer_epoch,
            bool(req.committed),
        )
        return Msg(throttle_time_ms=0, error_code=code)

    async def txn_offset_commit(self, hdr, req) -> Msg:
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

        coordinator = self.server.broker.group_coordinator
        g, code = await coordinator.get_group(req.group_id, create=True)
        if code:
            return all_errors(code)
        items = [
            (t.name, p.partition_index, p.committed_offset, p.committed_metadata)
            for t in req.topics
            for p in t.partitions
        ]
        code = await coordinator.txn_commit_offsets(
            g, req.producer_id, req.producer_epoch, items
        )
        return all_errors(code)

    # -- introspection ------------------------------------------------
    @staticmethod
    def _state_name(status: int) -> str:
        from ..cluster.tx_coordinator import (
            TX_EMPTY,
            TX_ONGOING,
            TX_PREPARING_ABORT,
            TX_PREPARING_COMMIT,
        )

        return {
            TX_EMPTY: "Empty",
            TX_ONGOING: "Ongoing",
            TX_PREPARING_COMMIT: "PrepareCommit",
            TX_PREPARING_ABORT: "PrepareAbort",
        }.get(status, "Unknown")

    async def describe_transactions(self, hdr, req) -> Msg:
        """DescribeTransactions (handlers/describe_transactions.cc):
        answered by each id's coordinator from the replayed tm shard."""
        states = []
        for tx_id in req.transactional_ids:
            if not self.server.authorize(
                AclOperation.describe, AclResourceType.transactional_id, tx_id
            ):
                states.append(
                    Msg(
                        error_code=int(
                            ErrorCode.transactional_id_authorization_failed
                        ),
                        transactional_id=tx_id,
                        transaction_state="",
                        transaction_timeout_ms=0,
                        transaction_start_time_ms=-1,
                        producer_id=-1,
                        producer_epoch=-1,
                        topics=[],
                    )
                )
                continue
            meta, code = await self.tx.describe_tx(tx_id)
            if meta is None:
                states.append(
                    Msg(
                        error_code=code,
                        transactional_id=tx_id,
                        transaction_state="",
                        transaction_timeout_ms=0,
                        transaction_start_time_ms=-1,
                        producer_id=-1,
                        producer_epoch=-1,
                        topics=[],
                    )
                )
                continue
            by_topic: dict[str, list[int]] = {}
            for ntp in sorted(meta.partitions, key=str):
                by_topic.setdefault(ntp.topic, []).append(ntp.partition)
            states.append(
                Msg(
                    error_code=0,
                    transactional_id=tx_id,
                    transaction_state=self._state_name(meta.status),
                    transaction_timeout_ms=meta.timeout_ms,
                    transaction_start_time_ms=meta.update_ms,
                    producer_id=meta.pid,
                    producer_epoch=meta.epoch,
                    topics=[
                        Msg(topic=t, partitions=ps)
                        for t, ps in by_topic.items()
                    ],
                )
            )
        return Msg(throttle_time_ms=0, transaction_states=states)

    async def list_transactions(self, hdr, req) -> Msg:
        """ListTransactions: every tx coordinated by partitions this
        broker leads, optionally filtered by state / producer id."""
        valid_states = {"Empty", "Ongoing", "PrepareCommit", "PrepareAbort"}
        state_filters = set(req.state_filters or [])
        unknown = sorted(state_filters - valid_states)
        pid_filters = set(req.producer_id_filters or [])
        metas, complete = await self.tx.list_local_txs()
        if not complete:
            return Msg(
                throttle_time_ms=0,
                error_code=int(ErrorCode.coordinator_load_in_progress),
                unknown_state_filters=unknown,
                transaction_states=[],
            )
        rows = []
        for meta in metas:
            if not self.server.authorize(
                AclOperation.describe,
                AclResourceType.transactional_id,
                meta.tx_id,
            ):
                continue
            state = self._state_name(meta.status)
            if state_filters and state not in state_filters:
                continue
            if pid_filters and meta.pid not in pid_filters:
                continue
            rows.append(
                Msg(
                    transactional_id=meta.tx_id,
                    producer_id=meta.pid,
                    transaction_state=state,
                )
            )
        rows.sort(key=lambda m: m.transactional_id)
        return Msg(
            throttle_time_ms=0,
            error_code=0,
            unknown_state_filters=unknown,
            transaction_states=rows,
        )
