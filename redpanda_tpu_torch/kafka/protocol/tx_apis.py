"""Transaction API schemas (EOS surface).

Reference: src/v/kafka/protocol/schemata/{add_partitions_to_txn,
add_offsets_to_txn,end_txn,txn_offset_commit}_*.json and handlers
(kafka/server/handlers/handlers.h:62-101, add_partitions_to_txn.cc,
end_txn.cc, txn_offset_commit.cc).
"""

from __future__ import annotations

from .apis import register
from .schema import Api, Array, F

ADD_PARTITIONS_TO_TXN = register(
    Api(
        key=24,
        name="add_partitions_to_txn",
        versions=(0, 1),
        flex_since=None,  # flex at v3
        request=[
            F("transactional_id", "string"),
            F("producer_id", "int64"),
            F("producer_epoch", "int16"),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F("partitions", Array("int32")),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "results",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "results",
                            Array(
                                [
                                    F("partition_index", "int32"),
                                    F("error_code", "int16"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

ADD_OFFSETS_TO_TXN = register(
    Api(
        key=25,
        name="add_offsets_to_txn",
        versions=(0, 1),
        flex_since=None,  # flex at v3
        request=[
            F("transactional_id", "string"),
            F("producer_id", "int64"),
            F("producer_epoch", "int16"),
            F("group_id", "string"),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16"),
        ],
    )
)

END_TXN = register(
    Api(
        key=26,
        name="end_txn",
        versions=(0, 1),
        flex_since=None,  # flex at v3
        request=[
            F("transactional_id", "string"),
            F("producer_id", "int64"),
            F("producer_epoch", "int16"),
            F("committed", "bool"),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16"),
        ],
    )
)

TXN_OFFSET_COMMIT = register(
    Api(
        key=28,
        name="txn_offset_commit",
        versions=(0, 2),
        flex_since=None,  # flex at v3
        request=[
            F("transactional_id", "string"),
            F("group_id", "string"),
            F("producer_id", "int64"),
            F("producer_epoch", "int16"),
            F("generation_id", "int32", versions=(3, None), default=-1),
            F("member_id", "string", versions=(3, None), default=""),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("partition_index", "int32"),
                                    F("committed_offset", "int64"),
                                    F(
                                        "committed_leader_epoch",
                                        "int32",
                                        versions=(2, None),
                                        default=-1,
                                    ),
                                    F(
                                        "committed_metadata",
                                        "string",
                                        nullable=(0, None),
                                        default=None,
                                    ),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "topics",
                Array(
                    [
                        F("name", "string"),
                        F(
                            "partitions",
                            Array(
                                [
                                    F("partition_index", "int32"),
                                    F("error_code", "int16"),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)


DESCRIBE_TRANSACTIONS = register(
    Api(
        key=65,
        name="describe_transactions",
        versions=(0, 0),
        flex_since=0,
        request=[
            F("transactional_ids", Array("string")),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F(
                "transaction_states",
                Array(
                    [
                        F("error_code", "int16"),
                        F("transactional_id", "string"),
                        F("transaction_state", "string"),
                        F("transaction_timeout_ms", "int32"),
                        F("transaction_start_time_ms", "int64"),
                        F("producer_id", "int64"),
                        F("producer_epoch", "int16"),
                        F(
                            "topics",
                            Array(
                                [
                                    F("topic", "string"),
                                    F("partitions", Array("int32")),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
        ],
    )
)

LIST_TRANSACTIONS = register(
    Api(
        key=66,
        name="list_transactions",
        versions=(0, 0),
        flex_since=0,
        request=[
            F("state_filters", Array("string")),
            F("producer_id_filters", Array("int64")),
        ],
        response=[
            F("throttle_time_ms", "int32"),
            F("error_code", "int16"),
            F("unknown_state_filters", Array("string")),
            F(
                "transaction_states",
                Array(
                    [
                        F("transactional_id", "string"),
                        F("producer_id", "int64"),
                        F("transaction_state", "string"),
                    ]
                ),
            ),
        ],
    )
)
