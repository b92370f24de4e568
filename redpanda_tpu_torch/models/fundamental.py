"""Core domain identifiers (reference: src/v/model/fundamental.h).

Named integral types for offsets/terms/ids and the ntp
(namespace/topic/partition) triple that addresses every log in the
system. Kept deliberately tiny: these values also live as int64 lanes
in the device-resident consensus tensors (models.consensus_state), so
the Python objects are just typed views for the host control plane.
"""

from __future__ import annotations

import dataclasses

from ..utils.named_type import named_int

Offset = named_int("Offset")
Term = named_int("Term")
NodeId = named_int("NodeId")
GroupId = named_int("GroupId")  # raft group id
PartitionId = named_int("PartitionId")
RevisionId = named_int("RevisionId")
ProducerId = named_int("ProducerId")

# Sentinel: "no offset yet". The framework uses -1 uniformly (one less
# than the first real offset 0) across Python objects, device tensors
# and the scalar backend; I64_MIN appears only as the masked-slot fill
# inside quorum order-statistic kernels.
NO_OFFSET = Offset(-1)
NO_TERM = Term(-1)
NO_NODE = NodeId(-1)

DEFAULT_NS = "kafka"
REDPANDA_NS = "redpanda"
KAFKA_INTERNAL_NS = "kafka_internal"
CONTROLLER_NS = REDPANDA_NS
CONTROLLER_TOPIC = "controller"
CONTROLLER_GROUP = GroupId(0)


@dataclasses.dataclass(frozen=True, slots=True)
class TopicNamespace:
    ns: str
    topic: str

    def __str__(self) -> str:
        return f"{self.ns}/{self.topic}"


@dataclasses.dataclass(frozen=True, slots=True)
class NTP:
    """namespace/topic/partition — the address of one replicated log."""

    ns: str
    topic: str
    partition: int

    def __str__(self) -> str:
        return f"{{{self.ns}/{self.topic}/{self.partition}}}"

    @property
    def tp_ns(self) -> TopicNamespace:
        return TopicNamespace(self.ns, self.topic)


CONTROLLER_NTP = NTP(CONTROLLER_NS, CONTROLLER_TOPIC, 0)


def kafka_ntp(topic: str, partition: int) -> NTP:
    return NTP(DEFAULT_NS, topic, partition)
