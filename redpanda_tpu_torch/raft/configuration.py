"""Group configuration: voters/learners + joint consensus
(reference: src/v/raft/group_configuration.{h,cc}).

A configuration is a set of voter node ids and learner node ids. During
reconfiguration both old and new voter sets are active ("joint"): a
value is committed only when it clears the quorum of BOTH sets
(group_configuration.h:487-490). The scalar quorum math itself lives in
raft.quorum_scalar / ops.quorum.
"""

from __future__ import annotations

from ..utils import serde


class GroupConfiguration(serde.Envelope):
    SERDE_FIELDS = [
        ("voters", serde.vector(serde.i32)),
        ("learners", serde.vector(serde.i32)),
        ("old_voters", serde.vector(serde.i32)),  # empty unless joint
        ("revision", serde.i64),
    ]

    @classmethod
    def simple(cls, voters: list[int], revision: int = 0) -> "GroupConfiguration":
        return cls(
            voters=sorted(voters), learners=[], old_voters=[], revision=revision
        )

    def all_nodes(self) -> list[int]:
        seen: dict[int, None] = {}
        for n in list(self.voters) + list(self.old_voters) + list(self.learners):
            seen.setdefault(n, None)
        return list(seen)

    def is_voter(self, node_id: int) -> bool:
        return node_id in self.voters

    def is_joint(self) -> bool:
        return bool(self.old_voters)

    def majority_size(self) -> int:
        return len(self.voters) // 2 + 1

    def enter_joint(self, new_voters: list[int], revision: int) -> "GroupConfiguration":
        return GroupConfiguration(
            voters=sorted(new_voters),
            learners=list(self.learners),
            old_voters=list(self.voters),
            revision=revision,
        )

    def leave_joint(self, revision: int) -> "GroupConfiguration":
        return GroupConfiguration(
            voters=list(self.voters),
            learners=list(self.learners),
            old_voters=[],
            revision=revision,
        )
