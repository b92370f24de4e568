"""Cluster feature table.

Reference: src/v/features/feature_table.{h,cc} + cluster/
feature_manager.{h,cc}. Each feature declares the logical cluster
version it needs; every node reports its build's version at
registration; the controller leader computes the ACTIVE cluster
version as the minimum across members and replicates activation
commands for features that version unlocks. Mixed-version clusters
therefore never serve a feature some member can't handle, and
activation is monotonic, durable, and identical on every node.
"""

from __future__ import annotations

import dataclasses

# this build's logical version (bump when adding a gated feature)
LATEST_LOGICAL_VERSION = 3


@dataclasses.dataclass(frozen=True, slots=True)
class FeatureSpec:
    name: str
    required_version: int


# the gated feature set — ONLY features with an enforcing is_active()
# check belong here (an unenforced entry would make /v1/features lie
# about what a mixed-version cluster protects):
#   delete_records — older builds mis-handle the replicated floor marker
#   fetch_sessions — session state assumes every node's session cache
#   migrations — older builds don't understand MigrationDoneCmd in the
#                controller log, so no migration may run (or replicate
#                its marker) until every member speaks it
FEATURES = [
    FeatureSpec("delete_records", 2),
    FeatureSpec("fetch_sessions", 2),
    FeatureSpec("migrations", 3),
]


class FeatureTable:
    def __init__(self):
        self._state: dict[str, str] = {}
        self.cluster_version = 0

    def apply(self, name: str, state: str, cluster_version: int) -> None:
        self._state[name] = state
        self.cluster_version = max(self.cluster_version, int(cluster_version))

    def is_active(self, name: str) -> bool:
        return self._state.get(name) == "active"

    def snapshot(self) -> dict:
        return {
            "cluster_version": self.cluster_version,
            "latest_version": LATEST_LOGICAL_VERSION,
            "features": [
                {
                    "name": f.name,
                    "required_version": f.required_version,
                    "state": self._state.get(f.name, "unavailable"),
                }
                for f in FEATURES
            ],
        }

    def pending_activations(self, member_versions: list[int]) -> list[FeatureSpec]:
        """Features the current membership unlocks but which are not
        active yet (feature_manager.cc maybe_update_active_version)."""
        if not member_versions:
            return []
        active_version = min(member_versions)
        return [
            f
            for f in FEATURES
            if f.required_version <= active_version and not self.is_active(f.name)
        ]
