"""The single placement authority: raft group → (process shard, device
lane slot) (reference: src/v/cluster/shard_table.h:26-46 +
shard_placement_table.h).

Before this layer existed, placement was decided twice and
independently — `ssx.shards.shard_of` hashed groups onto process
shards (replicated and internal groups pinned to shard 0), while the
vmap'd tick frame batched groups into device lanes with no record of
the pairing. The PlacementTable owns both coordinates now:

- the POLICY (`assign`): which shard a NEW group lands on. The v1
  shard-0 pin for replicated groups is retired — any default-namespace
  data partition spreads, whether its replica set is `[node_id]` or a
  full quorum (inbound raft RPC for worker-owned replicated groups
  forwards through the RaftService shard seam). `RP_PLACEMENT_PIN=1`
  restores the v1 behavior for A/B baselines.
- the MAP (`insert`/`erase`/`shard_for`/`shard_for_group`): live
  ntp/group → shard, mutated only by the controller backend and the
  PartitionMover. This subsumes the old `cluster.shard_table.
  ShardTable` interface, so every existing lookup site keeps working.
- the LANE (`bind_lane`/`lane_for`/`chip_lane_for`): the device lane
  slot the group's raft lanes occupy on its owning shard, reported at
  group creation and REBOUND by live moves (the target allocates a
  fresh row; the source frees its old one). Since the mesh backend the
  slot is a **(chip, lane)** pair — the device of the mesh whose block
  holds the row, plus the row itself (back-compat: chip defaults to 0,
  `lane_for` still answers with the bare row). `group_at` is the
  reverse map the TickFrame uses to resolve changed (chip, row)
  addresses back to groups after a lane rebind.

rplint RPL017 (placement-discipline) enforces that `compute_shard` —
the one modulo over the shard count — is computed nowhere else:
everyone asks this table.
"""

from __future__ import annotations

import os

from ..models.fundamental import DEFAULT_NS, NTP


def compute_shard(group_id: int, n_shards: int) -> int:
    """Deterministic raft-group → shard hash for NEW groups. Group 0
    (the controller) and negative fixture ids are pinned to shard 0,
    which runs the full broker; data groups spread round-robin. This
    is a DEFAULT, not an invariant: live moves rebind groups, so only
    the PlacementTable map is authoritative after creation."""
    if n_shards <= 1 or group_id <= 0:
        return 0
    return group_id % n_shards


def pin_replicated() -> bool:
    """A/B knob: RP_PLACEMENT_PIN=1 restores the v1 shard-0 pin for
    replicated (multi-replica) groups."""
    return os.environ.get("RP_PLACEMENT_PIN", "0") == "1"


class PlacementTable:
    """ntp/group → (shard, lane row). Drop-in superset of the old
    cluster.shard_table.ShardTable (the compat alias lives there)."""

    def __init__(self, shard_count: int = 1):
        # ssx.ShardedBroker overwrites this with the live shard count;
        # everything else treats it as read-only topology metadata
        self.shard_count = shard_count
        self._ntp: dict[NTP, int] = {}
        self._group: dict[int, int] = {}
        self._gid_of: dict[NTP, int] = {}
        # group → (chip, row, shard): the device lane slot, plus the
        # shard the binding was made under so the reverse map can be
        # unkeyed exactly on rebind even after a cross-shard move
        self._lane: dict[int, tuple[int, int, int]] = {}
        # (shard, chip, row) → group: the TickFrame's changed-row
        # resolution path (rows are per-shard, chips per-mesh — the
        # triple is the only collision-free key broker-wide)
        self._row_group: dict[tuple[int, int, int], int] = {}
        # bumped on every map mutation; the RaftService forwarding seam
        # caches per-sender "all groups local" verdicts against it
        self.epoch = 0
        self.moves_executed = 0
        # elastic lifecycle state: retired shards never receive NEW
        # assignments; unavailable shards (crashed, mid-restart) keep
        # their map entries but produce/fetch must answer retriable
        # errors instead of invoking into a dead channel
        self._retired: set[int] = set()
        self._unavailable: set[int] = set()

    # -- lifecycle ----------------------------------------------------
    def active_shards(self) -> list[int]:
        """Shards eligible for NEW placements (not retired). Shard 0
        is always active — it is the parent process."""
        return [s for s in range(self.shard_count) if s not in self._retired]

    def activate(self, shard: int) -> None:
        """A grown (or re-grown) shard joins the placement pool."""
        self.shard_count = max(self.shard_count, shard + 1)
        self._retired.discard(shard)
        self._unavailable.discard(shard)
        self.epoch += 1

    def deactivate(self, shard: int) -> None:
        """A retiring shard leaves the NEW-placement pool (its live
        groups evacuate through the PartitionMover before the process
        stops)."""
        if shard == 0:
            raise ValueError("shard 0 cannot retire")
        self._retired.add(shard)
        self.epoch += 1

    def set_unavailable(self, shard: int, down: bool = True) -> None:
        """Crash/restart window marker: the shard's groups stay mapped
        (the new child re-adopts them in place) but routing must fail
        fast with a retriable error while `down` holds."""
        if down:
            self._unavailable.add(shard)
        else:
            self._unavailable.discard(shard)
        self.epoch += 1

    def is_available(self, shard: int) -> bool:
        return shard not in self._unavailable and shard not in self._retired

    # -- policy -------------------------------------------------------
    def assign(self, ntp: NTP, group_id: int, replicas, node_id: int) -> int:
        """Shard for a NEW partition (Controller._shard_for_new's
        policy, unified here). Internal/coordinator topics (tx,
        consumer groups) and non-default namespaces keep the shard-0
        path, where the full coordinator machinery lives; everything
        else spreads across the ACTIVE (non-retired) shards — with no
        retirements the active list is [0..n) and the policy reduces
        to the classic compute_shard modulo."""
        if self.shard_count <= 1:
            return 0
        if ntp.ns != DEFAULT_NS or ntp.topic.startswith("__"):
            return 0
        if pin_replicated() and list(replicas) != [node_id]:
            return 0
        active = self.active_shards()
        return active[compute_shard(group_id, len(active))]

    # -- map ----------------------------------------------------------
    def insert(self, ntp: NTP, group_id: int, shard: int = 0) -> None:
        self._ntp[ntp] = shard
        self._group[group_id] = shard
        self._gid_of[ntp] = group_id
        self.epoch += 1

    def erase(self, ntp: NTP, group_id: int) -> None:
        self._ntp.pop(ntp, None)
        self._group.pop(group_id, None)
        self._gid_of.pop(ntp, None)
        self._unbind_lane(group_id)
        self.epoch += 1

    def shard_for(self, ntp: NTP) -> int | None:
        return self._ntp.get(ntp)

    def shard_for_group(self, group_id: int) -> int | None:
        return self._group.get(group_id)

    def record_move(self, ntp: NTP, group_id: int, shard: int) -> None:
        """Rebind after a completed live move (PartitionMover only)."""
        self.insert(ntp, group_id, shard)
        self.moves_executed += 1

    # -- lane ---------------------------------------------------------
    def _unbind_lane(self, group_id: int) -> None:
        old = self._lane.pop(group_id, None)
        if old is not None:
            self._row_group.pop((old[2], old[0], old[1]), None)

    def bind_lane(self, group_id: int, row: int, chip: int = 0) -> None:
        """Record the (chip, lane) slot the group occupies on its
        owning shard (reported at creation / move commit / lane
        migration). `chip` is the mesh device whose block holds the
        row — 0 off the mesh backend. row < 0 unbinds."""
        self._unbind_lane(group_id)
        if row >= 0:
            shard = self._group.get(group_id, 0)
            self._lane[group_id] = (chip, row, shard)
            self._row_group[(shard, chip, row)] = group_id

    def lane_for(self, group_id: int) -> int | None:
        e = self._lane.get(group_id)
        return e[1] if e is not None else None

    def chip_lane_for(self, group_id: int) -> tuple[int, int] | None:
        """The full (chip, lane) device slot."""
        e = self._lane.get(group_id)
        return (e[0], e[1]) if e is not None else None

    def group_at(self, chip: int, row: int, shard: int = 0) -> int | None:
        """Reverse lane resolution: which group occupies (chip, row)
        on `shard`. The TickFrame's changed-row residue resolves
        through this so callbacks survive a live lane rebind."""
        return self._row_group.get((shard, chip, row))

    # -- attribution --------------------------------------------------
    def counts(self) -> dict[int, int]:
        """partitions per shard (admin/bench attribution)."""
        out: dict[int, int] = {}
        for shard in self._ntp.values():
            out[shard] = out.get(shard, 0) + 1
        return out

    def group_of(self, ntp: NTP) -> int | None:
        return self._gid_of.get(ntp)

    def ntps_on(self, shard: int) -> list[NTP]:
        """Every ntp currently mapped to `shard` (evacuation before a
        retire; re-adoption after a per-shard restart)."""
        return [ntp for ntp, s in self._ntp.items() if s == shard]

    def entries(self) -> list[dict]:
        """Admin surface: the full map with lane bindings."""
        out = []
        for ntp, shard in self._ntp.items():
            gid = self._gid_of.get(ntp)
            lane = self._lane.get(gid) if gid is not None else None
            out.append(
                {
                    "ntp": f"{ntp.ns}/{ntp.topic}/{ntp.partition}",
                    "group": gid,
                    "shard": shard,
                    "lane": lane[1] if lane is not None else -1,
                    "chip": lane[0] if lane is not None else -1,
                }
            )
        return out

    def describe(self) -> dict:
        return {
            "shard_count": self.shard_count,
            "partitions": len(self._ntp),
            "counts": {str(k): v for k, v in sorted(self.counts().items())},
            "moves_executed": self.moves_executed,
            "epoch": self.epoch,
            "retired": sorted(self._retired),
            "unavailable": sorted(self._unavailable),
        }
