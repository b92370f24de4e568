"""Raft latency/event probe (reference: src/v/raft/probe.{h,cc}:47-101).

One probe per node (GroupManager), shared by every consensus group on
it — the reference aggregates per-partition probes the same way for
the node-level metric families. Hot-path fields are pre-resolved bound
methods (`observe_*`) so an observation costs one call + one frexp
bump, never a dict lookup.

Wired sites:
  append    replicate_batcher._flush_round — one coalesced leader
            append pass (log writes for the whole round)
  commit    consensus._resolve_quorum_items — replicate enqueue to
            quorum-commit ack, per item (acks=-1 produce latency core)
  election  consensus.try_election -> _become_leader
  heartbeat HeartbeatManager._loop, one full vectorized tick
  recovery  consensus._catch_up_locked throttled rounds
"""

from __future__ import annotations

from typing import Optional

from ..metrics import MetricsRegistry


class RaftProbe:
    def __init__(
        self, metrics: Optional[MetricsRegistry] = None, ledger=None
    ):
        m = metrics if metrics is not None else MetricsRegistry()
        self.registry = m
        # per-NTP load ledger leg (observability/load_ledger): the
        # broker shares ONE ledger across kafka+raft probes so the
        # hot-partition view merges produce/fetch/append rates
        if ledger is None:
            from ..observability.load_ledger import LoadLedger

            ledger = LoadLedger()
        self.ledger = ledger
        self.note_append = ledger.note_append
        self.append_hist = m.histogram(
            "raft_append_seconds",
            "Leader log append per coalesced flush round",
        )
        self.commit_hist = m.histogram(
            "raft_commit_seconds",
            "Replicate enqueue to quorum commit ack, per batch",
        )
        self.election_hist = m.histogram(
            "raft_election_seconds",
            "Vote dispatch to leadership established",
        )
        self.heartbeat_tick_hist = m.histogram(
            "raft_heartbeat_tick_seconds",
            "One node-batched heartbeat tick (build+send+fold)",
        )
        self.elections_started = m.counter(
            "raft_elections_started_total",
            "Vote rounds dispatched (post-prevote)",
        )
        self.leadership_changes = m.counter(
            "raft_leadership_changes_total",
            "Times a local group won leadership",
        )
        self.recovery_rounds = m.counter(
            "raft_recovery_rounds_total",
            "Throttled follower catch-up rounds (recovery_stm analog)",
        )
        # live replicate path per-stage latency (ReplicateStages
        # breakdown): coalesce = enqueue → flush-round pickup,
        # frame = one tick-frame fold+commit call, wire = one
        # AppendEntries RPC round-trip, quorum = fsync-done →
        # quorum-commit ack. Labeled children resolved once here so
        # the hot sites pay a single bound-method call.
        self.replicate_stage_hist = m.histogram(
            "raft_replicate_stage_seconds",
            "Live replicate path stage latency "
            "(coalesce -> frame -> wire -> quorum)",
        )
        self.tick_frame_flushes = m.counter(
            "raft_tick_frame_flushes_total",
            "Tick-frame windows folded (one vectorized call each)",
        )
        self.tick_frame_replies = m.counter(
            "raft_tick_frame_replies_total",
            "Append replies folded through tick-frame windows",
        )
        # hot-path pre-resolved observers
        self.observe_append = self.append_hist.observe
        self.observe_commit = self.commit_hist.observe
        self.observe_stage_coalesce = self.replicate_stage_hist.labels(
            stage="coalesce"
        ).observe
        self.observe_stage_frame = self.replicate_stage_hist.labels(
            stage="frame"
        ).observe
        self.observe_stage_wire = self.replicate_stage_hist.labels(
            stage="wire"
        ).observe
        self.observe_stage_quorum = self.replicate_stage_hist.labels(
            stage="quorum"
        ).observe


_fixture_probe: Optional[RaftProbe] = None


def fixture_probe() -> RaftProbe:
    """Shared standalone probe for Consensus objects built directly by
    unit fixtures (no GroupManager/Broker): observations land in a
    private registry nobody scrapes, so the hot path stays identical."""
    global _fixture_probe
    if _fixture_probe is None:
        _fixture_probe = RaftProbe()
    return _fixture_probe
