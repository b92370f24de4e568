"""tests/test_metadata_dissemination.py run on the port: all 7 cases,
with imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

Delta leadership gossip: per-peer sent tracking (r4 advisor).

A restarted peer lost its in-memory hints; delivery state must be
per-peer so (a) its outage triggers a full re-push to IT alone, and
(b) one down peer doesn't force re-sending deltas to healthy peers.
Pruning of deposed partitions must be unconditional so a same-tick
depose+gain can't pin a stale suppression entry.
"""

from __future__ import annotations

import asyncio
from types import SimpleNamespace

from redpanda_tpu_torch.cluster.metadata_dissemination import (
    MetadataDissemination,
    _LeaderUpdate,
)
from redpanda_tpu_torch.models.fundamental import NTP
import pytest

from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


class _FakePart:
    def __init__(self, ntp, term, leader=True):
        self.ntp = ntp
        self.is_leader = leader
        self.consensus = SimpleNamespace(term=term)


class _FakeConnCache:
    """Records per-peer pushes; peers in `down` raise. `gens` mimics
    ReconnectTransport.generation (bumped by ANY traffic reconnecting
    the shared link, e.g. raft heartbeats)."""

    def __init__(self):
        self.pushed: list[tuple[int, list]] = []
        self.down: set[int] = set()
        self.gens: dict[int, int] = {}

    def generation(self, peer):
        return self.gens.get(peer, 1)

    async def call(self, peer, verb, msg, timeout):
        if peer in self.down:
            raise ConnectionError(f"peer {peer} down")
        upd = _LeaderUpdate.decode(msg)
        self.pushed.append(
            (peer, [(e.topic, int(e.partition), int(e.term)) for e in upd.entries])
        )
        return b""


def _mk(parts, members=(1, 2, 3)):
    cc = _FakeConnCache()
    broker = SimpleNamespace(
        node_id=1,
        partition_manager=SimpleNamespace(
            partitions=lambda: {p.ntp: p for p in parts}
        ),
        controller=SimpleNamespace(members=list(members)),
        leaders=SimpleNamespace(update=lambda ntp, leader: None),
        _conn_cache=cc,
    )
    return MetadataDissemination(broker), cc


def _ntp(i):
    return NTP("kafka", "t", i)


def test_steady_state_sends_nothing_after_first_push():
    parts = [_FakePart(_ntp(i), term=3) for i in range(4)]
    d, cc = _mk(parts)

    async def main():
        await d._tick()
        assert sorted(p for p, _ in cc.pushed) == [2, 3]
        assert all(len(es) == 4 for _, es in cc.pushed)
        cc.pushed.clear()
        for _ in range(5):
            await d._tick()
        assert cc.pushed == [], "steady state must be delta-empty"

    run(main())


def test_down_peer_does_not_force_repush_to_healthy_peers():
    parts = [_FakePart(_ntp(i), term=3) for i in range(4)]
    d, cc = _mk(parts)

    async def main():
        cc.down.add(3)
        await d._tick()
        # healthy peer 2 got the batch and is marked delivered
        assert [p for p, _ in cc.pushed] == [2]
        cc.pushed.clear()
        # peer 3 comes back: next tick re-pushes EVERYTHING to 3 only
        cc.down.clear()
        await d._tick()
        assert [p for p, _ in cc.pushed] == [3]
        assert len(cc.pushed[0][1]) == 4

    run(main())


def test_restarted_peer_gets_full_repush_on_reconnect():
    """A peer that restarts between ticks (no delta traffic to observe
    the outage) is detected via the shared link's reconnect generation
    — raft heartbeats re-establish the connection, the generation
    bumps, and the next delta tick re-pushes the full leadership set
    instead of waiting for the FULL_EVERY anti-entropy pass."""
    parts = [_FakePart(_ntp(0), term=3)]
    d, cc = _mk(parts, members=(1, 2))

    async def main():
        await d._tick()
        cc.pushed.clear()
        # quiescent: deltas are empty, nothing observes the restart...
        await d._tick()
        assert cc.pushed == []
        # ...until other traffic reconnects the link (generation bump)
        cc.gens[2] = 2
        await d._tick()
        assert cc.pushed == [(2, [("t", 0, 3)])]
        cc.pushed.clear()
        # stable again: no re-push while the generation holds
        await d._tick()
        assert cc.pushed == []

    run(main())


def test_reconnect_inside_push_call_still_triggers_full_repush():
    """If the push call itself transparently reconnects (peer restarted
    between ticks, delta non-empty), only that delta was delivered —
    the recorded generation must be the PRE-call one so the next tick
    sees the bump and re-pushes the full set."""
    p0 = _FakePart(_ntp(0), term=3)
    p1 = _FakePart(_ntp(1), term=2)
    d, cc = _mk([p0, p1], members=(1, 2))

    async def main():
        await d._tick()  # both delivered, gen=1 recorded
        cc.pushed.clear()
        # peer restarts; a term change makes the next delta non-empty
        p1.consensus.term = 5
        orig_call = cc.call

        async def reconnecting_call(peer, verb, msg, timeout):
            cc.gens[peer] = 2  # transparent reconnect inside the call
            return await orig_call(peer, verb, msg, timeout)

        cc.call = reconnecting_call
        await d._tick()
        assert cc.pushed == [(2, [("t", 1, 5)])]  # delta only
        cc.pushed.clear()
        cc.call = orig_call
        # next tick: bumped generation observed → full re-push
        await d._tick()
        assert len(cc.pushed) == 1 and len(cc.pushed[0][1]) == 2

    run(main())


def test_failed_push_repushes_everything_when_peer_returns():
    parts = [_FakePart(_ntp(0), term=3)]
    d, cc = _mk(parts, members=(1, 2))

    async def main():
        # first push fails: sent-state stays empty
        cc.down.add(2)
        await d._tick()
        assert cc.pushed == []
        cc.down.clear()
        await d._tick()
        assert cc.pushed == [(2, [("t", 0, 3)])]

    run(main())


def test_prune_is_unconditional_same_tick_depose_and_gain():
    p0 = _FakePart(_ntp(0), term=3)
    p1 = _FakePart(_ntp(1), term=2, leader=False)
    d, cc = _mk([p0, p1], members=(1, 2))

    async def main():
        await d._tick()
        cc.pushed.clear()
        # same tick: depose ntp0, gain ntp1 — len(sent) == len(led),
        # the old conditional prune would have kept the stale entry
        p0.is_leader = False
        p1.is_leader = True
        await d._tick()
        assert cc.pushed == [(2, [("t", 1, 2)])]
        sent = d._sent_by_peer[2]
        assert _ntp(0) not in sent, "deposed partition not pruned"
        # ntp0 recreated at the same (term, leader): must NOT be
        # suppressed by the stale entry
        cc.pushed.clear()
        p0.is_leader = True
        await d._tick()
        assert cc.pushed == [(2, [("t", 0, 3)])]

    run(main())


def test_term_change_is_redelivered():
    p = _FakePart(_ntp(0), term=3)
    d, cc = _mk([p], members=(1, 2))

    async def main():
        await d._tick()
        cc.pushed.clear()
        p.consensus.term = 4
        await d._tick()
        assert cc.pushed == [(2, [("t", 0, 4)])]

    run(main())
