"""Per-client + shard-wide (node) throughput quotas.

Reference: src/v/kafka/server/quota_manager.{h,cc}
(record_produce_tp_and_throttle / record_fetch_tp, per-client-id token
buckets, throttle_time_ms surfaced in responses) and
snc_quota_manager.h:36 (the shard/node-wide ingress/egress balancer:
one bucket per direction shared by ALL clients, so aggregate node
throughput is bounded regardless of client-id cardinality). Rates come
from the replicated cluster config and apply live; rate 0 means
unlimited. The effective throttle is the max of the per-client and
node-wide delays.

Pressure-coupled degradation: when the NODE bucket is in deficit the
fleet is already hurting, and throttling every tenant equally punishes
the well-behaved for the noisy. The manager keeps a per-client
windowed byte rate; under node pressure a client whose share of
recent traffic exceeds its fair share — or whose request touches one
of the load ledger's hot NTPs (observability/load_ledger.top()) —
gets the node delay scaled UP (bounded), so heavy tenants degrade
before the fleet does.

Connection lifecycle: the server acquire()s a client_id per live
connection and release()s on teardown; at zero refs the client's
buckets and rate window drop immediately, so a churn storm of
short-lived client ids cannot grow the maps between GC sweeps.
"""

from __future__ import annotations

import asyncio
from typing import Iterable, Optional

from ..utils.token_bucket import TokenBucket

# forget a client's bucket after this long idle (client_quotas gc)
_GC_AFTER_S = 60.0
_MAX_THROTTLE_MS = 30_000

# per-client byte-rate window for the heavy-tenant decision
_RATE_WINDOW_S = 1.0
# bounds on the node-delay scale applied under pressure: heavy tenants
# climb toward the cap, light ones fall toward the floor — never to 0,
# the node bucket's deficit is real for everyone
_BOOST_CAP = 4.0
_BOOST_FLOOR = 0.25
# a request touching a ledger-hot NTP under node pressure is degraded
# at least this hard (it is, by definition, part of the problem)
_HOT_NTP_BOOST = 2.0
_HOT_NTP_TOPK = 8
_HOT_NTP_TTL_S = 1.0  # ledger.top() is a lazy fold: cache the set


class QuotaManager:
    def __init__(self, cluster_config, ledger=None):
        self._cfg = cluster_config
        # (kind, client_id) -> (bucket, last_used)
        self._buckets: dict[tuple[str, str], tuple[TokenBucket, float]] = {}
        self._last_gc = 0.0
        # snc (shard/node-wide) buckets, one per direction
        self._node: dict[str, TokenBucket] = {}
        # observability LoadLedger: the hot-NTP source (None = uncoupled)
        self._ledger = ledger
        self._hot: tuple[float, frozenset] = (-1.0, frozenset())
        # client_id -> [window_start, window_bytes, rate_bps]
        self._rates: dict[str, list[float]] = {}
        # client_id -> live connection count (server acquire/release)
        self._refs: dict[str, int] = {}

    # -- connection lifecycle --------------------------------------
    def acquire(self, client_id: str) -> None:
        """A connection started using this client_id."""
        self._refs[client_id] = self._refs.get(client_id, 0) + 1

    def release(self, client_id: str) -> None:
        """Connection teardown: at zero refs the client's quota state
        drops immediately instead of waiting out the idle GC."""
        n = self._refs.get(client_id, 0) - 1
        if n > 0:
            self._refs[client_id] = n
            return
        self._refs.pop(client_id, None)
        self._buckets.pop(("produce", client_id), None)
        self._buckets.pop(("fetch", client_id), None)
        self._rates.pop(client_id, None)

    def live_state(self) -> tuple[int, int, int]:
        """(client buckets, rate windows, refs) — leak assertions."""
        return len(self._buckets), len(self._rates), len(self._refs)

    def _rate(self, kind: str) -> float:
        key = (
            "quota_produce_bytes_per_s"
            if kind == "produce"
            else "quota_fetch_bytes_per_s"
        )
        try:
            return float(self._cfg.get(key))
        except Exception:
            return 0.0

    def _bucket(self, kind: str, client_id: str, rate: float, now: float) -> TokenBucket:
        key = (kind, client_id)
        entry = self._buckets.get(key)
        if entry is None:
            # burst of one second's allowance, like the reference's
            # default window
            b = TokenBucket(rate, burst=rate, now=now)
            self._buckets[key] = (b, now)
            return b
        b, _ = entry
        b.rate = rate  # live config rebind
        b.burst = rate
        self._buckets[key] = (b, now)
        return b

    def _node_rate(self, kind: str) -> float:
        key = (
            "kafka_throughput_limit_node_in_bps"
            if kind == "produce"
            else "kafka_throughput_limit_node_out_bps"
        )
        try:
            return float(self._cfg.get(key))
        except Exception:
            return 0.0

    def _node_throttle(self, kind: str, nbytes: int, now: float) -> float:
        """snc_quota_manager analog: one shared bucket per direction;
        returns the delay in seconds (0 = unlimited/within quota)."""
        rate = self._node_rate(kind)
        if rate <= 0:
            return 0.0
        b = self._node.get(kind)
        if b is None:
            b = self._node[kind] = TokenBucket(rate, burst=rate, now=now)
        else:
            b.rate = rate  # live config rebind
            b.burst = rate
        b.record(nbytes, now)
        return b.throttle_delay_s(now)

    # -- pressure-coupled degradation ------------------------------
    def _note_client_rate(self, client_id: str, nbytes: int, now: float) -> None:
        """Tumbling one-second window per client: on roll, last
        window's bytes become the published rate."""
        e = self._rates.get(client_id)
        if e is None:
            self._rates[client_id] = [now, float(nbytes), 0.0]
            return
        if now - e[0] >= _RATE_WINDOW_S:
            e[2] = e[1] / (now - e[0])
            e[0] = now
            e[1] = float(nbytes)
        else:
            e[1] += nbytes

    def client_rate_bps(self, client_id: str) -> float:
        e = self._rates.get(client_id)
        return e[2] if e is not None else 0.0

    def _hot_ntps(self, now: float) -> frozenset:
        t, hot = self._hot
        if now - t < _HOT_NTP_TTL_S:
            return hot
        try:
            hot = frozenset(
                d["key"] for d in self._ledger.top(_HOT_NTP_TOPK)
            )
        except Exception:
            hot = frozenset()
        self._hot = (now, hot)
        return hot

    def _pressure_boost(
        self, client_id: str, ntps: Iterable[str], now: float
    ) -> float:
        """Scale on the node delay when the node bucket is in deficit:
        rate-share steering (heavy above fair share climbs toward
        _BOOST_CAP, light falls toward _BOOST_FLOOR) plus the hot-NTP
        override from the load ledger."""
        boost = 1.0
        rates = self._rates
        if len(rates) > 1:
            mine = self.client_rate_bps(client_id)
            total = sum(e[2] for e in rates.values())
            if total > 0.0 and mine > 0.0:
                fair = total / len(rates)
                boost = min(_BOOST_CAP, max(_BOOST_FLOOR, mine / fair))
        if ntps and self._ledger is not None:
            hot = self._hot_ntps(now)
            if hot and any(n in hot for n in ntps):
                boost = max(boost, _HOT_NTP_BOOST)
        return boost

    def record_and_throttle(
        self,
        kind: str,
        client_id: Optional[str],
        nbytes: int,
        ntps: Iterable[str] = (),
    ) -> int:
        """Account traffic; returns throttle_time_ms for the response
        (0 when unlimited or within quota). The node-wide (snc) bucket
        always accounts; the per-client bucket only when configured.
        Under node pressure the node delay is scaled by the tenant's
        pressure boost before taking the max with the client delay —
        so the heavy tenant's responses stall first and hardest."""
        now = asyncio.get_event_loop().time()
        cid = client_id or ""
        node_delay = self._node_throttle(kind, nbytes, now)
        self._note_client_rate(cid, nbytes, now)
        rate = self._rate(kind)
        client_delay = 0.0
        if rate > 0:
            b = self._bucket(kind, cid, rate, now)
            b.record(nbytes, now)
            client_delay = b.throttle_delay_s(now)
        if len(self._buckets) > 10_000 or len(self._rates) > 10_000:
            self._gc(now)
        if node_delay > 0.0:
            node_delay *= self._pressure_boost(cid, ntps, now)
        delay = max(node_delay, client_delay)
        return min(int(delay * 1000), _MAX_THROTTLE_MS)

    def _gc(self, now: float) -> None:
        # client_id cardinality is client-controlled: rate-limit the
        # O(n) sweep so it cannot ride every hot-path request
        if now - self._last_gc < 10.0:
            return
        self._last_gc = now
        stale = [
            k for k, (_b, last) in self._buckets.items()
            if now - last > _GC_AFTER_S
        ]
        for k in stale:
            del self._buckets[k]
        # rate windows of refless clients age out with the buckets
        dead = [
            c for c, e in self._rates.items()
            if c not in self._refs and now - e[0] > _GC_AFTER_S
        ]
        for c in dead:
            del self._rates[c]
