"""tests/test_quotas.py run on the port: all 11 cases, with imports pointed
at redpanda_tpu_torch. An autouse fixture sets the codec and CRC
modules' `DEFAULT_DEVICE` to "cpu" (the kernels' plain versions).
Nothing is left out.

Unit coverage for kafka/quotas.py under concurrency-era load.

tests/test_fetch_sessions_quotas.py exercises throttle_time_ms over
the wire; this file pins the manager's own math — windowed rates,
per-tenant isolation, the pressure-coupled degradation (rate-share
boost + hot-NTP override), and the connection-refcounted lifecycle
that keeps a churn storm from growing the maps.
"""

import asyncio

from redpanda_tpu_torch.kafka.quotas import (
    QuotaManager,
    _BOOST_FLOOR,
    _HOT_NTP_BOOST,
)
import pytest

from redpanda_tpu_torch.ops import crc32c as crc_ops
from redpanda_tpu_torch.ops import fused as fused_ops
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops
from redpanda_tpu_torch.ops import zstd as zstd_ops


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    for mod in (lz4_ops, snappy_ops, zstd_ops, fused_ops, crc_ops):
        monkeypatch.setattr(mod, "DEFAULT_DEVICE", "cpu")


class FakeCfg:
    def __init__(self, **kv):
        self._kv = kv

    def get(self, key):
        return self._kv.get(key, 0)


class FakeLedger:
    """load_ledger stand-in: top(k) yields the configured hot NTPs."""

    def __init__(self, *keys):
        self.keys = list(keys)

    def top(self, k):
        return [{"key": key} for key in self.keys[:k]]


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _now():
    return asyncio.get_event_loop().time()


# -- per-client windowed throttle -------------------------------------


def test_client_bucket_throttles_overshoot():
    async def main():
        q = QuotaManager(FakeCfg(quota_produce_bytes_per_s=1000))
        # within the one-second burst allowance: free
        assert q.record_and_throttle("produce", "a", 500) == 0
        # blow through it: the deficit must refill at 1000 B/s, so
        # ~4.5s of backoff for the remaining 4500-byte hole
        ms = q.record_and_throttle("produce", "a", 5000)
        assert 4000 <= ms <= 5000, ms

    _run(main())


def test_unconfigured_rate_means_unlimited():
    async def main():
        q = QuotaManager(FakeCfg())
        assert q.record_and_throttle("produce", "a", 10**9) == 0
        assert q.record_and_throttle("fetch", "a", 10**9) == 0

    _run(main())


def test_per_tenant_isolation():
    async def main():
        q = QuotaManager(FakeCfg(quota_produce_bytes_per_s=1000))
        assert q.record_and_throttle("produce", "noisy", 50_000) > 0
        # the well-behaved tenant's bucket is untouched by the noisy one
        assert q.record_and_throttle("produce", "polite", 100) == 0
        # and produce vs fetch buckets are independent too
        assert q.record_and_throttle("fetch", "noisy", 100) == 0

    _run(main())


# -- windowed rate publication ----------------------------------------


def test_rate_window_publishes_on_roll():
    async def main():
        q = QuotaManager(FakeCfg())
        t0 = _now()
        q._note_client_rate("a", 80_000, t0)
        assert q.client_rate_bps("a") == 0.0  # window still open
        q._note_client_rate("a", 0, t0 + 2.0)  # roll after 2s
        assert abs(q.client_rate_bps("a") - 40_000) < 1.0

    _run(main())


# -- pressure-coupled degradation -------------------------------------


def _publish_rate(q, client_id, bps):
    """Plant a rolled rate window so _pressure_boost sees `bps`."""
    now = _now()
    q._note_client_rate(client_id, int(bps), now - 1.0)
    q._note_client_rate(client_id, 0, now)


def test_heavy_tenant_degrades_before_light():
    async def main():
        q = QuotaManager(FakeCfg(kafka_throughput_limit_node_in_bps=1000))
        _publish_rate(q, "heavy", 100_000)
        _publish_rate(q, "light", 1_000)
        heavy_ms = q.record_and_throttle("produce", "heavy", 10_000)
        light_ms = q.record_and_throttle("produce", "light", 100)
        # the node bucket's deficit hits BOTH (it is shared), but the
        # heavy tenant's boost (~2x fair share) vs the light one's
        # floor (0.25x) must separate them decisively
        assert heavy_ms > 0 and light_ms > 0
        assert heavy_ms > 3 * light_ms, (heavy_ms, light_ms)

    _run(main())


def test_no_node_pressure_no_boost():
    async def main():
        # node limit unset: the heavy tenant's rate share is noted but
        # nothing is scaled — there is no node delay to scale
        q = QuotaManager(FakeCfg())
        _publish_rate(q, "heavy", 100_000)
        _publish_rate(q, "light", 1_000)
        assert q.record_and_throttle("produce", "heavy", 10_000) == 0

    _run(main())


def test_hot_ntp_request_degrades_harder():
    async def main():
        hot = "kafka/hot-topic/0"
        cfg = dict(kafka_throughput_limit_node_in_bps=1000)

        def throttle(ntps):
            q = QuotaManager(FakeCfg(**cfg), ledger=FakeLedger(hot))
            return q.record_and_throttle("produce", "c", 5000, ntps=ntps)

        cold_ms = throttle(["kafka/cold-topic/0"])
        hot_ms = throttle([hot])
        assert cold_ms > 0
        # same deficit, but the hot-NTP override scales the node delay
        assert hot_ms >= (_HOT_NTP_BOOST - 0.1) * cold_ms, (hot_ms, cold_ms)

    _run(main())


def test_boost_floor_never_zeroes_node_delay():
    async def main():
        q = QuotaManager(FakeCfg(kafka_throughput_limit_node_in_bps=1000))
        _publish_rate(q, "whale", 10**7)
        _publish_rate(q, "minnow", 1)
        q.record_and_throttle("produce", "whale", 20_000)
        ms = q.record_and_throttle("produce", "minnow", 10)
        # the floor cuts the shared deficit for the minnow but cannot
        # erase it: the node bucket's hole is real for everyone
        assert ms > 0
        boost = q._pressure_boost("minnow", (), _now())
        assert abs(boost - _BOOST_FLOOR) < 1e-9

    _run(main())


def test_ledger_failure_is_not_fatal():
    async def main():
        class BadLedger:
            def top(self, k):
                raise RuntimeError("ledger offline")

        q = QuotaManager(
            FakeCfg(kafka_throughput_limit_node_in_bps=1000),
            ledger=BadLedger(),
        )
        # a broken ledger degrades to "no hot set", never to a crash
        assert q.record_and_throttle("produce", "c", 5000, ntps=["x"]) > 0

    _run(main())


# -- connection-refcounted lifecycle ----------------------------------


def test_release_drops_state_at_zero_refs():
    async def main():
        q = QuotaManager(
            FakeCfg(quota_produce_bytes_per_s=1000, quota_fetch_bytes_per_s=1000)
        )
        q.acquire("a")
        q.acquire("a")  # second connection, same client_id
        q.record_and_throttle("produce", "a", 5000)
        q.record_and_throttle("fetch", "a", 100)
        assert q.live_state() == (2, 1, 1)
        q.release("a")  # one connection down: state survives
        assert q.live_state() == (2, 1, 1)
        q.release("a")  # last ref: everything drops immediately
        assert q.live_state() == (0, 0, 0)
        # a fresh connection starts from a full burst, not the old debt
        q.acquire("a")
        assert q.record_and_throttle("produce", "a", 500) == 0

    _run(main())


def test_churn_storm_leaves_no_state():
    async def main():
        q = QuotaManager(FakeCfg(quota_produce_bytes_per_s=1000))
        for i in range(500):
            cid = f"churner-{i}"
            q.acquire(cid)
            q.record_and_throttle("produce", cid, 10)
            q.release(cid)
        assert q.live_state() == (0, 0, 0)

    _run(main())
