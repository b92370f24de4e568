"""tests/test_flightdata.py run on the port: all 13 cases, with imports
pointed at redpanda_tpu_torch. Brokers run on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets the codec and
CRC modules' `DEFAULT_DEVICE` to "cpu" (the kernels' plain versions).
The admin API is read with `test_admin_server`'s `http`, a plain
HTTP/1.1 client of no package. Nothing is left out.

Flight-data plane (PR 10): metrics-history ring, burn-rate SLO
alerting, continuous profiler.

The acceptance bar for the ring is EXACTNESS, not approximation: a
windowed histogram quantile must equal the quantile of a histogram
built directly from only the in-window observations (same bucket
math, bucket-wise diff of two cumulative samples), and a counter
window must report the exact delta even across ring wraparound and
for series born mid-window. The alerting bar is the multi-window
burn-rate contract (fire only when fast AND slow breach, clear when
fast recovers, min-count guard against quantiles-of-nothing). The e2e
bar: a real 3-broker cluster under a NemesisNet append-delay fires
produce_p99 with an auto-captured profile attached, then clears after
the nemesis lifts.
"""

import asyncio
import contextlib
import time

import pytest

from redpanda_tpu_torch.metrics import HistogramChild, MetricsRegistry
from redpanda_tpu_torch.observability import alerts as _alerts
from redpanda_tpu_torch.observability import flightdata as _fd
from redpanda_tpu_torch.observability import profiler as _prof
from redpanda_tpu_torch.observability.alerts import AlertManager, AlertRule
from redpanda_tpu_torch.observability.flightdata import (
    MetricsHistory,
    WindowQuery,
    merge_window_replies,
    window_reply,
)
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


class FakeClock:
    def __init__(self, start: float = 100.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


def _ring(reg, clk, capacity=64, interval_s=1.0, gauge_every=1):
    return MetricsHistory(
        reg, interval_s=interval_s, capacity=capacity,
        gauge_every=gauge_every, clock=clk, wall_clock=clk,
    )


# ------------------------------------------ windowed math exactness


def test_hist_window_quantile_matches_direct_merge():
    """Windowed quantile == quantile of a child holding ONLY the
    in-window observations: bucket-wise diff of cumulative samples
    loses nothing."""
    clk = FakeClock()
    reg = MetricsRegistry()
    child = reg.histogram("lat_seconds").labels(api="x")
    ring = _ring(reg, clk)

    warm = [0.001, 0.002, 0.005, 0.3, 1.7]
    for v in warm:
        child.observe(v)
    ring.sample()
    clk.advance(1.0)
    ring.sample()  # window start boundary

    in_window = [0.0001 * (i + 1) ** 2 for i in range(50)] + [0.9, 2.5]
    for v in in_window:
        child.observe(v)
    clk.advance(1.0)
    ring.sample()

    direct = HistogramChild()
    for v in in_window:
        direct.observe(v)

    for q in (0.5, 0.9, 0.99, 0.999):
        got = ring.quantile("redpanda_tpu_lat_seconds", 1.0, q)
        assert got is not None
        assert got["value"] == direct.quantile(q), q
    assert got["count"] == len(in_window)
    assert got["sum"] == pytest.approx(sum(in_window))


def test_counter_rate_across_ring_wraparound():
    """A query window larger than the ring clamps to the oldest
    retained sample and stays exact over the retained span."""
    clk = FakeClock()
    reg = MetricsRegistry()
    c = reg.counter("ticks_total")
    ring = _ring(reg, clk, capacity=4)

    for _ in range(10):  # 10 samples into a 4-deep ring: wraps twice
        c.inc(10.0)
        ring.sample()
        clk.advance(1.0)

    w = ring.counter_window("redpanda_tpu_ticks_total", 1000.0)
    assert w is not None
    # ring holds the last 4 samples, spanning 3 seconds and 30 incs
    assert w["window_s"] == pytest.approx(3.0)
    assert w["total_delta"] == pytest.approx(30.0)
    assert w["total_rate"] == pytest.approx(10.0)


def test_counter_series_born_mid_window_exact():
    """Counters are cumulative-from-zero: a label set first seen
    mid-window contributes its full value as the exact delta."""
    clk = FakeClock()
    reg = MetricsRegistry()
    c = reg.counter("reqs_total")
    ring = _ring(reg, clk)
    c.inc(5.0, api="old")
    ring.sample()
    clk.advance(2.0)
    c.inc(7.0, api="old")
    c.inc(3.0, api="new")  # born inside the window
    ring.sample()

    w = ring.counter_window("redpanda_tpu_reqs_total", 2.0)
    deltas = {r["labels"]["api"]: r["delta"] for r in w["series"]}
    assert deltas == {"old": pytest.approx(7.0), "new": pytest.approx(3.0)}
    assert w["total_delta"] == pytest.approx(10.0)


def test_gauge_window_stats():
    clk = FakeClock()
    reg = MetricsRegistry()
    val = {"v": 0.0}
    reg.gauge("depth", lambda: val["v"])
    ring = _ring(reg, clk)
    for v in (1.0, 5.0, 3.0):
        val["v"] = v
        ring.sample()
        clk.advance(1.0)
    w = ring.gauge_window("redpanda_tpu_depth", 10.0)
    assert w is not None and len(w["series"]) == 1
    st = w["series"][0]
    assert (st["min"], st["max"], st["last"]) == (1.0, 5.0, 3.0)
    assert st["avg"] == pytest.approx(3.0)


def test_gauge_sample_and_hold():
    """With gauge_every=N the callback runs on every Nth tick only;
    held ticks alias the previous snapshot, so an expensive gauge
    (e.g. the health exporter's lane reduction) is not re-reduced at
    the full sampling rate. Counters still capture every tick."""
    clk = FakeClock()
    reg = MetricsRegistry()
    calls = {"n": 0}

    def expensive():
        calls["n"] += 1
        return float(calls["n"])

    reg.gauge("depth", expensive)
    ctr = reg.counter("ticks_total")
    ring = _ring(reg, clk, gauge_every=3)
    for _ in range(7):  # fresh on ticks 0, 3, 6
        ctr.inc()
        ring.sample()
        clk.advance(1.0)
    assert calls["n"] == 3
    w = ring.gauge_window("redpanda_tpu_depth", 100.0)
    st = w["series"][0]
    # held value repeats between refreshes: 1,1,1,2,2,2,3
    assert (st["min"], st["max"], st["last"]) == (1.0, 3.0, 3.0)
    cw = ring.counter_window("redpanda_tpu_ticks_total", 100.0)
    assert cw["total_delta"] == pytest.approx(6.0)  # full-rate deltas


def test_fleet_merge_quantile_matches_direct_merge():
    """Shard replies ship windowed diff buckets, so the shard-0 merge
    answers the exact fleet quantile — byte round-trip included."""
    obs = {0: [0.002, 0.004, 0.008, 0.5], 1: [0.001, 0.25, 1.5, 3.0]}
    replies, direct = [], HistogramChild()
    for sid, values in obs.items():
        clk = FakeClock()
        reg = MetricsRegistry()
        child = reg.histogram("lat_seconds").labels(api="x")
        ring = _ring(reg, clk)
        child.observe(9.9)  # pre-window noise, must not leak in
        ring.sample()
        clk.advance(1.0)
        ring.sample()
        for v in values:
            child.observe(v)
            direct.observe(v)
        clk.advance(1.0)
        ring.sample()
        q = WindowQuery(
            family="redpanda_tpu_lat_seconds", window_s=1.0, labels={}
        )
        wire = window_reply(ring, sid, q).encode()
        replies.append(type(window_reply(ring, sid, q)).decode(wire))
    merged = merge_window_replies(replies, q=0.99)
    assert merged["kind"] == "histogram"
    assert merged["count"] == 8
    for q_ in (0.5, 0.99):
        got = merge_window_replies(replies, q=q_)
        assert got["value"] == direct.quantile(q_)


# ------------------------------------------ burn-rate alerting


def _alert_fixture(threshold=0.04, min_count=8):
    clk = FakeClock()
    reg = MetricsRegistry()
    child = reg.histogram("kafka_request_stage_seconds").labels(
        api="produce", stage="done", path="t"
    )
    ring = _ring(reg, clk)
    rule = AlertRule(
        "p99", "quantile", "redpanda_tpu_kafka_request_stage_seconds",
        {"api": "produce", "stage": "done"}, 0.99, threshold, "s", "test",
    )
    mgr = AlertManager(
        ring, rules=[rule], fast_s=2.0, slow_s=6.0, interval_s=1.0,
        min_count=min_count, registry=reg, clock=clk, wall_clock=clk,
    )
    return clk, child, ring, mgr


def test_alert_fires_then_clears():
    clk, child, ring, mgr = _alert_fixture()
    ring.sample()
    # breach: 10 samples/s at 100 ms against a 40 ms SLO
    for _ in range(3):
        for _ in range(10):
            child.observe(0.1)
        clk.advance(1.0)
        ring.sample()
        mgr.evaluate()
    assert "p99" in mgr.active
    alert = mgr.active["p99"]
    assert alert["state"] == "firing"
    assert alert["burn"]["fast"] > 1.0 and alert["burn"]["slow"] > 1.0
    assert mgr.overview() == {"alerts_firing": 1, "alerts": ["p99"]}

    # recovery: fast window fills with sub-SLO samples and clears even
    # while the slow window still remembers the breach
    for _ in range(3):
        for _ in range(10):
            child.observe(0.001)
        clk.advance(1.0)
        ring.sample()
        mgr.evaluate()
    assert mgr.active == {}
    assert len(mgr.recent) == 1
    cleared = mgr.recent[0]
    assert cleared["state"] == "cleared"
    assert cleared["duration_s"] > 0
    assert mgr.overview() == {"alerts_firing": 0, "alerts": []}


def test_alert_min_count_guard():
    """A p99 of three samples is noise, not a page."""
    clk, child, ring, mgr = _alert_fixture(min_count=8)
    ring.sample()
    for _ in range(3):
        for _ in range(3):  # breaching values, but the 2 s fast window
            child.observe(0.5)  # never accumulates min_count of them
        clk.advance(1.0)
        ring.sample()
        mgr.evaluate()
        assert mgr.active == {}


def test_slo_profile_loading():
    prof = _alerts.load_slo_profile("default")
    rules = _alerts.rules_from_slo(prof["slo"])
    names = {r.name for r in rules}
    assert {"produce_p99", "produce_p999", "replication_lag"} <= names
    # unknown profile degrades to the builtin SLO, never crashes boot
    fallback = _alerts.load_slo_profile("no-such-profile")
    assert fallback["profile"] == "builtin-default"
    assert _alerts.rules_from_slo(fallback["slo"])


# ------------------------------------------ continuous profiler


def test_profiler_collapsed_smoke():
    p = _prof.get_profiler()
    p.acquire()
    try:
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            collapsed = p.collapsed(5.0)
            if collapsed:
                break
            time.sleep(0.05)
        assert collapsed, "sampler produced no stacks in 3 s"
        assert all(";" in s or "." in s for s in collapsed)
        snap = p.snapshot(5.0, limit=10)
        assert snap["samples"] > 0
        assert snap["stacks"] and snap["stacks"][0]["count"] >= 1
        assert 0 < snap["stacks"][0]["pct"] <= 100.0
    finally:
        p.release()


# ------------------------------------------ e2e: nemesis -> alert


async def _nemesis_alert_cycle(tmp_path):
    import redpanda_tpu_torch.raft.types as rt
    from test_admin_server import http

    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.rpc import NemesisSchedule, NetRule
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    net = LoopbackNetwork()
    members = [0, 1, 2]
    brokers = [
        Broker(
            BrokerConfig(
                device="cpu",
                node_id=i,
                data_dir=str(tmp_path / f"n{i}"),
                members=members,
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                node_status_interval_s=0.1,
            ),
            loopback=net,
        )
        for i in members
    ]
    for b in brokers:
        # test-scale windows: fire within ~2 fast windows of the
        # breach, clear one fast window after the nemesis lifts
        b.flightdata.interval_s = 0.1
        b.alerts.fast_s = 1.0
        b.alerts.slow_s = 3.0
        b.alerts.interval_s = 0.15
        b.alerts.capture_s = 2.0
    for b in brokers:
        await b.start()
    client = None
    try:
        await brokers[0].wait_controller_leader()
        client = KafkaClient([b.kafka_advertised for b in brokers])
        await client.create_topic("alrt", partitions=1, replication_factor=3)

        deadline = asyncio.get_event_loop().time() + 5
        leader = None
        while asyncio.get_event_loop().time() < deadline:
            st, body = await http(
                brokers[0].admin.address, "GET", "/v1/partitions/kafka/alrt/0"
            )
            if st == 200 and body["leader"] is not None:
                leader = body["leader"]
                break
            await asyncio.sleep(0.05)
        assert leader is not None
        ldr = next(b for b in brokers if b.node_id == leader)
        followers = [i for i in members if i != leader]

        # delay appends into BOTH followers: the acks=all quorum now
        # waits ~80 ms per produce, far past the 40 ms p99 SLO, while
        # heartbeats stay clean so no election fires
        net.install_nemesis(NemesisSchedule(rules=[
            NetRule(dst=f, method=m, action="delay",
                    delay_s=0.08, count=1 << 30)
            for f in followers
            for m in (rt.APPEND_ENTRIES, rt.APPEND_ENTRIES_BATCH)
        ]))

        fired = None
        deadline = asyncio.get_event_loop().time() + 20
        while asyncio.get_event_loop().time() < deadline:
            await client.produce("alrt", 0, [(None, b"x" * 256)] * 4)
            st, al = await http(ldr.admin.address, "GET", "/v1/alerts")
            assert st == 200
            if al["enabled"]:
                hits = [a for a in al["firing"] if a["name"] == "produce_p99"]
                if hits:
                    fired = hits[0]
                    break
        assert fired is not None, "produce_p99 never fired under nemesis"
        assert fired["burn"]["fast"] > 1.0
        assert fired["observed"]["fast"]["value"] > 0.04
        if _prof.ENABLED:
            # auto-capture: the alert ships with the stacks that were
            # running while the budget burned
            assert fired["profile"] and fired["profile"]["stacks"]
        assert fired["hot_ntps"], "load ledger saw no hot partitions"

        st, overview = await http(
            ldr.admin.address, "GET", "/v1/cluster/health_overview"
        )
        assert st == 200 and overview["alerts_firing"] >= 1
        assert "produce_p99" in overview["alerts"]

        # lift the nemesis; once breaching samples age out of the fast
        # window the alert clears into `recent` with its duration
        net.clear_nemesis()
        cleared = None
        deadline = asyncio.get_event_loop().time() + 15
        while asyncio.get_event_loop().time() < deadline:
            await client.produce("alrt", 0, [(None, b"x" * 256)] * 4)
            st, al = await http(ldr.admin.address, "GET", "/v1/alerts")
            if not any(a["name"] == "produce_p99" for a in al["firing"]):
                hits = [
                    a for a in al["recent"] if a["name"] == "produce_p99"
                ]
                if hits:
                    cleared = hits[-1]
                    break
            await asyncio.sleep(0.1)
        assert cleared is not None, "alert never cleared after nemesis lift"
        assert cleared["state"] == "cleared"
        assert cleared["duration_s"] > 0
    finally:
        net.clear_nemesis()
        if client is not None:
            with contextlib.suppress(Exception):
                await client.close()
        for b in brokers:
            with contextlib.suppress(Exception):
                await b.stop()


@pytest.mark.timing
@pytest.mark.skipif(
    not (_fd.ENABLED and _alerts.ENABLED),
    reason="flight-data plane disabled via RP_FLIGHTDATA/RP_ALERTS",
)
def test_nemesis_alert_fire_profile_clear(tmp_path):
    asyncio.run(_nemesis_alert_cycle(tmp_path))


def test_counter_reset_yields_post_restart_delta():
    """A shard crash + in-place restart zeroes that child's cumulative
    counters mid-window. Per the Prometheus rate() convention the new
    cumulative value IS the in-window delta — clamping to zero would
    report a dead-silent shard until the window slid past the crash."""
    clk = FakeClock()
    reg = MetricsRegistry()
    c = reg.counter("reqs_total")
    ring = _ring(reg, clk)
    c.inc(100.0, shard="1")
    ring.sample()
    clk.advance(5.0)
    # the worker dies and is re-forked: counters restart from zero and
    # the reborn child serves 7 requests before the next scrape
    c._values.clear()
    c.inc(7.0, shard="1")
    ring.sample()

    w = ring.counter_window("redpanda_tpu_reqs_total", 5.0)
    assert w is not None and len(w["series"]) == 1
    assert w["series"][0]["delta"] == pytest.approx(7.0)
    assert w["total_rate"] == pytest.approx(7.0 / 5.0)


def test_histogram_diff_counter_reset():
    """Same reset convention for windowed histogram diffs: when the
    new cumulative count is below the old one, the new counts are the
    in-window observations (bucket-wise clamping would erase every
    post-restart sample)."""
    from redpanda_tpu_torch.metrics import _NBUCKETS

    def snap(n):
        h = HistogramChild()
        for _ in range(n):
            h.observe(0.010)
        return (tuple(h._buckets), h._overflow, h._sum, h._count)

    old, new = snap(100), snap(7)  # reborn child: 7 post-restart obs
    d = _fd._diff_child(new, old)
    assert d._count == 7
    assert sum(d._buckets) == 7
    assert d._sum == pytest.approx(7 * 0.010)
    # and the no-reset path still diffs
    d2 = _fd._diff_child(snap(100), snap(40))
    assert d2._count == 60
