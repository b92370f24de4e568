"""tests/test_health_plane.py run on the port: all 16 test functions,
with imports pointed at redpanda_tpu_torch. Every broker is the port's
on the CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu". The
reference's `health_reduce_jit` is the port's `ops.health.health_reduce`
on CPU tensors (`health_reduce_jit` below); `ShardGroupArrays` take
`device="cpu"`; `cluster` and `http` come from
`test_torch_ref_admin_server`. Nothing is left out.


Partition-health plane (PR 8): differential kernel suite, load
ledger, bounded surfacing, fleet merge, and the admin/nemesis e2e.

The acceptance bar for the reduction is byte-equality against the
scalar oracle (raft/health_scalar.py) across >=10k randomized lane
states — joint consensus, learners, NO_OFFSET, inactive rows — for
BOTH the numpy host mirror and the jit'd device kernel, plus
host/device parity of ShardGroupArrays.health_refresh under the
RP_QUORUM_BACKEND seam. The surfacing bar is bounded cardinality: the
/metrics sample count must not grow with partition count.
"""

import asyncio
import contextlib
import types

import numpy as np
import pytest

from redpanda_tpu_torch.metrics import MetricsRegistry
from redpanda_tpu_torch.models.consensus_state import NO_OFFSET, SELF_SLOT
from redpanda_tpu_torch.observability.health import (
    LAG_BUCKETS,
    HealthSampler,
    build_report,
    empty_report,
    lag_bucket_edges,
    lag_histogram,
    merge_reports,
    register_exporter,
)
from redpanda_tpu_torch.observability.load_ledger import LoadLedger, skew_of
from redpanda_tpu_torch.ops.health import health_reduce, health_reduce_np
from redpanda_tpu_torch.raft.group_manager import GroupManager
from redpanda_tpu_torch.raft.health_scalar import group_health
from redpanda_tpu_torch.raft.quorum_scalar import ReplicaState
from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")



def health_reduce_jit(*lanes):
    """The reference's jitted reduce is the port's `health_reduce` on
    CPU tensors (the kernel's plain PyTorch version)."""
    import torch

    return health_reduce(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in lanes)
    )


# ------------------------------------------------ differential suite


def _random_case(rng, g: int, r: int):
    """One batch of randomized lane states covering the full input
    space: NO_OFFSET holes, learners (neither mask), joint-consensus
    old voters, followers with match ahead of the leader's self slot
    (negative raw lag), inactive free-list rows."""
    match = rng.integers(-1, 200, size=(g, r))
    match = np.where(rng.random((g, r)) < 0.15, NO_OFFSET, match)
    match = match.astype(np.int64)
    commit = rng.integers(-1, 200, size=g).astype(np.int64)
    is_voter = rng.random((g, r)) < 0.6
    is_voter_old = rng.random((g, r)) < 0.25
    is_leader = rng.random(g) < 0.5
    leader_known = rng.random(g) < 0.7
    active = rng.random(g) < 0.9
    return match, commit, is_voter, is_voter_old, is_leader, leader_known, active


def test_health_reduce_differential_vs_scalar_oracle():
    """>=10k randomized groups: numpy mirror == jit'd kernel == scalar
    oracle, byte-for-byte."""
    rng = np.random.default_rng(0xC0FFEE)
    total = 0
    for _ in range(24):
        g, r = 512, 8
        case = _random_case(rng, g, r)
        match, commit, is_voter, is_voter_old, is_lead, known, active = case
        h_np = health_reduce_np(*case)
        h_dev = health_reduce_jit(*case)
        for k in h_np:
            dev = np.asarray(h_dev[k])
            assert h_np[k].dtype == dev.dtype, k
            assert np.array_equal(h_np[k], dev), k
        for row in range(g):
            replicas = [
                ReplicaState(
                    match_index=int(match[row, s]),
                    is_voter=bool(is_voter[row, s]),
                    is_voter_old=bool(is_voter_old[row, s]),
                )
                for s in range(r)
            ]
            ml, un, ll = group_health(
                replicas,
                int(commit[row]),
                bool(is_lead[row]),
                bool(known[row]),
                bool(active[row]),
            )
            assert ml == int(h_np["max_lag"][row]), row
            assert un == bool(h_np["under_replicated"][row]), row
            assert ll == bool(h_np["leaderless"][row]), row
        total += g
    assert total >= 10_000


def test_health_reduce_directed_cases():
    """Hand-built rows pinning each predicate's definition."""

    def one(match, commit, voter, old, lead, known, active=True):
        m = np.asarray([match], np.int64)
        return health_reduce_np(
            m,
            np.asarray([commit], np.int64),
            np.asarray([voter], bool),
            np.asarray([old], bool),
            np.asarray([lead], bool),
            np.asarray([known], bool),
            np.asarray([active], bool),
        )

    # leader, one voter 3 behind, committed past it -> lag 3 + under
    h = one([10, 7, 10], 9, [True, True, True], [False] * 3, True, True)
    assert int(h["max_lag"][0]) == 3
    assert bool(h["under_replicated"][0])
    assert not bool(h["leaderless"][0])
    # learner slot never counts (slot 1 is neither voter nor old)
    h = one([10, 0, 10], 5, [True, False, True], [False] * 3, True, True)
    assert int(h["max_lag"][0]) == 0
    assert not bool(h["under_replicated"][0])
    # joint consensus: an OLD voter behind still counts
    h = one([10, 0, 10], 5, [True, False, True],
            [False, True, False], True, True)
    assert int(h["max_lag"][0]) == 10
    assert bool(h["under_replicated"][0])
    # NO_OFFSET follower: lag measured from -1
    h = one([4, NO_OFFSET], 2, [True, True], [False, False], True, True)
    assert int(h["max_lag"][0]) == 5
    # non-leader rows report zero lag; leaderless needs unknown leader
    h = one([10, 0], 5, [True, True], [False, False], False, False)
    assert int(h["max_lag"][0]) == 0
    assert bool(h["leaderless"][0])
    h = one([10, 0], 5, [True, True], [False, False], False, True)
    assert not bool(h["leaderless"][0])
    # inactive (freed) rows are invisible
    h = one([10, 0], 5, [True, True], [False, False], False, False,
            active=False)
    assert not bool(h["leaderless"][0])
    assert int(h["max_lag"][0]) == 0


# ------------------------------------- ShardGroupArrays health lanes


def _populate(a: ShardGroupArrays, rng, n: int) -> list[int]:
    rows = [a.alloc_row() for _ in range(n)]
    idx = np.asarray(rows)
    r = a.replica_slots
    a.match_index[idx] = rng.integers(-1, 500, size=(n, r))
    a.commit_index[idx] = rng.integers(-1, 500, size=n)
    a.is_voter[idx] = rng.random((n, r)) < 0.7
    a.is_voter_old[idx] = rng.random((n, r)) < 0.2
    a.is_leader[idx] = rng.random(n) < 0.5
    a.leader_id[idx] = rng.integers(-1, 3, size=n)
    a.voter_epoch += 1
    a.touch()
    return rows


def test_health_refresh_backend_parity(monkeypatch):
    """RP_QUORUM_BACKEND=host and =device produce byte-equal lanes."""
    rng = np.random.default_rng(7)
    a = ShardGroupArrays(device="cpu", capacity=256)
    _populate(a, rng, 200)
    monkeypatch.setenv("RP_QUORUM_BACKEND", "host")
    a.health_refresh()
    host = (
        a.health_max_lag.copy(),
        a.health_under.copy(),
        a.health_leaderless.copy(),
    )
    host_totals = a.health_totals()
    # scribble over the lanes so parity proves a real recompute
    a.health_max_lag[:] = -7
    a.health_under[:] = True
    a.health_leaderless[:] = True
    monkeypatch.setenv("RP_QUORUM_BACKEND", "device")
    a.health_refresh()
    assert np.array_equal(a.health_max_lag, host[0])
    assert np.array_equal(a.health_under, host[1])
    assert np.array_equal(a.health_leaderless, host[2])
    assert a.health_totals() == host_totals


def test_freed_row_never_reads_leaderless():
    a = ShardGroupArrays(device="cpu", capacity=8)
    row = a.alloc_row()
    a.leader_id[row] = -1  # no known leader, not leading
    a.health_refresh()
    assert bool(a.health_leaderless[row])
    a.free_row(row)
    a.health_refresh()
    assert not a.health_leaderless.any()
    assert a.health_totals()["active"] == 0


# ------------------------------------------------------- load ledger


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_load_ledger_lazy_ewma():
    clk = FakeClock()
    led = LoadLedger(halflife_s=10.0, clock=clk)
    led.note_produce("kafka/a/0", 1000)
    led.note_produce("kafka/a/0", 1000)
    clk.t = 1.0
    r = led.rates("kafka/a/0")
    decay = 0.5 ** (1.0 / 10.0)
    gain = 1.0 - decay
    assert r["produce"]["bytes_per_s"] == pytest.approx(gain * 2000.0)
    assert r["produce"]["ops_per_s"] == pytest.approx(gain * 2.0)
    assert r["fetch"]["bytes_per_s"] == 0.0
    rate1 = r["produce"]["bytes_per_s"]
    # one full half-life idle: rate halves, accumulators stay drained
    clk.t = 11.0
    r2 = led.rates("kafka/a/0")
    assert r2["produce"]["bytes_per_s"] == pytest.approx(rate1 * 0.5)
    # unknown key reads all-zero without creating a record
    assert led.rates("kafka/nope/0")["produce"]["bytes_per_s"] == 0.0
    assert len(led) == 1
    led.forget("kafka/a/0")
    assert len(led) == 0


def test_load_ledger_top_skew_totals():
    clk = FakeClock()
    led = LoadLedger(halflife_s=10.0, clock=clk)
    for i in range(8):
        led.note_produce(f"kafka/t/{i}", 100)
    led.note_produce("kafka/t/0", 7_900)  # hot key
    led.note_fetch("kafka/t/1", 400)
    clk.t = 1.0
    top = led.top(3)
    assert [row["key"] for row in top][:1] == ["kafka/t/0"]
    assert len(top) == 3
    assert top[0]["total_bps"] >= top[1]["total_bps"] >= top[2]["total_bps"]
    assert top[0]["produce_bps"] == top[0]["total_bps"]  # produce-only key
    tot = led.totals()
    assert tot["total_bps"] == pytest.approx(
        tot["produce_bps"] + tot["fetch_bps"] + tot["append_bps"]
    )
    assert led.skew() > 1.0  # one key carries ~10x the mean
    # degenerate skew: single loaded key reads balanced
    led2 = LoadLedger(clock=clk)
    led2.note_append("g/1", 10)
    clk.t = 2.0
    assert led2.skew() == 1.0
    assert skew_of([]) == 1.0
    assert skew_of([5.0]) == 1.0
    assert skew_of([2.0, 2.0]) == pytest.approx(1.0)
    assert skew_of([9.0, 1.0, 1.0, 1.0]) == pytest.approx(3.0)


# ------------------------------------------------- histogram + merge


def test_lag_histogram_shape_and_cumulativity():
    assert lag_histogram(np.asarray([], np.int64)) == [0] * LAG_BUCKETS
    edges = lag_bucket_edges()
    assert len(edges) == LAG_BUCKETS
    assert edges[0] == "0" and edges[-1] == "+Inf"
    lags = np.asarray([0, 1, 1, 3, 600_000], np.int64)
    hist = lag_histogram(lags)
    assert len(hist) == LAG_BUCKETS
    assert hist[0] == 1  # lag == 0
    assert hist[1] == 3  # <= 1
    assert hist[2] == 3  # <= 2
    assert hist[3] == 4  # <= 4
    assert hist[-1] == len(lags)  # +Inf cumulates everything
    assert all(a <= b for a, b in zip(hist, hist[1:]))  # cumulative


def test_merge_reports_folds_shards():
    a = empty_report()
    a.update(active=10, max_follower_lag=5, under_replicated=2,
             leaderless=1, skew=2.0)
    a["rates"] = {"produce_bps": 100.0, "fetch_bps": 0.0,
                  "append_bps": 50.0, "total_bps": 150.0}
    a["top_laggy"] = [{"key": "kafka/a/0", "group": 1, "lag": 5,
                       "under_replicated": True}]
    a["top_hot"] = [{"key": "kafka/a/0", "total_bps": 150.0}]
    a["lag_histogram"] = lag_histogram(np.asarray([0, 5], np.int64))
    b = empty_report()
    b.update(active=4, max_follower_lag=9, under_replicated=0,
             leaderless=0, skew=1.5)
    b["rates"] = {"produce_bps": 10.0, "fetch_bps": 5.0,
                  "append_bps": 5.0, "total_bps": 20.0}
    b["top_laggy"] = [{"key": "kafka/b/0", "group": 2, "lag": 9,
                       "under_replicated": False}]
    b["lag_histogram"] = lag_histogram(np.asarray([9], np.int64))
    out = merge_reports([a, b], top_k=1)
    assert out["active"] == 14
    assert out["max_follower_lag"] == 9
    assert out["under_replicated"] == 2
    assert out["leaderless"] == 1
    assert out["skew"] == 2.0  # per-NTP skew merges as max
    assert out["rates"]["total_bps"] == pytest.approx(170.0)
    # top-k re-ranks across shards then truncates
    assert [r["key"] for r in out["top_laggy"]] == ["kafka/b/0"]
    assert len(out["top_hot"]) == 1
    assert out["lag_histogram"][-1] == 3  # bucket counts add
    assert out["shard_skew"] == pytest.approx(
        skew_of([150.0, 20.0])
    )
    assert out["shards"] == 2
    # merging nothing is the empty report with degenerate skew
    empty = merge_reports([])
    assert empty["active"] == 0 and empty["shard_skew"] == 1.0


# --------------------------------------- bounded /metrics cardinality


def _fake_gm(n_rows: int, rng):
    """GroupManager-shaped stand-in: real ShardGroupArrays + registry
    dict, borrowing the real health_report implementation — no
    Consensus objects needed to exercise the top-k path."""
    a = ShardGroupArrays(device="cpu", capacity=max(64, n_rows))
    rows = _populate(a, rng, n_rows)
    gm = types.SimpleNamespace(
        arrays=a,
        _by_row={
            row: types.SimpleNamespace(
                ledger_key=f"kafka/t/{row}", group_id=row
            )
            for row in rows
        },
    )
    gm.health_report = types.MethodType(GroupManager.health_report, gm)
    return gm


def _health_sample_lines(n_rows: int, n_keys: int) -> dict[str, int]:
    rng = np.random.default_rng(13)
    gm = _fake_gm(n_rows, rng)
    clk = FakeClock()
    led = LoadLedger(clock=clk)
    for i in range(n_keys):
        led.note_produce(f"kafka/t/{i}", 100 + i)
    clk.t = 1.0
    reg = MetricsRegistry()
    # long TTL: all 7 gauge fns share ONE snapshot per render
    register_exporter(reg, HealthSampler(gm, led, max_age_s=60.0))
    text = reg.render()
    fams = (
        "partition_health_max_follower_lag",
        "partition_health_under_replicated",
        "partition_health_leaderless",
        "partition_load_skew_index",
        "partition_health_top_lag",
        "partition_load_top_bps",
        "partition_health_lag_bucket",
    )
    counts = {}
    for fam in fams:
        full = f"redpanda_tpu_{fam}"
        counts[fam] = sum(
            1
            for ln in text.splitlines()
            if ln.startswith((full + " ", full + "{"))
        )
    return counts


@pytest.mark.slow
def test_metrics_sample_count_bounded_at_100k_partitions():
    """The acceptance bound: 100k partitions scrape EXACTLY as many
    health samples as 128 partitions."""
    small = _health_sample_lines(128, 128)
    big = _health_sample_lines(100_000, 100_000)
    assert small == big


def test_metrics_sample_count_bounded():
    """Fast tier-1 variant of the 100k bound (same invariant, 4k)."""
    small = _health_sample_lines(64, 64)
    big = _health_sample_lines(4096, 4096)
    assert small == big
    assert big["partition_health_lag_bucket"] == LAG_BUCKETS
    assert big["partition_health_top_lag"] <= 10
    assert big["partition_load_top_bps"] == 10
    assert big["partition_health_max_follower_lag"] == 1


def test_health_report_top_k_resolves_registry():
    rng = np.random.default_rng(99)
    gm = _fake_gm(64, rng)
    a = gm.arrays
    # force one unambiguous worst row
    rows = sorted(gm._by_row)
    worst = rows[0]
    a.is_leader[rows] = False
    a.is_leader[worst] = True
    a.is_voter[worst] = False
    a.is_voter_old[worst] = False
    a.is_voter[worst, :2] = True
    a.match_index[worst, 0] = 1000
    a.match_index[worst, 1] = 100
    a.commit_index[worst] = 500
    a.voter_epoch += 1
    rep = gm.health_report(top_k=5)
    assert rep["max_follower_lag"] == 900
    assert rep["top_laggy"][0] == {
        "key": f"kafka/t/{worst}",
        "group": worst,
        "lag": 900,
        "under_replicated": True,
    }
    assert len(rep["top_laggy"]) <= 5
    assert rep["lag_histogram"][-1] == 1  # one leader row
    assert rep["active"] == 64


def test_health_sampler_caches_within_ttl():
    rng = np.random.default_rng(3)
    gm = _fake_gm(16, rng)
    calls = []
    real = gm.health_report

    def counting(top_k=10):
        calls.append(top_k)
        return real(top_k=top_k)

    gm.health_report = counting
    clk = FakeClock()
    s = HealthSampler(gm, LoadLedger(clock=clk), max_age_s=0.25,
                      clock=clk)
    s.report()
    s.report()
    assert len(calls) == 1  # second read served from cache
    clk.t = 0.3
    s.report()
    assert len(calls) == 2  # TTL expired
    s.report(fresh=True)
    assert len(calls) == 3  # forced refresh bypasses the cache


def test_build_report_shape():
    rng = np.random.default_rng(21)
    gm = _fake_gm(32, rng)
    clk = FakeClock()
    led = LoadLedger(clock=clk)
    led.note_produce("kafka/t/1", 512)
    clk.t = 1.0
    rep = build_report(gm, led, top_k=4)
    for key in ("active", "max_follower_lag", "under_replicated",
                "leaderless", "skew", "rates", "top_laggy", "top_hot",
                "lag_histogram"):
        assert key in rep, key
    assert rep["top_hot"][0]["key"] == "kafka/t/1"
    assert rep["rates"]["produce_bps"] > 0.0


# ------------------------------------------------- fleet serde round


def test_health_envelope_roundtrip():
    from redpanda_tpu_torch.observability import fleet

    rep = empty_report()
    rep.update(active=7, max_follower_lag=42, under_replicated=3,
               leaderless=1, skew=2.5)
    rep["rates"] = {"produce_bps": 1.0, "fetch_bps": 2.0,
                    "append_bps": 3.0, "total_bps": 6.0}
    rep["top_laggy"] = [{"key": "kafka/x/0", "group": 9, "lag": 42,
                         "under_replicated": True}]
    rep["top_hot"] = [{"key": "kafka/x/0", "total_bps": 6.0,
                       "produce_bps": 1.0, "fetch_bps": 2.0,
                       "append_bps": 3.0}]
    rep["lag_histogram"] = [0] * (LAG_BUCKETS - 1) + [7]
    env = fleet.health_to_envelope(rep, shard=2, node=1)
    back = fleet.envelope_to_health(fleet.HealthSnapshot.decode(env.encode()))
    assert back["active"] == 7
    assert back["max_follower_lag"] == 42
    assert back["under_replicated"] == 3
    assert back["leaderless"] == 1
    assert back["skew"] == pytest.approx(2.5)
    assert back["rates"]["total_bps"] == pytest.approx(6.0)
    assert back["top_laggy"][0]["key"] == "kafka/x/0"
    assert back["top_laggy"][0]["shard"] == 2
    assert back["top_hot"][0]["shard"] == 2
    assert back["lag_histogram"][-1] == 7


# ------------------------------------------------- admin endpoint e2e


async def _partition_health_endpoint(tmp_path):
    from test_torch_ref_admin_server import cluster, http

    async with cluster(tmp_path, n=3) as brokers:
        b = brokers[0]
        from redpanda_tpu_torch.kafka.client import KafkaClient

        client = KafkaClient([x.kafka_advertised for x in brokers])
        try:
            await client.create_topic(
                "hp", partitions=2, replication_factor=3
            )
            for p in range(2):
                await client.produce("hp", p, [(None, b"x" * 64)] * 4)
        finally:
            await client.close()

        # produce traffic is accounted on the partition leader's
        # ledger — resolve it so the top_hot assertion can't miss
        deadline = asyncio.get_event_loop().time() + 5
        leader = None
        while asyncio.get_event_loop().time() < deadline:
            st, body = await http(
                b.admin.address, "GET", "/v1/partitions/kafka/hp/0"
            )
            if st == 200 and body["leader"] is not None:
                leader = body["leader"]
                break
            await asyncio.sleep(0.05)
        assert leader is not None
        ldr = next(x for x in brokers if x.node_id == leader)

        st, rep = await http(
            b.admin.address, "GET", "/v1/cluster/partition_health"
        )
        assert st == 200
        for key in ("active", "max_follower_lag", "under_replicated",
                    "leaderless", "skew", "shard_skew", "top_laggy",
                    "top_hot", "lag_histogram", "lag_bucket_edges",
                    "rates", "node_id", "shards"):
            assert key in rep, key
        assert rep["node_id"] == 0
        assert rep["active"] >= 2
        assert len(rep["lag_histogram"]) == LAG_BUCKETS
        # the produce traffic surfaced in the leader's ledger
        st, lrep = await http(
            ldr.admin.address, "GET", "/v1/cluster/partition_health"
        )
        assert st == 200
        assert any(
            r["key"].startswith("kafka/hp/") for r in lrep["top_hot"]
        ), lrep["top_hot"]
        # bad top_k rejected, clamped top_k honored
        st, _ = await http(
            b.admin.address, "GET", "/v1/cluster/partition_health?top_k=x"
        )
        assert st == 400
        st, rep1 = await http(
            b.admin.address, "GET", "/v1/cluster/partition_health?top_k=1"
        )
        assert st == 200 and len(rep1["top_hot"]) <= 1

        # enriched health_overview: old schema intact + live counts
        st, ov = await http(
            b.admin.address, "GET", "/v1/cluster/health_overview"
        )
        assert st == 200
        for key in ("controller_id", "all_nodes", "nodes_down",
                    "leaderless_partitions", "nodes",
                    "under_replicated_partitions", "max_follower_lag",
                    "active_partitions"):
            assert key in ov, key
        assert ov["all_nodes"] == [0, 1, 2]
        assert isinstance(ov["leaderless_partitions"], int)


@pytest.mark.timing
def test_partition_health_endpoint(tmp_path):
    asyncio.run(_partition_health_endpoint(tmp_path))


# --------------------------------------------------- nemesis lag e2e


@contextlib.asynccontextmanager
async def _net_cluster(tmp_path, n=3):
    """test_admin_server.cluster, with the LoopbackNetwork exposed so
    the test can install a nemesis schedule on the raft links."""
    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    net = LoopbackNetwork()
    members = list(range(n))
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
        await b.start()
    addrs = {b.node_id: b.kafka_advertised for b in brokers}
    for b in brokers:
        b.config.peer_kafka_addresses = addrs
    try:
        await brokers[0].wait_controller_leader()
        yield net, brokers
    finally:
        net.clear_nemesis()
        for b in brokers:
            await b.stop()


async def _nemesis_slow_follower(tmp_path):
    import redpanda_tpu_torch.raft.types as rt
    from test_torch_ref_admin_server import http

    async with _net_cluster(tmp_path) as (net, brokers):
        from redpanda_tpu_torch.kafka.client import KafkaClient
        from redpanda_tpu_torch.rpc import NemesisSchedule, NetRule

        client = KafkaClient([b.kafka_advertised for b in brokers])
        try:
            await client.create_topic(
                "lagt", partitions=1, replication_factor=3
            )
            # resolve the data partition's leader
            deadline = asyncio.get_event_loop().time() + 5
            leader = None
            while asyncio.get_event_loop().time() < deadline:
                st, body = await http(
                    brokers[0].admin.address, "GET",
                    "/v1/partitions/kafka/lagt/0",
                )
                if st == 200 and body["leader"] is not None:
                    leader = body["leader"]
                    break
                await asyncio.sleep(0.05)
            assert leader is not None
            follower = next(i for i in range(3) if i != leader)
            ldr = next(b for b in brokers if b.node_id == leader)

            # slow link: appends into `follower` crawl; heartbeats
            # stay clean so it remains a live follower and elections
            # never fire. acks=all still commits on the 2/3 quorum.
            net.install_nemesis(NemesisSchedule(rules=[
                NetRule(dst=follower, method=rt.APPEND_ENTRIES,
                        action="delay", delay_s=30.0, count=1 << 30),
                NetRule(dst=follower, method=rt.APPEND_ENTRIES_BATCH,
                        action="delay", delay_s=30.0, count=1 << 30),
            ]))
            for _ in range(4):
                await client.produce(
                    "lagt", 0, [(None, b"p" * 128)] * 8
                )

            # the health endpoint reads refreshed lanes on demand, so
            # the slow follower's lag is visible within one tick frame
            # of the produce — poll briefly only for scheduling slack
            deadline = asyncio.get_event_loop().time() + 3
            rep = None
            while asyncio.get_event_loop().time() < deadline:
                st, rep = await http(
                    ldr.admin.address, "GET",
                    "/v1/cluster/partition_health",
                )
                assert st == 200
                if rep["max_follower_lag"] > 0:
                    break
                await asyncio.sleep(0.05)
            assert rep is not None and rep["max_follower_lag"] > 0
            assert any(
                r["key"] == "kafka/lagt/0" for r in rep["top_laggy"]
            ), rep["top_laggy"]
            assert rep["under_replicated"] >= 1
        finally:
            with contextlib.suppress(Exception):
                await client.close()


@pytest.mark.timing
def test_nemesis_slow_follower_lag_reported(tmp_path):
    asyncio.run(_nemesis_slow_follower(tmp_path))
