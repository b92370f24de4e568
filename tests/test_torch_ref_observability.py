"""tests/test_observability.py run on the port: all 18 test functions,
with imports pointed at redpanda_tpu_torch. Every broker is the port's
on the CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`http` comes from `test_torch_ref_admin_server`. Nothing is left out.


Observability layer: Prometheus /metrics scrape shape, histogram
bucket semantics, and flight-recorder slow-request capture.

Reference test model: the reference asserts its probe wiring the same
way — scrape the endpoint and parse the exposition text (application.cc
/metrics), then drive load and check the latency families moved
(raft/probe.cc, kafka latency_probe.h). The flight recorder has no
reference twin (SURVEY §5.1); its tests pin the ring/freezer contract
directly and end-to-end under an injected NemesisNet delay.
"""

import asyncio
import contextlib
import json
import os
import re

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.metrics import _BOUNDS, HistogramChild, MetricsRegistry
from redpanda_tpu_torch.observability import trace
from redpanda_tpu_torch.observability.trace import FlightRecorder, span
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork, NemesisSchedule, NetRule
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

# the recorder tests exercise live span capture; under RP_TRACE=0 the
# whole layer is a no-op BY CONTRACT (verify.sh runs this module both
# ways — the /metrics tests must pass with tracing killed)
needs_trace = pytest.mark.skipif(
    not trace.ENABLED, reason="RP_TRACE=0: flight recorder disabled"
)

from test_torch_ref_admin_server import http  # shared minimal HTTP client


@contextlib.asynccontextmanager
async def cluster(tmp_path, n=3):
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
        for b in brokers:
            await b.stop()


# -- exposition-text parsing ------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$"
)


def parse_prometheus(text: str):
    """(types, samples): metric name -> TYPE, and a list of
    (name, labels_dict, float_value). Raises on malformed lines —
    the test doubles as an exposition-format lint."""
    types: dict[str, str] = {}
    samples: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"malformed exposition line: {line!r}"
        labels = {}
        if m.group(2):
            for part in re.findall(r'(\w+)="([^"]*)"', m.group(2)):
                labels[part[0]] = part[1]
        value = float("inf") if m.group(3) == "+Inf" else float(m.group(3))
        samples.append((m.group(1), labels, value))
    return types, samples


def _bucket_series(samples, family):
    """label-set (minus le) -> [(le_float, cum_count)] sorted by le."""
    out: dict[tuple, list[tuple[float, float]]] = {}
    for name, labels, value in samples:
        if name != family + "_bucket":
            continue
        le = labels["le"]
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        out.setdefault(key, []).append(
            (float("inf") if le == "+Inf" else float(le), value)
        )
    for series in out.values():
        series.sort(key=lambda p: p[0])
    return out


# -- /metrics end-to-end ----------------------------------------------


async def _scrape_after_load(tmp_path):
    """One /metrics text per broker. The kafka stage probe only moves
    on the broker that served the request, and partition leadership is
    election-order dependent — scraping every broker keeps the
    "histograms moved" assertions deterministic."""
    async with cluster(tmp_path) as (_net, brokers):
        client = KafkaClient([b.kafka_advertised for b in brokers])
        try:
            await client.create_topic("obs", partitions=2, replication_factor=3)
            for i in range(10):
                await client.produce("obs", i % 2, [(None, b"v%d" % i)])
            assert await client.fetch("obs", 0, 0) != []
        finally:
            await client.close()
        texts = []
        for b in brokers:
            st, text = await http(b.admin.address, "GET", "/metrics")
            assert st == 200
            texts.append(text.decode() if isinstance(text, bytes) else text)
        return texts


def test_metrics_scrape_parses_and_histograms_move(tmp_path):
    texts = asyncio.run(_scrape_after_load(tmp_path))
    types: dict = {}
    samples: list = []
    for text in texts:
        t, s = parse_prometheus(text)
        types.update(t)
        samples.extend(s)

    # the new probe families are present and typed histogram
    for family in (
        "redpanda_tpu_kafka_request_stage_seconds",
        "redpanda_tpu_raft_append_seconds",
        "redpanda_tpu_raft_commit_seconds",
        "redpanda_tpu_storage_segment_append_seconds",
        "redpanda_tpu_storage_flush_wait_seconds",
    ):
        assert types.get(family) == "histogram", family
        counts = [
            v for n, l, v in samples if n == family + "_count"
        ]
        assert counts and sum(counts) > 0, f"{family} never observed"

    # labeled kafka stage family: produce went through decode,
    # dispatch and done, with a concrete path label
    stage_labels = {
        (l.get("api"), l.get("stage"))
        for n, l, _ in samples
        if n == "redpanda_tpu_kafka_request_stage_seconds_count"
        and l.get("api") == "produce"
    }
    assert {"decode", "dispatch", "done"} <= {s for _, s in stage_labels}
    paths = {
        l.get("path")
        for n, l, _ in samples
        if n == "redpanda_tpu_kafka_request_stage_seconds_count"
    }
    assert paths <= {"native", "python"} and paths


def test_metrics_bucket_monotonicity(tmp_path):
    texts = asyncio.run(_scrape_after_load(tmp_path))
    checked = 0
    for text in texts:  # each registry is internally consistent
        types, samples = parse_prometheus(text)
        for family, kind in types.items():
            if kind != "histogram":
                continue
            series = _bucket_series(samples, family)
            for key, buckets in series.items():
                # cumulative counts never decrease, +Inf terminates
                cums = [c for _, c in buckets]
                assert cums == sorted(cums), (family, key)
                assert buckets[-1][0] == float("inf"), (family, key)
                # _count agrees with the +Inf bucket
                label_dict = dict(key)
                count = [
                    v
                    for n, l, v in samples
                    if n == family + "_count" and l == label_dict
                ]
                assert count == [buckets[-1][1]], (family, key)
                checked += 1
    assert checked > 0


# -- histogram unit semantics -----------------------------------------


def test_histogram_observe_bucket_placement():
    # each sample must land in the bucket whose (prev, bound] range
    # contains it — the octave arithmetic off-by-one regression test
    for s in (1e-5, 1e-3, 0.0017, 0.1, 1.0, 7.5):
        c = HistogramChild()
        c.observe(s)
        (i,) = [j for j, n in enumerate(c._buckets) if n]
        assert s <= _BOUNDS[i], (s, i)
        if i > 0:
            # lower edge is the previous bucket's bound (inclusive:
            # an exact power of two opens its octave's first bucket)
            assert s >= _BOUNDS[i - 1], (s, i)


def test_histogram_quantile_upper_bound_convention():
    # HdrHistogram convention: the quantile is the containing bucket's
    # upper bound, so observed <= quantile(1.0) always holds
    c = HistogramChild()
    samples = [0.0012, 0.0031, 0.0155, 0.0508]
    for s in samples:
        c.observe(s)
    assert c.quantile(1.0) >= max(samples)
    assert c.quantile(0.25) >= min(samples)
    # quantiles are monotone in q
    qs = [c.quantile(q) for q in (0.1, 0.5, 0.9, 0.99, 1.0)]
    assert qs == sorted(qs)


def test_histogram_labeled_children_merge():
    m = MetricsRegistry(prefix="t")
    h = m.histogram("lat_seconds", "x")
    h.labels(path="native").observe(0.001)
    h.labels(path="python").observe(0.004)
    snap = h.snapshot()
    assert snap["count"] == 2
    assert set(snap["series"]) == {'{path="native"}', '{path="python"}'}
    # render: one _bucket family per label set plus merged default
    out = "\n".join(h.render())
    assert 'path="native"' in out and 'path="python"' in out


# -- flight recorder: unit contract -----------------------------------


@needs_trace
def test_flight_recorder_ring_and_freezer():
    rec = FlightRecorder(ring_capacity=4, slow_ms=5.0, node_id=7)
    for i in range(6):
        with rec.span("req", idx=i):
            pass
    tail = rec.ring_tail()
    assert len(tail) == 4  # ring wrapped: only the last 4 trees
    assert rec.trees_total == 6
    assert rec.frozen() == []  # nothing crossed 5ms

    rec.slow_ns = 0  # everything is now "slow"
    with rec.span("slow-req") as root:
        with span("child", parent=root):
            pass
    frozen = rec.frozen()
    assert len(frozen) == 1 and rec.frozen_total == 1
    tree = frozen[0]
    assert tree["root"] == "slow-req"
    names = {s["name"] for s in tree["spans"]}
    assert names == {"slow-req", "child"}
    child = next(s for s in tree["spans"] if s["name"] == "child")
    root_span = next(s for s in tree["spans"] if s["name"] == "slow-req")
    assert child["parent"] == root_span["id"]


@needs_trace
def test_flight_recorder_dump_is_json_ready():
    rec = FlightRecorder(ring_capacity=2, slow_ms=1000.0)
    with rec.span("a", k="v"):
        pass
    rec.record_event("nemesis", action="delay", src=0, dst=1)
    dump = rec.dump()
    json.dumps(dump)  # must serialize as-is for /v1/debug/traces
    assert dump["trees_total"] == 1
    assert [e["name"] for e in dump["events"]] == ["nemesis"]


# -- flight recorder: slow capture under injected delay ---------------


async def _slow_capture(tmp_path):
    async with cluster(tmp_path) as (net, brokers):
        client = KafkaClient([b.kafka_advertised for b in brokers])
        try:
            await client.create_topic("slow", partitions=1, replication_factor=3)
            await client.produce("slow", 0, [(None, b"warm")])

            # freeze anything over 20ms, then make raft RPC slow enough
            # that an acks=-1 produce must cross the threshold
            for b in brokers:
                b.recorder.slow_ns = int(20e6)
            net.install_nemesis(
                NemesisSchedule(
                    rules=[NetRule(action="delay", delay_s=0.05, count=200)],
                    seed=3,
                )
            )
            await client.produce("slow", 0, [(None, b"slowed")])
            net.clear_nemesis()
        finally:
            await client.close()

        # one of the brokers (the partition leader) froze the produce
        dumps = []
        for b in brokers:
            st, body = await http(
                b.admin.address, "GET", "/v1/debug/traces?tail=10"
            )
            assert st == 200
            dumps.append(body)
        return dumps


@needs_trace
def test_debug_traces_freezes_slow_produce(tmp_path):
    dumps = asyncio.run(_slow_capture(tmp_path))
    frozen = [t for d in dumps for t in d["frozen"]]
    produce_trees = [t for t in frozen if t["root"] == "kafka.produce"]
    assert produce_trees, "no slow produce tree frozen by any broker"
    tree = produce_trees[-1]
    assert tree["dur_ns"] >= 20e6
    names = {s["name"] for s in tree["spans"]}
    assert "kafka.produce" in names
    # the nemesis firing is visible in the fault-event log
    events = [e for d in dumps for e in d["events"]]
    assert any(e["name"] == "nemesis" for e in events)
    # ring tail always returns trees, frozen or not
    assert any(d["ring"] for d in dumps)


@needs_trace
def test_log_viewer_renders_trace_dump(tmp_path):
    import io

    from tools.log_viewer import dump_traces

    rec = FlightRecorder(ring_capacity=4, slow_ms=0.0)
    with rec.span("kafka.produce", path="native") as root:
        with span("produce.dispatch", parent=root):
            pass
    path = tmp_path / "traces.json"
    path.write_text(json.dumps(rec.dump()))
    buf = io.StringIO()
    dump_traces(str(path), out=buf)
    text = buf.getvalue()
    assert "kafka.produce" in text and "produce.dispatch" in text
    assert "[SLOW]" in text  # slow_ms=0 froze it
    # aligned waterfall: every span row carries a bar column
    rows = [ln for ln in text.splitlines() if "|" in ln]
    assert len(rows) >= 2
    assert len({ln.index("|") for ln in rows}) == 1


# -- fleet plane: snapshots, merged scrape, stitched traces ------------


def _loaded_registry(shard_tag: str) -> MetricsRegistry:
    reg = MetricsRegistry()
    c = reg.counter("fleet_reqs_total", "requests")
    c.inc(3, api="produce")
    c.inc(1, api="fetch")
    reg.counter("fleet_idle_total", "never incremented")
    reg.gauge("fleet_depth", lambda: 7.0, "queue depth")
    h = reg.histogram("fleet_lat_seconds", "latency")
    h.labels(path=shard_tag).observe(0.002)
    h.labels(path=shard_tag).observe(0.04)
    return reg


def test_fleet_snapshot_serde_round_trip():
    from redpanda_tpu_torch.observability import fleet

    reg = _loaded_registry("a")
    snap = fleet.snapshot_registry(reg, shard=1, node=0)
    back = fleet.RegistrySnapshot.decode(snap.encode())
    assert back.shard == 1 and back.node == 0
    # the decoded snapshot renders byte-identically to the original
    assert fleet.render_snapshot(back) == fleet.render_snapshot(snap)
    # an empty counter still ships a zero sample (shard visibility)
    idle = next(
        f for f in back.families
        if f.name == "redpanda_tpu_fleet_idle_total"
    )
    assert [(dict(s.labels), s.value) for s in idle.samples] == [({}, 0.0)]
    # histograms ship raw buckets, not quantiles
    hist = next(
        h for h in back.hists if h.name == "redpanda_tpu_fleet_lat_seconds"
    )
    assert sum(hist.series[0].buckets) == hist.series[0].count == 2


def test_fleet_render_labels_every_sample_with_shard():
    from redpanda_tpu_torch.observability import fleet

    snaps = [
        fleet.snapshot_registry(_loaded_registry("x"), shard=0, node=0),
        fleet.snapshot_registry(_loaded_registry("y"), shard=1, node=0),
    ]
    text = fleet.render_fleet(snaps)
    types, samples = parse_prometheus(text)
    assert samples
    for name, labels, _value in samples:
        assert "shard" in labels, name
    shards = {l["shard"] for _n, l, _v in samples}
    assert shards == {"0", "1"}
    # HELP/TYPE once per family even though both shards carry it
    assert text.count("# TYPE redpanda_tpu_fleet_reqs_total counter") == 1
    # exposition stays parseable/monotone through the fleet merge path
    series = _bucket_series(samples, "redpanda_tpu_fleet_lat_seconds")
    assert len(series) == 2  # one per (path, shard)
    for _key, buckets in series.items():
        cums = [cnt for _le, cnt in buckets]
        assert cums == sorted(cums)


def test_fleet_merged_hist_equals_direct_merge():
    from redpanda_tpu_torch.observability import fleet

    regs = [MetricsRegistry(), MetricsRegistry()]
    direct = HistogramChild()
    vals = [0.0011, 0.003, 0.0092, 0.017, 0.25, 0.0007, 0.08]
    for i, v in enumerate(vals):
        h = regs[i % 2].histogram("m_lat_seconds", "x")
        h.labels(path="p%d" % (i % 3)).observe(v)
        direct.observe(v)
    snaps = [
        fleet.snapshot_registry(r, shard=i) for i, r in enumerate(regs)
    ]
    merged = fleet.merged_hist(snaps, "redpanda_tpu_m_lat_seconds")
    assert merged is not None and merged._count == len(vals)
    for q in (0.5, 0.9, 0.99, 0.999):
        assert merged.quantile(q) == direct.quantile(q)
    assert fleet.merged_hist(snaps, "redpanda_tpu_nope") is None


@needs_trace
def test_trace_dump_envelope_round_trip():
    from redpanda_tpu_torch.observability import fleet

    rec = FlightRecorder(ring_capacity=4, slow_ms=0.0, node_id=3, shard=2)
    with rec.span("kafka.produce", topic="t") as root:
        with span("raft.append", parent=root):
            pass
    rec.record_event("nemesis", action="delay")
    dump = rec.dump()
    td = fleet.dump_to_envelope(dump)
    back = fleet.envelope_to_dump(fleet.TraceDump.decode(td.encode()))
    assert back["node_id"] == 3 and back["shard"] == 2
    assert back["trees_total"] == dump["trees_total"]
    # slow_ms=0 froze the tree: the frozen/ring split survives the wire
    assert len(back["frozen"]) == 1 and len(back["ring"]) == 1
    spans = {s["name"]: s for s in back["ring"][0]["spans"]}
    assert set(spans) == {"kafka.produce", "raft.append"}
    assert spans["raft.append"]["parent"] == spans["kafka.produce"]["id"]
    assert spans["kafka.produce"]["tags"] == {"topic": "t"}
    assert [e["name"] for e in back["events"]] == ["nemesis"]
    json.dumps(back)  # /v1/debug/traces ships it as-is


@needs_trace
def test_stitch_trees_merges_cross_process_parts():
    import contextvars

    from redpanda_tpu_torch.observability import fleet

    r0 = FlightRecorder(node_id=0, shard=0)
    r1 = FlightRecorder(node_id=0, shard=1)

    def remote_side(tid, sid):
        # an empty Context stands in for the worker process
        tok = trace.set_remote_parent(tid, sid, "shard0")
        try:
            with trace.span("ssx.dispatch", recorder=r1):
                with trace.span("raft.append", recorder=r1):
                    pass
        finally:
            trace.reset_remote_parent(tok)

    with trace.span("kafka.produce", recorder=r0):
        with trace.span("shard.forward", recorder=r0):
            tid, sid = trace.propagation_ctx()
            contextvars.Context().run(remote_side, tid, sid)

    trees = r0.dump()["ring"] + r1.dump()["ring"]
    stitched = fleet.stitch_trees(trees)
    assert len(stitched) == 1
    tree = stitched[0]
    assert tree["stitched"] and tree["parts"] == 2
    assert tree["root"] == "kafka.produce" and not tree["orphaned"]
    assert tree["shards"] == [0, 1]
    by_name = {s["name"]: s for s in tree["spans"]}
    assert by_name["raft.append"]["shard"] == 1
    assert by_name["kafka.produce"]["shard"] == 0
    # the continuation root resolves its parent inside the merged tree
    assert by_name["ssx.dispatch"]["parent"] == by_name["shard.forward"]["id"]
    assert by_name["ssx.dispatch"]["origin"] == "shard0"
    # single-part groups never stitch; trace_id 0 never groups
    assert fleet.stitch_trees(r0.dump()["ring"]) == []
    json.dumps(stitched)


async def _two_shard_fleet(tmp_path):
    from redpanda_tpu_torch.ssx.sharded_broker import ShardedBroker

    cfg = BrokerConfig(
        device="cpu",
        node_id=0,
        data_dir=str(tmp_path / "n0"),
        members=[0],
        election_timeout_s=0.3,
        heartbeat_interval_s=0.05,
        enable_admin=True,
    )
    sb = ShardedBroker(cfg, n_shards=2)
    await sb.start()
    try:
        assert sb.active, f"unexpected stand-down: {sb.standdown}"
        c = KafkaClient([("127.0.0.1", sb.kafka_port)])
        try:
            deadline = asyncio.get_event_loop().time() + 30.0

            async def retry(fn):
                while True:
                    try:
                        return await fn()
                    except Exception:
                        if asyncio.get_event_loop().time() > deadline:
                            raise
                        await asyncio.sleep(0.2)

            await retry(
                lambda: c.create_topic("f", partitions=4, replication_factor=1)
            )
            while not sb.broker.shard_table.counts().get(1, 0):
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError("no partitions routed to shard 1")
                await asyncio.sleep(0.1)
            for p in range(4):
                await retry(
                    lambda p=p: c.produce("f", p, [(b"k", b"v%d" % p)])
                )
        finally:
            await c.close()

        addr = sb.broker.admin.address
        st, metrics_text = await http(addr, "GET", "/metrics")
        assert st == 200
        st, shard1_text = await http(addr, "GET", "/v1/shards/1/metrics")
        assert st == 200
        st404, _ = await http(addr, "GET", "/v1/shards/9/metrics")
        st_probes, probes = await http(addr, "GET", "/v1/debug/probes")
        assert st_probes == 200
        st_traces, traces = await http(addr, "GET", "/v1/debug/traces")
        assert st_traces == 200
        return metrics_text, shard1_text, st404, probes, traces
    finally:
        await sb.stop()


def test_two_shard_fleet_scrape_and_stitched_traces(tmp_path):
    """ISSUE 6 acceptance: under 2 shards, one /metrics scrape at shard
    0 returns merged samples with a `shard` label for every shard, the
    per-shard raw view serves, probes report liveness, and (tracing on)
    a forwarded produce stitches into one tree spanning 2 processes."""
    metrics_text, shard1_text, st404, probes, traces = asyncio.run(
        _two_shard_fleet(tmp_path)
    )
    if isinstance(metrics_text, bytes):
        metrics_text = metrics_text.decode()
    if isinstance(shard1_text, bytes):
        shard1_text = shard1_text.decode()

    _types, samples = parse_prometheus(metrics_text)
    shards_seen = {l.get("shard") for _n, l, _v in samples}
    assert {"0", "1"} <= shards_seen
    for _name, labels, _v in samples:
        assert "shard" in labels
    # the worker's kafka stage histogram is part of the merged view
    # only when its frontend took connections; its raft/storage
    # families always are
    worker_families = {
        n for n, l, _v in samples if l.get("shard") == "1"
    }
    assert any("raft" in n or "storage" in n for n in worker_families)

    # raw per-shard view: no shard label, families present
    _t1, s1_samples = parse_prometheus(shard1_text)
    assert s1_samples
    assert all("shard" not in l for _n, l, _v in s1_samples)
    assert st404 == 404

    # probes liveness block
    sh = probes["shards"]
    assert sh["n_shards"] == 2
    assert "1" in {str(k) for k in sh["alive"]}
    assert sh["failed"] is False

    # stitched cross-process produce (tracing on only)
    assert "node_id" in traces and "ring" in traces  # pre-PR6 keys stay
    if trace.ENABLED:
        assert str(1) in {str(k) for k in traces["shards"]}
        stitched = traces["stitched"]
        multi = [t for t in stitched if len(t.get("shards", [])) >= 2]
        assert multi, f"no stitched multi-process tree: {stitched!r}"
        spans = multi[-1]["spans"]
        assert {s.get("shard") for s in spans} >= {0, 1}


def test_cloud_probe_families_move_under_tiered_load(tmp_path):
    """The tiered read path's /metrics surface: drive produce ->
    archive -> evict -> cold fetch (with one injected transient store
    error so the retry counter moves) and require the cloud families
    to show up typed and non-zero."""
    from redpanda_tpu_torch.cloud import (
        MemoryObjectStore,
        NemesisObjectStore,
        StoreFaultSchedule,
        StoreRule,
    )

    async def main():
        nem = NemesisObjectStore(MemoryObjectStore())
        b = Broker(
            BrokerConfig(
                device="cpu",
                node_id=0,
                data_dir=str(tmp_path / "n0"),
                members=[0],
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                housekeeping_interval_s=0,
                archival_interval_s=0,
            ),
            loopback=LoopbackNetwork(),
            object_store=nem,
        )
        await b.start()
        b.config.peer_kafka_addresses = {0: b.kafka_advertised}
        try:
            await b.wait_controller_leader()
            client = KafkaClient([b.kafka_advertised])
            await client.create_topic(
                "ct",
                partitions=1,
                replication_factor=1,
                configs={
                    "redpanda.remote.write": "true",
                    "redpanda.remote.read": "true",
                    "segment.bytes": "400",
                    "retention.bytes": "400",
                },
            )
            for i in range(12):
                await client.produce("ct", 0, [(b"k%d" % i, b"v%d" % i)])
            from redpanda_tpu_torch.models.fundamental import kafka_ntp

            p = b.partition_manager.get(kafka_ntp("ct", 0))
            p.log.flush()
            await b.archival.run_once()
            b.storage.log_mgr.housekeeping()
            # one transient range-read error: the RetryingStore retry
            # loop fires on_retry -> the counter must move
            nem.install(
                StoreFaultSchedule(
                    rules=[StoreRule(op="get_range", action="error", count=1)],
                    seed=11,
                )
            )
            got = await client.fetch("ct", 0, 0, max_bytes=1 << 22)
            assert len(got) == 12
            await client.close()

            st, text = await http(b.admin.address, "GET", "/metrics")
            assert st == 200
            types, samples = parse_prometheus(
                text.decode() if isinstance(text, bytes) else text
            )
            assert types.get("redpanda_tpu_cloud_read_seconds") == "histogram"
            cold = [
                v
                for n, l, v in samples
                if n == "redpanda_tpu_cloud_read_seconds_count"
                and l.get("path") == "cold"
            ]
            assert cold and sum(cold) > 0, "cold read never observed"
            retries = [
                v
                for n, l, v in samples
                if n == "redpanda_tpu_cloud_op_retries_total"
            ]
            assert retries and sum(retries) > 0, "retry counter never moved"
            hyd = [
                v
                for n, _l, v in samples
                if n == "redpanda_tpu_cloud_hydrations_total"
            ]
            assert hyd and hyd[0] > 0
            for fam in (
                "redpanda_tpu_cloud_cache_bytes",
                "redpanda_tpu_cloud_cache_hits_total",
                "redpanda_tpu_cloud_cache_misses_total",
                "redpanda_tpu_cloud_degradation_events_total",
            ):
                assert fam in types, f"{fam} missing from /metrics"
        finally:
            await b.stop()

    asyncio.run(main())


# -- fork hygiene (PR-17 shard re-fork seam) ---------------------------
#
# spawn_shard (and the per-shard crash-restart respawn) forks the
# broker process; the span-id counter and the module-default recorder
# are copied by fork, so without _after_fork_child a child's stitched
# spans could collide with the parent's ids and its /v1/debug/traces
# would serve the parent's inherited trees as its own. The hook is
# registered via os.register_at_fork, so any fork — multiprocessing
# included — must come up clean.


def _fork_probe(q):
    r = trace._default_recorder
    inherited = {
        "trees_total": r.trees_total,
        "frozen": len(r._frozen),
        "ring": sum(1 for t in r._ring if t is not None),
        "events": len(r._events),
    }
    ids = []
    for _ in range(3):
        with span("child.work") as s:
            ids.append(s.span_id)
    q.put(
        {
            "pid": os.getpid(),
            "inherited": inherited,
            "ids": ids,
            "trees_after": r.trees_total,
        }
    )


@needs_trace
def test_fork_child_drops_inherited_trees_and_reseeds_ids():
    import multiprocessing as mp

    if not hasattr(os, "register_at_fork"):
        pytest.skip("platform without register_at_fork")
    with span("parent.seed"):
        pass
    with span("parent.marker") as s:
        parent_id = s.span_id
    assert trace._default_recorder.trees_total >= 2

    ctx = mp.get_context("fork")
    q = ctx.SimpleQueue()
    p = ctx.Process(target=_fork_probe, args=(q,))
    p.start()
    out = q.get()
    p.join(10)
    assert p.exitcode == 0

    # the child saw NONE of the parent's trees/events at startup
    assert out["inherited"] == {
        "trees_total": 0, "frozen": 0, "ring": 0, "events": 0,
    }
    # ...but its own recorder works: 3 fresh root trees recorded
    assert out["trees_after"] == 3
    # ids reseeded into the pid-disjoint range: (pid & 0x3FFFFF) << 40
    base = (out["pid"] & 0x3FFFFF) << 40
    for sid in out["ids"]:
        assert base < sid < base + (1 << 40), (hex(sid), hex(base))
    # and therefore cannot collide with the parent's counter
    assert parent_id not in out["ids"]


@needs_trace
def test_refork_children_span_ids_pairwise_disjoint():
    """Two successive forks (the crash-restart respawn shape): each
    child's id space is keyed on its OWN pid, so stitched trees
    collected from parent + both generations never collide."""
    import multiprocessing as mp

    if not hasattr(os, "register_at_fork"):
        pytest.skip("platform without register_at_fork")
    ctx = mp.get_context("fork")
    outs = []
    for _ in range(2):  # second fork = the respawned shard
        q = ctx.SimpleQueue()
        p = ctx.Process(target=_fork_probe, args=(q,))
        p.start()
        outs.append(q.get())
        p.join(10)
        assert p.exitcode == 0
    with span("parent.after") as s:
        parent_id = s.span_id

    a, b = (set(o["ids"]) for o in outs)
    assert outs[0]["pid"] != outs[1]["pid"]
    assert not a & b, "re-forked shard reused span ids"
    assert parent_id not in a | b
    # the parent counter stays in the low range (seeded at 1), the
    # children in their pid-shifted ranges — three disjoint id planes
    assert parent_id < (1 << 40)
