"""The brokers' event loop on the record: the loop monitor's busy and
stall histograms (resource_mgmt.LoopMonitor), the loop sections of
observability/trace.section (histogram child, leaf span, profiler
range), the process-wide families counted once across three brokers,
the `gc` section, the follower's native append under its section, and
a long-poll fetch's pass count.

Brokers run on the CPU (`BrokerConfig(device="cpu")`, the kernels'
plain versions), as in test_torch_ref_kafka_e2e.py, whose cluster
fixture this file uses.
"""

import asyncio
import gc
import os
import sys
import time

import pytest
import torch

from redpanda_tpu_torch.metrics import MetricsRegistry
from redpanda_tpu_torch.observability import trace
from redpanda_tpu_torch.ops import default_device
from redpanda_tpu_torch.raft.consensus import Consensus
from redpanda_tpu_torch.utils import native as native_mod

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_ref_kafka_e2e import broker_cluster, client_for  # noqa: E402

FAMILY = "redpanda_tpu_" + trace.SECTION_FAMILY


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _per_registry(brokers, family, **labels):
    """[(sum, count)] of `family`'s matching series, one a broker."""
    out = []
    for b in brokers:
        s = n = 0
        h = b.metrics.histograms().get("redpanda_tpu_" + family)
        if h is not None:
            for lab, child in h.series():
                if all(lab.get(k) == v for k, v in labels.items()):
                    _, _, cs, cn = child.counts()
                    s, n = s + cs, n + cn
        out.append((s, n))
    return out


def _gained(before, after):
    """(sum, count) gained over every registry, and the count by registry."""
    by = [a[1] - b[1] for a, b in zip(after, before)]
    return sum(a[0] - b[0] for a, b in zip(after, before)), sum(by), by


class _Spy:
    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __call__(self, name, *a, **k):
        self.calls.append(name)
        return self.inner(name, *a, **k)


def test_section_observes_its_child_once_per_entry_and_opens_no_range_unprofiled(monkeypatch):
    spy = _Spy(torch.autograd.profiler.record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    reg = MetricsRegistry()
    for _ in range(3):
        with trace.section("recompress", reg):
            time.sleep(0.002)
    with trace.section("fetch_read", reg):
        pass
    child = reg.histograms()[FAMILY].labels(section="recompress")
    _, _, total, count = child.counts()
    assert count == 3 and total >= 0.006
    assert reg.histograms()[FAMILY].labels(section="fetch_read").counts()[3] == 1
    assert spy.calls == []
    with trace.section("recompress", None):  # no registry: nothing observed
        pass
    assert child.counts()[3] == 3


def test_section_lies_on_the_profiler_timeline_around_its_ops():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reg = MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.section("recompress", reg):
            x = torch.ones(512)
            y = x + 1
    assert float(y[0]) == 2.0
    ev = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in ("recompress", "aten::add"):
            ev[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    assert set(ev) == {"recompress", "aten::add"}
    (s0, e0), (s1, e1) = ev["recompress"], ev["aten::add"]
    assert s0 <= s1 and e1 <= e0
    assert reg.histograms()[FAMILY].labels(section="recompress").counts()[3] == 1


def test_section_is_a_leaf_span_of_the_open_request_tree(monkeypatch):
    monkeypatch.setattr(trace, "ENABLED", True)
    rec = trace.FlightRecorder()
    with rec.span("kafka.fetch"):
        with trace.section("fetch_read", None, span=False):
            pass
        with trace.section("fetch_verify", None):
            pass
        trace.tag_current(polls=1)
    with trace.section("recompress", None):  # no request open: no tree
        pass
    (tree,) = rec.ring_tail()
    names = {s["name"]: s for s in tree["spans"]}
    assert set(names) == {"kafka.fetch", "fetch_verify"}
    assert names["fetch_verify"]["parent"] == names["kafka.fetch"]["id"]
    assert names["fetch_verify"]["dur_ns"] >= 0
    assert names["kafka.fetch"]["tags"] == {"polls": 1}


def test_a_60ms_block_is_one_stall_across_three_brokers(tmp_path):
    async def go():
        async with broker_cluster(tmp_path, 3) as brokers:
            loop = asyncio.get_running_loop()
            stall0 = _per_registry(brokers, "reactor_stall_seconds")
            busy0 = _per_registry(brokers, "reactor_busy_seconds")
            loop.call_soon(time.sleep, 0.06)
            # a timer: the blocked iteration ends at the next select,
            # which records it; this task resumes one iteration later
            await asyncio.sleep(0.001)
            stall1 = _per_registry(brokers, "reactor_stall_seconds")
            busy1 = _per_registry(brokers, "reactor_busy_seconds")
            return stall0, stall1, busy0, busy1

    stall0, stall1, busy0, busy1 = asyncio.run(go())
    s, n, by = _gained(stall0, stall1)
    assert n == 1 and s >= 0.06
    assert sorted(by) == [0, 0, 1]
    s, n, by = _gained(busy0, busy1)
    assert s >= 0.06 and n >= 1
    # the families live in one registry: each iteration counted once
    assert sum(1 for _, c in busy1 if c) == 1


def test_a_forced_collection_is_one_gc_section_across_three_brokers(tmp_path):
    async def go():
        async with broker_cluster(tmp_path, 3) as brokers:
            before = _per_registry(brokers, trace.SECTION_FAMILY, section="gc")
            gc.collect()
            after = _per_registry(brokers, trace.SECTION_FAMILY, section="gc")
            return before, after

    before, after = asyncio.run(go())
    s, n, by = _gained(before, after)
    assert n == 1 and s > 0
    assert sorted(by) == [0, 0, 1]


def test_follower_append_takes_the_native_route(tmp_path, monkeypatch):
    if native_mod.load() is None:
        pytest.skip("native toolchain unavailable")
    served = []
    inner = Consensus.native_append_frame

    def spy(self, payload):
        out = inner(self, payload)
        served.append(out is not None)
        return out

    monkeypatch.setattr(Consensus, "native_append_frame", spy)

    async def go():
        async with broker_cluster(tmp_path, 3) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("t", partitions=1, replication_factor=3)
                before = _per_registry(brokers, trace.SECTION_FAMILY, section="log_append")
                for i in range(5):
                    await client.produce("t", 0, [(b"k", b"v%d" % i)], acks=-1)
                after = _per_registry(brokers, trace.SECTION_FAMILY, section="log_append")
                return before, after

    before, after = asyncio.run(go())
    assert any(served)
    _, n, by = _gained(before, after)
    # the leader's appends and its two followers' each count
    assert n >= 5 and sum(1 for c in by if c) == 3


def test_a_long_poll_fetch_records_its_passes(tmp_path):
    async def go():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("t", partitions=1, replication_factor=1)
                before = _per_registry(brokers, "kafka_fetch_polls")
                got = await client.fetch("t", 0, 0, max_wait_ms=100, min_bytes=1)
                after = _per_registry(brokers, "kafka_fetch_polls")
                return got, before, after, brokers[0].recorder.ring_tail()

    got, before, after, ring = asyncio.run(go())
    assert got == []
    polls, fetches, _ = _gained(before, after)
    assert fetches >= 1 and polls > fetches
    roots = [s for t in ring if t["root"] == "kafka.fetch" for s in t["spans"] if s["name"] == "kafka.fetch"]
    if trace.ENABLED:
        assert max(r["tags"]["polls"] for r in roots) >= 2
        assert not any(s["name"] == "fetch_read" for t in ring for s in t["spans"])


def test_the_loop_monitor_leaves_out_the_profilers_start_and_unhooks():
    from torch.profiler import ProfilerActivity, profile

    from redpanda_tpu_torch.resource_mgmt import LoopMonitor

    reg = MetricsRegistry()
    mon = LoopMonitor()
    mon.bind(reg)
    loop = asyncio.new_event_loop()
    mon.hook(loop)
    stall = reg.histograms()["redpanda_tpu_reactor_stall_seconds"]
    prof = profile(activities=[ProfilerActivity.CPU])

    async def go():
        await asyncio.sleep(0.001)
        seen = [stall._merged().counts()[3]]
        time.sleep(0.03)  # a stall the monitor counts
        await asyncio.sleep(0.001)
        seen.append(stall._merged().counts()[3])
        prof.start()  # the profiler's start in a long iteration: left out
        time.sleep(0.03)
        await asyncio.sleep(0.001)
        seen.append(stall._merged().counts()[3])
        prof.stop()
        await asyncio.sleep(0.001)
        return seen

    try:
        seen = loop.run_until_complete(go())
        assert seen[1] == seen[0] + 1 and seen[2] == seen[1]
        assert "select" in vars(loop._selector)
        mon.unhook()
        assert "select" not in vars(loop._selector)
    finally:
        loop.close()
