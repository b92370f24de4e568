"""Cells assembled from data alone: BENCHMARK.json's names find their
configuration, traffic and metric files, and the file keeps to the
benchmark's contract."""

from __future__ import annotations

import json
import os
import re

import pytest

from harness import cell, traffic, wire

ROOT = cell.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = cell.load(name)
    assert c.chips == 1
    assert {"brokers", "replication_factor", "partitions", "topic", "topic_configs", "env"} <= set(c.config)
    assert c.config["replication_factor"] == 3 and c.config["acks"] == -1 == c.mix["acks"]
    assert (c.mix["producers"], c.mix["consumers"], c.mix["record_bytes"]) == (16, 8, 1024)
    assert c.config["topic_configs"]["compression.type"] in wire.CODECS
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(cell.reader(m["name"]))
    # the mix's batches: same sizes for every seed, under the fused path's 64 KiB
    per = c.mix["records_per_batch"]
    a = traffic.pool({**c.mix, "pool_batches": 2}, 1, wire_batches=False)
    b = traffic.pool({**c.mix, "pool_batches": 2}, 2**40 + 3, wire_batches=False)
    assert [len(x["section"]) for x in a] == [len(x["section"]) for x in b]
    assert all(len(x["records"]) == per and len(x["section"]) <= 65536 for x in a)


@pytest.mark.parametrize("key,value", [("acks", 1), ("producers", 1), ("consumers", 0), ("record_bytes", 10),
                                       ("check_sample", 0), ("drain_s", 1)])
def test_a_mix_sets_only_rate_batch_and_codec(key, value):
    """What the deployment states (acks, clients, message size) and the
    harness's own constants come from their files alone: a mix that
    sets one is refused, not obeyed."""
    for name in os.listdir(os.path.join(cell.BENCH_DIR, "traffic")):
        with open(os.path.join(cell.BENCH_DIR, "traffic", name)) as f:
            assert set(json.load(f)) <= traffic.MIX_KEYS, name
    config = cell.load(CELLS[0]).config
    mix = {"name": "bad", "batches_per_s": 1, "records_per_batch": 1, "producer_codec": "none", key: value}
    with pytest.raises(ValueError, match=key):
        traffic.plan(config, mix)


def test_a_cell_is_data_alone(tmp_path):
    """A new cell, mix and metric are new files and entries: nothing of
    the harness changes."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "lz4-new", "config": "omb-100p-lz4-rf3", "traffic": "steady",
                               "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    c = cell.load("lz4-new", root=str(tmp_path))
    assert c.config["name"] == "omb-100p-lz4-rf3" and c.mix["name"] == "steady"


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/") and len(c["source"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert sorted(conf["reduced"]) == sorted(c["reduced"]) and all(NAME.match(k) for k in c["reduced"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
