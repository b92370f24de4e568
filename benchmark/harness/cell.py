"""A cell assembled from data alone: `BENCHMARK.json` at the root of the
checkout names the cell's configuration, traffic mix and metrics, and
each of those is a file of its own that this module finds by name:

    configs/<config>.json    (the path in BENCHMARK.json's `file`)
    traffic/<traffic>.json   a mix's parameters (harness/traffic.py MIX_KEYS)
    metrics/<metric>.py      a per-layer metric's reader: read(ctx)

Adding a cell, a mix or a metric adds files and entries; no code here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

from . import traffic

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict  # the run's parameters: traffic.plan(config, the mix file)
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, its files read."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    mix = traffic.plan(config, load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")))
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The `read(ctx)` of metrics/<metric>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
