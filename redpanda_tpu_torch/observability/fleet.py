"""Fleet observability plane: cross-shard metric snapshots + trace stitching.

PR 5 made the broker multi-process (ssx shard-per-core runtime) but the
metrics registry and flight recorder are per-process — a `/metrics`
scrape at shard 0 used to describe only the parent. This module is the
wire protocol and merge logic that closes that gap, modeled on the
reference's `metrics_reporter` aggregated-stats path:

  * `RegistrySnapshot` — a serde envelope capturing every Counter /
    Gauge / Histogram of one shard's registry (gauges are sampled at
    snapshot time; histograms ship their raw bucket arrays so quantiles
    merge exactly, not approximately). Workers serve it over the
    `invoke_on` "obs" service; shard 0 renders the union with a `shard`
    label injected on every sample (`render_fleet`).
  * `TraceDump` — the flight-recorder dump as an envelope, so worker
    rings/freezers reach `/v1/debug/traces`. `stitch_trees` groups
    trees from all shards by the propagated `trace_id` and merges their
    spans into one tree per trace — a produce that enters shard 1,
    forwards raw frames to shard 2, and replicates over TcpTransport
    renders as a single span tree with per-span shard/node provenance.

All payloads are serde envelopes (rplint RPL009: nothing pickled
crosses the shard boundary)."""

from __future__ import annotations

from typing import Optional

from ..metrics import (
    Counter,
    Gauge,
    Histogram,
    HistogramChild,
    MetricsRegistry,
    _fmt_labels,
)
from ..utils.serde import (
    Envelope,
    boolean,
    envelope,
    f64,
    i32,
    i64,
    mapping,
    string,
    u8,
    u64,
    vector,
)
from . import health

# SampleFamily.kind
KIND_COUNTER = 0
KIND_GAUGE = 1


class MetricSample(Envelope):
    SERDE_FIELDS = [
        ("labels", mapping(string, string)),
        ("value", f64),
    ]


class SampleFamily(Envelope):
    """One counter or gauge family: point-in-time (labels, value) rows."""

    SERDE_FIELDS = [
        ("name", string),
        ("kind", u8),
        ("help", string),
        ("samples", vector(envelope(MetricSample))),
    ]


class HistSeries(Envelope):
    """One labeled histogram series with its raw bucket counts — shipping
    buckets (not quantiles) is what makes the fleet merge exact."""

    SERDE_FIELDS = [
        ("labels", mapping(string, string)),
        ("buckets", vector(u64)),
        ("overflow", u64),
        ("sum", f64),
        ("count", u64),
    ]

    def to_child(self) -> HistogramChild:
        return HistogramChild.from_counts(
            self.buckets, self.overflow, self.sum, self.count
        )


class HistFamily(Envelope):
    SERDE_FIELDS = [
        ("name", string),
        ("help", string),
        ("series", vector(envelope(HistSeries))),
    ]


class RegistrySnapshot(Envelope):
    SERDE_FIELDS = [
        ("shard", i32),
        ("node", i32),
        ("families", vector(envelope(SampleFamily))),
        ("hists", vector(envelope(HistFamily))),
    ]


class LaggyRow(Envelope):
    """One top-k laggy partition sample (bounded by k, never per-NTP)."""

    SERDE_FIELDS = [
        ("key", string),
        ("group", i64),
        ("lag", i64),
        ("under", boolean),
    ]


class HotRow(Envelope):
    """One top-k hot partition sample from the load ledger."""

    SERDE_FIELDS = [
        ("key", string),
        ("total_bps", f64),
        ("produce_bps", f64),
        ("fetch_bps", f64),
        ("append_bps", f64),
    ]


class HealthSnapshot(Envelope):
    """One shard's partition-health report on the wire: aggregate
    counts, per-kind byte rates, top-k rows and the fixed-width lag
    distribution (observability/health.py builds and merges these)."""

    SERDE_FIELDS = [
        ("shard", i32),
        ("node", i32),
        ("active", u64),
        ("max_lag", i64),
        ("under_replicated", u64),
        ("leaderless", u64),
        ("skew", f64),
        ("produce_bps", f64),
        ("fetch_bps", f64),
        ("append_bps", f64),
        ("total_bps", f64),
        ("top_laggy", vector(envelope(LaggyRow))),
        ("top_hot", vector(envelope(HotRow))),
        ("lag_hist", vector(u64)),
        # read-path cache counters in health.READ_PATH_KEYS order
        ("read_path", vector(u64)),
    ]


def health_to_envelope(rep: dict, shard: int, node: int = -1) -> HealthSnapshot:
    """observability.health report dict -> wire envelope."""
    rates = rep.get("rates") or {}
    return HealthSnapshot(
        shard=shard,
        node=node,
        active=rep.get("active", 0),
        max_lag=rep.get("max_follower_lag", 0),
        under_replicated=rep.get("under_replicated", 0),
        leaderless=rep.get("leaderless", 0),
        skew=rep.get("skew", 1.0),
        produce_bps=rates.get("produce_bps", 0.0),
        fetch_bps=rates.get("fetch_bps", 0.0),
        append_bps=rates.get("append_bps", 0.0),
        total_bps=rates.get("total_bps", 0.0),
        top_laggy=[
            LaggyRow(
                key=r["key"],
                group=r.get("group", -1),
                lag=r.get("lag", 0),
                under=bool(r.get("under_replicated")),
            )
            for r in rep.get("top_laggy", [])
        ],
        top_hot=[
            HotRow(
                key=r["key"],
                total_bps=r.get("total_bps", 0.0),
                produce_bps=r.get("produce_bps", 0.0),
                fetch_bps=r.get("fetch_bps", 0.0),
                append_bps=r.get("append_bps", 0.0),
            )
            for r in rep.get("top_hot", [])
        ],
        lag_hist=[int(c) for c in rep.get("lag_histogram", [])],
        read_path=[
            int((rep.get("read_path") or {}).get(k, 0))
            for k in health.READ_PATH_KEYS
        ],
    )


def envelope_to_health(snap: HealthSnapshot) -> dict:
    """Wire envelope -> the same dict shape health.build_report emits
    (plus shard/node provenance), so merge_reports folds local and
    remote shards identically."""
    return {
        "shard": snap.shard,
        "node": snap.node,
        "active": snap.active,
        "max_follower_lag": snap.max_lag,
        "under_replicated": snap.under_replicated,
        "leaderless": snap.leaderless,
        "skew": snap.skew,
        "rates": {
            "produce_bps": snap.produce_bps,
            "fetch_bps": snap.fetch_bps,
            "append_bps": snap.append_bps,
            "total_bps": snap.total_bps,
        },
        "top_laggy": [
            {
                "key": r.key,
                "group": r.group,
                "lag": r.lag,
                "under_replicated": r.under,
                "shard": snap.shard,
            }
            for r in snap.top_laggy
        ],
        "top_hot": [
            {
                "key": r.key,
                "total_bps": r.total_bps,
                "produce_bps": r.produce_bps,
                "fetch_bps": r.fetch_bps,
                "append_bps": r.append_bps,
                "shard": snap.shard,
            }
            for r in snap.top_hot
        ],
        "lag_histogram": list(snap.lag_hist),
        "read_path": dict(zip(health.READ_PATH_KEYS, snap.read_path)),
    }


# ------------------------------------------------------------- snapshot
def snapshot_registry(
    reg: MetricsRegistry, shard: int, node: int = -1
) -> RegistrySnapshot:
    """Capture one registry: counters/gauges as sampled values,
    histograms as raw buckets. An empty counter still contributes a
    zero sample so every shard is visible in the merged scrape."""
    families: list[SampleFamily] = []
    hists: list[HistFamily] = []
    fams = reg.families()
    for name in sorted(fams):
        m = fams[name]
        if isinstance(m, Histogram):
            hists.append(
                HistFamily(
                    name=name,
                    help=m.help,
                    series=[
                        HistSeries(
                            labels=labels,
                            buckets=c._buckets,
                            overflow=c._overflow,
                            sum=c._sum,
                            count=c._count,
                        )
                        for labels, c in m.series()
                    ],
                )
            )
            continue
        kind = KIND_COUNTER if isinstance(m, Counter) else KIND_GAUGE
        samples = [
            MetricSample(labels={k: str(v) for k, v in labels.items()}, value=v)
            for labels, v in m.samples()
        ]
        if kind == KIND_COUNTER and not samples:
            samples = [MetricSample(labels={}, value=0.0)]
        families.append(
            SampleFamily(name=name, kind=kind, help=m.help, samples=samples)
        )
    return RegistrySnapshot(
        shard=shard, node=node, families=families, hists=hists
    )


def _with_shard(labels: dict, shard: int) -> dict[str, str]:
    lab = dict(labels)
    lab["shard"] = str(shard)
    return lab


def render_fleet(snapshots: list[RegistrySnapshot]) -> str:
    """Prometheus exposition of the union of shard snapshots: HELP/TYPE
    once per family, a `shard` label injected on every sample. Family
    sets may differ across shards (worker registries carry worker
    gauges only) — the union is taken by name."""
    # family name -> (kind_str, help, [(shard, labels, value)...])
    flat: dict[str, tuple[str, str, list]] = {}
    hist: dict[str, tuple[str, list]] = {}
    for snap in snapshots:
        for fam in snap.families:
            kind = "counter" if fam.kind == KIND_COUNTER else "gauge"
            entry = flat.setdefault(fam.name, (kind, fam.help, []))
            for s in fam.samples:
                entry[2].append((snap.shard, s.labels, s.value))
        for hf in snap.hists:
            entry = hist.setdefault(hf.name, (hf.help, []))
            for series in hf.series:
                entry[1].append((snap.shard, series))
    lines: list[str] = []
    for name in sorted(set(flat) | set(hist)):
        if name in flat:
            kind, help_, rows = flat[name]
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for shard, labels, value in sorted(
                rows, key=lambda r: (r[0], sorted(r[1].items()))
            ):
                lab = _fmt_labels(_with_shard(labels, shard))
                lines.append(f"{name}{lab} {value:g}")
        else:
            help_, rows = hist[name]
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
            for shard, series in sorted(
                rows, key=lambda r: (r[0], sorted(r[1].labels.items()))
            ):
                series.to_child().render_into(
                    lines, name, _with_shard(series.labels, shard)
                )
    return "\n".join(lines) + "\n"


def render_snapshot(snap: RegistrySnapshot) -> str:
    """Raw single-shard exposition (the /v1/shards/{n}/metrics view):
    same format as MetricsRegistry.render(), no shard label."""
    lines: list[str] = []
    for fam in snap.families:
        kind = "counter" if fam.kind == KIND_COUNTER else "gauge"
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {kind}")
        for s in fam.samples:
            lines.append(f"{fam.name}{_fmt_labels(s.labels)} {s.value:g}")
    for hf in snap.hists:
        lines.append(f"# HELP {hf.name} {hf.help}")
        lines.append(f"# TYPE {hf.name} histogram")
        for series in hf.series:
            series.to_child().render_into(lines, hf.name, dict(series.labels))
    return "\n".join(lines) + "\n"


def merged_hist(
    snapshots: list[RegistrySnapshot], name: str
) -> Optional[HistogramChild]:
    """All series of histogram `name` across all shards merged into one
    child — exact fleet quantiles (used by the merge-equivalence test
    and bench --probes fleet p99)."""
    out: Optional[HistogramChild] = None
    for snap in snapshots:
        for hf in snap.hists:
            if hf.name != name:
                continue
            for series in hf.series:
                c = series.to_child()
                if out is None:
                    out = c
                else:
                    out.merge_from(c)
    return out


# ---------------------------------------------------------------- traces
def _tags_to_wire(tags: Optional[dict]) -> list[str]:
    if not tags:
        return []
    return [f"{k}={v}" for k, v in tags.items()]


def _tags_from_wire(pairs: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for p in pairs:
        k, _, v = p.partition("=")
        out[k] = v
    return out


class TraceSpan(Envelope):
    SERDE_FIELDS = [
        ("name", string),
        ("id", u64),
        ("parent", u64),
        ("start_ns", u64),
        ("dur_ns", i64),
        ("tags", vector(string)),
    ]


class TraceTree(Envelope):
    SERDE_FIELDS = [
        ("trace_id", u64),
        ("root", string),
        ("dur_ns", i64),
        ("node", i32),
        ("shard", i32),
        ("remote_parent", u64),  # 0 = locally-originated tree
        ("origin", string),
        ("slow", boolean),
        ("spans", vector(envelope(TraceSpan))),
    ]


class TraceEvent(Envelope):
    SERDE_FIELDS = [
        ("name", string),
        ("at_ns", u64),
        ("tags", vector(string)),
    ]


class TraceDump(Envelope):
    SERDE_FIELDS = [
        ("node", i32),
        ("shard", i32),
        ("trees_total", u64),
        ("frozen_total", u64),
        ("trees", vector(envelope(TraceTree))),
        ("events", vector(envelope(TraceEvent))),
    ]


def _tree_to_env(tree: dict, slow: bool) -> TraceTree:
    return TraceTree(
        trace_id=tree.get("trace_id", 0),
        root=tree["root"],
        dur_ns=tree["dur_ns"],
        node=tree.get("node", -1),
        shard=tree.get("shard", 0),
        remote_parent=tree.get("remote_parent", 0),
        origin=tree.get("origin") or "",
        slow=slow,
        spans=[
            TraceSpan(
                name=s["name"],
                id=s["id"],
                parent=s["parent"],
                start_ns=s["start_ns"],
                dur_ns=s["dur_ns"],
                tags=_tags_to_wire(s.get("tags")),
            )
            for s in tree["spans"]
        ],
    )


def _tree_from_env(t: TraceTree) -> dict:
    tree = {
        "trace_id": t.trace_id,
        "root": t.root,
        "dur_ns": t.dur_ns,
        "node": t.node,
        "shard": t.shard,
        "spans": [
            {
                "name": s.name,
                "id": s.id,
                "parent": s.parent,
                "start_ns": s.start_ns,
                "dur_ns": s.dur_ns,
                **({"tags": _tags_from_wire(s.tags)} if s.tags else {}),
            }
            for s in t.spans
        ],
    }
    if t.origin:
        tree["remote_parent"] = t.remote_parent
        tree["origin"] = t.origin
    return tree


def dump_to_envelope(dump: dict) -> TraceDump:
    """FlightRecorder.dump() dict -> wire envelope. Frozen trees keep
    their slow marker; ring duplicates of frozen trees are dropped the
    same way log_viewer does (by (shard, first-span id))."""
    frozen = dump.get("frozen", [])
    seen = {id(t) for t in frozen}
    trees = [_tree_to_env(t, True) for t in frozen]
    trees.extend(
        _tree_to_env(t, False)
        for t in dump.get("ring", [])
        if id(t) not in seen
    )
    return TraceDump(
        node=dump.get("node_id", -1),
        shard=dump.get("shard", 0),
        trees_total=dump.get("trees_total", 0),
        frozen_total=dump.get("frozen_total", 0),
        trees=trees,
        events=[
            TraceEvent(
                name=e["name"],
                at_ns=e["at_ns"],
                tags=_tags_to_wire(e.get("tags")),
            )
            for e in dump.get("events", [])
        ],
    )


def envelope_to_dump(td: TraceDump) -> dict:
    """Wire envelope -> the same JSON shape FlightRecorder.dump() emits
    (frozen/ring split restored from the slow marker)."""
    frozen = [_tree_from_env(t) for t in td.trees if t.slow]
    ring = [_tree_from_env(t) for t in td.trees]
    return {
        "node_id": td.node,
        "shard": td.shard,
        "trees_total": td.trees_total,
        "frozen_total": td.frozen_total,
        "frozen": frozen,
        "ring": ring,
        "events": [
            {
                "name": e.name,
                "at_ns": e.at_ns,
                "tags": _tags_from_wire(e.tags),
            }
            for e in td.events
        ],
    }


def stitch_trees(trees: list[dict]) -> list[dict]:
    """Group trees (from any number of shard dumps) by trace_id and
    merge each multi-part group into one stitched tree.

    Every span in a stitched tree is annotated with its originating
    shard/node; a remote continuation's root span keeps its propagated
    parent id, which resolves inside the merged span list when the
    sender's part arrived — and safely dangles (rendered as a top-level
    orphan, never a crash) when it did not. The returned list holds
    only stitched (multi-part) trees, newest-first by root start."""
    by_trace: dict[int, list[dict]] = {}
    for t in trees:
        tid = t.get("trace_id")
        if not tid:
            continue
        by_trace.setdefault(tid, []).append(t)
    out: list[dict] = []
    for tid, parts in by_trace.items():
        if len(parts) < 2:
            continue
        # de-dup parts that appear in both a frozen list and a ring
        seen_span_ids: set = set()
        uniq: list[dict] = []
        for p in parts:
            key = tuple(s["id"] for s in p["spans"][:1])
            if key in seen_span_ids:
                continue
            seen_span_ids.add(key)
            uniq.append(p)
        if len(uniq) < 2:
            continue
        # the locally-originated part (no remote parent) is the trace
        # root; orphaned groups (root part never arrived) fall back to
        # the earliest part
        root_part = next(
            (p for p in uniq if not p.get("origin")),
            min(uniq, key=lambda p: p["spans"][0]["start_ns"] if p["spans"] else 0),
        )
        spans: list[dict] = []
        shards: set = set()
        for p in uniq:
            shards.add(p.get("shard", 0))
            for s in p["spans"]:
                s2 = dict(s)
                s2["shard"] = p.get("shard", 0)
                s2["node"] = p.get("node", -1)
                if p is not root_part and s.get("parent") and p.get("origin"):
                    # mark continuation roots so viewers can badge the
                    # process hop
                    if s["id"] == p["spans"][-1]["id"]:
                        s2["origin"] = p["origin"]
                spans.append(s2)
        spans.sort(key=lambda s: s["start_ns"])
        out.append(
            {
                "trace_id": tid,
                "root": root_part["root"],
                "dur_ns": root_part["dur_ns"],
                "stitched": True,
                "parts": len(uniq),
                "shards": sorted(shards),
                "orphaned": bool(root_part.get("origin")),
                "spans": spans,
            }
        )
    out.sort(key=lambda t: t["spans"][0]["start_ns"] if t["spans"] else 0)
    return out
