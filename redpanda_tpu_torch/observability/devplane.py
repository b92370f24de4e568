"""devplane — runtime telemetry for the device plane (`RP_DEVPLANE=1`).

Port of redpanda_tpu/observability/devplane.py, the same families,
helpers and switches. The host side of the broker is observable
(metrics registry, flightdata ring, burn-rate alerts, trace spans);
this module is the measurement plane of the CUDA kernels that step the
consensus state and the codecs, built on three legs:

  * **Frame/kernel timing** — `instrument(fn, name)` brackets a kernel
    wrapper with a dispatch→ready latency histogram. The first call and
    every Nth call (`RP_DEVPLANE_SAMPLE`, default 16) are sampled: host
    `perf_counter` from before the dispatch until the outputs are
    ready, which for CUDA outputs is a `torch.cuda.Event` recorded on
    the current stream after the call and synchronized (the reference
    blocks on `jax.block_until_ready`); CPU outputs (the plain versions)
    are ready when the call returns. `frame_scope(kind)` brackets one
    full mesh frame and opens a trace span that joins the task's span.
  * **Transfer accounting** — `count_transfer` totals host↔device bytes
    by direction and `count_fold` counts cross-chip folds, so the mesh
    backend holds `devplane_frame_folds_total == devplane_frames_total`
    (one fold per frame) at run time, and any kernel dispatch or
    transfer inside `tick_scope()` but outside a frame bumps
    `devplane_tick_transfers_total`, which an alert rule watches.
  * **Launch counts** — `count_launches` exports the kernel wrappers'
    own launch counters as `devplane_kernel_launches` (this package
    only: the reference's jitted programs have no such counter), so a
    shard process's launches ride its scrape.
  * **Build events** — every nvcc build `ops/_build.py` runs reaches
    `utils/compileguard.py`'s subscribers: build count and seconds per
    kernel, labeled warmup vs steady (the port's counterpart of an XLA
    compile), feeding the recompile-storm alert rule. The probes push
    the compileguard attribution stack themselves, so a build attributes
    to the kernel whose first call needed it with the guard off.

All families live in one process-global `registry` and are *adopted*
into each broker/shard registry (`MetricsRegistry.adopt`), so they ride
the ordinary `/metrics` scrape, the fleet snapshot protocol and the
flightdata history ring. `snapshot()` / `merged_status()` ship and
merge them as the serde `RegistrySnapshot` envelope `/metrics` uses.

Off-state (`RP_DEVPLANE` unset, read at import) is zero-overhead **by
construction**: `instrument(f, n) is f` — no wrapper, no per-call
branch on the tick path. Scope helpers degrade to pass-through context
managers and recording calls to early returns.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

from ..metrics import HistogramChild, MetricsRegistry, _NBUCKETS
from ..utils import compileguard
from . import trace

ENABLED = os.environ.get("RP_DEVPLANE", "") == "1"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: every Nth dispatch of an instrumented kernel pays the ready sync
#: that yields a dispatch→ready sample (the first call always samples,
#: so cold kernels are visible immediately)
SAMPLE_EVERY = max(1, _env_int("RP_DEVPLANE_SAMPLE", 16))

#: process-global registry the broker registries adopt; the prefix
#: matches theirs so family names merge transparently
registry = MetricsRegistry()

_KERNEL_HIST = registry.histogram(
    "devplane_kernel_seconds",
    "sampled dispatch->ready latency per instrumented kernel (labels: "
    "the static instrument() name set, RPL012)",
)
_FRAME_HIST = registry.histogram(
    "devplane_frame_seconds",
    "full mesh-frame dispatch->ready latency (labels: frame kind, "
    "tick|health)",
)
_FRAMES = registry.counter(
    "devplane_frames_total",
    "full device frames run, by frame kind",
)
_FOLDS = registry.counter(
    "devplane_frame_folds_total",
    "cross-chip folds dispatched; the RPL018 runtime invariant is "
    "exactly one per frame (== devplane_frames_total)",
)
_TRANSFER_BYTES = registry.counter(
    "devplane_transfer_bytes_total",
    "host<->device transfer bytes, by direction (h2d|d2h)",
)
_TICK_TRANSFERS = registry.counter(
    "devplane_tick_transfers_total",
    "device transfers/dispatches observed on the steady tick path "
    "OUTSIDE a frame — any nonzero is an RPL018 runtime breach",
)
_COMPILES = registry.counter(
    "devplane_compiles_total",
    "kernel library builds (nvcc) attributed per kernel, by "
    "compileguard phase (warmup|steady); steady builds feed the "
    "recompile-storm alert",
)
_COMPILE_SECS = registry.counter(
    "devplane_compile_seconds_total",
    "kernel library build wall seconds attributed per kernel and phase",
)

#: full family names (registry prefix applied) — the set the digest,
#: the flightdata windows, and the alert rules all key on
KERNEL_FAMILY = _KERNEL_HIST.name
FRAME_FAMILY = _FRAME_HIST.name
FRAMES_FAMILY = _FRAMES.name
FOLDS_FAMILY = _FOLDS.name
TRANSFER_FAMILY = _TRANSFER_BYTES.name
TICK_TRANSFER_FAMILY = _TICK_TRANSFERS.name
COMPILES_FAMILY = _COMPILES.name
COMPILE_SECS_FAMILY = _COMPILE_SECS.name
JIT_CACHE_FAMILY = f"{registry.prefix}_devplane_jit_cache_entries"

_JIT_CACHE_HELP = (
    "kernel library builds per registered kernel "
    "(compileguard.compile_counts, the series bench deltas grade)"
)


def _jit_cache_samples() -> list[tuple[dict, float]]:
    return [
        ({"kernel": k}, float(v))
        for k, v in compileguard.compile_counts().items()
    ]


registry.gauge(
    "devplane_jit_cache_entries", _jit_cache_samples, _JIT_CACHE_HELP
)

#: the kernel wrappers' own launch counters (each ops module's
#: LAUNCHES, registered at its import): a wrapper adds one where it
#: launches its CUDA kernel, and its plain version counts nothing
_LAUNCH_TABLES: list[dict] = []


def count_launches(table: dict) -> dict:
    """Export `table` ({kernel: launches}) as the
    devplane_kernel_launches family; returns it."""
    _LAUNCH_TABLES.append(table)
    return table


def _launch_samples() -> list[tuple[dict, float]]:
    return [
        ({"kernel": k}, float(v)) for t in _LAUNCH_TABLES for k, v in t.items()
    ]


registry.gauge(
    "devplane_kernel_launches",
    _launch_samples,
    "CUDA kernel launches per kernel wrapper in this process",
)


def enabled() -> bool:
    return ENABLED


def register(reg: MetricsRegistry) -> None:
    """Wire the devplane into a broker/shard registry. Armed: adopt
    every process-global family (they then ride this registry's scrape,
    fleet snapshot, and flightdata ring). Disarmed: only the jit-cache
    gauge family exports — compileguard registration is unconditional,
    so the series bench deltas grade is always scrapeable."""
    if ENABLED:
        reg.adopt(registry)
    else:
        reg.gauge(
            "devplane_jit_cache_entries", _jit_cache_samples, _JIT_CACHE_HELP
        )


# ---------------------------------------------------------------- scopes
_TICK_DEPTH = 0
_FRAME_DEPTH = 0


@contextmanager
def tick_scope():
    """Declare the steady tick path: entered by the mesh backend's
    per-tick sweep. Device activity inside this scope but outside a
    `frame_scope` is the RPL018 breach the tick-transfer counter (and
    its alert rule) exists to catch."""
    global _TICK_DEPTH
    if not ENABLED:
        yield
        return
    _TICK_DEPTH += 1
    try:
        yield
    finally:
        _TICK_DEPTH -= 1


@contextmanager
def frame_scope(kind: str):
    """Bracket one full device frame (`kind` from the static set
    tick|health): frames counter, dispatch→ready histogram, and a
    trace span that joins the task's current span so slow-request
    trees show the device frame they waited on."""
    global _FRAME_DEPTH
    if not ENABLED:
        yield
        return
    _FRAME_DEPTH += 1
    t0 = time.perf_counter()
    try:
        with trace.span("devplane.frame", kind=kind):
            yield
    finally:
        _FRAME_DEPTH -= 1
        _FRAME_HIST.labels(frame=kind).observe(time.perf_counter() - t0)
        _FRAMES.inc(frame=kind)


def in_frame() -> bool:
    return _FRAME_DEPTH > 0


def count_fold(n: int = 1) -> None:
    """One cross-chip fold dispatched (the mesh frame's totals
    reduction). The runtime RPL018 invariant is folds == frames."""
    if ENABLED:
        _FOLDS.inc(float(n))


def count_transfer(nbytes: int, direction: str) -> None:
    """Account `nbytes` of host<->device traffic (`direction` from the
    static set h2d|d2h). A transfer on the tick outside a frame is a
    discipline breach and bumps the tick-transfer counter."""
    if not ENABLED:
        return
    _TRANSFER_BYTES.inc(float(nbytes), direction=direction)
    if _TICK_DEPTH and not _FRAME_DEPTH:
        _TICK_TRANSFERS.inc(kind="transfer")


# -------------------------------------------------------------- kernels
def _cuda_device(out, depth: int = 0):
    """The device of the first CUDA tensor in a kernel's outputs (a
    tensor, or tuples, dicts and dataclasses of them), else None."""
    if depth > 3:
        return None
    dev = getattr(out, "device", None)
    if dev is not None and getattr(out, "is_cuda", False):
        return dev
    if isinstance(out, dict):
        items = out.values()
    elif isinstance(out, (tuple, list)):
        items = out
    elif hasattr(out, "__dataclass_fields__"):
        items = (getattr(out, f) for f in out.__dataclass_fields__)
    else:
        return None
    for item in items:
        dev = _cuda_device(item, depth + 1)
        if dev is not None:
            return dev
    return None


def _ready(out):
    """Wait until `out` is ready: for CUDA outputs, an event recorded on
    the current stream after the call, synchronized; CPU outputs are
    ready already."""
    dev = _cuda_device(out)
    if dev is not None:
        import torch

        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return out


class _Probe:
    """Dispatch→ready probe for one instrumented kernel: forwards to
    the underlying callable (a kernel wrapper or compileguard._Guard),
    samples latency on the first and every Nth call by waiting for the
    outputs (`_ready`), keeps the build-attribution stack current, and
    flags tick-path dispatches outside a frame."""

    __slots__ = ("fn", "name", "_child", "_n")

    def __init__(self, fn, name: str) -> None:
        self.fn = fn
        self.name = name
        self._child = _KERNEL_HIST.labels(kernel=name)
        self._n = 0

    def __call__(self, *args, **kwargs):
        if _TICK_DEPTH and not _FRAME_DEPTH:
            _TICK_TRANSFERS.inc(kind="dispatch")
        self._n += 1
        compileguard.push_kernel(self.name)
        try:
            if self._n != 1 and self._n % SAMPLE_EVERY:
                return self.fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            out = _ready(out)
            self._child.observe(time.perf_counter() - t0)
            return out
        finally:
            compileguard.pop_kernel()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<devplane {self.name} of {self.fn!r}>"


def instrument(fn, name: str):
    """Return the callable to bind for kernel `name`. Off-state this
    IS `fn` (structural absence: `instrument(f, n) is f` — zero
    overhead by construction, the compileguard recipe); armed, a
    `_Probe`. Stacks outside compileguard.instrument at the kernel
    sites (`probe`): the probe sees the guarded dispatch."""
    if not ENABLED:
        return fn
    return _Probe(fn, name)


def probe(fn, name: str):
    """`fn` registered with compileguard and instrumented here, both
    under `name`: the binding every kernel site of the port uses."""
    return instrument(compileguard.instrument(fn, name), name)


# ------------------------------------------------------- compile events
def _on_compile(kernel: str, secs: float, phase: str) -> None:
    _COMPILES.inc(kernel=kernel, phase=phase)
    _COMPILE_SECS.inc(secs, kernel=kernel, phase=phase)


if ENABLED:
    compileguard.subscribe_compiles(_on_compile)


# ---------------------------------------------------------- alert rules
def alert_rules() -> list:
    """Devplane burn-rate rules for `AlertManager.rules` — empty when
    the plane is disarmed (the families would never move):

      * device_recompile_storm — any steady-phase kernel build in the
        window (threshold 0 over the compiles counter delta);
      * device_tick_transfer  — any device transfer/dispatch on the
        tick outside a frame (the RPL018 runtime invariant, live);
      * device_frame_p99      — windowed frame dispatch→ready p99 vs
        `RP_DEVPLANE_FRAME_SLO_MS` (default 250 ms).
    """
    if not ENABLED:
        return []
    from . import alerts as _alerts

    try:
        frame_slo_ms = float(
            os.environ.get("RP_DEVPLANE_FRAME_SLO_MS", "") or 250.0
        )
    except ValueError:
        frame_slo_ms = 250.0
    return [
        _alerts.AlertRule(
            "device_recompile_storm", "counter", COMPILES_FAMILY,
            {"phase": "steady"}, 0.0, 0.0, "compiles",
            "steady-phase kernel builds under instrumented kernels — any "
            "in-window build is a storm precursor",
        ),
        _alerts.AlertRule(
            "device_tick_transfer", "counter", TICK_TRANSFER_FAMILY,
            None, 0.0, 0.0, "events",
            "device transfers/dispatches on the steady tick path "
            "outside a frame (RPL018 runtime breach)",
        ),
        _alerts.AlertRule(
            "device_frame_p99", "quantile", FRAME_FAMILY, None,
            0.99, frame_slo_ms / 1000.0, "s",
            "windowed mesh-frame dispatch->ready p99 vs the declared "
            "frame budget",
        ),
    ]


# ------------------------------------------------------- fleet surface
def snapshot(shard: int = 0, node: int = -1):
    """This process's devplane registry as the same serde
    `RegistrySnapshot` envelope `/metrics` ships (RPL009: nothing
    pickled crosses the shard boundary)."""
    from . import fleet

    return fleet.snapshot_registry(registry, shard, node)


def _hist_digest(c: HistogramChild) -> dict:
    return {
        "count": c._count,
        "p50_ms": c.quantile(0.50) * 1e3,
        "p99_ms": c.quantile(0.99) * 1e3,
        "p999_ms": c.quantile(0.999) * 1e3,
        "mean_ms": (c._sum / c._count * 1e3) if c._count else 0.0,
    }


def merged_status(snaps: list) -> dict:
    """JSON digest of one or more devplane `RegistrySnapshot`s (one
    per shard): counters summed, histogram buckets merged exactly
    before the quantiles, build counts per kernel max'd (each process
    loads its own copy of the same libraries)."""
    frames: dict[str, float] = {}
    folds = 0.0
    transfers: dict[str, float] = {}
    tick_violations = 0.0
    compiles: dict[str, dict] = {}
    jit_cache: dict[str, float] = {}
    frame_hist: dict[str, HistogramChild] = {}
    kernel_hist: dict[str, HistogramChild] = {}
    for snap in snaps:
        for fam in snap.families:
            for s in fam.samples:
                lab = dict(s.labels)
                if fam.name == FRAMES_FAMILY and "frame" in lab:
                    k = lab["frame"]
                    frames[k] = frames.get(k, 0.0) + s.value
                elif fam.name == FOLDS_FAMILY:
                    folds += s.value
                elif fam.name == TRANSFER_FAMILY and "direction" in lab:
                    d = lab["direction"]
                    transfers[d] = transfers.get(d, 0.0) + s.value
                elif fam.name == TICK_TRANSFER_FAMILY:
                    tick_violations += s.value
                elif fam.name == COMPILES_FAMILY and "kernel" in lab:
                    ent = compiles.setdefault(
                        lab["kernel"],
                        {"warmup": 0.0, "steady": 0.0, "seconds": 0.0},
                    )
                    ph = lab.get("phase", "warmup")
                    ent[ph] = ent.get(ph, 0.0) + s.value
                elif fam.name == COMPILE_SECS_FAMILY and "kernel" in lab:
                    ent = compiles.setdefault(
                        lab["kernel"],
                        {"warmup": 0.0, "steady": 0.0, "seconds": 0.0},
                    )
                    ent["seconds"] += s.value
                elif fam.name == JIT_CACHE_FAMILY and "kernel" in lab:
                    k = lab["kernel"]
                    jit_cache[k] = max(jit_cache.get(k, 0.0), s.value)
        for hf in snap.hists:
            if hf.name == FRAME_FAMILY:
                store, key = frame_hist, "frame"
            elif hf.name == KERNEL_FAMILY:
                store, key = kernel_hist, "kernel"
            else:
                continue
            for series in hf.series:
                k = dict(series.labels).get(key, "")
                if not k:
                    continue
                c = series.to_child()
                prev = store.get(k)
                if prev is None:
                    store[k] = c
                else:
                    prev.merge_from(c)
    frames_total = sum(frames.values())
    return {
        "enabled": True,
        "sample_every": SAMPLE_EVERY,
        "shards": len(snaps),
        "frames": {k: int(v) for k, v in sorted(frames.items())},
        "frames_total": int(frames_total),
        "folds": int(folds),
        "folds_per_frame": (folds / frames_total) if frames_total else 0.0,
        "transfer_bytes": {
            k: int(v) for k, v in sorted(transfers.items())
        },
        "tick_violations": int(tick_violations),
        "frame_ms": {
            k: _hist_digest(c) for k, c in sorted(frame_hist.items())
        },
        "kernels": {
            k: _hist_digest(c) for k, c in sorted(kernel_hist.items())
        },
        "compiles": {k: v for k, v in sorted(compiles.items())},
        "jit_cache": {k: int(v) for k, v in sorted(jit_cache.items())},
    }


def status() -> dict:
    """Local-process digest (single-shard view of merged_status)."""
    if not ENABLED:
        return {"enabled": False}
    return merged_status([snapshot()])


# ------------------------------------------------------------- harness
def reset() -> None:
    """Zero every devplane counter and histogram in place (bench/test
    harness hook). In place because probes hold pre-resolved histogram
    child refs — the objects must survive the reset."""
    from .. import metrics as _metrics

    for m in registry.families().values():
        if isinstance(m, _metrics.Counter):
            m._values.clear()
        elif isinstance(m, _metrics.Histogram):
            children = list(m._children.values())
            if m._default is not None:
                children.append(m._default)
            for c in children:
                c._buckets = [0] * _NBUCKETS
                c._overflow = 0
                c._sum = 0.0
                c._count = 0
