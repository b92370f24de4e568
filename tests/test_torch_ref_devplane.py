"""tests/test_devplane.py run on the port, plus the port's probe
bindings: the device-plane telemetry (RP_DEVPLANE=1).

Off-state cases run in process (the suite never sets RP_DEVPLANE, so
the default import IS the off state and `instrument(f, n) is f` is
checked directly). Armed cases run in subprocesses (RP_DEVPLANE is
read at import) on the CPU, where the kernel wrappers run their plain
versions and a sample is ready when the call returns.

Carried, each as the reference runs it, with these translations:
* `test_off_instrument_is_structural_passthrough`,
  `test_off_surface_degrades_not_errors`,
  `test_off_register_exports_only_jit_cache_gauge`,
  `test_adopt_aliases_families` — as they are.
* `test_armed_mesh_fold_invariant` — the 8 forced host devices become
  the port's mesh of 8 chip blocks on the CPU (`ShardGroupArrays(...,
  device="cpu")` under RP_QUORUM_BACKEND=mesh, RP_MESH_DEVICES=8, so
  `arrays.mesh_frame` is `MeshFrame(n_devices=8, device="cpu")`);
  `folds == frames_total` is asserted live. The reference's compile
  assertions (a warmup compile attributed to the frame kernel) become:
  no build is attributed, since the plain versions build nothing — the
  attribution itself is held by `test_armed_build_attributed_to_probe`.
* `test_armed_tick_transfer_breach_counted`,
  `test_armed_snapshot_roundtrip_and_fleet_merge`,
  `test_armed_sampling_cadence` — a torch function in place of the jit
  kernel.
* `test_armed_recompile_storm_alert_fires` — there is no nvcc on the
  CPU test machine, so the build is driven through
  `compileguard.report_build`, the call ops/_build.py makes after every
  nvcc build: a warmup build on the kernel's first call, none on a warm
  call, then one after `steady()` on a new shape, which must fire
  `device_recompile_storm`.
Left out: nothing.

Added for the port: the 21 probe names bound where the live path looks
them up, raw off-state; armed, one call counts once under its own name
(the composites call the raw functions); builds attribute to the
innermost probe.
"""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from redpanda_tpu_torch.observability import devplane  # noqa: E402

_off = pytest.mark.skipif(
    devplane.enabled(), reason="suite assumes the default off state"
)

PROBES = (
    "quorum.commit_step", "quorum.follower_commit_step", "quorum.fold_replies",
    "quorum.local_append_update", "quorum.build_heartbeats", "quorum.heartbeat_tick",
    "quorum.tick_frame", "health.reduce", "health.tick_frame", "crc32c.device",
    "lz4.compress_chunks", "snappy.compress_chunks", "fused.crc_lz4", "fused.crc_snappy",
    "fused.crc_zstd", "zstd.encode_chunks", "zstd.decode_streams",
    "mesh_frame.tick_frame", "mesh_frame.health", "cluster.tick", "cluster.election_round",
)


def _run_armed(tmp_path, body: str, extra_env: dict | None = None):
    """Run `body` in a subprocess with the devplane armed."""
    script = tmp_path / "armed.py"
    script.write_text("import os, sys\n" f"sys.path.insert(0, {REPO_ROOT!r})\n" + body)
    env = dict(os.environ, RP_DEVPLANE="1")
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, str(script)],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=300,
    )


# -- off state (the tier-1 default) ------------------------------------


@_off
def test_off_instrument_is_structural_passthrough():
    def fn(x):
        return x

    assert not devplane.enabled()
    # zero overhead BY CONSTRUCTION: the bound callable IS the kernel —
    # no wrapper object, no per-call branch on the tick path
    assert devplane.instrument(fn, "t.passthrough") is fn


@_off
def test_off_surface_degrades_not_errors():
    assert devplane.status() == {"enabled": False}
    assert devplane.alert_rules() == []
    # scopes pass through; recording calls are early returns
    with devplane.tick_scope():
        with devplane.frame_scope("tick"):
            assert not devplane.in_frame()  # depth untracked when off
        devplane.count_fold()
        devplane.count_transfer(4096, "h2d")


@_off
def test_off_register_exports_only_jit_cache_gauge():
    from redpanda_tpu_torch.metrics import MetricsRegistry

    reg = MetricsRegistry()
    devplane.register(reg)
    fams = reg.families()
    assert f"{reg.prefix}_devplane_jit_cache_entries" in fams
    # the frame/kernel/transfer families stay out of disarmed scrapes
    assert devplane.FRAMES_FAMILY not in fams
    assert devplane.KERNEL_FAMILY not in fams


def test_adopt_aliases_families():
    from redpanda_tpu_torch.metrics import MetricsRegistry

    src = MetricsRegistry()
    c = src.counter("t_adopted_total", "t")
    dst = MetricsRegistry()
    dst.adopt(src)
    # adoption aliases, never copies: increments through the source
    # are visible in the adopting registry's scrape
    c.inc(kind="x")
    assert dst.families()[c.name] is c


def test_family_names_and_prefix_match_the_reference():
    from redpanda_tpu.observability import devplane as ref

    from redpanda_tpu_torch.metrics import MetricsRegistry

    assert MetricsRegistry().prefix == "redpanda_tpu"
    for name in ("KERNEL_FAMILY", "FRAME_FAMILY", "FRAMES_FAMILY", "FOLDS_FAMILY",
                 "TRANSFER_FAMILY", "TICK_TRANSFER_FAMILY", "COMPILES_FAMILY",
                 "COMPILE_SECS_FAMILY", "JIT_CACHE_FAMILY"):
        assert getattr(devplane, name) == getattr(ref, name), name


@_off
def test_off_live_path_reaches_the_raw_wrappers():
    from redpanda_tpu_torch.ops import crc32c, fused, health, lz4, quorum, snappy, zstd
    from redpanda_tpu_torch.parallel import cluster_step, make_mesh
    from redpanda_tpu_torch.parallel.mesh_frame import MeshFrame, mesh_health, mesh_tick_frame
    from redpanda_tpu_torch.utils import compileguard

    for mod, name in ((quorum, "fold_replies"), (quorum, "quorum_commit_step"),
                      (quorum, "build_heartbeats"), (quorum, "heartbeat_tick"),
                      (quorum, "tick_frame"), (health, "health_reduce"),
                      (lz4, "_compress_chunks"), (snappy, "_compress_chunks"),
                      (zstd, "_encode_chunks")):
        assert getattr(mod, name) is getattr(mod, name + "_raw"), name
    # the others are plain functions, never a wrapper object
    for f in (quorum.follower_commit_step, quorum.local_append_update,
              health.tick_frame_health, crc32c.crc32c_device, fused._fused,
              fused._fused_snappy, fused._fused_zstd, zstd.decode_staged):
        assert type(f).__name__ == "function", f
    mf = MeshFrame(n_devices=8, device="cpu")
    assert mf._frame is mesh_tick_frame and mf._health is mesh_health
    mesh = make_mesh(8, "cpu")
    for f in (cluster_step.cluster_tick_sharded(mesh), cluster_step.election_round_sharded(mesh)):
        assert type(f).__name__ == "function"
    # every name is registered with compileguard (its build counts)
    assert set(PROBES) <= set(compileguard.compile_counts())


# -- on state (armed subprocesses) -------------------------------------

_MESH_INVARIANT = """\
import os
os.environ["RP_QUORUM_BACKEND"] = "mesh"
os.environ["RP_MESH_DEVICES"] = "8"
import numpy as np
from redpanda_tpu_torch.observability import devplane
from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

assert devplane.enabled()

def fn(x):
    return x

probe = devplane.instrument(fn, "t.probe")
assert probe is not fn and type(probe).__name__ == "_Probe"

arrays = ShardGroupArrays(capacity=64, device="cpu")
rows = np.array([arrays.alloc_row() for _ in range(8)], np.int64)
arrays.is_leader[rows] = True
arrays.touch()
mf = arrays.mesh_frame
assert mf.n_devices == 8
window = (
    rows[:4],
    np.full(4, 1, np.int64),
    np.full(4, 5, np.int64),
    np.full(4, 4, np.int64),
    np.full(4, 1, np.int64),
)
N = 5
for _ in range(N):
    mf.run(arrays, *window)
mf.run_health(arrays)

st = devplane.status()
assert st["enabled"] is True
# the runtime invariant: exactly one cross-chip fold per frame
assert st["frames_total"] == N + 1, st["frames"]
assert st["folds"] == st["frames_total"], (st["folds"], st["frames"])
assert st["frames"] == {"health": 1, "tick": N}, st["frames"]
assert st["folds_per_frame"] == 1.0
# transfer accounting moved in both directions
assert st["transfer_bytes"]["h2d"] > 0 and st["transfer_bytes"]["d2h"] > 0
# no device activity escaped onto a tick outside a frame
assert st["tick_violations"] == 0
# kernel latency histograms sampled (first call always samples)
assert st["kernels"]["mesh_frame.tick_frame"]["count"] >= 1
assert st["kernels"]["mesh_frame.tick_frame"]["p99_ms"] > 0
assert st["kernels"]["mesh_frame.health"]["count"] == 1
# the frame counts once, under its own name: its plain chain's
# heartbeat_tick is the raw function
assert st["kernels"]["quorum.heartbeat_tick"]["count"] == 0, st["kernels"]
# the plain versions build nothing: no build attributed to the frame
assert "mesh_frame.tick_frame" not in st["compiles"], st["compiles"]
assert st["jit_cache"]["mesh_frame.tick_frame"] == 0
print("ARMED-INVARIANT-OK", st["frames_total"], st["folds"])
"""


def test_armed_mesh_fold_invariant(tmp_path):
    out = _run_armed(tmp_path, _MESH_INVARIANT)
    assert out.returncode == 0, out.stderr
    assert "ARMED-INVARIANT-OK 6 6" in out.stdout


_TICK_BREACH = """\
import torch
from redpanda_tpu_torch.observability import devplane
from redpanda_tpu_torch.utils import compileguard

kern = devplane.instrument(
    compileguard.instrument(lambda x: x + 1, "t.kern"), "t.kern"
)
with devplane.tick_scope():
    with devplane.frame_scope("tick"):
        kern(torch.zeros(8, dtype=torch.int32))   # inside a frame: clean
        devplane.count_transfer(64, "h2d")
    assert devplane.status()["tick_violations"] == 0
    kern(torch.zeros(8, dtype=torch.int32))       # on the tick, no frame
    devplane.count_transfer(64, "h2d")            # ditto
st = devplane.status()
assert st["tick_violations"] == 2, st["tick_violations"]
# outside any tick scope, bare dispatches are not violations
kern(torch.zeros(8, dtype=torch.int32))
assert devplane.status()["tick_violations"] == 2
print("ARMED-BREACH-OK")
"""


def test_armed_tick_transfer_breach_counted(tmp_path):
    out = _run_armed(tmp_path, _TICK_BREACH)
    assert out.returncode == 0, out.stderr
    assert "ARMED-BREACH-OK" in out.stdout


_STORM = """\
import torch
from redpanda_tpu_torch.metrics import MetricsRegistry
from redpanda_tpu_torch.observability import alerts as _alerts
from redpanda_tpu_torch.observability import devplane
from redpanda_tpu_torch.observability.flightdata import MetricsHistory
from redpanda_tpu_torch.utils import compileguard

reg = MetricsRegistry()
devplane.register(reg)                      # adopt: families ride reg
history = MetricsHistory(reg)
mgr = _alerts.AlertManager(
    history, rules=devplane.alert_rules(), profile="devplane-test"
)
names = [r.name for r in mgr.rules]
assert "device_recompile_storm" in names, names
assert "device_tick_transfer" in names, names
assert "device_frame_p99" in names, names

built = set()

def kernel(x):
    # a kernel whose library ops/_build.py builds on the first call at
    # a shape bucket it has not seen: the report _build makes after nvcc
    if x.shape[0] not in built:
        built.add(x.shape[0])
        compileguard.report_build("t", 12.5)
    return x * 2

kern = devplane.instrument(compileguard.instrument(kernel, "t.kern"), "t.kern")
kern(torch.zeros(8, dtype=torch.int32))     # warmup build: expected
assert devplane.status()["compiles"]["t.kern"]["warmup"] == 1
compileguard.steady()
history.sample()
assert mgr.evaluate() == []                 # quiet: nothing fires
kern(torch.ones(8, dtype=torch.int32))      # warm: no build
history.sample()
assert mgr.evaluate() == [], mgr.active
kern(torch.zeros(16, dtype=torch.int32))    # new shape: a fresh build
st = devplane.status()
assert st["compiles"]["t.kern"]["steady"] >= 1, st["compiles"]
assert st["compiles"]["t.kern"]["seconds"] == 25.0, st["compiles"]
history.sample()
fired = mgr.evaluate()
assert "device_recompile_storm" in [a["name"] for a in fired], fired
assert mgr.active["device_recompile_storm"]["state"] == "firing"
print("ARMED-STORM-OK")
"""


def test_armed_recompile_storm_alert_fires(tmp_path):
    out = _run_armed(tmp_path, _STORM)
    assert out.returncode == 0, out.stderr
    assert "ARMED-STORM-OK" in out.stdout


_ROUNDTRIP = """\
import torch
from redpanda_tpu_torch.observability import devplane
from redpanda_tpu_torch.observability.fleet import RegistrySnapshot
from redpanda_tpu_torch.utils import compileguard

kern = devplane.instrument(
    compileguard.instrument(lambda x: x + 1, "t.kern"), "t.kern"
)
with devplane.frame_scope("tick"):
    devplane.count_fold()
    devplane.count_transfer(1024, "h2d")
    kern(torch.zeros(8, dtype=torch.int32))

snap = devplane.snapshot(shard=3, node=7)
wire = snap.encode()                        # the serde envelope
back = RegistrySnapshot.decode(wire)
assert back.shard == 3 and back.node == 7
one = devplane.merged_status([back])
assert one["frames_total"] == 1 and one["folds"] == 1
assert one["kernels"]["t.kern"]["count"] == 1
# two shards shipping the same envelope: counters sum, histogram
# buckets merge exactly, build counts max (not sum)
two = devplane.merged_status([back, RegistrySnapshot.decode(wire)])
assert two["shards"] == 2
assert two["frames_total"] == 2 and two["folds"] == 2
assert two["folds_per_frame"] == 1.0
assert two["kernels"]["t.kern"]["count"] == 2
assert two["transfer_bytes"]["h2d"] == 2048
assert two["jit_cache"]["t.kern"] == one["jit_cache"]["t.kern"]
print("ARMED-ROUNDTRIP-OK")
"""


def test_armed_snapshot_roundtrip_and_fleet_merge(tmp_path):
    out = _run_armed(tmp_path, _ROUNDTRIP)
    assert out.returncode == 0, out.stderr
    assert "ARMED-ROUNDTRIP-OK" in out.stdout


_SAMPLING = """\
import torch
from redpanda_tpu_torch.observability import devplane

assert devplane.SAMPLE_EVERY == 4
kern = devplane.instrument(lambda x: x + 1, "t.kern")
for _ in range(9):                          # calls 1, 4, 8 sample
    kern(torch.zeros(8, dtype=torch.int32))
st = devplane.status()
assert st["kernels"]["t.kern"]["count"] == 3, st["kernels"]
print("ARMED-SAMPLING-OK")
"""


def test_armed_sampling_cadence(tmp_path):
    out = _run_armed(tmp_path, _SAMPLING, extra_env={"RP_DEVPLANE_SAMPLE": "4"})
    assert out.returncode == 0, out.stderr
    assert "ARMED-SAMPLING-OK" in out.stdout


# -- the port's probes on the live path ---------------------------------

_LIVE = """\
import numpy as np
import torch
from redpanda_tpu_torch.entry import dryrun_multichip, entry
from redpanda_tpu_torch.observability import devplane
from redpanda_tpu_torch.ops import fused, health, quorum
from redpanda_tpu_torch.ops import zstd as zstd_ops

assert devplane.SAMPLE_EVERY == 4
assert type(quorum.heartbeat_tick).__name__ == "_Probe"
fn, args = entry(device="cpu")
for _ in range(9):                          # samples at calls 1, 4, 8
    fn(*args)
bodies = [b"abcd" * 300, bytes(range(256)) * 8]
prefixes = [bytes(40)] * 2
for _ in range(5):                          # samples at calls 1, 4
    fused.crc_lz4_fused(prefixes, bodies, device="cpu")
fused.crc_zstd_fused(prefixes, bodies, device="cpu")
encs = zstd_ops.encode_chunks(bodies, device="cpu")
dryrun_multichip(8, device="cpu")
st = devplane.status()
k = {name: d["count"] for name, d in st["kernels"].items()}
assert k["quorum.heartbeat_tick"] == 3, k
assert k["fused.crc_lz4"] == 2, k
assert k["fused.crc_zstd"] == 1 and k["zstd.encode_chunks"] == 1, k
# dryrun: 3 cluster ticks, 1 election, 2 commit steps
assert k["cluster.tick"] == 1 + 3 // 4 and k["cluster.election_round"] == 1, k
assert k["quorum.commit_step"] == 1, k
# one call counts once, under its own name: the composites reach the
# raw fold / commit / codec functions
for inner in ("quorum.fold_replies", "lz4.compress_chunks"):
    assert k[inner] == 0, (inner, k)
assert st["tick_violations"] == 0
print("ARMED-LIVE-OK")
"""


def test_armed_live_path_counts_each_call_once(tmp_path):
    out = _run_armed(tmp_path, _LIVE, extra_env={"RP_DEVPLANE_SAMPLE": "4"})
    assert out.returncode == 0, out.stderr
    assert "ARMED-LIVE-OK" in out.stdout


_ATTRIBUTION = """\
from redpanda_tpu_torch.observability import devplane
from redpanda_tpu_torch.utils import compileguard

def inner(x):
    compileguard.report_build("quorum", 3.0)
    return x

def outer(x):
    return kin(x)

kin = devplane.instrument(inner, "t.inner")
kout = devplane.instrument(outer, "t.outer")
kout(1)
compileguard.report_build("health", 1.0)     # outside any kernel
counts = compileguard.compile_counts()
assert counts["t.inner"] == 1 and "t.outer" not in counts, counts
assert counts["csrc/health.cu"] == 1, counts
st = devplane.status()
assert st["compiles"]["t.inner"] == {"warmup": 1.0, "steady": 0.0, "seconds": 3.0}
print("ARMED-ATTRIBUTION-OK")
"""


def test_armed_build_attributed_to_probe(tmp_path):
    out = _run_armed(tmp_path, _ATTRIBUTION)
    assert out.returncode == 0, out.stderr
    assert "ARMED-ATTRIBUTION-OK" in out.stdout
