#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (redpanda_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each raising on any mismatch:
  1. the card (nvidia-smi name and power limit; the bounds assume an
     H100 SXM and the script refuses another card) and the nvcc build of
     every kernel in redpanda_tpu_torch/csrc, one nvcc per source;
  2. every kernel against its plain PyTorch version on the card at the
     replication tick's shapes (G=50,000 groups, R=8 slots, M=100,000
     replies with duplicate pairs and stale seqs, H=50,000 heartbeat
     rows), the fold, the commit sweep and the tick frame kernel also at
     R=5, 3, 12 and 32 (padded rows, the 16- and 32-slot kernels; the
     fold's and the frame's cooperative grids logged); the tick's launch
     sequences (heartbeat_tick: fold + sweep; tick_frame and
     tick_frame_health: one launch of the frame kernel) against their
     plain chains; batches that mix rows -1, -G, -G-1, G, G+5 and slots
     -1, -R, -R-1, R with in-range replies through fold_replies,
     local_append_update, build_heartbeats and the frame (both forms),
     each exact against its plain version; and on CRC rows (1,024 ragged rows of ~16.4 KiB, 4,096 rows
     of 4 KiB, rows at every start alignment mod 16 with lengths at the
     kernel's piece, tile and team boundaries, one row of 1 MiB and one of
     4 MiB + 3 bytes held to the host CRC); all outputs are integers, so
     every comparison is exact; beside the CRC's times, an empty kernel
     launched at its launch shape (the floor);
  3. the main path end to end: a 50,000-group ShardGroupArrays at RF=3
     on the card, driven by a TickFrame for 25 ticks of seeded follower
     acks and leader appends (every fifth tick a fused frame_tick with
     heartbeat rows: one launch of the frame kernel, health included),
     then one health_refresh on the device backend (health_reduce), all
     held lane for lane against the numpy host leg;
  4. the second half of the main path: Kafka CRCs of 1,024 record
     batches (16 records of 1 KiB each) through models.record.batch_crcs
     on the card, against the CRCs the host computed at build time, and
     a corrupted staged row that must be the only mismatch;
  5. the codec kernels (cell parse, LZ4 and snappy emission) against
     their plain versions at the fused path's shape (256 rows of 32 KiB
     bodies read in place after the 40-byte CRC prefix) and the codec
     shape (16 rows of 64 KiB), on 64 short, empty and ragged rows, and on
     an all-random 64 KiB row (no sequence: the whole block is the final
     literal run) beside an empty one (v = 0), and through both emissions
     where the size pass loads cells one by one (rows of 17 cells; parse
     vectors off a 16-byte boundary): equal parse vectors, equal lengths
     and equal bytes on [0, out_len);
     and at the fused shape `_fused` and `_fused_snappy` (the path 256
     rows take: one launch of the cluster kernel, rp_fused_lz4 /
     rp_fused_snappy, csrc/fused.cu) exact against the plain chain (CRC,
     lengths, block bytes);
  5b. the kernels at the shapes one call gives them, each exact against
     its plain version and timed: CRC, parse and LZ4 emission on phase
     6's one fused row (one 16 x 1 KiB batch), and `_fused` and
     `_fused_snappy` there (one cluster launch each) beside the empty
     cluster launch at its shape and the three-launch sequence it
     replaced, and both on the parse's skew edges at one row (one byte,
     distinct 4-grams, random bytes, zeros at v in {0, 1, 3, 4, 5} and
     full, n = 512 and 65,536; the host CRC) at every cluster size
     `plan` can choose, the zstd encode on phase
     8b's one row, `_fused_zstd` there (one rp_fused_zstd launch, exact
     against the plain chain and the host CRC) beside the empty encode
     launch and the two-launch sequence it replaced, the decode of that
     block's four streams, and the
     parse and both emissions on two full-width 64 KiB skew edges (one
     repeated byte; all 4-grams distinct); beside them the per-launch
     floor, one empty kernel launch timed the same way;
  6. the codec path end to end: 1,024 batches (16 x 1 KiB records, half
     JSON-like text, half random bytes) through RecordBatch.recompressed
     (lz4) under RP_CODEC_BACKEND=device (one launch of the fused
     cluster kernel a batch), each CRC checked on the card
     against the host CRC and each frame decoded back here (pure-Python
     LZ4 and snappy decoders: the image need not carry liblz4 or
     libsnappy), a flipped wire CRC refused, and 16 x 64 KiB buffers
     through the registry backend's LZ4 and snappy legs;
  7. the zstd kernels (encode, decode) against their plain versions,
     exact on every output: 32 full-width 64 KiB chunks of the phase 8
     segment, edge rows at every bucket n = 256 ... 65536, rows of
     lengths 1-5 and v = 1, 5, 15 (mod 64) at odd column offsets and
     pitches (quarters at every alignment), one symbol over 64 KiB, the
     Kraft down loop at 64 KiB, the fused CRC + encode (`_fused_zstd`:
     one rp_fused_zstd launch a call) at the fused shape and on edge rows
     (v = 0, 1, 3, 4, 5, 8, n - 1, n of random bytes and of one repeated
     byte at n = 512 and 65,536, each alone and 40 to a launch), exact
     against the plain CRC, the host CRC and the plain encode, timed
     beside the two-launch sequence it replaced, and tampered, truncated
     and regen = 0 streams (the decode error names the same stream);
  8. the tiered segment path at full size: one 128 MiB segment of
     serialized record batches (a quarter JSON-like values, a quarter
     random, half zipf-skewed) through compression.compress / uncompress
     (zstd) under RP_ZSTD_BACKEND=tpu, three passes, byte-exact with no
     punt to the host codec, 8 blocks checked by the pure-Python
     reference decoder, the stage split, and each zstd kernel at the
     path's shapes against its plain version;
  8b. 1,024 batches through recompressed(zstd) and .records() under
     RP_ZSTD_BACKEND=tpu, records equal to the originals';
  9. the mesh backend (RP_QUORUM_BACKEND=mesh, RP_MESH_FULL=1) at
     1,000,000 rows over D=8 chip blocks on the card, a quarter of the
     rows in joint consensus: 10 windows of 512 replies and 2 of 8,192
     (duplicates, stale seqs) through a TickFrame and one
     health_refresh, against the numpy host leg built from the same
     seed (lanes, advanced rows, health lanes, fleet totals), then at
     D=3 on 100,003 rows (padding rows); each full frame is the fold
     kernel and one pass of the mesh sweep kernel over the rows
     (mesh_tick_frame), the refresh one health_totals; health_totals,
     the mesh frame, fold_replies and
     quorum_commit_step against their plain versions at 1M rows (each
     timed alone beside its bound; the mesh frame also at EXTRA_SLOTS
     and on the mixed-index batch in phase 2) and the fold and the sweep
     also on the D=3 run's lanes;
  10. the RF=3 ring cluster at 1,000,000 groups over D=8 blocks, resident
     on the card: __graft_entry__.dryrun_multichip's scenario with its
     assertions, then 20 seeded ticks (elections every fifth tick,
     retention stranding mirrors) with every lane, elected, the terms
     and both totals equal to the plain versions after every call; the
     cluster kernels and the two follower-side quorum rules (no main-path
     caller, held against their plain versions; the follower rule also
     on G - 3 rows and on a view one row in) on the device clock,
     local_append_update also beside the library's two
     scatter_reduce_(amax) calls on the same appends.
The launch counters are zeroed just before each main-path phase (3, 4,
6, 8, 8b, 9 and 10) and read just after; every kernel must have
launched there, except those in OFF_PATH (follower_commit_step,
local_append_update, build_heartbeats, fused_snappy, fused_zstd).

Output: progress lines, the card line, one JSON line of per-kernel
numbers, and last `{"ok": true, "device": {...}}`. Without a CUDA card
it exits 2 and prints no result.

The traffic generator and the leg driver below are also used by
tests/test_torch_slice.py on the CPU (device="cpu").
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from redpanda_tpu_torch.ops import cellparse as parse_ops
from redpanda_tpu_torch.ops import crc32c as crc_ops
from redpanda_tpu_torch.ops import fused as fused_ops
from redpanda_tpu_torch.ops import health as health_ops
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import quorum as quorum_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops
from redpanda_tpu_torch.ops import zstd as zstd_ops
from redpanda_tpu_torch.parallel import cluster_step as cluster_ops

G, R, RF = 50_000, 8, 3
M_REPLIES, H_ROWS = 100_000, 50_000
TICKS, HB_EVERY = 25, 5
SEED = 20_240_601

# the bounds' device memory rate: H100 SXM data sheet, the card the port targets
CARD = "H100 80GB HBM3"
MEM_BYTES_PER_S = 3.35e12
# replica-slot counts beside the path's R=8 at which the fold and the commit
# kernel are also held to their plain versions: padded rows (R < 8) and the
# 16- and 32-slot instantiations of the commit kernel
EXTRA_SLOTS = (5, 3, 12, 32)

KERNELS = {
    # name: (source, TPU program it replaces, launch counter dict)
    "fold_replies": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/ops/quorum.py:172", quorum_ops.LAUNCHES),
    "quorum_commit_step": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/ops/quorum.py:110", quorum_ops.LAUNCHES),
    "build_heartbeats": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/ops/quorum.py:196", quorum_ops.LAUNCHES),
    "tick_frame": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/ops/quorum.py:283", quorum_ops.LAUNCHES),
    "health_reduce": ("redpanda_tpu_torch/csrc/health.cu", "redpanda_tpu/ops/health.py:39", health_ops.LAUNCHES),
    "crc32c_device": ("redpanda_tpu_torch/csrc/crc32c.cu", "redpanda_tpu/ops/crc32c.py:226", crc_ops.LAUNCHES),
    "cell_parse": ("redpanda_tpu_torch/csrc/codec.cu", "redpanda_tpu/ops/cellparse.py:30", parse_ops.LAUNCHES),
    "lz4_emit": ("redpanda_tpu_torch/csrc/codec.cu", "redpanda_tpu/ops/lz4.py:59", lz4_ops.LAUNCHES),
    "snappy_emit": ("redpanda_tpu_torch/csrc/codec.cu", "redpanda_tpu/ops/snappy.py:52", snappy_ops.LAUNCHES),
    "fused_lz4": ("redpanda_tpu_torch/csrc/fused.cu", "redpanda_tpu/ops/fused.py:42", fused_ops.LAUNCHES),
    "fused_snappy": ("redpanda_tpu_torch/csrc/fused.cu", "redpanda_tpu/ops/fused.py:69", fused_ops.LAUNCHES),
    "fused_zstd": ("redpanda_tpu_torch/csrc/zstd.cu", "redpanda_tpu/ops/fused.py:89", fused_ops.LAUNCHES),
    "zstd_encode": ("redpanda_tpu_torch/csrc/zstd.cu", "redpanda_tpu/ops/zstd.py:190", zstd_ops.LAUNCHES),
    "zstd_decode": ("redpanda_tpu_torch/csrc/zstd.cu", "redpanda_tpu/ops/zstd.py:274", zstd_ops.LAUNCHES),
    "health_totals": ("redpanda_tpu_torch/csrc/health.cu", "redpanda_tpu/parallel/mesh_frame.py:103", health_ops.LAUNCHES),
    "mesh_tick_frame": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/parallel/mesh_frame.py:63", quorum_ops.LAUNCHES),
    "cluster_tick": ("redpanda_tpu_torch/csrc/cluster.cu", "redpanda_tpu/parallel/cluster_step.py:105", cluster_ops.LAUNCHES),
    "election_round": ("redpanda_tpu_torch/csrc/cluster.cu", "redpanda_tpu/parallel/cluster_step.py:232", cluster_ops.LAUNCHES),
    "follower_commit_step": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/ops/quorum.py:154", quorum_ops.LAUNCHES),
    "local_append_update": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/ops/quorum.py:211", quorum_ops.LAUNCHES),
}
# codec shapes: the fused path's 256 rows x 32 KiB bodies (alternately seeded
# random and a repeated pattern, read in place after the 40-byte CRC prefix;
# bench.py:850-875) and the codec path's 16 x 64 KiB JSON-like rows
# (bench.py:961-965)
FUSED_ROWS, FUSED_BODY = 256, 32 * 1024
CODEC_ROWS, CODEC_BODY = 16, 64 * 1024
N_BATCHES, RECORDS, RECORD_BYTES = 1024, 16, 1024
# the tiered path: one log segment at the segment.bytes default
# (redpanda_tpu/kafka/server_admin.py:52, storage/log.py:23), compressed and
# hydrated in 64 KiB zstd blocks (compression/tpu_backend.py RP_ZSTD_BLOCK)
SEGMENT_BYTES, ZSTD_BLOCK, ZSTD_CHECK_CHUNKS = 134_217_728, 65536, 32
KINDS = ("json", "random", "zipf", "zipf")
# the mesh backend at bench.py:478 bench_mesh_flat's scale (1,000,000
# partitions, 8 devices, 512-reply windows) plus windows at and past
# MESH_FULL_THRESHOLD (4,096), and once at 3 blocks on a row count they
# do not divide; the ring cluster of __graft_entry__.dryrun_multichip at
# the same scale (RF = 3), 20 seeded ticks
MESH_G, MESH_D = 1_000_000, 8
MESH_WINDOW, MESH_WINDOWS, MESH_BIG_WINDOW, MESH_BIG_WINDOWS = 512, 10, 8192, 2
MESH_PAD_G, MESH_PAD_D = 100_003, 3
CLUSTER_G, CLUSTER_TICKS = 1_000_000, 20
# the frame kernel also replaces the health stage of tick_frame_health
ALSO_REPLACES = {"tick_frame": "redpanda_tpu/ops/health.py:90"}
# kernels with no caller on a main path, as in the reference: the follower
# rules (held against their plain versions at the cluster shape), the
# standalone heartbeat gather, whose one caller, the tick frame, runs it
# inside the frame kernel (the reference's build_heartbeats_jit has no
# caller outside tick_frame either), the fused CRC + snappy (the
# registry's snappy leg compresses without a CRC; held at phases 5 and 5b)
# and the fused CRC + zstd (crc_zstd_fused has no caller in the package,
# as in the reference; held at phases 5b and 7)
OFF_PATH = ("follower_commit_step", "local_append_update", "build_heartbeats", "fused_snappy", "fused_zstd")


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    for _, _, counts in KERNELS.values():
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ traffic
class Traffic:
    """Seeded replication traffic for `g` leader groups at `rf`
    replicas (slot 0 = the leader). Each tick the leader appends on
    about half the groups with fsync lagging a little, and the
    followers send `per_group * g` acks: random (group, follower)
    pairs, so one window holds duplicate pairs, with seqs out of order
    inside the window and a tenth of them stale."""

    def __init__(self, g: int, rf: int = RF, seed: int = SEED, per_group: int = 2):
        self.rng = np.random.default_rng(seed)
        self.g, self.rf, self.per_group = g, rf, per_group
        self.dirty = np.zeros(g, np.int64)
        self.flushed = np.zeros(g, np.int64)
        self.acked = np.full((g, rf), -1, np.int64)
        self.t = 0

    def tick(self):
        """(moved groups, leader dirty, leader flushed, replies) where
        replies = (groups, slots, dirty, flushed, seqs)."""
        rng, g = self.rng, self.g
        self.t += 1
        grow = rng.random(g) < 0.5
        self.dirty += np.where(grow, rng.integers(1, 8, g), 0)
        self.flushed = np.maximum(self.flushed, self.dirty - rng.integers(0, 3, g))
        m = self.per_group * g
        groups = rng.integers(0, g, m).astype(np.int64)
        slots = rng.integers(1, self.rf, m).astype(np.int64)
        ack = np.minimum(self.dirty[groups], self.acked[groups, slots] + rng.integers(0, 10, m))
        stale = rng.random(m) < 0.1
        seqs = (4 * self.t + rng.integers(0, 4, m) - np.where(stale, 8, 0)).astype(np.int64)
        np.maximum.at(self.acked, (groups[~stale], slots[~stale]), ack[~stale])
        fl = np.maximum(ack - rng.integers(0, 3, m), -1).astype(np.int64)
        return np.flatnonzero(grow), self.dirty.copy(), self.flushed.copy(), (groups, slots, ack, fl, seqs)


def setup_leg(arrays, g: int, rf: int = RF) -> np.ndarray:
    """Allocate `g` leader rows at `rf` voters (self is slot 0, known
    leader) and mark them for a first full quorum pass."""
    rows = np.array([arrays.alloc_row() for _ in range(g)], np.int64)
    arrays.is_leader[rows] = True
    arrays.is_voter[rows, :rf] = True
    arrays.term[rows] = 1
    arrays.term_start[rows] = 0
    arrays.leader_id[rows] = 0
    arrays.match_index[rows, 0] = 0
    arrays.flushed_index[rows, 0] = 0
    arrays.quorum_dirty[rows] = True
    arrays.voter_epoch += 1
    arrays.touch()
    return rows


def drive_tick(arrays, frame, rows, event, hb: bool):
    """Apply one Traffic event to a leg: the leader's own slot moves,
    then either a TickFrame window (half the acks enqueued one by one,
    half handed to fold_now as the heartbeat fold's vectors) or, on a
    heartbeat tick, one fused frame_tick with every row's heartbeat.
    Returns (advanced rows, heartbeat fields or None, seconds spent in
    the fold call)."""
    moved, dirty, flushed, (groups, slots, ack, fl, seqs) = event
    mrows = rows[moved]
    arrays.match_index[mrows, 0] = dirty[moved]
    arrays.flushed_index[mrows, 0] = flushed[moved]
    arrays.touch()
    grows = rows[groups]
    if hb:
        t0 = time.perf_counter()
        advanced, hbf = arrays.frame_tick(grows, slots, ack, fl, seqs, hb_rows=rows, force_rows=mrows)
        return advanced, hbf, time.perf_counter() - t0
    for r in mrows:
        frame.note_self(int(r))
    half = len(grows) // 2
    for i in range(half):
        frame.enqueue_reply(int(grows[i]), int(slots[i]), int(ack[i]), int(fl[i]), int(seqs[i]))
    t0 = time.perf_counter()
    advanced = frame.fold_now(grows[half:], slots[half:], ack[half:], fl[half:], seqs[half:])
    return advanced, None, time.perf_counter() - t0


LANES = ("commit_index", "last_visible", "match_index", "flushed_index", "last_seq")
HEALTH_LANES = ("health_max_lag", "health_under", "health_leaderless")


@contextlib.contextmanager
def env_backend(var: str, name: str):
    old = os.environ.get(var)
    os.environ[var] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ[var]
        else:
            os.environ[var] = old


def quorum_backend(name: str):
    return env_backend("RP_QUORUM_BACKEND", name)


def codec_backend(name: str):
    return env_backend("RP_CODEC_BACKEND", name)


def assert_equal(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = np.argwhere(a != b)[:5] if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: device leg != host leg (first diffs at {bad})")


def run_slice(g: int, ticks: int, device: str, seed: int = SEED) -> dict:
    """The replication slice on two legs fed identical traffic: the
    device leg (RP_QUORUM_BACKEND=device on `device`) and the numpy host
    leg. Raises on the first lane that differs; returns per-tick
    timings of both legs' fold calls and the device leg's stages."""
    from redpanda_tpu_torch.ops.health import health_reduce_np
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays
    from redpanda_tpu_torch.raft.tick_frame import TickFrame

    dev = ShardGroupArrays(capacity=g, device=device)
    host = ShardGroupArrays(capacity=g, device="cpu")
    dev_rows, host_rows = setup_leg(dev, g), setup_leg(host, g)
    dev_frame, host_frame = TickFrame(dev), TickFrame(host)
    traffic = Traffic(g, seed=seed)
    dev.stage_ms = {}
    tick_s, host_tick_s, advanced_total = [], [], 0
    for t in range(ticks):
        event = traffic.tick()
        hb = (t + 1) % HB_EVERY == 0
        with quorum_backend("device"):
            adv_d, hb_d, secs = drive_tick(dev, dev_frame, dev_rows, event, hb)
        with quorum_backend("host"):
            adv_h, hb_h, host_secs = drive_tick(host, host_frame, host_rows, event, hb)
        tick_s.append(secs)
        host_tick_s.append(host_secs)
        assert_equal(adv_d, adv_h, f"tick {t}: advanced rows")
        advanced_total += len(adv_d)
        for lane in LANES:
            assert_equal(getattr(dev, lane), getattr(host, lane), f"tick {t}: {lane}")
        if hb:
            for k in hb_h:
                assert_equal(hb_d[k], hb_h[k], f"tick {t}: heartbeat {k}")
            want = health_reduce_np(
                host.match_index, host.commit_index, host.is_voter, host.is_voter_old,
                host.is_leader, host.leader_id >= 0, host.row_active,
            )
            for lane, k in zip(HEALTH_LANES, ("max_lag", "under_replicated", "leaderless")):
                assert_equal(getattr(dev, lane), want[k], f"tick {t}: fused {lane}")
    with quorum_backend("device"):
        totals_d = dev_frame.health_totals()
    with quorum_backend("host"):
        totals_h = host_frame.health_totals()
    for lane in HEALTH_LANES:
        assert_equal(getattr(dev, lane), getattr(host, lane), lane)
    if totals_d != totals_h:
        raise AssertionError(f"health_totals: {totals_d} != {totals_h}")
    if advanced_total == 0:
        raise AssertionError("no commit advanced in the whole run")
    return {
        "tick_s": tick_s,
        "host_tick_s": host_tick_s,
        "stage_ms": dev.stage_ms,
        "advanced_rows": advanced_total,
        "health_totals": totals_d,
    }


# ------------------------------------------------------------- timing
def _events():
    import torch

    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def time_kernel(fn, reset=None, reps: int = 30) -> float:
    """Median device ms of one launch. A spin kernel queued ahead keeps
    the stream busy while the host enqueues the events and the launch,
    so the two events bracket the kernel and not the wrapper's Python."""
    import torch

    start, end = _events()
    out = []
    for _ in range(reps):
        if reset is not None:
            reset()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def time_plain(fn, reset=None, reps: int = 5) -> float:
    """Median ms of the plain version, host gaps included."""
    import torch

    start, end = _events()
    out = []
    for _ in range(reps):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def max_abs_err(a: dict, b: dict) -> float:
    err = 0.0
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not bool((x == y).all()):
            raise AssertionError(f"kernel != plain on {k}")
        err = max(err, float((x.double() - y.double()).abs().max()) if x.numel() else 0.0)
    return err


# ----------------------------------------------------- phase 2 inputs
def random_state_fields(rng, g: int, r: int) -> dict:
    """[G, R] lanes with 0..R voters per row, joint configs on a fifth
    of the rows, NO_OFFSET sentinels, and mixed leaders."""
    n_voters = rng.integers(0, r + 1, g)
    voter = np.arange(r)[None, :] < n_voters[:, None]
    old = (rng.random((g, r)) < 0.5) & (rng.random(g) < 0.2)[:, None]
    match = rng.integers(-1, 100_000, (g, r)).astype(np.int64)
    match[rng.random((g, r)) < 0.1] = -1
    flushed = np.maximum(match - rng.integers(0, 50, (g, r)), -1).astype(np.int64)
    commit = rng.integers(-1, 60_000, g).astype(np.int64)
    return {
        "term": rng.integers(0, 9, g).astype(np.int64),
        "is_leader": rng.random(g) < 0.8,
        "commit_index": commit,
        "term_start": rng.integers(0, 70_000, g).astype(np.int64),
        "last_visible": commit,
        "match_index": match,
        "flushed_index": flushed,
        "is_voter": voter,
        "is_voter_old": old,
        "last_seq": rng.integers(0, 5, (g, r)).astype(np.int64),
    }


def padded_replies(rng, g: int, r: int, m: int):
    """M replies over a quarter of the groups (so pairs repeat), a
    tenth stale, padded to the next power of two with shard_state's
    no-op entries (row 0, slot 0, seq i64 min)."""
    bucket = 8
    while bucket < m:
        bucket *= 2
    i64_min = np.iinfo(np.int64).min
    rows = np.zeros(bucket, np.int64)
    slots = np.zeros(bucket, np.int64)
    dirty = np.full(bucket, i64_min, np.int64)
    flushed = np.full(bucket, i64_min, np.int64)
    seqs = np.full(bucket, i64_min, np.int64)
    rows[:m] = rng.integers(0, g // 4, m)
    slots[:m] = rng.integers(0, r, m)
    dirty[:m] = rng.integers(-1, 120_000, m)
    flushed[:m] = dirty[:m] - rng.integers(0, 30, m)
    seqs[:m] = rng.integers(0, 10, m)
    return rows, slots, dirty, flushed, seqs


def crc_rows(rng, n: int, stride: int, min_len: int):
    lens = rng.integers(min_len, stride + 1, n).astype(np.int64)
    lens[0] = 0
    lens[1] = stride
    data = rng.integers(0, 256, (n, stride), dtype=np.uint8)
    data[np.arange(stride)[None, :] >= lens[:, None]] = 0
    return data, lens


def crc_floor_ms(torch, n: int) -> float:
    """One empty kernel launched with crc32c_device's grid, block and
    shared memory for n rows, timed as the kernels are."""
    from redpanda_tpu_torch.ops import _build

    lib = crc_ops._lib()
    _build.bind(lib, "rp_crc32c_empty", 0, 1)
    stream = torch.cuda.current_stream().cuda_stream
    return time_kernel(lambda: _build.check(lib, lib.rp_crc32c_empty(n, stream), "empty"), reps=30)


def crc_boundary_lengths(team: int, w: int) -> list:
    """Lengths at the edges of one of the CRC kernel's shapes: the scalar
    head and tail, a lane's piece (w), a warp's tile, a team's round of
    tiles."""
    tile = 32 * w
    return [0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 19, 20, w - 1, w, w + 1,
            tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile + 1,
            team * tile - 1, team * tile + 1, (2 * team + 1) * tile + 3]


def crc_edge_rows(torch, rng) -> None:
    """crc32c_device on rows at every start alignment mod 16 (odd
    strides) with lengths at the kernel's boundaries, through both of its
    launch shapes (up to one row an SM, and more), exact against the
    plain version and the host CRC; and one row of 1 MiB and one of
    4 MiB + 3 bytes (Kafka's message.max.bytes is 1,048,588) against the
    host CRC alone: the plain version steps column by column."""
    from redpanda_tpu_torch.utils.crc import crc32c_batch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, (team, w) in ((min(64, sms), crc_ops.ONE), (300, crc_ops.MANY)):
        stride = 32 * w * (2 * team + 2) + 1
        lens_np = rng.integers(0, stride + 1, n).astype(np.int64)
        edges = crc_boundary_lengths(team, w)
        lens_np[: len(edges)] = edges
        data_np = rng.integers(0, 256, (n, stride), dtype=np.uint8)
        data = torch.from_numpy(data_np).cuda()
        lens = torch.from_numpy(lens_np).cuda()
        got = crc_ops.crc32c_device(data, lens)
        torch.cuda.synchronize()
        max_abs_err({"crc": got}, {"crc": crc_ops.crc32c_device_plain(data, lens)})
        assert_equal(got.cpu().numpy().astype(np.uint32), crc32c_batch(data_np, lens_np.astype(np.uint64)),
                     f"crc edges B={n} S={stride} vs host")
        log(f"[kernels] crc32c_device edges B={n} S={stride}: rows at every start mod 16, "
            f"lengths {sorted(set(edges))[:6]}... {len(edges)} boundary lengths: equal to plain and host")
    for size in (1 << 20, (4 << 20) + 3):
        data_np = rng.integers(0, 256, (1, size), dtype=np.uint8)
        data = torch.from_numpy(data_np).cuda()
        lens = torch.tensor([size], device="cuda")
        got = crc_ops.crc32c_device(data, lens).cpu().numpy().astype(np.uint32)
        assert_equal(got, crc32c_batch(data_np, np.array([size], np.uint64)), f"crc long row {size} vs host")
        ms = time_kernel(lambda: crc_ops.crc32c_device(data, lens), reps=5)
        log(f"[kernels] crc32c_device long row of {size} B: equal to the host CRC, {ms:.4f} ms")


def phase_kernels(torch, mem_rate: float) -> dict:
    """Phase 2: each kernel vs its plain version on the card."""
    from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy
    from redpanda_tpu_torch.utils.crc import crc32c_batch

    rng = np.random.default_rng(SEED)
    fields = random_state_fields(rng, G, R)
    base = group_state_from_numpy(fields, "cuda")
    work = group_state_from_numpy(fields, "cuda")

    def reset():
        for a, b in zip(work, base):
            a.copy_(b)

    def lanes(state):
        return {k: getattr(state, k).clone() for k in state._fields}

    def bound(nbytes):
        return nbytes / mem_rate * 1e3

    out = {}
    # -- fold_replies
    replies_np = padded_replies(rng, G, R, M_REPLIES)
    replies = [torch.from_numpy(a).cuda() for a in replies_np]
    reset()
    want = lanes(quorum_ops.fold_replies_plain(work, *replies))
    reset()
    got = lanes(quorum_ops.fold_replies(work, *replies))
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    rows, slots, _, _, seqs = replies_np
    cell = rows * R + slots
    fresh = seqs > fields["last_seq"].reshape(-1)[cell]
    uniq, uniq_fresh = len(np.unique(cell)), len(np.unique(cell[fresh]))
    blocks, threads, its = quorum_ops.fold_grid(len(rows))
    log(f"[kernels] fold_replies: one cooperative launch of {blocks} blocks x {threads} threads, {its} "
        f"reply(ies) a thread, at M={len(rows)}")
    out["fold_replies"] = {
        "shape": f"G={G} R={R} M={len(rows)} (of which {M_REPLIES} real, {int(fresh.sum())} fresh)",
        "max_abs_err": err,
        "ms": time_kernel(lambda: quorum_ops.fold_replies(work, *replies), reset),
        "plain_ms": time_plain(lambda: quorum_ops.fold_replies_plain(work, *replies), reset),
        # group, slot and seq of every entry, dirty and flushed of every
        # fresh reply; last_seq read once per addressed pair; match and
        # flushed read and all three lanes written once per fresh pair
        "bound_ms": bound(24 * len(rows) + 16 * int(fresh.sum()) + 8 * uniq + 40 * uniq_fresh),
    }
    # -- quorum_commit_step
    reset()
    want = lanes(quorum_ops.quorum_commit_step_plain(work))
    reset()
    got = lanes(quorum_ops.quorum_commit_step(work))
    torch.cuda.synchronize()
    out["quorum_commit_step"] = {
        "shape": f"G={G} R={R}",
        "max_abs_err": max_abs_err(got, want),
        "ms": time_kernel(lambda: quorum_ops.quorum_commit_step(work), reset),
        "plain_ms": time_plain(lambda: quorum_ops.quorum_commit_step_plain(work), reset),
        # match, flushed (i64) and both voter masks (bool) over [G, R];
        # is_leader, term_start, commit, last_visible read; two written
        "bound_ms": bound(G * R * (8 + 8 + 1 + 1) + G * (1 + 8 + 8 + 8) + G * 16),
    }
    padded_slot_counts(torch, rng)
    # -- build_heartbeats (on the post-advance lanes)
    hb_idx = torch.from_numpy(rng.permutation(G)[:H_ROWS].astype(np.int64)).cuda()
    want = quorum_ops.build_heartbeats_plain(work, hb_idx)
    got = quorum_ops.build_heartbeats(work, hb_idx)
    torch.cuda.synchronize()
    out["build_heartbeats"] = {
        "shape": f"G={G} R={R} H={H_ROWS}",
        "max_abs_err": max_abs_err(got, want),
        "ms": time_kernel(lambda: quorum_ops.build_heartbeats(work, hb_idx)),
        "plain_ms": time_plain(lambda: quorum_ops.build_heartbeats_plain(work, hb_idx)),
        # hb_idx read, four gathered fields read and written
        "bound_ms": bound(H_ROWS * (8 + 4 * 8 + 4 * 8)),
    }
    # -- health_reduce
    known = torch.from_numpy(rng.random(G) < 0.5).cuda()
    active = torch.from_numpy(rng.random(G) < 0.95).cuda()
    hargs = (work.match_index, work.commit_index, work.is_voter, work.is_voter_old,
             work.is_leader, known, active)
    want = health_ops.health_reduce_plain(*hargs)
    got = health_ops.health_reduce(*hargs)
    torch.cuda.synchronize()
    out["health_reduce"] = {
        "shape": f"G={G} R={R}",
        "max_abs_err": max_abs_err(got, want),
        "ms": time_kernel(lambda: health_ops.health_reduce(*hargs)),
        "plain_ms": time_plain(lambda: health_ops.health_reduce_plain(*hargs)),
        # match (i64) and both masks over [G, R]; commit, three flags;
        # max_lag and two flags written
        "bound_ms": bound(G * R * (8 + 1 + 1) + G * (8 + 3) + G * (8 + 2)),
    }
    sequences(torch, out, work, reset, replies, hb_idx, known, active, fresh, uniq, uniq_fresh, bound)
    mixed_indices(torch, rng, fields, known, active)
    # -- crc32c_device at the ragged record-batch shape and the bench shape
    for label, (n, stride, min_len) in (
        ("ragged", (1024, 16_800, 16_000)),
        ("bench", (4096, 4096, 0)),
    ):
        data_np, lens_np = crc_rows(rng, n, stride, min_len)
        data = torch.from_numpy(data_np).cuda()
        lens = torch.from_numpy(lens_np).cuda()
        want = {"crc": crc_ops.crc32c_device_plain(data, lens)}
        got = {"crc": crc_ops.crc32c_device(data, lens)}
        torch.cuda.synchronize()
        host = crc32c_batch(data_np, lens_np.astype(np.uint64))
        assert_equal(got["crc"].cpu().numpy().astype(np.uint32), host, f"crc {label} vs host")
        entry = {
            "shape": f"B={n} S={stride} bytes={int(lens_np.sum())}",
            "max_abs_err": max_abs_err(got, want),
            "ms": time_kernel(lambda: crc_ops.crc32c_device(data, lens)),
            "plain_ms": time_plain(lambda: crc_ops.crc32c_device_plain(data, lens), reps=1),
            # every row byte once, lens read, one u32 per row written
            "bound_ms": bound(int(lens_np.sum()) + 8 * n + 4 * n),
            "floor_ms": crc_floor_ms(torch, n),
        }
        if label == "ragged":
            out["crc32c_device"] = entry
        else:
            out["crc32c_device@bench"] = entry
    crc_edge_rows(torch, rng)
    for name, e in out.items():
        floor = f", empty kernel at its launch shape {e['floor_ms']:.4f} ms" if "floor_ms" in e else ""
        log(
            f"[kernels] {name:<22} {e['shape']}: equal to plain, tolerance exact "
            f"(max_abs_err {e['max_abs_err']}); "
            f"kernel {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms{floor}"
        )
    return out


def sequences(torch, out, work, reset, replies, hb_idx, known, active, fresh, uniq, uniq_fresh,
              bound) -> None:
    """The tick's sequences at the path's shapes, each held exactly
    against its plain chain (state lanes, heartbeat fields, health
    lanes) and timed on the device clock beside the bytes it must move
    as one function: the replies (group, slot, seq of every entry; dirty,
    flushed of every fresh one), last_seq once per addressed pair, match /
    flushed / both voter masks over [G, R] and four [G] lanes read once,
    the fresh pairs' three lanes and two [G] lanes written; the heartbeat
    gather adds hb_idx and term read and four fields written per row; the
    health adds two [G] flags read and max_lag plus two flags written.
    heartbeat_tick is two launches (fold, sweep); tick_frame and
    tick_frame_health one launch of the frame kernel each, entered as
    "tick_frame" (the health form is the one the main path calls)."""
    m, nf = len(replies[0]), int(fresh.sum())
    tick = (24 * m + 16 * nf + 8 * uniq + G * R * (8 + 8 + 1 + 1) + G * (1 + 8 + 8 + 8)
            + 24 * uniq_fresh + 16 * G)
    hb = H_ROWS * (8 + 8 + 4 * 8)
    health = G * 2 + G * (8 + 2)

    def plain_tick(hb_rows=None, health_lanes=False):
        state = quorum_ops.quorum_commit_step_plain(quorum_ops.fold_replies_plain(work, *replies))
        outs = [state._asdict()]
        if hb_rows is not None:
            outs.append(quorum_ops.build_heartbeats_plain(state, hb_rows))
        if health_lanes:
            outs.append(health_ops.health_reduce_plain(state.match_index, state.commit_index, state.is_voter,
                                                       state.is_voter_old, state.is_leader, known, active))
        return outs

    def kernel_tick():
        return [quorum_ops.heartbeat_tick(work, *replies)._asdict()]

    def kernel_frame():
        state, beats = quorum_ops.tick_frame(work, *replies, hb_idx)
        return [state._asdict(), beats]

    def kernel_frame_health():
        state, beats, lanes = health_ops.tick_frame_health(work, *replies, hb_idx, known, active)
        return [state._asdict(), beats, lanes]

    def held(fn, plain) -> float:
        reset()
        got = [{k: v.clone() for k, v in d.items()} for d in fn()]
        torch.cuda.synchronize()
        reset()
        want = plain()
        return max(max_abs_err(a, b) for a, b in zip(got, want))

    entries = {}
    for name, fn, plain, nbytes in (
        ("heartbeat_tick", kernel_tick, plain_tick, tick),
        ("tick_frame@no_health", kernel_frame, lambda: plain_tick(hb_idx), tick + hb),
        ("tick_frame", kernel_frame_health, lambda: plain_tick(hb_idx, True), tick + hb + health),
    ):
        entries[name] = {
            "shape": f"G={G} R={R} M={m} H={H_ROWS}", "max_abs_err": held(fn, plain),
            "ms": time_kernel(fn, reset), "plain_ms": time_plain(plain, reset),
            "bound_ms": bound(nbytes),
        }
    blocks, threads, its = quorum_ops.frame_grid(m, G, R, H_ROWS)
    log(f"[kernels] tick_frame: one cooperative launch of {blocks} blocks x {threads} threads, {its} "
        f"reply(ies) a thread, at M={m} G={G} H={H_ROWS}")
    no_health = entries.pop("tick_frame@no_health")
    entries["tick_frame"]["max_abs_err"] = max(entries["tick_frame"]["max_abs_err"], no_health["max_abs_err"])
    entries["tick_frame"]["no_health"] = {k: no_health[k] for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[kernels] tick_frame without health (quorum tick_frame): equal to plain, kernel "
        f"{no_health['ms']:.4f} ms, bound {no_health['bound_ms']:.4f} ms, plain {no_health['plain_ms']:.3f} ms")
    out.update(entries)


def mixed_index_batch(rng, g: int, r: int, m: int):
    """padded_replies with replies at rows -1, -G, -G-1, G, G+5 (in-range
    slots), at slots -1, -R, -R-1, R (in-range rows), at both, and the
    in-range twin of every wrapped pair, written over seeded entries with
    fresh seqs; and H_ROWS heartbeat rows with the same bad rows among
    duplicated in-range ones."""
    rows, slots, dirty, flushed, seqs = padded_replies(rng, g, r, m)
    bad_rows, bad_slots = [-1, -g, -g - 1, g, g + 5], [-1, -r, -r - 1, r]
    pairs = [(b, int(rng.integers(0, r))) for b in bad_rows] + [(int(rng.integers(0, g)), s) for s in bad_slots]
    pairs += [(b, s) for b in bad_rows for s in bad_slots]
    pairs += [(b + g if b < 0 else b, s + r if s < 0 else s) for b, s in pairs if -g <= b < g and -r <= s < r]
    at = rng.choice(m, len(pairs), replace=False)
    rows[at] = [p[0] for p in pairs]
    slots[at] = [p[1] for p in pairs]
    seqs[at] = rng.integers(5, 12, len(at))
    hb = rng.integers(0, g, H_ROWS).astype(np.int64)
    hb[rng.choice(H_ROWS, 70, replace=False)] = np.repeat(np.array(bad_rows, np.int64), 14)
    return (rows, slots, dirty, flushed, seqs), hb


def mixed_indices(torch, rng, fields, known, active) -> None:
    """Phase 2's out-of-range rows and slots: fold_replies,
    local_append_update, build_heartbeats, tick_frame and
    tick_frame_health on mixed_index_batch at G groups, each exact
    against its plain version (JAX's rule: wrap once, then drop or
    clamp)."""
    from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy

    replies_np, hb_np = mixed_index_batch(rng, G, R, M_REPLIES)
    replies = [torch.from_numpy(a).cuda() for a in replies_np]
    hb = torch.from_numpy(hb_np).cuda()
    rows, _, dirty, flushed, _ = replies

    def state():
        return group_state_from_numpy(fields, "cuda")

    def fold(s):
        return [quorum_ops.fold_replies(s, *replies)._asdict()]

    def fold_plain(s):
        return [quorum_ops.fold_replies_plain(s, *replies)._asdict()]

    def frame(s, health):
        if health:
            st, beats, lanes = health_ops.tick_frame_health(s, *replies, hb, known, active)
            return [st._asdict(), beats, lanes]
        st, beats = quorum_ops.tick_frame(s, *replies, hb)
        return [st._asdict(), beats]

    def frame_plain(s, health):
        st = quorum_ops.quorum_commit_step_plain(quorum_ops.fold_replies_plain(s, *replies))
        outs = [st._asdict(), quorum_ops.build_heartbeats_plain(st, hb)]
        if health:
            outs.append(health_ops.health_reduce_plain(st.match_index, st.commit_index, st.is_voter,
                                                       st.is_voter_old, st.is_leader, known, active))
        return outs

    for name, kern, plain in (
        ("fold_replies", fold, fold_plain),
        ("local_append_update", lambda s: [quorum_ops.local_append_update(s, rows, dirty, flushed)._asdict()],
         lambda s: [quorum_ops.local_append_update_plain(s, rows, dirty, flushed)._asdict()]),
        ("build_heartbeats", lambda s: [quorum_ops.build_heartbeats(s, hb)],
         lambda s: [quorum_ops.build_heartbeats_plain(s, hb)]),
        ("tick_frame", lambda s: frame(s, False), lambda s: frame_plain(s, False)),
        ("tick_frame_health", lambda s: frame(s, True), lambda s: frame_plain(s, True)),
        ("mesh_tick_frame", lambda s: mesh_frame_card(s, replies, known, active),
         lambda s: mesh_frame_plain(s, replies, known, active)),
    ):
        got = kern(state())
        torch.cuda.synchronize()
        for a, b in zip(got, plain(state())):
            max_abs_err(a, b)
    log(f"[kernels] rows {{-1, -G, -G-1, G, G+5}} x slots {{-1, -R, -R-1, R}} among {M_REPLIES} replies and "
        f"{H_ROWS} heartbeat rows: fold_replies, local_append_update, build_heartbeats, tick_frame, "
        f"tick_frame_health, mesh_tick_frame equal to plain, tolerance exact")


def mesh_frame_plain(state, replies, known, active) -> list:
    """The mesh frame's plain chain (the CPU path of
    parallel/mesh_frame.mesh_tick_frame): the plain fold and sweep, then
    health_totals_plain against the commit lane from before the frame
    (over one block: the totals do not depend on how rows are grouped).
    Returns [state lanes, health lanes, {"totals": [5]}]."""
    before = state.commit_index.clone()
    st = quorum_ops.quorum_commit_step_plain(quorum_ops.fold_replies_plain(state, *replies))
    health, totals = health_ops.health_totals_plain(st.match_index, st.commit_index, st.is_voter,
                                                    st.is_voter_old, st.is_leader, known, active, 1,
                                                    before=before)
    return [st._asdict(), health, {"totals": totals}]


def mesh_frame_card(state, replies, known, active) -> list:
    """The card's mesh frame (ops.quorum.launch_mesh_frame), as
    mesh_frame_plain returns it."""
    st, health, totals = quorum_ops.launch_mesh_frame(state, replies, known, active)
    return [st._asdict(), health, {"totals": totals}]


def mesh_frame_err(torch, state_of, replies, known, active) -> float:
    """The card's mesh frame against its plain chain, each from a fresh
    state_of(), exact on every lane, health lane and total; returns the
    max_abs_err (0.0, or raises)."""
    got = [{k: v.clone() for k, v in d.items()} for d in mesh_frame_card(state_of(), replies, known, active)]
    torch.cuda.synchronize()
    return max(max_abs_err(a, b) for a, b in zip(got, mesh_frame_plain(state_of(), replies, known, active)))


def padded_slot_counts(torch, rng) -> None:
    """fold_replies, quorum_commit_step, the tick frame kernel (with
    health) and the mesh frame against their plain versions at G groups
    for each R in EXTRA_SLOTS, exact."""
    from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy

    for r in EXTRA_SLOTS:
        fields = random_state_fields(rng, G, r)
        replies = [torch.from_numpy(a).cuda() for a in padded_replies(rng, G, r, M_REPLIES)]
        hb = torch.from_numpy(rng.integers(0, G, H_ROWS).astype(np.int64)).cuda()
        known = torch.from_numpy(rng.random(G) < 0.5).cuda()
        active = torch.from_numpy(rng.random(G) < 0.95).cuda()
        for name, kern, plain, args in (
            ("fold_replies", quorum_ops.fold_replies, quorum_ops.fold_replies_plain, replies),
            ("quorum_commit_step", quorum_ops.quorum_commit_step, quorum_ops.quorum_commit_step_plain, ()),
        ):
            want = plain(group_state_from_numpy(fields, "cuda"), *args)
            got = kern(group_state_from_numpy(fields, "cuda"), *args)
            torch.cuda.synchronize()
            max_abs_err(got._asdict(), want._asdict())
        st, beats, lanes = health_ops.tick_frame_health(group_state_from_numpy(fields, "cuda"), *replies, hb,
                                                        known, active)
        torch.cuda.synchronize()
        want = quorum_ops.quorum_commit_step_plain(
            quorum_ops.fold_replies_plain(group_state_from_numpy(fields, "cuda"), *replies))
        max_abs_err(st._asdict(), want._asdict())
        max_abs_err(beats, quorum_ops.build_heartbeats_plain(want, hb))
        max_abs_err(lanes, health_ops.health_reduce_plain(want.match_index, want.commit_index, want.is_voter,
                                                          want.is_voter_old, want.is_leader, known, active))
        mesh_frame_err(torch, lambda: group_state_from_numpy(fields, "cuda"), replies, known, active)
        log(f"[kernels] fold_replies, quorum_commit_step, tick_frame (health), mesh_tick_frame at G={G} R={r}: "
            f"equal to plain, tolerance exact; frame grid "
            f"{quorum_ops.frame_grid(len(replies[0]), G, r, H_ROWS, r % 8 == 0)}")


def phase_record_batches(torch) -> dict:
    """Phase 4: Kafka CRCs of 1,024 seeded record batches on the card."""
    from redpanda_tpu_torch.models.record import RecordBatchBuilder, batch_crcs

    rng = np.random.default_rng(SEED + 4)
    batches = []
    for i in range(1024):
        b = RecordBatchBuilder(base_offset=16 * i, timestamp_ms=1_700_000_000_000 + i)
        for _ in range(16):
            b.add(rng.integers(0, 256, 1024, dtype=np.uint8).tobytes(), key=b"k%d" % i)
        batches.append(b.build())
    want = np.array([b.header.crc & 0xFFFFFFFF for b in batches], np.uint32)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = batch_crcs(batches)
    secs = time.perf_counter() - t0
    launches = crc_ops.LAUNCHES["crc32c_device"]
    assert_equal(got, want, "batch_crcs on the card vs host finalize_crcs")
    # corrupt one staged row: exactly that row must mismatch
    payloads = [b.header.crc_prefix() + b.body for b in batches]
    stride = max(len(p) for p in payloads)
    mat = np.zeros((len(payloads), stride), np.uint8)
    lens = np.array([len(p) for p in payloads], np.int64)
    for i, p in enumerate(payloads):
        mat[i, : len(p)] = np.frombuffer(p, np.uint8)
    bad_row = int(rng.integers(0, len(payloads)))
    mat[bad_row, int(rng.integers(0, lens[bad_row]))] ^= 0x5A
    mism = np.flatnonzero(crc_ops.crc32c_batch_device(mat, lens) != want)
    if mism.tolist() != [bad_row]:
        raise AssertionError(f"corrupted row {bad_row}: mismatching rows {mism.tolist()}")
    log(
        f"[batches] 1024 batches x 16 x 1 KiB (stride {stride}): batch_crcs on the card "
        f"== host crcs in {secs * 1e3:.3f} ms end to end; corrupted row {bad_row} detected alone"
    )
    return {"launches": launches, "ms": secs * 1e3, "stride": stride}


# --------------------------------------------------------- codec phases
def fused_bodies(rows: int = FUSED_ROWS, body: int = FUSED_BODY) -> list:
    out = []
    for i in range(rows):
        if i % 2:
            out.append(np.random.default_rng(SEED * 997 + i).integers(0, 256, body, dtype=np.uint8).tobytes())
        else:
            pat = b"redpanda%d" % i
            out.append((pat * (body // len(pat) + 1))[:body])
    return out


def json_text(rng, size: int) -> bytes:
    """Seeded JSON-like records (compressible text with varying fields)."""
    parts, n = [], 0
    while n < size:
        rec = b'{"key":"user-%06d","topic":"orders","seq":%d,"amount":%d.%02d,"flag":%s},' % (
            int(rng.integers(0, 10**6)), int(rng.integers(0, 10**9)), int(rng.integers(0, 10**4)),
            int(rng.integers(0, 100)), b"true" if rng.random() < 0.5 else b"false")
        parts.append(rec)
        n += len(rec)
    return b"".join(parts)[:size]


def codec_shapes(torch) -> dict:
    """The two codec shapes as uploaded matrices: (data, valid, n, offset)."""
    from redpanda_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED + 5)
    prefixes = [rng.integers(0, 256, fused.PREFIX, dtype=np.uint8).tobytes() for _ in range(FUSED_ROWS)]
    mat, body_len, n = fused.stage_fused(prefixes, fused_bodies())
    buffers = [json_text(rng, CODEC_BODY) for _ in range(CODEC_ROWS)]
    batch, valid, n2 = lz4_ops.stage_chunks(lz4_ops.as_arrays(buffers), "lz4")
    return {
        "fused": (torch.from_numpy(mat).cuda(), torch.from_numpy(body_len).cuda(), n, fused.PREFIX),
        "codec": (torch.from_numpy(batch).cuda(), torch.from_numpy(valid).cuda(), n2, 0),
    }


def codec_edge_rows(torch):
    """Short, empty and ragged rows (the past-valid-length candidates,
    the final literal alone, one-byte rows, long literal runs), staged
    as the fused path stages them: (data, valid, n, offset)."""
    from redpanda_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED + 7)
    bodies = [b"", b"Z", b"\x00" * 4096, b"ab" * 24 + b"\x01", bytes(range(16)) * 64,
              b"the quick brown fox jumps over the lazy dog. " * 90, b"\x00\xff" * 2048]
    for i in range(57):
        size = int(rng.integers(0, FUSED_BODY + 1))
        if i % 2:
            bodies.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        else:
            bodies.append(json_text(rng, size))
    mat, body_len, n = fused.stage_fused([bytes(fused.PREFIX)] * len(bodies), bodies)
    return torch.from_numpy(mat).cuda(), torch.from_numpy(body_len).cuda(), n, fused.PREFIX


def check_codec_kernels(torch, data, valid, n, offset, label: str):
    """Parse and both emissions against their plain versions, exact:
    the seven parse outputs, the lengths, the bytes on [0, out_len).
    Returns the kernel's parse, the plain parse, each emission's block
    bytes and each kernel's max_abs_err."""
    want = parse_ops.cell_parse_plain(data, valid, n, offset)
    got = parse_ops.launch_parse(data, valid, n, offset)
    torch.cuda.synchronize()
    errs = {"cell_parse": max_abs_err(dict(zip(parse_ops.FIELDS, got)), dict(zip(parse_ops.FIELDS, want)))}
    out_bytes = {}
    for key, emit, emit_plain in (
        ("lz4_emit", lz4_ops.lz4_emit, lz4_ops.lz4_emit_plain),
        ("snappy_emit", snappy_ops.snappy_emit, snappy_ops.snappy_emit_plain),
    ):
        p_out, p_len = emit_plain(data, valid, want, n, offset)
        k_out, k_len = emit(data, valid, got, n, offset)
        torch.cuda.synchronize()
        if not torch.equal(p_len, k_len):
            raise AssertionError(f"{key}@{label}: out_len differs from the plain version")
        cols = torch.arange(k_out.shape[1], device=k_out.device)[None, :] < k_len[:, None].long()
        diff = (torch.where(cols, k_out, 0).int() - torch.where(cols, p_out, 0).int()).abs()
        errs[key] = float(diff.max()) if diff.numel() else 0.0
        if errs[key] != 0.0:
            raise AssertionError(f"{key}@{label}: bytes on [0, out_len) differ from the plain version")
        out_bytes[key] = int(k_len.sum())
    return got, want, out_bytes, errs


def check_scalar_loads(torch) -> None:
    """Both emissions where the size pass cannot load four cells of a
    field at once, exact against the plain versions: rows of 17 cells
    (n = 272, not a multiple of four cells), and the fused shape's parse
    vectors copied to views 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(SEED + 9)
    n = 272
    chunks = [json_text(rng, n), rng.integers(0, 256, n, dtype=np.uint8).tobytes(), b"a" * 200, b""]
    batch = np.zeros((len(chunks), n + parse_ops.CELL), np.uint8)
    for i, c in enumerate(chunks):
        batch[i, : len(c)] = np.frombuffer(c, np.uint8)
    valid = torch.tensor([len(c) for c in chunks], dtype=torch.int32, device="cuda")
    check_codec_kernels(torch, torch.from_numpy(batch).cuda(), valid, n, 0, "cells17")
    data, valid, n, offset = codec_shapes(torch)["fused"]
    parse = parse_ops.launch_parse(data, valid, n, offset)
    shifted = []
    for t in parse[:-1]:
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
        lead = (-buf.data_ptr() % 16 + 4) // t.element_size()
        view = buf[lead : lead + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        shifted.append(view)
    shifted.append(parse[-1])
    for key, emit, emit_plain in (
        ("lz4_emit", lz4_ops.lz4_emit, lz4_ops.lz4_emit_plain),
        ("snappy_emit", snappy_ops.snappy_emit, snappy_ops.snappy_emit_plain),
    ):
        p_out, p_len = emit_plain(data, valid, parse, n, offset)
        k_out, k_len = emit(data, valid, shifted, n, offset)
        cols = torch.arange(k_out.shape[1], device=k_out.device)[None, :] < p_len[:, None].long()
        if not (torch.equal(p_len, k_len) and torch.equal(torch.where(cols, k_out, 0), torch.where(cols, p_out, 0))):
            raise AssertionError(f"{key}@shifted_fields: differs from the plain version")
    log("[codec] parse, lz4_emit, snappy_emit on 4 rows of 17 cells (n=272), and both emissions on the fused "
        "shape's parse vectors 4 bytes past a 16-byte boundary (the size pass's scalar loads): equal to plain, "
        "tolerance exact")


def codec_kernel_rows(torch, data, valid, n, offset, label: str, mem_rate: float,
                      reps: int = 10) -> tuple:
    """The parse and both emissions on one staged shape: equal to their
    plain versions (exact), each timed beside its bytes bound and its
    plain version. Returns (rows keyed kernel@label, the kernel's parse,
    the plain parse)."""
    def bound(nbytes):
        return nbytes / mem_rate * 1e3

    b = data.shape[0]
    nc = n // parse_ops.CELL
    v_sum = int(valid.sum())
    shape = f"{label}: B={b} n={n} offset={offset} bytes={v_sum}"
    got, want, out_bytes, errs = check_codec_kernels(torch, data, valid, n, offset, label)
    out = {f"cell_parse@{label}": {
        "shape": shape, "max_abs_err": errs["cell_parse"],
        "ms": time_kernel(lambda: parse_ops.launch_parse(data, valid, n, offset), reps=reps),
        "plain_ms": time_plain(lambda: parse_ops.cell_parse_plain(data, valid, n, offset), reps=2),
        # each row's valid bytes and length read; six [B, nc] vectors
        # (has 1 B, five int32) and last_end written
        "bound_ms": bound(v_sum + 4 * b + 21 * b * nc + 4 * b),
    }}
    lit = int(got[5].sum()) + int((valid - got[6]).clamp(min=0).sum())
    cells_read = int(((valid.clamp(0, n) + parse_ops.CELL - 1) // parse_ops.CELL).sum())
    seqs = int(got[0].sum())
    for key, emit, emit_plain in (
        ("lz4_emit", lz4_ops.lz4_emit, lz4_ops.lz4_emit_plain),
        ("snappy_emit", snappy_ops.snappy_emit, snappy_ops.snappy_emit_plain),
    ):
        out[f"{key}@{label}"] = {
            "shape": f"{shape} out={out_bytes[key]}", "max_abs_err": errs[key],
            "ms": time_kernel(lambda: emit(data, valid, got, n, offset), reps=reps),
            "plain_ms": time_plain(lambda: emit_plain(data, valid, want, n, offset), reps=2),
            # what the emission must read and write: `has` (1 B) of each
            # cell below v (no cell past v holds a match), the four int32
            # fields (offs, mlen, lit_start, lit_len) of each cell with a
            # match, valid and last_end of each row, every literal byte
            # once; every block byte and out_len once
            "bound_ms": bound(cells_read + 16 * seqs + 8 * b + lit + out_bytes[key] + 4 * b),
            "ratio": v_sum / max(out_bytes[key], 1),
        }
    return out, got, want


def log_rows(tag: str, rows: dict, what: str = "equal to plain, tolerance exact") -> None:
    for name, e in rows.items():
        extra = f", ratio {e['ratio']:.3f}" if "ratio" in e else ""
        if "floor_ms" in e:
            extra += f", empty kernel at its launch shape {e['floor_ms']:.4f} ms"
        log(f"[{tag}] {name:<22} {e['shape']}: {what}; kernel {e['ms']:.4f} ms, "
            f"bound {e['bound_ms']:.6f} ms, plain {e['plain_ms']:.3f} ms{extra}")


def phase_codec_kernels(torch, mem_rate: float) -> dict:
    """Phase 5: the parse and both emission kernels against their plain
    versions at the two codec shapes (exact: equal parse vectors, equal
    out_len and equal bytes on [0, out_len)), and the fused launch
    sequences' device times."""
    from redpanda_tpu_torch.ops import fused

    def bound(nbytes):
        return nbytes / mem_rate * 1e3

    edge = codec_edge_rows(torch)
    check_codec_kernels(torch, *edge, "edge")
    log(f"[codec] parse, lz4_emit, snappy_emit on {edge[0].shape[0]} short, empty and ragged rows "
        f"(n={edge[2]}, offset {edge[3]}): equal to plain, tolerance exact")
    raw = np.random.default_rng(SEED + 8).integers(0, 256, CODEC_BODY, dtype=np.uint8).tobytes()
    batch, valid, n = lz4_ops.stage_chunks(lz4_ops.as_arrays([raw, b""]), "lz4")
    _, _, out_bytes, _ = check_codec_kernels(torch, torch.from_numpy(batch).cuda(), torch.from_numpy(valid).cuda(),
                                             n, 0, "random_v0")
    log(f"[codec] parse, lz4_emit, snappy_emit on an all-random {CODEC_BODY}-byte row and an empty one "
        f"(n={n}; blocks of {out_bytes['lz4_emit']} and {out_bytes['snappy_emit']} B): equal to plain, tolerance exact")
    check_scalar_loads(torch)
    out = {}
    for label, (data, valid, n, offset) in codec_shapes(torch).items():
        b = data.shape[0]
        v_sum = int(valid.sum())
        shape = f"{label}: B={b} n={n} offset={offset} bytes={v_sum}"
        rows, _, _ = codec_kernel_rows(torch, data, valid, n, offset, label, mem_rate)
        out.update(rows)
        if label == "fused":
            crc_lens = valid.to(torch.int64) + fused.PREFIX
            want_crc = crc_ops.crc32c_device_plain(data, crc_lens)
            want_parse = parse_ops.cell_parse_plain(data, valid, n, offset)
            for codec, seq, emit_plain in (
                ("lz4", fused._fused, lz4_ops.lz4_emit_plain),
                ("snappy", fused._fused_snappy, snappy_ops.snappy_emit_plain),
            ):
                key = f"fused_{codec}"
                crc, f_out, f_len = seq(data, valid, n)
                # the CRC, out_len and the block: the path B rows take (plan)
                err = fused_err(torch, (crc, f_out, f_len),
                                (want_crc, *emit_plain(data, valid, want_parse, n, offset)), f"{key}@{label}")

                def plain(emit_plain=emit_plain):
                    crc_ops.crc32c_device_plain(data, crc_lens)
                    emit_plain(data, valid, parse_ops.cell_parse_plain(data, valid, n, offset), n, offset)

                out[key] = {
                    "shape": f"{shape} {fused_path(data, n, codec)}", "max_abs_err": err,
                    "ms": time_kernel(lambda: seq(data, valid, n), reps=10),
                    "plain_ms": time_plain(plain, reps=1),
                    "bound_ms": fused_bound_ms(valid, f_len, mem_rate),
                }
    log_rows("codec", out)
    return out

def fused_path(data, n: int, codec: str = "lz4") -> str:
    """The cluster size the codec's fused entry launches these rows at
    (ops/fused.py plan)."""
    return f"cluster C={fused_ops.plan_for(data, n, codec)}"


def fused_sizes(data, n: int, codec: str) -> list:
    """Every cluster size `plan` can choose for bucket n on this card:
    those that sort the bucket's keys and are resident."""
    return fused_ops.sizes(n, fused_ops.resident(data.device, n, codec))


FUSED_ENTRY = {"lz4": (fused_ops._fused, fused_ops._fused_sequence),
               "snappy": (fused_ops._fused_snappy, fused_ops._fused_snappy_sequence)}


def fused_bound_ms(valid, f_len, mem_rate: float) -> float:
    """The fused CRC + codec's bytes bound: each row's prefix and body and
    its int32 length read once; the CRC (int64), the block bytes and the
    int32 length written once."""
    b = valid.shape[0]
    return (int(valid.sum()) + fused_ops.PREFIX * b + 4 * b + 8 * b + int(f_len.sum()) + 4 * b) / mem_rate * 1e3


def fused_err(torch, got, want, what: str) -> float:
    """`_fused`'s outputs against the plain chain's, exact: the CRCs, the
    lengths and the block bytes on [0, out_len). Returns max_abs_err."""
    crc, out, out_len = got
    w_crc, w_out, w_len = want
    torch.cuda.synchronize()
    if not (torch.equal(crc.cpu(), w_crc.cpu()) and torch.equal(out_len.cpu(), w_len.cpu())):
        raise AssertionError(f"{what}: the CRC or out_len differs from the plain chain")
    cols = torch.arange(out.shape[1], device=out.device)[None, :] < out_len[:, None].long()
    diff = (torch.where(cols, out, 0).int() - torch.where(cols, w_out.to(out.device), 0).int()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{what}: block bytes on [0, out_len) differ from the plain chain")
    return err


def fused_plain(torch, data, valid, n: int, host_crc: bool = False, codec: str = "lz4"):
    """The plain chain of `_fused` (`_fused_snappy`) on the same rows: the
    CRC over prefix || body (the plain CRC, or the host's utils/crc), the
    plain parse and the plain LZ4 (snappy) emission."""
    from redpanda_tpu_torch.utils import crc as host

    off = fused_ops.PREFIX
    if host_crc:
        rows, lens = data.cpu().numpy(), valid.cpu().numpy()
        crc = torch.tensor([host.crc32c(rows[i, : off + int(lens[i])].tobytes()) for i in range(rows.shape[0])],
                           dtype=torch.int64)
    else:
        crc = crc_ops.crc32c_device_plain(data, valid.to(torch.int64) + off)
    parse = parse_ops.cell_parse_plain(data, valid, n, off)
    emit = lz4_ops.lz4_emit_plain if codec == "lz4" else snappy_ops.snappy_emit_plain
    return (crc, *emit(data, valid, parse, n, off))


def fused_row(torch, data, valid, n: int, mem_rate: float, codec: str = "lz4") -> dict:
    """The codec's fused entry on phase 6's one row: exact against the
    plain chain, timed beside its bound, its plain chain, the empty
    cluster launch at its shape (the floor) and the three-launch sequence
    it replaced."""
    entry, sequence = FUSED_ENTRY[codec]
    c = fused_ops.plan_for(data, n, codec)
    got = entry(data, valid, n)
    err = fused_err(torch, got, fused_plain(torch, data, valid, n, codec=codec), f"fused_{codec}@row")
    smem, clusters = fused_ops.shape_info(n, c, codec)
    return {
        "shape": (f"row: B=1 n={n} bytes={int(valid.sum())} {fused_path(data, n, codec)} smem={smem} "
                  f"clusters={clusters}"),
        "max_abs_err": err,
        "ms": time_kernel(lambda: entry(data, valid, n), reps=30),
        "plain_ms": time_plain(lambda: fused_plain(torch, data, valid, n, codec=codec), reps=2),
        "bound_ms": fused_bound_ms(valid, got[2], mem_rate),
        "floor_ms": time_kernel(lambda: fused_ops.launch_empty(data, n, c, codec), reps=30),
        "sequence_ms": time_kernel(lambda: sequence(data, valid, n), reps=30),
    }


def fused_edges(torch, mem_rate: float, codec: str = "lz4") -> dict:
    """The codec's fused kernel at one row on the parse's skew edges: one
    repeated byte, all 4-grams distinct, random bytes and zeros, each at v
    in {0, 1, 3, 4, 5} and full, at n = 512 and 65,536, exact against the
    plain chain (the host CRC) at every cluster size `plan` can choose
    (and the entry at plan's); the full 65,536-byte rows timed."""
    entry = FUSED_ENTRY[codec][0]
    rows, launches = {}, 0
    for n in (512, CODEC_BODY):
        full = {"one_byte": b"a" * n, "distinct": distinct_grams_row(n),
                "random": np.random.default_rng(SEED + 33).integers(0, 256, n, dtype=np.uint8).tobytes(),
                "zeros": bytes(n)}
        for kind, raw in full.items():
            for v in (0, 1, 3, 4, 5, n):
                mat, blen, nn = fused_ops.stage_fused([bytes(range(40))], [raw[:v]])
                data, valid = torch.from_numpy(mat).cuda(), torch.from_numpy(blen).cuda()
                want = fused_plain(torch, data, valid, nn, host_crc=True, codec=codec)
                got = entry(data, valid, nn)
                fused_err(torch, got, want, f"fused_{codec}@{kind} v={v}")
                for c in fused_sizes(data, nn, codec):
                    fused_err(torch, fused_ops.launch_fused(data, valid, nn, c, codec), want,
                              f"fused_{codec}@{kind} v={v} C={c}")
                    launches += 1
                if n == CODEC_BODY and v == n and kind != "zeros":
                    rows[f"fused_{codec}@{kind}"] = {
                        "shape": f"{kind}: B=1 n={nn} bytes={v} {fused_path(data, nn, codec)}",
                        "ms": time_kernel(lambda: entry(data, valid, nn), reps=30),
                        "bound_ms": fused_bound_ms(valid, got[2], mem_rate),
                    }
    log(f"[per-call] fused_{codec} at one row on the skew edges (one byte, distinct, random, zeros; "
        f"v in {{0,1,3,4,5,n}}; n = 512, 65536), at plan's cluster size and at every size plan can choose "
        f"({launches} launches): equal to the plain chain (host CRC), tolerance exact; " +
        ", ".join(f"{k} {e['shape']} {e['ms']:.4f} ms (bound {e['bound_ms']:.6f})" for k, e in rows.items()))
    return rows


def distinct_grams_row(n: int) -> bytes:
    """n bytes whose n - 3 4-grams are all distinct: the first seeded
    random row that has no repeated 4-gram."""
    for seed in range(100):
        row = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).astype(np.int64)
        grams = row[:-3] | row[1:-2] << 8 | row[2:-1] << 16 | row[3:] << 24
        if np.unique(grams).size == n - 3:
            return row.astype(np.uint8).tobytes()
    raise AssertionError("no seed gave distinct 4-grams")


def per_call_inputs(torch) -> dict:
    """The shapes one call gives the kernels: phase 6's recompressed(lz4)
    stages one record batch (16 x 1 KiB JSON-like records) as one fused
    row; phase 8b's recompressed(zstd) stages it as one zstd row and its
    fetch decodes that block's four streams; and the parse's skew edges at
    full width: a row of one repeated byte and a row whose 4-grams are all
    distinct. Returns {label: staged tensors}."""
    from redpanda_tpu_torch.ops import fused

    b = build_batches(np.random.default_rng(SEED + 6), count=1)[0]
    prefix, body = b.header.crc_prefix(), bytes(b.body)
    mat, blen, n = fused.stage_fused([prefix], [body])
    zmat, zlen, zn = fused.stage_fused([prefix], [body], fused._zstd_width)
    row = {"lz4": (torch.from_numpy(mat).cuda(), torch.from_numpy(blen).cuda(), n, fused.PREFIX),
           "zstd": (torch.from_numpy(zmat).cuda(), torch.from_numpy(zlen).cuda(), zn, fused.PREFIX)}
    nbits, streams, bits = (t.cpu().numpy() for t in zstd_ops._encode_chunks(*row["zstd"]))
    items = stream_items([body], nbits, streams, bits)
    if len(items) != 4:
        raise AssertionError(f"the batch's zstd block carries {len(items)} streams, not 4")
    full = CODEC_BODY
    edges = {}
    for label, raw in (("one_byte", b"a" * full), ("distinct", distinct_grams_row(full))):
        batch, valid, en = lz4_ops.stage_chunks(lz4_ops.as_arrays([raw]), "lz4")
        edges[label] = (torch.from_numpy(batch).cuda(), torch.from_numpy(valid).cuda(), en, 0)
    return {"row": row, "items": items, "edges": edges}


def phase_per_call(torch, mem_rate: float) -> dict:
    """Phase 5b: the kernels of one call's shape, each equal to its plain
    version (exact) and timed: CRC, parse and LZ4 emission on phase 6's
    one fused row; the zstd encode and `_fused_zstd` on phase 8b's one row
    and the decode of its four streams; the parse and both emissions on
    the two full-width skew edges; and the per-launch floor (one empty
    kernel)."""
    from redpanda_tpu_torch.ops import _build

    inp = per_call_inputs(torch)
    data, valid, n, offset = inp["row"]["lz4"]
    crc_lens = valid.to(torch.int64) + offset
    want = crc_ops.crc32c_device_plain(data, crc_lens)
    # as the fused sequence launches it: the int32 body length and the prefix
    got = crc_ops.crc32c_rows(data, valid, offset)
    torch.cuda.synchronize()
    out = {"crc32c_device@row": {
        "shape": f"row: B=1 S={data.shape[1]} bytes={int(crc_lens.sum())}",
        "max_abs_err": max_abs_err({"crc": got}, {"crc": want}),
        "ms": time_kernel(lambda: crc_ops.crc32c_rows(data, valid, offset)),
        "plain_ms": time_plain(lambda: crc_ops.crc32c_device_plain(data, crc_lens), reps=2),
        # the row's bytes and its length read, the CRC (int64) written
        "bound_ms": (int(crc_lens.sum()) + 4 + 8) / mem_rate * 1e3,
        "floor_ms": crc_floor_ms(torch, 1),
    }}
    rows, _, _ = codec_kernel_rows(torch, data, valid, n, offset, "row", mem_rate, reps=30)
    out.update(rows)
    for codec in ("lz4", "snappy"):
        key = f"fused_{codec}@row"
        out[key] = fused_row(torch, data, valid, n, mem_rate, codec)
        log(f"[per-call] {key}: the three-launch sequence it replaced {out[key]['sequence_ms']:.4f} ms; "
            f"the empty cluster launch {out[key]['floor_ms']:.4f} ms")
        fused_edges(torch, mem_rate, codec)
    out.update(zstd_encode_rows(torch, *inp["row"]["zstd"], "row", mem_rate))
    out["fused_zstd@row"] = fused_zstd_row(torch, *inp["row"]["zstd"], mem_rate)
    log(f"[per-call] fused_zstd@row: the two-launch sequence it replaced "
        f"{out['fused_zstd@row']['sequence_ms']:.4f} ms; the empty encode launch "
        f"{out['fused_zstd@row']['floor_ms']:.4f} ms")
    out.update(zstd_decode_row(torch, inp["items"], "batch", mem_rate))
    for label, staged in inp["edges"].items():
        rows, _, _ = codec_kernel_rows(torch, *staged, label, mem_rate, reps=30)
        out.update(rows)
    log_rows("per-call", out)
    lib = parse_ops._lib()
    _build.bind(lib, "rp_empty", 0, 0)
    stream = _build.stream_of(data)
    floor_ms = time_kernel(lambda: _build.check(lib, lib.rp_empty(stream), "empty"), reps=30)
    log(f"[per-call] launch floor: one empty kernel as wide as an emission block at one row, timed as "
        f"the rows above: {floor_ms:.4f} ms")
    return out


# Decoders of our own: the chip machine's image is not known to carry
# liblz4 / libsnappy, so the frames are read back in plain Python.
def _lz4_len(src: bytes, i: int, base: int):
    if base != 15:
        return base, i
    while True:
        x = src[i]
        i += 1
        base += x
        if x != 255:
            return base, i


def lz4_block_decode(src: bytes, limit: int) -> bytes:
    out, i = bytearray(), 0
    while i < len(src):
        tok = src[i]
        lit, i = _lz4_len(src, i + 1, tok >> 4)
        out += src[i : i + lit]
        i += lit
        if i >= len(src):
            break
        off = src[i] | (src[i + 1] << 8)
        ml, i = _lz4_len(src, i + 2, tok & 15)
        ml += 4
        start = len(out) - off
        if off == 0 or start < 0:
            raise ValueError("lz4 block: offset out of range")
        while ml:
            piece = out[start : start + min(ml, off)]
            out += piece
            start += len(piece)
            ml -= len(piece)
    if len(out) > limit:
        raise ValueError("lz4 block: longer than the frame's block size")
    return bytes(out)


def lz4_frame_decode(frame: bytes) -> bytes:
    from redpanda_tpu_torch.utils.hash import xxh32

    if int.from_bytes(frame[:4], "little") != 0x184D2204:
        raise ValueError("lz4 frame: bad magic")
    flg, bd = frame[4], frame[5]
    i = 6 + (8 if flg & 0x08 else 0)
    if (xxh32(frame[4:i]) >> 8) & 0xFF != frame[i]:
        raise ValueError("lz4 frame: bad header checksum")
    i += 1
    max_block = 1 << (8 + 2 * ((bd >> 4) & 7))
    out = bytearray()
    while True:
        word = int.from_bytes(frame[i : i + 4], "little")
        i += 4
        if word == 0:
            break
        size = word & 0x7FFFFFFF
        blk = frame[i : i + size]
        i += size
        out += blk if word & 0x80000000 else lz4_block_decode(blk, max_block)
    if flg & 0x04:
        if int.from_bytes(frame[i : i + 4], "little") != xxh32(bytes(out)):
            raise ValueError("lz4 frame: bad content checksum")
        i += 4
    if i != len(frame):
        raise ValueError("lz4 frame: trailing bytes")
    return bytes(out)


def snappy_raw_decode(src: bytes) -> bytes:
    size, shift, i = 0, 0, 0
    while True:
        x = src[i]
        i += 1
        size |= (x & 0x7F) << shift
        shift += 7
        if x < 0x80:
            break
    out = bytearray()
    while i < len(src):
        tag = src[i]
        i += 1
        kind = tag & 3
        if kind == 0:
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(src[i : i + nb], "little")
                i += nb
            out += src[i : i + ln + 1]
            i += ln + 1
            continue
        if kind == 1:
            ln, off = ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | src[i]
            i += 1
        elif kind == 2:
            ln, off = (tag >> 2) + 1, src[i] | (src[i + 1] << 8)
            i += 2
        else:
            ln, off = (tag >> 2) + 1, int.from_bytes(src[i : i + 4], "little")
            i += 4
        start = len(out) - off
        if off == 0 or start < 0:
            raise ValueError("snappy: offset out of range")
        while ln:
            piece = out[start : start + min(ln, off)]
            out += piece
            start += len(piece)
            ln -= len(piece)
    if len(out) != size:
        raise ValueError(f"snappy: {len(out)} bytes, preamble says {size}")
    return bytes(out)


def xerial_decode(stream: bytes) -> bytes:
    from redpanda_tpu_torch.compression import snappy_codec

    head = snappy_codec.xerial_header()
    if not stream.startswith(head):
        raise ValueError("snappy-java stream: bad header")
    i, out = len(head), bytearray()
    while i < len(stream):
        size = int.from_bytes(stream[i : i + 4], "big")
        out += snappy_raw_decode(stream[i + 4 : i + 4 + size])
        i += 4 + size
    return bytes(out)


def build_batches(rng, count: int = N_BATCHES) -> list:
    """`count` uncompressed batches of RECORDS x RECORD_BYTES records:
    even ones JSON-like text, odd ones random bytes."""
    from redpanda_tpu_torch.models.record import RecordBatchBuilder

    batches = []
    for i in range(count):
        b = RecordBatchBuilder(base_offset=RECORDS * i, timestamp_ms=1_700_000_000_000 + i)
        for r in range(RECORDS):
            if i % 2 == 0:
                value = json_text(rng, RECORD_BYTES)
            else:
                value = rng.integers(0, 256, RECORD_BYTES, dtype=np.uint8).tobytes()
            b.add(value, key=b"key-%d-%d" % (i, r))
        batches.append(b.build())
    return batches


def phase_recompress(torch) -> dict:
    """Phase 6, the codec path end to end: 1,024 batches through
    RecordBatch.recompressed(lz4) under RP_CODEC_BACKEND=device (one
    synchronous fused call per batch: CRC checked on the card against
    the wire CRC, LZ4 block, host frame), a flipped wire CRC refused,
    then 16 x 64 KiB buffers through the registry backend's LZ4 and
    snappy legs. Every frame is decoded back here."""
    from redpanda_tpu_torch.compression import CompressionType, tpu_backend
    from redpanda_tpu_torch.models.record import CrcMismatch
    from redpanda_tpu_torch.utils import crc as host_crc

    rng = np.random.default_rng(SEED + 6)
    batches = build_batches(rng)
    for b in batches:
        if b.header.crc & 0xFFFFFFFF != host_crc.crc32c(b.body, host_crc.crc32c(b.header.crc_prefix())):
            raise AssertionError("builder CRC differs from utils/crc")
    buffers = [json_text(rng, CODEC_BODY) for _ in range(CODEC_ROWS)]
    with codec_backend("device"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the wire CRC is the host utils/crc value the builder stamped;
        # recompressed raises CrcMismatch unless the card's CRC equals it
        outs = [b.recompressed(CompressionType.lz4, verify_crc=b.header.crc) for b in batches]
        secs = time.perf_counter() - t0
        victim = batches[int(rng.integers(0, len(batches)))]
        try:
            victim.recompressed(CompressionType.lz4, verify_crc=victim.header.crc ^ 0x10)
        except CrcMismatch:
            pass
        else:
            raise AssertionError("a flipped wire CRC was not refused")
        t1 = time.perf_counter()
        lz4_frames = tpu_backend.compress_many(buffers)
        t2 = time.perf_counter()
        snappy_streams = tpu_backend.compress_many_snappy(buffers)
        t3 = time.perf_counter()
        launches = {k: KERNELS[k][2][k] for k in ("crc32c_device", "cell_parse", "lz4_emit", "snappy_emit", "fused_lz4")}
    raw_in = comp_out = 0
    for b, o in zip(batches, outs):
        if o.header.compression != CompressionType.lz4 or lz4_frame_decode(o.body) != b.body:
            raise AssertionError("a recompressed frame does not decode to its body")
        raw_in += len(b.body)
        comp_out += len(o.body)
    for buf, frame, stream in zip(buffers, lz4_frames, snappy_streams):
        if lz4_frame_decode(frame) != buf or xerial_decode(stream) != buf:
            raise AssertionError("a registry-backend frame does not round-trip")
    log(
        f"[recompress] {len(batches)} batches x {RECORDS} x {RECORD_BYTES} B through recompressed(lz4) "
        f"on the card: CRCs equal to utils/crc, frames decode to their bodies, flipped CRC refused; "
        f"{secs * 1e3:.3f} ms end to end ({secs * 1e6 / len(batches):.1f} us per batch); "
        f"{raw_in} -> {comp_out} bytes"
    )
    log(
        f"[recompress] tpu_backend {CODEC_ROWS} x {CODEC_BODY} B: compress_many {(t2 - t1) * 1e3:.3f} ms, "
        f"compress_many_snappy {(t3 - t2) * 1e3:.3f} ms; both round-trip"
    )
    with codec_backend("device"):
        stages = recompress_stages(torch, batches[:64])
    log("[recompress] one call, p50 over 64 batches (host clock; device = the fused kernel "
        "on the device clock): " + ", ".join(f"{k} {v:.1f} us" for k, v in stages.items()))
    return {"launches": launches, "ms": secs * 1e3, "stages_us": stages}


def recompress_stages(torch, batches) -> dict:
    """Where one recompressed(lz4) call's time goes, p50 over `batches`:
    the whole call, then the fused entry's stages one by one on the
    host clock (each ending in a synchronize, so they add up to more
    than the call), and `_fused` (one cluster launch) on the device clock
    alone (a spin kernel queued ahead hides the host's enqueue)."""
    from redpanda_tpu_torch.compression import CompressionType, lz4_codec
    from redpanda_tpu_torch.ops import fused

    rows = {k: [] for k in ("call", "stage", "h2d", "launches + sync", "d2h", "frame", "device")}
    for b in batches:
        body = bytes(b.body)
        t0 = time.perf_counter()
        b.recompressed(CompressionType.lz4, verify_crc=b.header.crc)
        t1 = time.perf_counter()
        mat, body_len, n = fused.stage_fused([b.header.crc_prefix()], [body])
        t2 = time.perf_counter()
        data = torch.from_numpy(mat).cuda()
        lens = torch.from_numpy(body_len).cuda()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        crc, out, out_len = fused._fused(data, lens, n)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        crc, out, out_len = crc.cpu().numpy(), out.cpu().numpy(), out_len.cpu().numpy()
        t5 = time.perf_counter()
        lz4_codec.frame_from_blocks([out[0, : out_len[0]].tobytes()], [body])
        t6 = time.perf_counter()
        device_ms = time_kernel(lambda: fused._fused(data, lens, n), reps=1)
        for k, v in zip(rows, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5, device_ms / 1e3)):
            rows[k].append(v * 1e6)
    return {k: float(np.median(v)) for k, v in rows.items()}


# ----------------------------------------------------------- zstd phases
def json_values(rng, count: int, size: int = RECORD_BYTES) -> list:
    """`count` JSON-like values of `size` bytes: json_text's records,
    their fields drawn in bulk."""
    per = size // 60 + 2
    m = count * per
    fields = zip(rng.integers(0, 10**6, m).tolist(), rng.integers(0, 10**9, m).tolist(),
                 rng.integers(0, 10**4, m).tolist(), rng.integers(0, 100, m).tolist(),
                 (rng.random(m) < 0.5).tolist())
    recs = [b'{"key":"user-%06d","topic":"orders","seq":%d,"amount":%d.%02d,"flag":%s},'
            % (u, q, a, c, b"true" if f else b"false") for u, q, a, c, f in fields]
    return [b"".join(recs[i * per : (i + 1) * per])[:size] for i in range(count)]


def zipf_bytes(rng, size: int) -> np.ndarray:
    """iid zipf-skewed bytes, skew 1.3 (bench.py:1045 _zstd_entropy_corpus)."""
    w = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size, p=w / w.sum()).astype(np.uint8)


def build_segment(rng, size: int = SEGMENT_BYTES) -> bytes:
    """One log segment of exactly `size` bytes as the storage layer
    writes it (storage/segment.py:4): serialized record batches of
    RECORDS x RECORD_BYTES records, back to back. Values come in runs of
    four batches: JSON-like, uniform random, zipf, zipf; so a quarter of
    the values are JSON-like, a quarter random, half zipf-skewed, and a
    64 KiB chunk holds one kind or a mix of two. The last batch holds
    one record sized so the segment ends at `size`."""
    from redpanda_tpu_torch.models.record import RecordBatchBuilder

    est = size // (RECORDS * RECORD_BYTES) + 8
    kinds = [KINDS[(i // 4) % 4] for i in range(est)]
    need = {k: RECORDS * kinds.count(k) for k in set(KINDS)}
    pools = {
        "json": iter(json_values(rng, need["json"])),
        "random": iter(rng.integers(0, 256, (need["random"], RECORD_BYTES), dtype=np.uint8)),
        "zipf": iter(zipf_bytes(rng, need["zipf"] * RECORD_BYTES).reshape(-1, RECORD_BYTES)),
    }

    def batch(i, values):
        b = RecordBatchBuilder(base_offset=RECORDS * i, timestamp_ms=1_700_000_000_000 + i)
        for r, v in enumerate(values):
            b.add(bytes(v), key=b"key-%d-%d" % (i, r))
        return b.build().serialize()

    parts, total = [], 0
    for i, kind in enumerate(kinds):
        ser = batch(i, [next(pools[kind]) for _ in range(RECORDS)])
        if total + len(ser) > size - 256:
            break
        parts.append(ser)
        total += len(ser)
    rest = size - total
    x = rest - 100
    for _ in range(8):
        last = batch(len(parts), [b"\x00" * x])
        if len(last) == rest:
            break
        x += rest - len(last)
    assert len(last) == rest, "could not size the segment's last batch"
    segment = b"".join(parts) + last
    assert len(segment) == size
    return segment


def zstd_edge_rows(rng, n: int) -> list:
    """Short lengths around the huff0 floor and the 4-stream split, one-
    and two-symbol rows, a uniform 256-symbol row, 200 rare symbols
    beside one dominant, a row whose Kraft seed overshoots (the down
    loop halves 100 symbols), and skewed and random rows of length n."""
    w = 1.0 / np.arange(1, 257) ** 1.3
    p = w / w.sum()
    rows = []
    for k, size in enumerate(x for x in (0, 1, 2, 63, 64, 65, 255, 256, 257) if x <= n):
        if k % 2:
            rows.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        else:
            rows.append(rng.choice(256, size, p=p).astype(np.uint8).tobytes())
    rows.append(b"\x41" * min(n, 300))
    rows.append(b"\x00" * min(n, 77))
    rows.append(bytes(rng.choice([0x30, 0xB1], n).astype(np.uint8)))
    rows.append(bytes(range(256)) * (n // 256))
    rare = np.full(n, 250, np.uint8)
    rare[rng.choice(n, 200, replace=False)] = np.arange(200, dtype=np.uint8)
    rows.append(rare.tobytes())
    if n >= 2048:
        rows.append(kraft_down_row(rng, n))
    rows.append(rng.choice(256, n, p=p).astype(np.uint8).tobytes())
    rows.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    return rows


def kraft_down_row(rng, n: int) -> bytes:
    """n >= 2048 bytes: 200 rare symbols at 1.5 slot units each (seeded
    at 2 slots) beside power-of-two shares summing to 1,748 units, so the
    Kraft seed overshoots 2,048 by 100 and the down loop halves 100 rare
    symbols one by one."""
    unit = n // 2048
    syms = []
    for s, share in zip(range(6), (1024, 512, 128, 64, 16, 4)):
        syms += [s] * (unit * share)
    for s in range(50, 250):
        syms += [s] * (unit + unit // 2)
    return rng.permutation(np.array(syms, np.uint8)).tobytes()


def quarter_rows(rng, n: int) -> list:
    """Rows whose four stream quarters start at every alignment: lengths
    1-5 (streams of one symbol or none), v = 1, 5 and 15 (mod 64) up to
    n, one symbol over all n bytes, and the Kraft down loop's row."""
    w = 1.0 / np.arange(1, 257) ** 1.3
    p = w / w.sum()
    lens = [1, 2, 3, 4, 5] + [x for k in (1, 3, 17, n // 64 - 1) for x in (64 * k + 1, 64 * k + 5, 64 * k + 15)
                              if x <= n]
    rows = [rng.choice(256, x, p=p).astype(np.uint8).tobytes() for x in lens]
    rows.append(b"\x07" * n)
    if n >= 2048:
        rows.append(kraft_down_row(rng, n))
    return rows


def pad_rows(rows, n: int):
    """(uint8 [len(rows), n] zero-padded matrix, int32 lengths)."""
    mat = np.zeros((len(rows), n), np.uint8)
    valid = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = np.frombuffer(r, np.uint8)
        valid[i] = len(r)
    return mat, valid


def stage_rows(torch, rows, n: int):
    """`pad_rows` uploaded to the card."""
    return tuple(torch.from_numpy(a).cuda() for a in pad_rows(rows, n))


ENC_FIELDS = ("nbits", "streams", "bits")


def check_encode(torch, data, valid, n: int, offset: int = 0) -> tuple:
    """The encode kernel against the plain version, exact on all three
    outputs (every stream byte up to SB). Returns the kernel's outputs."""
    want = zstd_ops._encode_chunks_plain(data, valid, n, offset)
    got = zstd_ops._encode_chunks(data, valid, n, offset)
    torch.cuda.synchronize()
    max_abs_err(dict(zip(ENC_FIELDS, got)), dict(zip(ENC_FIELDS, want)))
    return got


def stream_items(rows, nbits, streams, bits) -> list:
    """(stream bytes, regenerated size, decode table) of every stream of
    the rows that a compressed block could carry."""
    from redpanda_tpu_torch.compression import zstd_frame as zf

    out = []
    for r, nb, st, bt in zip(rows, nbits, streams, bits):
        if len(set(r)) < 2 or len(r) < zf.MIN_HUFFMAN_LEN:
            continue
        tbl = zf.decode_table(nb.astype(np.int64))
        for k, rg in enumerate(zf.stream_splits(len(r))):
            out.append((st[k, : bt[k] // 8 + 1].tobytes(), rg, tbl))
    return out


def decode_plain(bufs, tbits, regen, tsym, tnb, index, sbytes, rmax, groups=None):
    """The plain version of the staged decode (one table per stream)."""
    i = index.long()
    return zstd_ops._decode_streams_plain(bufs, tbits, regen, tsym[i], tnb[i], sbytes, rmax)


def check_decode(torch, items) -> tuple:
    """The decode kernel against the plain version on the same streams,
    staged as decode_streams stages them (each table object once, the
    groups uploaded), exact on out and end. Returns (end, the staged
    arguments of launch_decode)."""
    *mats, index, sbytes, rmax = zstd_ops.stage_streams(*zip(*items))
    args = [torch.from_numpy(m).cuda() for m in (*mats, index)] + [sbytes, rmax]
    args.append(torch.from_numpy(zstd_ops.decode_groups(index)).cuda())
    want = decode_plain(*args)
    got = zstd_ops.decode_staged(*args)
    torch.cuda.synchronize()
    max_abs_err(dict(zip(("out", "end"), got)), dict(zip(("out", "end"), want)))
    return got[1].cpu().numpy(), args


def decode_error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        if type(e) is not ValueError:
            raise AssertionError(f"decode raised {type(e).__name__}, not a plain ValueError")
        return str(e)
    raise AssertionError("a corrupt stream was not refused")


def phase_zstd_kernels(torch, segment: bytes, mem_rate: float) -> dict:
    """Phase 7: the zstd kernels against their plain versions on the
    card, exact: 32 full-width 64 KiB chunks of the segment, the edge
    rows at every bucket n = 256 ... 65536, rows whose quarters start at
    every alignment, the decode on those chunks' streams plus tampered,
    truncated and regen = 0 streams, and the fused CRC + encode (one
    rp_fused_zstd launch) at the fused shape and on edge rows. Returns
    {"fused_zstd": its entry}."""
    from redpanda_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED + 8)
    step = SEGMENT_BYTES // ZSTD_BLOCK // ZSTD_CHECK_CHUNKS
    rows = [segment[o : o + ZSTD_BLOCK] for o in range(0, SEGMENT_BYTES, step * ZSTD_BLOCK)]
    data, valid = stage_rows(torch, rows, ZSTD_BLOCK)
    nbits, streams, bits = (t.cpu().numpy() for t in check_encode(torch, data, valid, ZSTD_BLOCK))
    log(f"[zstd] zstd_encode on {len(rows)} full-width 64 KiB chunks of the segment: "
        f"equal to plain, tolerance exact (nbits, all {zstd_ops.stream_byte_bound(ZSTD_BLOCK)} stream "
        f"bytes, bits); bits per chunk {int(bits.sum(1).min())}..{int(bits.sum(1).max())}")
    items = stream_items(rows, nbits, streams, bits)
    edge_items = []
    for n in [256 << k for k in range(9)]:
        erows = zstd_edge_rows(rng, n)
        out = [t.cpu().numpy() for t in check_encode(torch, *stage_rows(torch, erows, n), n)]
        edge_items += stream_items(erows, *out)[:12]
    log("[zstd] zstd_encode on the edge rows (lengths 0-257, one and two symbols, "
        "uniform, 200 rare, Kraft down loop, full skewed and random rows) at every bucket "
        "n = 256 ... 65536: equal to plain, tolerance exact")
    for n, offset, stride in ((65536, 0, 65536), (65536, 5, 65536 + 24), (4096, 40, 4608), (256, 3, 277)):
        qrows = quarter_rows(rng, n)
        mat, valid = pad_rows(qrows, n)
        wide = np.zeros((len(qrows), stride), np.uint8)
        wide[:, offset : offset + n] = mat
        check_encode(torch, torch.from_numpy(wide).cuda(), torch.from_numpy(valid).cuda(), n, offset)
    log("[zstd] zstd_encode on rows of lengths 1-5 (empty streams), v = 1, 5, 15 (mod 64) (quarters at "
        "every alignment), one symbol over the whole bucket and the Kraft down loop at n = 65536 and "
        "256, at column offsets 0, 3, 5 and 40 of rows with odd pitches: equal to plain, tolerance exact")
    (s0, r0, t0), (s1, r1, t1), (s2, _, t2) = items[:3]
    traps = [(s0 + b"\x05", r0, t0), (s1[len(s1) // 2 :], r1, t1), (s2, 0, t2)]
    end, _ = check_decode(torch, items + edge_items + traps)
    k = len(items) + len(edge_items)
    if end[:k].any() or end[k] == 0 or end[k + 1] != 0 or end[k + 2] == 0:
        raise AssertionError(f"decode ends: valid {end[:k].any()}, traps {end[k:].tolist()}")
    log(f"[zstd] zstd_decode on {k} streams of those rows and 3 trap streams: equal to plain, "
        f"tolerance exact (out, end); tampered end {end[k]}, truncated sticks at 0, "
        f"regen 0 end {end[k + 2]}")
    batch = items[:5] + [traps[0]] + items[5:9]
    *mats, index, sbytes, rmax = zstd_ops.stage_streams(*zip(*batch))
    cuda_args = [torch.from_numpy(m).cuda() for m in (*mats, index)] + [sbytes, rmax]
    got = decode_error(lambda: zstd_ops.decode_streams(*map(list, zip(*batch)), device="cuda"))
    want = decode_error(lambda: zstd_ops.check_ends(decode_plain(*cuda_args)[1].cpu().numpy()))
    if got != want or not got.startswith("huffman stream 5 "):
        raise AssertionError(f"decode error {got!r} != plain {want!r}")
    log(f"[zstd] decode_streams refuses the tampered stream as the plain version does: {got!r}")

    # -- the fused CRC + encode (one rp_fused_zstd launch) at the fused path's shape and on edge rows
    prefixes = [rng.integers(0, 256, fused.PREFIX, dtype=np.uint8).tobytes() for _ in range(FUSED_ROWS)]
    mat, body_len, n = fused.stage_fused(prefixes, fused_bodies(FUSED_ROWS), fused._zstd_width)
    assert n == FUSED_BODY
    fdata, fvalid = torch.from_numpy(mat).cuda(), torch.from_numpy(body_len).cuda()
    crc_lens = fvalid.to(torch.int64) + fused.PREFIX
    t0 = time.perf_counter()
    err = fused_zstd_err(torch, fdata, fvalid, FUSED_BODY, "fused_zstd@fused")
    t1 = time.perf_counter()
    edge_launches = fused_zstd_edges(torch)
    t2 = time.perf_counter()
    v_sum = int(fvalid.sum())
    sb = zstd_ops.stream_byte_bound(FUSED_BODY)

    def plain():
        crc_ops.crc32c_device_plain(fdata, crc_lens)
        zstd_ops._encode_chunks_plain(fdata, fvalid, FUSED_BODY, fused.PREFIX)

    out = {"fused_zstd": {
        "shape": f"B={FUSED_ROWS} n={FUSED_BODY} offset={fused.PREFIX} bytes={v_sum}",
        "max_abs_err": err,
        "ms": time_kernel(lambda: fused._fused_zstd(fdata, fvalid, FUSED_BODY), reps=10),
        "plain_ms": time_plain(plain, reps=1),
        # prefix and body of every row and the int32 lengths read once; the
        # CRC (int64), nbits, all SB bytes of the four streams and bits written
        "bound_ms": (v_sum + fused.PREFIX * FUSED_ROWS + 4 * FUSED_ROWS + 8 * FUSED_ROWS
                     + FUSED_ROWS * (256 + 4 * sb + 16)) / mem_rate * 1e3,
        "sequence_ms": time_kernel(lambda: fused._fused_zstd_sequence(fdata, fvalid, FUSED_BODY), reps=10),
    }}
    t3 = time.perf_counter()
    e = out["fused_zstd"]
    log(f"[zstd] fused_zstd {e['shape']}: one rp_fused_zstd launch a call, CRCs equal to the plain CRC and "
        f"the host's, encode (nbits, codes, all stream bytes, bits) equal to plain, tolerance exact; also on "
        f"the edge rows (v = 0, 1, 3, 4, 5, 8, n - 1, n of random bytes and of one repeated byte at n = 512 "
        f"and 65536, each alone and {FUSED_EDGE_ROWS} rows in one launch; {edge_launches} launches); kernel "
        f"{e['ms']:.4f} ms, the two-launch sequence it replaced {e['sequence_ms']:.4f} ms, bound "
        f"{e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms; checks took {t1 - t0:.1f} s at the fused "
        f"shape, {t2 - t1:.1f} s on the edge rows, timings {t3 - t2:.1f} s")
    return out


def fused_zstd_plain(torch, data, valid, n: int) -> dict:
    """The plain chain of `_fused_zstd` on CUDA rows: the plain CRC of
    prefix || body and the plain encode's nbits, codes, streams and
    bits."""
    off = fused_ops.PREFIX
    lens = valid.to(torch.int64) + off
    nbits, codes = zstd_ops._lengths_plain(data, valid, n, off)
    streams, bits = zstd_ops._emit_plain(data, valid, nbits, codes, n, off)
    # bytes past a row's length are never read: the plain CRC walks the columns the longest row holds
    crc = crc_ops.crc32c_device_plain(data[:, : int(lens.max())], lens)
    return {"crc": crc, "nbits": nbits, "streams": streams, "bits": bits, "codes": codes}


def fused_zstd_err(torch, data, valid, n: int, what: str, want: dict | None = None) -> float:
    """`_fused_zstd` on CUDA rows: exactly one rp_fused_zstd launch, its
    CRC, nbits, every stream byte and bits (and the launch's codes) equal
    to the plain CRC, the host CRC and the plain encode (`want`, the
    plain chain's outputs on these rows, else computed here), exact.
    Returns max_abs_err."""
    from redpanda_tpu_torch.utils.crc import crc32c_batch

    before = fused_ops.LAUNCHES["fused_zstd"]
    got = fused_ops._fused_zstd(data, valid, n)
    if fused_ops.LAUNCHES["fused_zstd"] != before + 1:
        raise AssertionError(f"{what}: _fused_zstd was not one rp_fused_zstd launch")
    codes = fused_ops.launch_fused_zstd(data, valid, n)[2]
    if want is None:
        want = fused_zstd_plain(torch, data, valid, n)
    torch.cuda.synchronize()
    err = max_abs_err(dict(zip(("crc", "nbits", "streams", "bits"), got)),
                      {k: want[k] for k in ("crc", "nbits", "streams", "bits")})
    max_abs_err({"codes": codes}, {"codes": want["codes"]})
    lens = valid.to(torch.int64) + fused_ops.PREFIX
    host = crc32c_batch(data.cpu().numpy(), lens.cpu().numpy().astype(np.uint64))
    assert_equal(got[0].cpu().numpy().astype(np.uint32), host, f"{what}: crc vs host")
    return err


def fused_zstd_edge_rows(n: int):
    """(data, body lengths) staged at bucket n of the fused zstd edge rows:
    v in {0, 1, 3, 4, 5, 8, n - 1, n} of random bytes, then of one
    repeated byte, each with a random prefix."""
    rng = np.random.default_rng(SEED + 34 + n)
    bodies = []
    for raw in (rng.integers(0, 256, n, dtype=np.uint8).tobytes(), b"\x61" * n):
        bodies += [raw[:v] for v in (0, 1, 3, 4, 5, 8, n - 1, n)]
    prefixes = [rng.integers(0, 256, fused_ops.PREFIX, dtype=np.uint8).tobytes() for _ in bodies]
    mat, blen, nn = fused_ops.stage_fused(prefixes, bodies, fused_ops._zstd_width)
    assert nn == n
    return mat, blen


# rows of the fused zstd edge launch: past the 33 rows (csrc/zstd.cu
# ENC_FEW_ROWS) that take 512-thread CTAs, so it runs at 256
FUSED_EDGE_ROWS = 40


def fused_zstd_edges(torch) -> int:
    """`_fused_zstd` on the edge rows at n = 512 and 65,536
    (fused_zstd_edge_rows), each row alone (512-thread CTAs) and the 16
    tiled to FUSED_EDGE_ROWS in one launch (256-thread CTAs), exact
    (fused_zstd_err) against one plain chain a bucket. Returns the
    launches."""
    launches = 0
    for n in (512, 65536):
        mat, blen = fused_zstd_edge_rows(n)
        data, valid = torch.from_numpy(mat).cuda(), torch.from_numpy(blen).cuda()
        want = fused_zstd_plain(torch, data, valid, n)
        groups = [[i] for i in range(len(blen))] + [[i % len(blen) for i in range(FUSED_EDGE_ROWS)]]
        for rows in groups:
            idx = torch.tensor(rows, device=data.device)
            what = f"fused_zstd n={n} rows {rows[:3]}{'...' if len(rows) > 3 else ''}"
            fused_zstd_err(torch, data[idx], valid[idx], n, what, {k: w[idx] for k, w in want.items()})
            launches += 2
    return launches


def block_kinds(blob: bytes) -> tuple:
    """({raw, rle, compressed} block counts, [(offset, header) of every
    block]) of a single-frame zstd blob."""
    from redpanda_tpu_torch.compression import zstd_frame as zf

    _, pos = zf.parse_frame_header(blob)
    counts = {"raw": 0, "rle": 0, "compressed": 0}
    blocks, last = [], False
    while not last:
        bh = int.from_bytes(blob[pos : pos + 3], "little")
        last, btype, size = bool(bh & 1), (bh >> 1) & 3, bh >> 3
        counts[("raw", "rle", "compressed")[btype]] += 1
        blocks.append((pos, bh))
        pos += 3 + (1 if btype == 1 else size)
    return counts, blocks


def one_block_frame(blob: bytes, pos: int, bh: int, chunk_len: int) -> bytes:
    """The block at `pos` of `blob` as a frame of its own (last flag set)."""
    from redpanda_tpu_torch.compression import zstd_frame as zf

    btype, size = (bh >> 1) & 3, bh >> 3
    body = blob[pos + 3 : pos + 3 + (1 if btype == 1 else size)]
    return zf.frame_header(chunk_len) + (bh | 1).to_bytes(3, "little") + body


class Recorder:
    """Wraps an entry: records its last call's arguments and the host
    clock at its entry and exit."""

    def __init__(self, fn):
        self.fn, self.args, self.t_in, self.t_out = fn, None, 0.0, 0.0

    def __call__(self, *args, **kwargs):
        self.args = args
        self.t_in = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.t_out = time.perf_counter()


def device_ms(torch, fn) -> float:
    start, end = _events()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def libzstd_yardstick(segment: bytes) -> str:
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("zstd")
    if not name:
        return "libzstd absent"
    lib = ctypes.CDLL(name)
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                  ctypes.c_size_t, ctypes.c_int]
    cap = lib.ZSTD_compressBound(len(segment))
    buf = ctypes.create_string_buffer(cap)
    t0 = time.perf_counter()
    r = lib.ZSTD_compress(buf, cap, segment, len(segment), 3)
    secs = time.perf_counter() - t0
    return f"libzstd level 3 on the host: {secs * 1e3:.1f} ms, {r} bytes (ratio {r / len(segment):.4f})"


def phase_segment(torch, segment: bytes, mem_rate: float) -> dict:
    """Phase 8, the tiered segment path at full size: one 128 MiB
    segment through compression.compress / uncompress(zstd) under
    RP_ZSTD_BACKEND=tpu, as cloud/archiver.py compresses every uploaded
    segment and cloud/remote_partition.py hydrates it. Three passes
    each, p50; no frame may punt to the host codec; 8 sampled blocks
    decoded by the pure-Python reference decoder. Then the kernels timed
    at the path's own shapes against their plain versions."""
    from redpanda_tpu_torch import compression
    from redpanda_tpu_torch.compression import CompressionType
    from redpanda_tpu_torch.compression import zstd_frame as zf

    def no_punt(_data):
        raise AssertionError("a device zstd frame punted to the host codec")

    enc_rec = Recorder(zstd_ops.encode_chunks)
    dec_rec = Recorder(zstd_ops.decode_streams)
    saved = (compression._zstd_uncompress_host, zstd_ops.encode_chunks, zstd_ops.decode_streams)
    compression._zstd_uncompress_host = no_punt
    zstd_ops.encode_chunks, zstd_ops.decode_streams = enc_rec, dec_rec
    comp_s, decomp_s, comp_split, decomp_split = [], [], [], []
    try:
        with env_backend("RP_ZSTD_BACKEND", "tpu"):
            reset_launches()
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                blob = compression.compress(segment, CompressionType.zstd)
                t1 = time.perf_counter()
                comp_s.append(t1 - t0)
                comp_split.append((enc_rec.t_in - t0, enc_rec.t_out - enc_rec.t_in, t1 - enc_rec.t_out))
                back = compression.uncompress(blob, CompressionType.zstd)
                t2 = time.perf_counter()
                decomp_s.append(t2 - t1)
                decomp_split.append((dec_rec.t_in - t1, dec_rec.t_out - dec_rec.t_in, t2 - dec_rec.t_out))
                if back != segment:
                    raise AssertionError("the hydrated segment differs from the segment")
            launches = {k: zstd_ops.LAUNCHES[k] for k in zstd_ops.LAUNCHES}
    finally:
        compression._zstd_uncompress_host, zstd_ops.encode_chunks, zstd_ops.decode_streams = saved
    kinds, blocks = block_kinds(blob)
    comp = [i for i, (_, bh) in enumerate(blocks) if (bh >> 1) & 3 == 2]
    picks = [comp[j * len(comp) // 8] for j in range(min(8, len(comp)))]
    for i in picks:
        pos, bh = blocks[i]
        chunk = segment[i * ZSTD_BLOCK : (i + 1) * ZSTD_BLOCK]
        if zf.reference_decompress(one_block_frame(blob, pos, bh, len(chunk))) != chunk:
            raise AssertionError(f"block {i}: the reference decoder disagrees")
    n_streams = len(dec_rec.args[0])
    log(f"[segment] {SEGMENT_BYTES} B segment ({len(blocks)} chunks of 64 KiB): compress and hydrate "
        f"under RP_ZSTD_BACKEND=tpu byte-exact, no punt; blocks {kinds}; stored/logical "
        f"{len(blob) / SEGMENT_BYTES:.4f} ({len(blob)} B); {n_streams} huff0 streams in one decode "
        f"launch; reference decoder agrees on blocks {picks}")
    log(f"[segment] compress p50 {pct(comp_s, 50) * 1e3:.1f} ms (passes "
        f"{', '.join(f'{x * 1e3:.1f}' for x in comp_s)}), hydrate p50 {pct(decomp_s, 50) * 1e3:.1f} ms "
        f"(passes {', '.join(f'{x * 1e3:.1f}' for x in decomp_s)}); host clock")
    log(f"[segment] {libzstd_yardstick(segment)}")
    stages = segment_stages(torch, enc_rec.args[0], dec_rec.args, comp_split, decomp_split)
    log("[segment] where the time goes, p50 of the three passes (host clock, each stage ending in a "
        "sync; kernels on the device clock): " + "; ".join(
            f"{k}: " + ", ".join(f"{s} {v:.1f} ms" for s, v in st.items()) for k, st in stages.items()))
    out = segment_kernels(torch, enc_rec.args[0], dec_rec.args, mem_rate)
    return {"launches": launches, "compress_ms": pct(comp_s, 50) * 1e3,
            "hydrate_ms": pct(decomp_s, 50) * 1e3, "kernels": out}


def segment_stages(torch, chunks, dec_args, comp_split, decomp_split) -> dict:
    """The encode and decode entries' inner stages, replayed once on the
    inputs the segment path gave them, beside the splits recorded around
    them in the three passes."""
    t0 = time.perf_counter()
    batch, valid = pad_rows(chunks, ZSTD_BLOCK)
    t1 = time.perf_counter()
    data, vt = torch.from_numpy(batch).cuda(), torch.from_numpy(valid).cuda()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    enc = []
    kern = device_ms(torch, lambda: enc.extend(zstd_ops._encode_chunks(data, vt, ZSTD_BLOCK)))
    t3 = time.perf_counter()
    host = [t.cpu().numpy() for t in enc]
    t4 = time.perf_counter()
    zstd_ops.streams_of(*host, len(chunks))
    t5 = time.perf_counter()
    compress = {
        "split": pct([c[0] for c in comp_split], 50) * 1e3,
        "encode_chunks": pct([c[1] for c in comp_split], 50) * 1e3,
        "of which chunk/pad": (t1 - t0) * 1e3, "h2d": (t2 - t1) * 1e3,
        "kernels (device)": kern, "launch + sync": (t3 - t2) * 1e3, "d2h": (t4 - t3) * 1e3,
        "cut streams": (t5 - t4) * 1e3,
        "build_block + frame": pct([c[2] for c in comp_split], 50) * 1e3,
    }
    streams, regens, tables = dec_args[:3]
    t0 = time.perf_counter()
    *mats, index, sbytes, rmax = zstd_ops.stage_streams(streams, regens, tables)
    groups = zstd_ops.decode_groups(index)
    t1 = time.perf_counter()
    args = [torch.from_numpy(m).cuda() for m in (*mats, index)]
    groups = torch.from_numpy(groups).cuda()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = []
    kern = device_ms(torch, lambda: res.extend(zstd_ops.decode_staged(*args, sbytes, rmax, groups)))
    t3 = time.perf_counter()
    zstd_ops.check_ends(res[1].cpu().numpy())
    res[0].cpu().numpy()
    t4 = time.perf_counter()
    hydrate = {
        "host walk (split_compressed_block, decode_table)": pct([c[0] for c in decomp_split], 50) * 1e3,
        "decode_streams": pct([c[1] for c in decomp_split], 50) * 1e3,
        "of which stage": (t1 - t0) * 1e3, "h2d": (t2 - t1) * 1e3,
        "kernel + checks (device)": kern, "launch + sync": (t3 - t2) * 1e3, "d2h": (t4 - t3) * 1e3,
        "join": pct([c[2] for c in decomp_split], 50) * 1e3,
    }
    return {"compress": compress, "hydrate": hydrate}


def encode_floor_ms(torch, b: int, n: int) -> float:
    """One empty kernel launched with the encode's cluster grid (four
    CTAs a row), block and shared memory, timed as the kernels are."""
    from redpanda_tpu_torch.ops import _build

    lib = zstd_ops._lib()
    _build.bind(lib, "rp_zstd_encode_empty", 0, 2)
    stream = torch.cuda.current_stream().cuda_stream
    return time_kernel(lambda: _build.check(lib, lib.rp_zstd_encode_empty(b, n, stream), "empty"), reps=30)


def zstd_encode_rows(torch, data, vt, n: int, offset: int, label: str, mem_rate: float) -> dict:
    """The encode kernel on one staged shape: every output (nbits, codes,
    all SB bytes of the four streams, bits) equal to the plain versions,
    timed beside its bytes bound, its plain version and the empty-kernel
    floor at its launch shape."""
    b, v_sum = data.shape[0], int(vt.sum())
    sb = zstd_ops.stream_byte_bound(n)
    check_encode(torch, data, vt, n, offset)
    nbits, codes, streams, bits = zstd_ops.launch_encode(data, vt, n, offset)
    p_nbits, p_codes = zstd_ops._lengths_plain(data, vt, n, offset)
    p_streams, p_bits = zstd_ops._emit_plain(data, vt, p_nbits, p_codes, n, offset)
    torch.cuda.synchronize()
    max_abs_err({"nbits": nbits, "codes": codes, "streams": streams, "bits": bits},
                {"nbits": p_nbits, "codes": p_codes, "streams": p_streams, "bits": p_bits})
    return {f"zstd_encode@{label}": {
        "shape": f"{label}: B={b} n={n} offset={offset} bytes={v_sum} streams={b * 4}x{sb}",
        "max_abs_err": 0.0,
        "ms": time_kernel(lambda: zstd_ops.launch_encode(data, vt, n, offset), reps=10),
        "plain_ms": time_plain(lambda: zstd_ops._encode_chunks_plain(data, vt, n, offset), reps=1),
        # valid bytes and lengths read; nbits (1 B) and codes (4 B) per symbol,
        # all SB bytes of the four streams and the bit counts written
        "bound_ms": (v_sum + 4 * b + 5 * 256 * b + b * 4 * (sb + 4)) / mem_rate * 1e3,
        "floor_ms": encode_floor_ms(torch, b, n),
    }}


def fused_zstd_row(torch, data, valid, n: int, offset: int, mem_rate: float) -> dict:
    """`_fused_zstd` on phase 8b's one row: one rp_fused_zstd launch, exact
    against the plain chain and the host CRC, timed beside its bound, its
    plain chain, the empty encode launch at its shape and the two-launch
    sequence it replaced."""
    assert offset == fused_ops.PREFIX
    err = fused_zstd_err(torch, data, valid, n, "fused_zstd@row")
    b, v_sum = data.shape[0], int(valid.sum())
    sb = zstd_ops.stream_byte_bound(n)
    lens = valid.to(torch.int64) + offset

    def plain():
        crc_ops.crc32c_device_plain(data, lens)
        zstd_ops._encode_chunks_plain(data, valid, n, offset)

    return {
        "shape": f"row: B={b} n={n} offset={offset} bytes={v_sum}",
        "max_abs_err": err,
        "ms": time_kernel(lambda: fused_ops._fused_zstd(data, valid, n), reps=30),
        "plain_ms": time_plain(plain, reps=2),
        # prefix, body and length read once; the CRC, nbits, the streams and bits written
        "bound_ms": (v_sum + offset * b + 4 * b + 8 * b + b * (256 + 4 * sb + 16)) / mem_rate * 1e3,
        "floor_ms": encode_floor_ms(torch, b, n),
        "sequence_ms": time_kernel(lambda: fused_ops._fused_zstd_sequence(data, valid, n), reps=30),
    }


def zstd_decode_row(torch, items, label: str, mem_rate: float) -> dict:
    """The decode kernel on the streams `items`, staged as decode_streams
    stages them: equal to the plain version (exact), timed beside its
    bytes bound and its plain version."""
    end, args = check_decode(torch, items)
    if end.any():
        raise AssertionError(f"zstd_decode@{label}: a valid stream did not consume its bits")
    streams, regens = [x[0] for x in items], [x[1] for x in items]
    s_n, t_n, sbytes, rmax = len(streams), args[3].shape[0], args[-3], args[-2]
    stream_bytes = sum(len(x) for x in streams)
    return {f"zstd_decode@{label}": {
        "shape": f"{label}: S={s_n} T={t_n} sbytes={sbytes} rmax={rmax} stream_bytes={stream_bytes} "
                 f"regen={sum(regens)}",
        "max_abs_err": 0.0,
        "ms": time_kernel(lambda: zstd_ops.launch_decode(*args), reps=10),
        "plain_ms": time_plain(lambda: decode_plain(*args), reps=1),
        # the valid stream bytes, tbits, regen and index, the T tables
        # (uint8 sym + int32 nb per entry) read; out [S, rmax] and end written
        "bound_ms": (stream_bytes + 12 * s_n + t_n * zstd_ops.TSIZE * 5 + s_n * rmax + 4 * s_n)
                    / mem_rate * 1e3,
    }}


def segment_kernels(torch, chunks, dec_args, mem_rate: float) -> dict:
    """Each zstd kernel at the segment path's shape: device ms beside its
    bytes bound and the plain version (equal, exact, at the full shape)."""
    data, vt = stage_rows(torch, chunks, ZSTD_BLOCK)
    t0 = time.perf_counter()
    out = zstd_encode_rows(torch, data, vt, ZSTD_BLOCK, 0, "segment", mem_rate)
    out.update(zstd_decode_row(torch, list(zip(*dec_args[:3])), "segment", mem_rate))
    log_rows("segment", out, "equal to plain at the full shape, tolerance exact")
    log(f"[segment] the full-shape checks and timings took {time.perf_counter() - t0:.1f} s")
    return {k.split("@")[0]: v for k, v in out.items()}


def phase_zstd_recompress(torch) -> dict:
    """Phase 8b: produce to and fetch from a zstd topic. Phase 6's 1,024
    batches through recompressed(zstd, verify_crc=...) and back through
    .records(), under RP_ZSTD_BACKEND=tpu; records equal to the
    originals'."""
    from redpanda_tpu_torch import compression
    from redpanda_tpu_torch.compression import CompressionType

    def no_punt(_data):
        raise AssertionError("a device zstd frame punted to the host codec")

    batches = build_batches(np.random.default_rng(SEED + 6))
    want = [[(r.key, r.value) for r in b.records()] for b in batches]
    saved = compression._zstd_uncompress_host
    compression._zstd_uncompress_host = no_punt
    try:
        with env_backend("RP_ZSTD_BACKEND", "tpu"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [b.recompressed(CompressionType.zstd, verify_crc=b.header.crc) for b in batches]
            t1 = time.perf_counter()
            got = [[(r.key, r.value) for r in o.records()] for o in outs]
            t2 = time.perf_counter()
            launches = {k: zstd_ops.LAUNCHES[k] for k in zstd_ops.LAUNCHES}
    finally:
        compression._zstd_uncompress_host = saved
    if got != want or any(o.header.compression != CompressionType.zstd for o in outs):
        raise AssertionError("a zstd batch does not round-trip through recompressed / records")
    raw_in, comp_out = sum(len(b.body) for b in batches), sum(len(o.body) for o in outs)
    log(f"[zstd-batches] {len(batches)} batches x {RECORDS} x {RECORD_BYTES} B through "
        f"recompressed(zstd) and .records() under RP_ZSTD_BACKEND=tpu: records equal, no punt; "
        f"produce {(t1 - t0) * 1e6 / len(batches):.1f} us per batch, fetch "
        f"{(t2 - t1) * 1e6 / len(batches):.1f} us per batch (host clock); {raw_in} -> {comp_out} bytes")
    return {"launches": launches, "produce_us": (t1 - t0) * 1e6 / len(batches),
            "fetch_us": (t2 - t1) * 1e6 / len(batches)}


# ------------------------------------------------- phase 9: the mesh
def mesh_lanes(arrays, n: int, seed: int):
    """`n` allocated rows of `arrays` with seeded quorum lanes, built as
    bench.py:407-435 builds the mesh bench's shard (SELF always a current
    voter), with about a quarter of the rows in joint consensus as
    tests/test_mesh_frame.py:37-60; one frame forced over every row
    settles them through the selected backend. Returns (arrays, rows)."""
    rows = np.array([arrays.alloc_row() for _ in range(n)], np.int64)
    rng = np.random.default_rng(seed)
    r = arrays.replica_slots
    match = rng.integers(-1, 400, (n, r)).astype(np.int64)
    flushed = np.maximum(match - rng.integers(0, 40, (n, r)), -1)
    voter = rng.random((n, r)) < 0.6
    voter[:, 0] = True
    old = np.zeros((n, r), bool)
    joint = rng.random(n) < 0.25
    old[joint] = rng.random((int(joint.sum()), r)) < 0.5
    arrays.match_index[rows] = match
    arrays.flushed_index[rows] = flushed
    arrays.is_voter[rows] = voter
    arrays.is_voter_old[rows] = old
    arrays.is_leader[rows] = True
    arrays.commit_index[rows] = rng.integers(-1, 200, n)
    arrays.term_start[rows] = rng.integers(0, 300, n)
    arrays.last_visible[rows] = arrays.commit_index[rows]
    arrays.voter_epoch += 1
    arrays.touch()
    arrays.quorum_dirty[:] = False
    empty = np.empty(0, np.int64)
    arrays.frame_tick(empty, empty, empty, empty, empty, force_rows=rows)
    return arrays, rows


def mesh_window(rng, rows, size: int, k: int, r: int):
    """Reply window k: `size` replies as the bench's steady window
    (unique rows, one non-self slot each, bench.py:456-463), of which an
    eighth repeat an earlier (row, slot) pair with a larger offset and a
    tenth carry a stale seq."""
    uniq = size - size // 8
    rr = rows[rng.choice(len(rows), size=min(uniq, len(rows)), replace=False)]
    slots = rng.integers(1, r, len(rr)).astype(np.int64)
    dirty = rng.integers(-1, 400 + 150 * k, len(rr)).astype(np.int64)
    dup = rng.integers(0, len(rr), size - len(rr))
    rr = np.concatenate([rr, rr[dup]])
    slots = np.concatenate([slots, slots[dup]])
    dirty = np.concatenate([dirty, dirty[dup] + rng.integers(0, 50, len(dup))])
    flushed = np.maximum(dirty - rng.integers(0, 25, len(rr)), -1)
    seqs = np.full(len(rr), k + 1, np.int64) - np.where(rng.random(len(rr)) < 0.1, 2, 0)
    return rr, slots, dirty, flushed, seqs.astype(np.int64)


def mesh_env(devices: int):
    """RP_QUORUM_BACKEND=mesh with RP_MESH_FULL=1 over `devices` blocks."""
    stack = contextlib.ExitStack()
    stack.enter_context(quorum_backend("mesh"))
    stack.enter_context(env_backend("RP_MESH_FULL", "1"))
    stack.enter_context(env_backend("RP_MESH_DEVICES", str(devices)))
    return stack


def run_mesh_slice(g: int, devices: int, device: str, window: int = MESH_WINDOW,
                   big_window: int = MESH_BIG_WINDOW, windows: int = MESH_WINDOWS,
                   big_windows: int = MESH_BIG_WINDOWS) -> dict:
    """The mesh backend (RP_QUORUM_BACKEND=mesh, RP_MESH_FULL=1, D =
    `devices` chip blocks on `device`) and the numpy host leg, built from
    one seed and fed the same reply windows through their TickFrames:
    `windows` of `window` replies, `big_windows` of `big_window`, then
    one health_refresh. Raises on the first lane, advanced-row set or
    total that differs; returns the mesh leg's frame times and stages."""
    from redpanda_tpu_torch.ops.health import health_reduce_np
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays
    from redpanda_tpu_torch.raft.tick_frame import TickFrame

    with mesh_env(devices):
        mesh, rows = mesh_lanes(ShardGroupArrays(capacity=g, device=device), g, SEED + 9)
        if mesh.chip_count() != devices or mesh.chip_block() != -(-g // devices):
            raise AssertionError(f"chip blocks: {mesh.chip_count()} x {mesh.chip_block()}")
    with quorum_backend("host"):
        host, _ = mesh_lanes(ShardGroupArrays(capacity=g, device="cpu"), g, SEED + 9)
    for lane in LANES:
        assert_equal(getattr(mesh, lane), getattr(host, lane), f"mesh build: {lane}")
    mframe, hframe = TickFrame(mesh), TickFrame(host)
    rng = np.random.default_rng(SEED + 10)
    mesh.stage_ms = {}
    frame_s, advanced_rows = [], 0
    sizes = [window] * windows + [big_window] * big_windows
    for k, size in enumerate(sizes):
        replies = mesh_window(rng, rows, size, k + 1, mesh.replica_slots)
        with mesh_env(devices):
            t0 = time.perf_counter()
            adv_m = mframe.fold_now(*replies)
            frame_s.append(time.perf_counter() - t0)
        with quorum_backend("host"):
            adv_h = hframe.fold_now(*replies)
        assert_equal(np.sort(adv_m), np.sort(adv_h), f"window {k}: advanced rows")
        advanced_rows += len(adv_h)
        for lane in LANES:
            assert_equal(getattr(mesh, lane), getattr(host, lane), f"window {k}: {lane}")
        want = health_reduce_np(host.match_index, host.commit_index, host.is_voter, host.is_voter_old,
                                host.is_leader, host.leader_id >= 0, host.row_active)
        for lane, key in zip(HEALTH_LANES, ("max_lag", "under_replicated", "leaderless")):
            assert_equal(getattr(mesh, lane), want[key], f"window {k}: {lane}")
        totals = {
            "advanced": len(adv_h),
            "max_follower_lag": int(want["max_lag"].max(initial=0)),
            "under_replicated": int(want["under_replicated"].sum()),
            "leaderless": int(want["leaderless"].sum()),
            "active": int(host.row_active.sum()),
        }
        if mesh.mesh_totals() != totals:
            raise AssertionError(f"window {k}: totals {mesh.mesh_totals()} != {totals}")
    with mesh_env(devices):
        mesh.health_refresh()
        got = mesh.health_totals()
    with quorum_backend("host"):
        host.health_refresh()
        want = host.health_totals()
    for lane in HEALTH_LANES:
        assert_equal(getattr(mesh, lane), getattr(host, lane), f"health_refresh: {lane}")
    if got != want or {k: mesh.mesh_totals()[k] for k in want} != want:
        raise AssertionError(f"health_refresh totals: {got} / {mesh.mesh_totals()} != {want}")
    if advanced_rows == 0:
        raise AssertionError("no commit advanced in the whole mesh run")
    return {"frame_s": frame_s, "stage_ms": mesh.stage_ms, "advanced_rows": advanced_rows,
            "frames": len(sizes) + 1, "totals": mesh.mesh_totals(), "arrays": mesh, "rows": rows}


# what phase 9's main path launches: each full frame the fold kernel and
# the mesh sweep kernel (mesh_tick_frame), the health refresh health_totals
MESH_PATH = ("fold_replies", "mesh_tick_frame", "health_totals")


def phase_mesh(torch, mem_rate: float) -> dict:
    """Phase 9: the mesh backend at 1M rows over D = 8 chip blocks, then
    at D = 3 on a row count the blocks do not divide (padding rows);
    then the mesh frame and health_totals on the device clock against
    their bounds, each against its plain version."""
    reset_launches()
    out = run_mesh_slice(MESH_G, MESH_D, "cuda")
    pad = run_mesh_slice(MESH_PAD_G, MESH_PAD_D, "cuda", windows=2, big_windows=1)
    launches = {k: KERNELS[k][2][k] for k in MESH_PATH}
    mesh_pad_kernels(torch, pad, MESH_PAD_D)
    st = out["stage_ms"]
    log(f"[mesh] G={MESH_G} D={MESH_D}: {out['frames'] - 1} frames ({MESH_WINDOWS} x {MESH_WINDOW}, "
        f"{MESH_BIG_WINDOWS} x {MESH_BIG_WINDOW} replies) + one health_refresh equal to the host leg "
        f"lane for lane, advanced sets and totals ({out['advanced_rows']} row advances; last totals "
        f"{out['totals']}); D={MESH_PAD_D} at G={MESH_PAD_G} (padded to "
        f"{-(-MESH_PAD_G // MESH_PAD_D) * MESH_PAD_D} rows) equal too")
    log(f"[mesh] frame p50 {pct(out['frame_s'], 50) * 1e3:.3f} ms p99 {pct(out['frame_s'], 99) * 1e3:.3f} ms "
        f"(host clock, fold_now); per frame (n={len(st['kernel'])}): upload p50 {pct(st['h2d'], 50):.3f} ms, "
        f"kernels p50 {pct(st['kernel'], 50):.3f} ms, readback p50 {pct(st['d2h'], 50):.3f} ms")
    out["kernels"] = mesh_kernels(torch, out.pop("arrays"), out.pop("rows"), out["frames"], mem_rate)
    out["launches"] = launches
    return out


def mesh_kernels(torch, arrays, rows, k: int, mem_rate: float, device: str = "cuda") -> dict:
    """health_totals and the mesh frame at the path's shape (the mesh
    leg's lanes placed as D blocks, a next window k of the big size
    padded as _mesh_full_frame pads it), each exact against its plain
    version from the same state, on the device clock."""
    from redpanda_tpu_torch.parallel import mesh_frame

    frame = mesh_frame.MeshFrame(MESH_D, device)
    base = frame.place_state(arrays)
    work = frame.place_state(arrays)
    known = frame._place(arrays.leader_id >= 0)
    active = frame._place(arrays.row_active)
    before = frame._place(arrays.commit_index)
    gp, r = base.match_index.shape
    window = mesh_window(np.random.default_rng(SEED + 13), rows, MESH_BIG_WINDOW, k, arrays.replica_slots)
    replies = [torch.from_numpy(a).to(device) for a in padded_window(window)]

    def reset():
        for a, b in zip(work, base):
            a.copy_(b)

    hargs = (work.match_index, work.commit_index, work.is_voter, work.is_voter_old, work.is_leader,
             known, active, MESH_D)
    want, want_t = health_ops.health_totals_plain(*hargs, before=before)
    got, got_t = health_ops.health_totals(*hargs, before=before)
    torch.cuda.synchronize()
    err = max(max_abs_err(got, want), max_abs_err({"totals": got_t}, {"totals": want_t}))
    out = {"health_totals": {
        "shape": f"G={gp} R={r} D={MESH_D}", "max_abs_err": err,
        "ms": time_kernel(lambda: health_ops.health_totals(*hargs, before=before)),
        "plain_ms": time_plain(lambda: health_ops.health_totals_plain(*hargs, before=before)),
        # match (i64) and both masks over [G, R]; commit, before, three
        # flags read; max_lag and two flags written
        "bound_ms": gp * (r * (8 + 1 + 1) + 8 + 8 + 3 + 8 + 2) / mem_rate * 1e3,
    }}
    rows, slots, _, _, seqs = (a.cpu().numpy() for a in replies)
    cell = rows * r + slots
    fresh = seqs > np.ascontiguousarray(arrays.last_seq).reshape(-1)[cell]
    uniq, uniq_fresh, nf = len(np.unique(cell)), len(np.unique(cell[fresh])), int(fresh.sum())
    seq_bytes = (24 * len(rows) + 16 * nf + 8 * uniq + gp * r * (8 + 8 + 1 + 1) + gp * (1 + 8 + 8 + 8 + 2)
                 + 24 * uniq_fresh + 16 * gp + 10 * gp)

    def state():
        reset()
        return work

    out["mesh_tick_frame"] = {
        "shape": f"G={gp} R={r} D={MESH_D} M={len(rows)}",
        "max_abs_err": mesh_frame_err(torch, state, replies, known, active),
        "ms": time_kernel(lambda: mesh_frame.mesh_tick_frame(work, *replies, known, active, MESH_D), reset),
        "plain_ms": time_plain(lambda: mesh_frame_plain(work, replies, known, active), reset),
        # replies, last_seq per addressed pair, the [G, R] lanes and five
        # [G] lanes read once; fresh pairs' three lanes, commit, visible
        # and the health lanes written
        "bound_ms": seq_bytes / mem_rate * 1e3,
    }
    alone = quorum_alone(torch, base, work, reset, replies, f"G={gp} R={r} D={MESH_D}", mem_rate)
    out.update({f"{name}@mesh": e for name, e in alone.items()})
    blocks, threads, its = quorum_ops.fold_grid(len(replies[0]))
    log(f"[mesh] fold_replies: one cooperative launch of {blocks} blocks x {threads} threads, {its} "
        f"reply(ies) a thread, at M={len(replies[0])}")
    for name, e in out.items():
        log(f"[mesh] {name:<24} {e['shape']}: kernel {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms, "
            f"plain {e['plain_ms']:.3f} ms (equal to plain, tolerance exact)")
    return out


def quorum_alone(torch, base, work, reset, replies, shape: str, mem_rate: float, timed: bool = True) -> dict:
    """fold_replies and quorum_commit_step alone on a placed mesh state,
    each against its plain version (exact) and, if `timed`, on the device
    clock beside its bytes bound: the fold's as in phase 2 (group, slot,
    seq of every entry, dirty and flushed of every fresh reply, last_seq
    once per addressed pair, three lanes written once per fresh pair), the
    sweep's the [G, R] lanes and four [G] lanes read, two written."""
    gp, r = base.match_index.shape
    rows, slots, _, _, seqs = replies
    cell = rows * r + slots
    fresh = seqs > base.last_seq.reshape(-1)[cell]
    m, nf = len(rows), int(fresh.sum())
    uniq, uniq_fresh = int(torch.unique(cell).numel()), int(torch.unique(cell[fresh]).numel())
    out = {}
    for name, kern, plain, args, nbytes in (
        ("fold_replies", quorum_ops.fold_replies, quorum_ops.fold_replies_plain, replies,
         24 * m + 16 * nf + 8 * uniq + 40 * uniq_fresh),
        ("quorum_commit_step", quorum_ops.quorum_commit_step, quorum_ops.quorum_commit_step_plain, (),
         gp * r * (8 + 8 + 1 + 1) + gp * (1 + 8 + 8 + 8) + gp * 16),
    ):
        reset()
        want = {k: getattr(plain(work, *args), k).clone() for k in work._fields}
        reset()
        got = {k: getattr(kern(work, *args), k).clone() for k in work._fields}
        torch.cuda.synchronize()
        e = {"shape": shape + (f" M={m}" if args else ""), "max_abs_err": max_abs_err(got, want)}
        if timed:
            e.update(ms=time_kernel(lambda: kern(work, *args), reset),
                     plain_ms=time_plain(lambda: plain(work, *args), reset), bound_ms=nbytes / mem_rate * 1e3)
        out[name] = e
    reset()
    return out


def mesh_pad_kernels(torch, run: dict, devices: int) -> None:
    """fold_replies and quorum_commit_step against their plain versions on
    the padded mesh run's lanes placed as `devices` blocks, with a next
    window of the big size padded as _mesh_full_frame pads it."""
    from redpanda_tpu_torch.parallel import mesh_frame

    arrays, rows = run["arrays"], run["rows"]
    frame = mesh_frame.MeshFrame(devices, "cuda")
    base, work = frame.place_state(arrays), frame.place_state(arrays)
    window = mesh_window(np.random.default_rng(SEED + 14), rows, MESH_BIG_WINDOW, run["frames"],
                         arrays.replica_slots)
    replies = [torch.from_numpy(a).cuda() for a in padded_window(window)]

    def reset():
        for a, b in zip(work, base):
            a.copy_(b)

    gp, r = base.match_index.shape
    quorum_alone(torch, base, work, reset, replies, "", 0.0, timed=False)
    log(f"[mesh] fold_replies, quorum_commit_step at G={gp} (D={devices} blocks of {gp // devices} rows) R={r} "
        f"M={len(replies[0])}: equal to plain, tolerance exact")


def padded_window(window):
    """A reply window padded to its power-of-two bucket with no-op
    entries (row 0, slot 0, seq i64 min), as _mesh_full_frame pads it."""
    m = len(window[0])
    bucket = 8
    while bucket < m:
        bucket *= 2
    i64_min = np.iinfo(np.int64).min
    out = []
    for a, fill in zip(window, (0, 0, i64_min, i64_min, i64_min)):
        b = np.full(bucket, fill, np.int64)
        b[:m] = a
        out.append(b)
    return out


# ----------------------------------------- phase 10: the ring cluster
def cluster_fields(rng, g: int, r: int = R) -> dict:
    """A seeded cluster state in which every group, so every chip block,
    differs: mixed terms and leaders, logs, joint configs (old set
    {0, 3}) on about 15 % of the rows, mirrors at every stage, some log
    starts past a mirror."""
    match = np.full((g, r), -1, np.int64)
    match[:, :RF] = rng.integers(-1, 30, (g, RF))
    voter = np.zeros((g, r), bool)
    voter[:, :RF] = True
    old = np.zeros((g, r), bool)
    joint = rng.random(g) < 0.15
    old[joint, 0] = True
    old[joint, RF] = True
    commit = rng.integers(-1, 20, g).astype(np.int64)
    fol_dirty = rng.integers(-1, 30, (g, RF - 1)).astype(np.int64)
    fol_flushed = np.maximum(fol_dirty - rng.integers(0, 3, (g, RF - 1)), -1)
    return {
        "leader": {
            "term": rng.integers(0, 3, g).astype(np.int64),
            "is_leader": rng.random(g) < 0.85,
            "commit_index": commit,
            "term_start": rng.integers(0, 12, g).astype(np.int64),
            "last_visible": commit.copy(),
            "match_index": match,
            "flushed_index": np.maximum(match - rng.integers(0, 4, (g, r)), -1),
            "is_voter": voter,
            "is_voter_old": old,
            "last_seq": np.zeros((g, r), np.int64),
        },
        "fol_dirty": fol_dirty,
        "fol_flushed": fol_flushed,
        "fol_commit": np.maximum(fol_flushed - rng.integers(0, 3, (g, RF - 1)), -1),
        "fol_term": rng.integers(0, 3, (g, RF - 1)).astype(np.int64),
        "voted_term": rng.integers(0, 3, (g, RF - 1)).astype(np.int64),
        "log_start": np.where(rng.random(g) < 0.2, rng.integers(0, 12, g), 0).astype(np.int64),
    }


MIRROR_LANES = ("fol_dirty", "fol_flushed", "fol_commit", "fol_term", "voted_term", "log_start")


def cluster_state(fields: dict, device):
    import torch
    from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy
    from redpanda_tpu_torch.parallel.cluster_step import ClusterState

    return ClusterState(group_state_from_numpy(fields["leader"], device),
                        *(torch.from_numpy(np.ascontiguousarray(fields[k])).to(device) for k in MIRROR_LANES))


def clone_cluster(s):
    from redpanda_tpu_torch.models.consensus_state import GroupState

    return s._replace(leader=GroupState(*(t.clone() for t in s.leader)),
                      **{k: getattr(s, k).clone() for k in MIRROR_LANES})


def same_cluster(a, b, what: str) -> None:
    import torch

    for k in a.leader._fields:
        if not torch.equal(getattr(a.leader, k), getattr(b.leader, k)):
            raise AssertionError(f"{what}: leader.{k} differs from the plain version")
    for k in MIRROR_LANES:
        if not torch.equal(getattr(a, k), getattr(b, k)):
            raise AssertionError(f"{what}: {k} differs from the plain version")


def dryrun_cluster(torch, g: int, n: int, device: str) -> dict:
    """__graft_entry__.dryrun_multichip's scenario through the port at
    `g` groups over `n` chip blocks, with its assertions: every group
    commits at 7 in one tick; a failover election won by all with
    committed data intact; joint consensus gating commit on the old
    set's laggard (7), released to 9 when the old set dissolves; every
    stranded mirror installs the snapshot boundary in one tick."""
    from redpanda_tpu_torch.models.consensus_state import GroupState
    from redpanda_tpu_torch.parallel import (cluster_tick_sharded, election_round_sharded, make_cluster_state,
                                              make_mesh, shard_group_state)

    mesh = make_mesh(n, device)
    dev = mesh.device
    state = shard_group_state(make_cluster_state(g, device=device), mesh)
    tick = cluster_tick_sharded(mesh)

    def full(v, dtype=torch.int64):
        return torch.full((g,), v, dtype=dtype, device=dev)

    state, total, _ = tick(state, full(7))
    if int(total) != g or not bool((state.leader.commit_index == 7).all()):
        raise AssertionError(f"expected all {g} groups to commit at 7, got {int(total)}")
    state, _, _ = tick(state, full(-1))
    state.leader.match_index[:, 0] = 11
    state.leader.flushed_index[:, 0] = 11
    state, elected, _ = election_round_sharded(mesh, 1)(state, full(True, torch.bool))
    won = int(elected.sum())
    if won != g or not bool((state.fol_commit >= 7).all()):
        raise AssertionError(f"failover election: {won}/{g} won, or committed data lost")
    # re-seat the winners, then joint consensus: new {0, 1}, old {0, 2}
    lead = state.leader
    lead.is_leader.fill_(True)
    lead.term.add_(1)
    lead.term_start.zero_()
    lead.match_index[:, 0] = 9
    lead.flushed_index[:, 0] = 9
    lead.is_voter.zero_()
    lead.is_voter[:, :2] = True
    lead.is_voter_old.zero_()
    lead.is_voter_old[:, 0] = True
    lead.is_voter_old[:, 2] = True
    lead.match_index[:, 1], lead.match_index[:, 2] = 9, 7
    lead.flushed_index[:, 1], lead.flushed_index[:, 2] = 9, 7
    lead.commit_index.fill_(7)
    gated = quorum_ops.quorum_commit_step(GroupState(*(t.clone() for t in lead)))
    if not bool((gated.commit_index == 7).all()):
        raise AssertionError("joint quorum must gate on the old set's laggard")
    done = GroupState(*(t.clone() for t in lead))
    done.is_voter_old.zero_()
    done = quorum_ops.quorum_commit_step(done)
    if not bool((done.commit_index == 9).all()):
        raise AssertionError("leaving joint consensus must commit 9")
    lead.is_voter_old.zero_()
    state.fol_dirty[:, 0] = 1
    state.fol_flushed[:, 0] = 1
    state.fol_commit[:, 0] = 1
    state.log_start.fill_(6)
    state, _, installs = tick(state, full(-1))
    if int(installs) != g or not bool((state.fol_dirty[:, 0] >= 5).all()):
        raise AssertionError(f"expected {g} snapshot installs, got {int(installs)}")
    return {"committed": int(total), "elected": won, "installs": int(installs)}


def run_cluster(torch, g: int, n: int, ticks: int, device: str, seed: int = SEED + 11) -> dict:
    """`ticks` seeded rounds of the ring cluster at g groups over n chip
    blocks, the state resident on `device`: each tick about 30 % of the
    leaders append nothing, the rest up to 3 entries; every fifth tick an
    election on about 1 % of the groups with candidate_hop alternating 1
    and 2, its winners seated at the new term (the host handoff) so the
    next heartbeat truncates; each tick retention moves 2 % of log starts
    to commit + 1 and 1 % of mirrors lose their tail. The wrappers run
    on one copy of the state, the plain versions on another; after every
    call every lane, `elected`, the terms and both totals must be equal."""
    from redpanda_tpu_torch.parallel import cluster_step as cl

    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    kern = cluster_state(cluster_fields(rng, g), device)
    plain = clone_cluster(kern)
    totals = {"committed": 0, "installs": 0, "elected": 0, "elections": 0}

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for t in range(ticks):
        grow = up(np.where(rng.random(g) < 0.3, -1, rng.integers(0, 4, g)))
        new_dirty = torch.where(grow < 0, -1, kern.leader.match_index[:, 0] + grow)
        _, tot, inst = cl.cluster_tick(kern, new_dirty, n)
        _, p_tot, p_inst = cl.cluster_tick_plain(plain, new_dirty, n)
        same_cluster(kern, plain, f"tick {t}")
        if (int(tot), int(inst)) != (int(p_tot), int(p_inst)):
            raise AssertionError(f"tick {t}: totals {(int(tot), int(inst))} != {(int(p_tot), int(p_inst))}")
        totals["committed"] += int(tot)
        totals["installs"] += int(inst)
        if t % 5 == 4:
            hop = 1 + (t // 5) % 2
            mask = up(rng.random(g) < 0.01)
            _, el, terms = cl.election_round(kern, mask, hop, n)
            _, p_el, p_terms = cl.election_round_plain(plain, mask, hop, n)
            same_cluster(kern, plain, f"election at tick {t}")
            if not (torch.equal(el, p_el) and torch.equal(terms, p_terms)):
                raise AssertionError(f"election at tick {t}: elected / terms differ from the plain version")
            totals["elected"] += int(el.sum())
            totals["elections"] += 1
            for s in (kern, plain):
                s.leader.is_leader[el] = True
                s.leader.term[el] = terms[el]
                s.leader.term_start[el] = s.leader.match_index[el, 0] + 1
        adv = up(rng.random(g) < 0.02)
        lose = up(rng.random((g, RF - 1)) < 0.01)
        cut = up(rng.integers(-1, 5, (g, RF - 1)))
        for s in (kern, plain):
            s.log_start[adv] = torch.maximum(s.log_start, s.leader.commit_index + 1)[adv]
            s.fol_dirty[lose] = torch.minimum(s.fol_dirty, cut)[lose]
            torch.minimum(s.fol_flushed, s.fol_dirty, out=s.fol_flushed)
            torch.minimum(s.fol_commit, s.fol_flushed, out=s.fol_commit)
    if not (totals["committed"] and totals["installs"] and totals["elected"]):
        raise AssertionError(f"the schedule missed a path: {totals}")
    return {"totals": totals, "state": kern}


def phase_cluster(torch, mem_rate: float) -> dict:
    """Phase 10: the ring cluster at G = 1M groups over D = 8 chip
    blocks: the dryrun scenario, then the seeded ticks against the plain
    versions; then the four kernels on the device clock."""
    from redpanda_tpu_torch.parallel import cluster_step as cl

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dry = dryrun_cluster(torch, CLUSTER_G, MESH_D, "cuda")
    t1 = time.perf_counter()
    run = run_cluster(torch, CLUSTER_G, MESH_D, CLUSTER_TICKS, "cuda")
    t2 = time.perf_counter()
    launches = {k: cl.LAUNCHES[k] for k in cl.LAUNCHES}
    log(f"[cluster] G={CLUSTER_G} D={MESH_D} RF={RF}: the dryrun_multichip scenario held ({dry}) in "
        f"{(t1 - t0) * 1e3:.1f} ms; {CLUSTER_TICKS} seeded ticks and {run['totals']['elections']} elections "
        f"equal to the plain versions after every call ({run['totals']}) in {t2 - t1:.1f} s (host clock, "
        f"plain versions and comparisons included)")
    out = cluster_kernels(torch, run["state"], mem_rate)
    return {"launches": launches, "kernels": out}


def cluster_kernels(torch, state, mem_rate: float) -> dict:
    """cluster_tick, election_round, follower_commit_step and
    local_append_update at the cluster shape on the device clock beside
    their bounds; the last two also against their plain versions."""
    from redpanda_tpu_torch.models.consensus_state import GroupState
    from redpanda_tpu_torch.parallel import cluster_step as cl

    rng = np.random.default_rng(SEED + 12)
    g, r = state.leader.match_index.shape
    dev = state.leader.match_index.device
    base = clone_cluster(state)
    work = clone_cluster(state)

    def reset():
        for a, b in zip(work.leader, base.leader):
            a.copy_(b)
        for k in MIRROR_LANES:
            getattr(work, k).copy_(getattr(base, k))

    new_dirty = torch.where(torch.from_numpy(rng.random(g) < 0.3).to(dev), -1,
                            base.leader.match_index[:, 0] + torch.from_numpy(rng.integers(0, 4, g)).to(dev))
    mask = torch.from_numpy(rng.random(g) < 0.01).to(dev)
    out = {
        "cluster_tick": {
            "shape": f"G={g} R={r} D={MESH_D} RF={RF}", "max_abs_err": 0.0,
            "ms": time_kernel(lambda: cl.cluster_tick(work, new_dirty, MESH_D), reset),
            "plain_ms": time_plain(lambda: cl.cluster_tick_plain(work, new_dirty, MESH_D), reset),
            # leader row read (match, flushed over [G, R]; both masks; five
            # [G] lanes), five mirror lanes, log_start, new_dirty; slots
            # 0..2 of match / flushed, commit, visible, four mirror lanes
            # written
            "bound_ms": g * (r * 18 + 33 + 5 * 16 + 16 + 2 * RF * 8 + 16 + 4 * 16) / mem_rate * 1e3,
        },
        "election_round": {
            "shape": f"G={g} R={r} D={MESH_D} mask={int(mask.sum())}", "max_abs_err": 0.0,
            "ms": time_kernel(lambda: cl.election_round(work, mask, 1, MESH_D), reset),
            "plain_ms": time_plain(lambda: cl.election_round_plain(work, mask, 1, MESH_D), reset),
            # mask, term, is_leader, match[:, 0], three mirror lanes read;
            # elected, terms, term, is_leader and the two vote columns and
            # the candidate's append column written
            "bound_ms": g * (1 + 8 + 1 + 8 + 3 * 16 + 1 + 8 + 8 + 1 + 16 + 8) / mem_rate * 1e3,
        },
    }
    # the two follower-side rules on the leader lanes at the same shape
    lead_base = GroupState(*(t.clone() for t in base.leader))
    lead = GroupState(*(t.clone() for t in base.leader))

    def reset_lead():
        for a, b in zip(lead, lead_base):
            a.copy_(b)

    def lanes(s):
        return {k: getattr(s, k).clone() for k in s._fields}

    lc = base.leader.commit_index + torch.from_numpy(rng.integers(-2, 6, g)).to(dev)
    rows = torch.from_numpy(rng.integers(0, g, g)).to(dev)
    distinct = len(np.unique(rows.cpu().numpy()))
    app = base.leader.match_index[:, 0][rows] + torch.from_numpy(rng.integers(-3, 8, g)).to(dev)
    app_f = app - torch.from_numpy(rng.integers(0, 3, g)).to(dev)
    for name, kern, plain, args, nbytes in (
        ("follower_commit_step", quorum_ops.follower_commit_step, quorum_ops.follower_commit_step_plain,
         (lc,), g * (8 + 8 + 8 + 8 + 16)),
        # rows, dirty, flushed read; slot 0 of match / flushed read and
        # written once per distinct row
        ("local_append_update", quorum_ops.local_append_update, quorum_ops.local_append_update_plain,
         (rows, app, app_f), 24 * g + 32 * distinct),
    ):
        reset_lead()
        want = lanes(plain(lead, *args))
        reset_lead()
        got = lanes(kern(lead, *args))
        torch.cuda.synchronize()
        out[name] = {
            "shape": f"G={g} R={r}" + (f" M={g} distinct rows={distinct}" if name == "local_append_update" else ""),
            "max_abs_err": max_abs_err(got, want),
            "ms": time_kernel(lambda: kern(lead, *args), reset_lead),
            "plain_ms": time_plain(lambda: plain(lead, *args), reset_lead),
            "bound_ms": nbytes / mem_rate * 1e3,
        }
    # the follower rule where G is no multiple of its rows a thread (the
    # scalar tail) and on a view one row in (the [G] lanes 8 bytes off a
    # 16-byte boundary: the unaligned kernel), each against its plain version
    follow = out["follower_commit_step"]
    for label, rows_of in (("tail", slice(0, g - 3)), ("unaligned", slice(1, g))):
        reset_lead()
        part = GroupState(*(t[rows_of] for t in lead))
        aligned = all(t.data_ptr() % 16 == 0 for t in (part.commit_index, part.last_visible, lc[rows_of]))
        want = lanes(quorum_ops.follower_commit_step_plain(GroupState(*(t.clone() for t in part)), lc[rows_of]))
        got = lanes(quorum_ops.follower_commit_step(part, lc[rows_of]))
        torch.cuda.synchronize()
        follow[f"{label}_max_abs_err"] = max_abs_err(got, want)
        follow[f"{label}_shape"] = f"G={part.commit_index.numel()} R={r} aligned={aligned}"
    log(f"[cluster] follower_commit_step on {follow['tail_shape']} and {follow['unaligned_shape']}: equal to "
        f"plain, tolerance exact")
    # the library's function: two scatter_reduce_(amax) calls on the same
    # appends' cells (the rows are drawn in range, so no wrap or drop)
    cells = rows * r + quorum_ops.SELF_SLOT
    out["local_append_update"]["library_ms"] = time_kernel(lambda: (
        lead.match_index.view(-1).scatter_reduce_(0, cells, app, "amax"),
        lead.flushed_index.view(-1).scatter_reduce_(0, cells, app_f, "amax")), reset_lead)
    for name, e in out.items():
        lib_ms = f", library {e['library_ms']:.4f} ms" if "library_ms" in e else ""
        log(f"[cluster] {name:<20} {e['shape']}: kernel {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms, "
            f"plain {e['plain_ms']:.3f} ms{lib_ms}")
    return out


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, float), q))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    if CARD not in card:
        raise RuntimeError(f"bounds assume the {CARD} memory rate; this card is {card}")
    log(f"[card] bounds use {MEM_BYTES_PER_S / 1e12:.2f} TB/s device memory rate")

    from redpanda_tpu_torch.ops import _build

    t0 = time.perf_counter()
    build_s = _build.build_all()
    log(
        f"[build] one nvcc per source, all started together: {time.perf_counter() - t0:.1f} s wall; "
        f"each nvcc {', '.join(f'{k} {v:.1f} s' for k, v in build_s.items())} "
        f"(sum {sum(build_s.values()):.1f} s)"
    )

    results = phase_kernels(torch, MEM_BYTES_PER_S)
    codec = phase_codec_kernels(torch, MEM_BYTES_PER_S)
    for name in ("cell_parse", "lz4_emit", "snappy_emit"):
        results[name] = codec[f"{name}@fused"]
    results["fused_lz4"] = codec["fused_lz4"]
    results["fused_snappy"] = codec["fused_snappy"]
    per_call = phase_per_call(torch, MEM_BYTES_PER_S)

    reset_launches()
    s = run_slice(G, TICKS, "cuda")
    path_launches = {
        name: KERNELS[name][2][name]
        for name in ("fold_replies", "quorum_commit_step", "build_heartbeats", "tick_frame", "health_reduce")
    }
    st = s["stage_ms"]
    log(
        f"[slice] G={G} RF={RF}: {TICKS} ticks equal to the host leg lane for lane "
        f"({s['advanced_rows']} row advances; health {s['health_totals']}); "
        f"device-leg tick p50 {pct(s['tick_s'], 50) * 1e3:.3f} ms p99 {pct(s['tick_s'], 99) * 1e3:.3f} ms "
        f"(numpy host leg p50 {pct(s['host_tick_s'], 50) * 1e3:.3f} ms p99 {pct(s['host_tick_s'], 99) * 1e3:.3f} ms); "
        f"per device tick (n={len(st.get('kernel', []))}): h2d p50 {pct(st['h2d'], 50):.3f} ms, "
        f"kernels p50 {pct(st['kernel'], 50):.3f} ms, d2h p50 {pct(st['d2h'], 50):.3f} ms"
    )
    rb = phase_record_batches(torch)
    path_launches["crc32c_device"] = rb["launches"]
    rc = phase_recompress(torch)
    for name, count in rc["launches"].items():
        path_launches[name] = path_launches.get(name, 0) + count
    t0 = time.perf_counter()
    segment = build_segment(np.random.default_rng(SEED + 9))
    log(f"[segment] built {len(segment)} B of serialized record batches in {time.perf_counter() - t0:.1f} s")
    results.update(phase_zstd_kernels(torch, segment, MEM_BYTES_PER_S))
    seg = phase_segment(torch, segment, MEM_BYTES_PER_S)
    del segment
    zr = phase_zstd_recompress(torch)
    results.update(seg["kernels"])
    mesh = phase_mesh(torch, MEM_BYTES_PER_S)
    cluster = phase_cluster(torch, MEM_BYTES_PER_S)
    results.update(mesh["kernels"])
    results.update(cluster["kernels"])
    for launches in (seg["launches"], zr["launches"], mesh["launches"], cluster["launches"]):
        for name, count in launches.items():
            path_launches[name] = path_launches.get(name, 0) + count
    missing = [k for k in KERNELS if k not in OFF_PATH and path_launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"[launches] main path (batch CRCs: crc32c_device {rb['launches']}; codec path: {rc['launches']}; "
        f"segment path: {seg['launches']}; zstd batches: {zr['launches']}; mesh: {mesh['launches']}; "
        f"cluster: {cluster['launches']}; no main-path caller: {', '.join(OFF_PATH)}): {path_launches}")

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        e = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches.get(name, 0), "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": "bytes", "library_ms": e.get("library_ms"), "shape": e["shape"],
        })
        if name in ALSO_REPLACES:
            kernels[-1]["also_replaces"] = ALSO_REPLACES[name]
        if "no_health" in e:  # the frame kernel as quorum.tick_frame launches it
            kernels[-1]["no_health"] = e["no_health"]
        at_mesh = results.get(f"{name}@mesh")
        if at_mesh is not None:  # the same kernel alone at the mesh frame's shape
            kernels[-1]["mesh"] = {k: at_mesh[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
        one = per_call.get(f"{name}@row", per_call.get(f"{name}@batch"))
        if one is not None:  # the same kernel at the shape one call gives it
            kernels[-1]["per_call"] = {k: one[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
