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
     rows), the fold and the commit sweep also at R=5, 3, 12 and 32
     (padded rows, the 16- and 32-slot kernels), and on CRC rows (1,024 ragged rows of ~16.4 KiB, 4,096 rows
     of 4 KiB); all outputs are integers, so every comparison is exact;
  3. the main path end to end: a 50,000-group ShardGroupArrays at RF=3
     on the card, driven by a TickFrame for 25 ticks of seeded follower
     acks and leader appends (every fifth tick a fused frame_tick with
     heartbeat rows), held lane for lane against the numpy host leg;
  4. the second half of the main path: Kafka CRCs of 1,024 record
     batches (16 records of 1 KiB each) through models.record.batch_crcs
     on the card, against the CRCs the host computed at build time, and
     a corrupted staged row that must be the only mismatch;
  5. the codec kernels (cell parse, LZ4 and snappy emission) against
     their plain versions at the fused path's shape (256 rows of 32 KiB
     bodies read in place after the 40-byte CRC prefix) and the codec
     shape (16 rows of 64 KiB), and on 64 short, empty and ragged rows:
     equal parse vectors, equal lengths and equal bytes on [0, out_len);
     and the fused CRC + codec launch sequences' CRCs against the plain
     CRC;
  6. the codec path end to end: 1,024 batches (16 x 1 KiB records, half
     JSON-like text, half random bytes) through RecordBatch.recompressed
     (lz4) under RP_CODEC_BACKEND=device, each CRC checked on the card
     against the host CRC and each frame decoded back here (pure-Python
     LZ4 and snappy decoders: the image need not carry liblz4 or
     libsnappy), a flipped wire CRC refused, and 16 x 64 KiB buffers
     through the registry backend's LZ4 and snappy legs.
The launch counters are zeroed just before each main-path phase (3, 4
and 6) and read just after; every kernel must have launched there.

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
from redpanda_tpu_torch.ops import health as health_ops
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import quorum as quorum_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops

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
    "health_reduce": ("redpanda_tpu_torch/csrc/health.cu", "redpanda_tpu/ops/health.py:39", health_ops.LAUNCHES),
    "crc32c_device": ("redpanda_tpu_torch/csrc/crc32c.cu", "redpanda_tpu/ops/crc32c.py:226", crc_ops.LAUNCHES),
    "cell_parse": ("redpanda_tpu_torch/csrc/codec.cu", "redpanda_tpu/ops/cellparse.py:30", parse_ops.LAUNCHES),
    "lz4_emit": ("redpanda_tpu_torch/csrc/codec.cu", "redpanda_tpu/ops/lz4.py:59", lz4_ops.LAUNCHES),
    "snappy_emit": ("redpanda_tpu_torch/csrc/codec.cu", "redpanda_tpu/ops/snappy.py:52", snappy_ops.LAUNCHES),
}
# codec shapes: the fused path's 256 rows x 32 KiB bodies (alternately seeded
# random and a repeated pattern, read in place after the 40-byte CRC prefix;
# bench.py:850-875) and the codec path's 16 x 64 KiB JSON-like rows
# (bench.py:961-965)
FUSED_ROWS, FUSED_BODY = 256, 32 * 1024
CODEC_ROWS, CODEC_BODY = 16, 64 * 1024
N_BATCHES, RECORDS, RECORD_BYTES = 1024, 16, 1024


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
        }
        if label == "ragged":
            out["crc32c_device"] = entry
        else:
            out["crc32c_device@bench"] = entry
    for name, e in out.items():
        log(
            f"[kernels] {name:<22} {e['shape']}: equal to plain, tolerance exact "
            f"(max_abs_err {e['max_abs_err']}); "
            f"kernel {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms"
        )
    return out


def padded_slot_counts(torch, rng) -> None:
    """fold_replies and quorum_commit_step against their plain versions
    at G groups for each R in EXTRA_SLOTS, exact."""
    from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy

    for r in EXTRA_SLOTS:
        fields = random_state_fields(rng, G, r)
        replies = [torch.from_numpy(a).cuda() for a in padded_replies(rng, G, r, M_REPLIES)]
        for name, kern, plain, args in (
            ("fold_replies", quorum_ops.fold_replies, quorum_ops.fold_replies_plain, replies),
            ("quorum_commit_step", quorum_ops.quorum_commit_step, quorum_ops.quorum_commit_step_plain, ()),
        ):
            want = plain(group_state_from_numpy(fields, "cuda"), *args)
            got = kern(group_state_from_numpy(fields, "cuda"), *args)
            torch.cuda.synchronize()
            max_abs_err(got._asdict(), want._asdict())
        log(f"[kernels] fold_replies, quorum_commit_step at G={G} R={r}: equal to plain, tolerance exact")


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
    out = {}
    for label, (data, valid, n, offset) in codec_shapes(torch).items():
        b = data.shape[0]
        nc = n // parse_ops.CELL
        v_sum = int(valid.sum())
        shape = f"{label}: B={b} n={n} offset={offset} bytes={v_sum}"
        got, want, out_bytes, errs = check_codec_kernels(torch, data, valid, n, offset, label)
        out[f"cell_parse@{label}"] = {
            "shape": shape, "max_abs_err": errs["cell_parse"],
            "ms": time_kernel(lambda: parse_ops.launch_parse(data, valid, n, offset), reps=10),
            "plain_ms": time_plain(lambda: parse_ops.cell_parse_plain(data, valid, n, offset), reps=2),
            # each row's valid bytes and length read; six [B, nc] vectors
            # (has 1 B, five int32) and last_end written
            "bound_ms": bound(v_sum + 4 * b + 21 * b * nc + 4 * b),
        }
        lit = int(got[5].sum()) + int((valid - got[6]).clamp(min=0).sum())
        for key, emit, emit_plain in (
            ("lz4_emit", lz4_ops.lz4_emit, lz4_ops.lz4_emit_plain),
            ("snappy_emit", snappy_ops.snappy_emit, snappy_ops.snappy_emit_plain),
        ):
            out[f"{key}@{label}"] = {
                "shape": f"{shape} out={out_bytes[key]}", "max_abs_err": errs[key],
                "ms": time_kernel(lambda: emit(data, valid, got, n, offset), reps=10),
                "plain_ms": time_plain(lambda: emit_plain(data, valid, want, n, offset), reps=2),
                # the parse vectors the emission reads (has, offs, mlen,
                # lit_start, lit_len: 17 B per cell, plus last_end and
                # valid), every literal byte once, every block byte once
                "bound_ms": bound(17 * b * nc + 8 * b + lit + out_bytes[key] + 4 * b),
                "ratio": v_sum / max(out_bytes[key], 1),
            }
        if label == "fused":
            crc_lens = valid.to(torch.int64) + fused.PREFIX
            want_crc = crc_ops.crc32c_device_plain(data, crc_lens)
            for key, seq, emit_plain in (
                ("fused_lz4", fused._fused, lz4_ops.lz4_emit_plain),
                ("fused_snappy", fused._fused_snappy, snappy_ops.snappy_emit_plain),
            ):
                crc, _, f_len = seq(data, valid, n)
                torch.cuda.synchronize()
                crc_err = float((crc - want_crc).abs().max())
                if crc_err != 0.0:
                    raise AssertionError(f"{key}: fused CRC differs from the plain CRC")

                def plain(emit_plain=emit_plain):
                    crc_ops.crc32c_device_plain(data, crc_lens)
                    emit_plain(data, valid, parse_ops.cell_parse_plain(data, valid, n, offset), n, offset)

                out[key] = {
                    "shape": shape, "max_abs_err": crc_err,
                    "ms": time_kernel(lambda: seq(data, valid, n), reps=10),
                    "plain_ms": time_plain(plain, reps=1),
                    # prefix and body of every row and lens read once; the
                    # CRC (int64) and the block bytes and lengths written
                    "bound_ms": bound(v_sum + fused.PREFIX * b + 8 * b + 8 * b + int(f_len.sum()) + 4 * b),
                }
    for name, e in out.items():
        extra = f", ratio {e['ratio']:.3f}" if "ratio" in e else ""
        log(
            f"[codec] {name:<22} {e['shape']}: equal to plain, tolerance exact; "
            f"kernel {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms{extra}"
        )
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
        launches = {k: KERNELS[k][2][k] for k in ("crc32c_device", "cell_parse", "lz4_emit", "snappy_emit")}
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
    log("[recompress] one call, p50 over 64 batches (host clock; device = the fused launch sequence "
        "on the device clock): " + ", ".join(f"{k} {v:.1f} us" for k, v in stages.items()))
    return {"launches": launches, "ms": secs * 1e3, "stages_us": stages}


def recompress_stages(torch, batches) -> dict:
    """Where one recompressed(lz4) call's time goes, p50 over `batches`:
    the whole call, then the fused entry's stages one by one on the
    host clock (each ending in a synchronize, so they add up to more
    than the call), and the fused launch sequence on the device clock
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

    reset_launches()
    s = run_slice(G, TICKS, "cuda")
    path_launches = {
        name: KERNELS[name][2][name]
        for name in ("fold_replies", "quorum_commit_step", "build_heartbeats", "health_reduce")
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
    missing = [k for k in KERNELS if path_launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"[launches] main path (batch CRCs: crc32c_device {rb['launches']}; codec path: {rc['launches']}): "
        f"{path_launches}")

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        e = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name], "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": e["shape"],
        })
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
