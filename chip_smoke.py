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
     a corrupted staged row that must be the only mismatch.
The launch counters are zeroed just before each main-path phase and
read just after; every kernel must have launched there.

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

from redpanda_tpu_torch.ops import crc32c as crc_ops
from redpanda_tpu_torch.ops import health as health_ops
from redpanda_tpu_torch.ops import quorum as quorum_ops

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
}


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
def quorum_backend(name: str):
    old = os.environ.get("RP_QUORUM_BACKEND")
    os.environ["RP_QUORUM_BACKEND"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["RP_QUORUM_BACKEND"]
        else:
            os.environ["RP_QUORUM_BACKEND"] = old


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
    missing = [k for k, v in path_launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"[launches] main path: {path_launches}")

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
