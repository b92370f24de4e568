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
     sequences (heartbeat_tick: one rp_heartbeat_tick call, its fold
     kernel and its sweep kernel, timed beside the fold + sweep launch
     sequence it replaced; tick_frame and tick_frame_health: one launch
     of the frame kernel) against their plain chains; batches that mix
     rows -1, -G, -G-1, G, G+5 and slots
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
     scatter_reduce_(amax) calls on the same appends;
  11. the main path armed: a child process (`chip_smoke.py --armed`,
     RP_DEVPLANE=1, the default RP_DEVPLANE_SAMPLE) runs phase 3's tick,
     the mesh backend at 1M rows over D=8 blocks (four tick frames and a
     health refresh, against the host leg), 64 recompressed(lz4) calls,
     entry()'s heartbeat_tick (exact against its plain chain) and
     entry.dryrun_multichip(8), then checks that each probe's sample
     count is 1 + calls // N for the calls a counting shim saw, one
     cross-chip fold a frame, no dispatch or transfer on the tick
     outside a frame, the transfer bytes equal to what the mesh frames
     must move, and merged_status of an encoded snapshot equal to
     status(); it prints the armed tick p50 / p99 beside phase 3's and
     each probe's sampled dispatch->ready p50;
  12. the port's Raft layer live through its entry points: three
     raft.GroupManagers on the card (device="cuda", the default quorum
     backend) over rpc.LoopbackNetwork, 5,000 groups at RF=3 with node 0
     forced leader (bench.py:133 _live_tick_async at BENCH_LIVE_GROUPS'
     default), ticks driven by hand (3,600 s timeouts); after catch-up,
     20 rounds of one acks=-1 batch (16 x 1 KiB records) on a seeded
     500 groups, every ack awaited, then one heartbeat tick on node 0;
     20 idle ticks and one health_report. Every device_tick of node 0
     (a frame flush: one heartbeat_tick call) is held against
     the numpy host leg on a copy of the lanes taken just before it
     (advanced rows and the five lanes, exact); the same scenario under
     RP_QUORUM_BACKEND=host must end equal (every ack's offsets, commit
     / visible / term of every group on every node, node 0's match and
     flushed rows, the records read back from both followers, which
     must also be those sent, and health_report); each shape of the
     traffic's heartbeat_tick calls (the GroupManager's row capacity and
     the reply bucket, read from the calls) is then given to the
     kernel on seeded lanes and replies with duplicates and stale seqs,
     exact against its plain chain and timed beside the launch sequence
     it replaced; prints setup and
     catch-up seconds, round and tick p50 / p99, the launches at warm-up
     (prewarm's tick_frame_health) and around the traffic, and
     tick_frame.flushes;
  13. (run before 12) the Kafka broker through its entry points: three
     app.Brokers in one process, each on the card
     (BrokerConfig(device="cuda")), over
     loopback internal RPC with their real Kafka TCP listeners and one
     kafka.client.KafkaClient, at OMB's
     workloads/1-topic-100-partitions-1kb.yaml size: one topic of 100
     partitions at RF=3, compression.type=lz4, every leader moved to a
     fixed node; 1,024 acks=all produce requests of one 16 x 1 KiB batch
     (Kafka's default batch.size, 16,384 B; half JSON-like, half random),
     the batches of a partition in order and every partition in flight
     at once, then every partition fetched back to its high watermark,
     then node 0's health report, under RP_CODEC_BACKEND=device (the
     broker recompresses each batch in one rp_fused_lz4 launch) and
     RP_FETCH_VERIFY=1 (one crc32c_device launch a fetch response with
     records); the same traffic again on the host leg
     (RP_QUORUM_BACKEND=host, RP_CRC_BACKEND=host, RP_CODEC_BACKEND unset,
     RP_FETCH_VERIFY=0). On both legs every batch must be acknowledged at
     the next offsets of its partition and every record fetched back
     equal, with equal high watermarks and no KAFKA_STORAGE_ERROR; on the
     device leg fused_lz4 must launch once a produced batch, crc32c_device
     once a fetch response that carried records, and heartbeat_tick and
     health_reduce at least once; leaders that
     moved during the produce lead as created again before the fetch;
     prints the setup, the produce wall time and per-batch p50 / p99, the
     fetch MB/s and per-call p50 / p99 of both legs, the launches, the
     leaders moved and the event loop's longest stall;
  14. (run before 12) the port as users start it. Part A: three OS
     processes `python -m redpanda_tpu_torch --device cuda --shards 2`
     (shard 0 and one worker shard each; RP_DEVPLANE=1
     RP_DEVPLANE_SAMPLE=1 RP_CODEC_BACKEND=device RP_FETCH_VERIFY=1), the
     topic created with the port's CLI at phase 13's shape, phase 13's
     1,024 acks=all batches and every partition fetched back; then node
     0's worker shard SIGKILLed (its pid from GET /v1/shards), its
     restart awaited (forked by the shard runtime's fork server after
     shard 0 had initialised CUDA), 256 more batches to the partitions it
     owns and everything fetched back again. Checked: every record back
     equal at its offset; /v1/shards on every node sharded with exactly
     the one restart; the restarted worker's own registry
     (/v1/shards/1/metrics) with samples of quorum.heartbeat_tick, as
     many as its heartbeat_tick launches on the card; node 0's /v1/devplane
     with fused.crc_lz4 and crc32c.device samples. The probe calls of
     every process (each call sampled) are the part's launches. Part B:
     three Brokers on the card sharing one bucket directory
     (RP_ARCHIVE_COMPRESSION=zstd RP_ZSTD_BACKEND=tpu), one partition at
     RF=3 with remote write / read and segment.bytes =
     retention.local.target.bytes = 16 MiB; 48 MiB of phase 13's records
     produced acks=all, 16 batches a request; archival.run_once() and
     housekeeping() on every broker; the partition fetched from offset
     0, below the local start. Checked: every record back equal,
     hydrations, zstd_encode and zstd_decode launched, every stored
     object decoding with the host codec to its local segment's bytes,
     and the host leg (RP_ZSTD_BACKEND=host) equal in records and
     offsets. Prints produce / fetch p50 / p99 and MB/s on the host
     clock beside the card's name and power limit, and
     `nvidia-smi --query-compute-apps` (one line per process on the
     card).
  15. (run before 12) the brokers under faults, through the port's copy
     of the chaos harness (tests/test_torch_chaos_harness.py run_chaos).
     Part A: three app.Brokers on the card (device="cuda", the default
     quorum backend, RP_CODEC_BACKEND=device, RP_FETCH_VERIFY=1), one
     topic of 2 partitions at RF=3 with compression.type=lz4, acks=all
     sequenced produces and a live fetch stream for 15 s of crashes
     (Broker.stop, then a fresh Broker over the same data directory on
     the same CUDA context), network partitions and leadership
     transfers, the internal RPC under test_nemesis.py's capstone
     schedule (seed 20260804: AppendEntries dropped 5 %, duplicated 2 %,
     reordered 4 % in windows of 4, corrupted 1 %; both heartbeat kinds
     duplicated 2 %; every method delayed 5 %, 1 ms + up to 4 ms). Checked:
     I1-I3 (the harness's validate), every acked record at its offset in
     each of the three replicas' committed logs, L1-L4 (linear_check)
     over the produce and fetch history, every device_tick of node 0
     (across its restarts) exact against the numpy host leg on a copy of
     its lanes, every nemesis action fired, and heartbeat_tick,
     fused_lz4, crc32c_device and health_reduce launched. Part B: the
     tiered brokers (RP_ARCHIVE_COMPRESSION=zstd RP_ZSTD_BACKEND=tpu)
     under test_chaos.py's object-store schedule (seed 515: partial
     uploads, torn manifests, slow ranged reads, failed gets, throttles)
     for 6 s of broker faults. Checked: I1-I3, the tiered checks (at
     least one partition archived and one trimmed, every manifest
     object present at its stored size), the store's fault trace
     replayed byte-equal from (rules, seed, ops), the topic read from
     offset 0 after the trim equal to the acks, and crc32c_device,
     zstd_encode and zstd_decode launched. Prints, for each part, acked /
     attempts, the faults fired, produce p50 / p99 on the host clock, the
     launches and its wall seconds.
  16. (run before 12) the broker's zstd and mesh seams: three app.Brokers
     on the card as in phase 13. Part A (RP_ZSTD_BACKEND=tpu
     RP_CODEC_BACKEND=device RP_FETCH_VERIFY=1): phase 13's 1,024
     uncompressed batches to a topic of 100 partitions at RF=3, acks=all,
     with compression.type=zstd (BASELINE.json config 5's codec; each
     leader recompresses each batch with one zstd_encode launch), then
     512 batches of JSON-like records the producer compressed with zstd
     (the port's RecordBatchBuilder, before the count starts) to an lz4
     topic of 100 partitions (each leader decodes each with one
     zstd_decode launch and re-encodes it with one fused_lz4 launch);
     every partition fetched back. Every zstd_encode,
     zstd_decode and fused_lz4 call is held against its plain version
     (the fused CRC against the host's), exact; no zstd decode may punt
     to the host codec. Checked: every record back at its
     offset, every stored zstd batch decoding through libzstd (ctypes) to
     the body sent, each stage's launches equal to its held calls and to
     the leaders' recompressions (retries counted), crc32c_device once a
     fetch response with records. Part B (RP_QUORUM_BACKEND=mesh
     RP_MESH_FULL=1 RP_MESH_DEVICES=8): phase 13's lz4 traffic, the
     second half produced while the lanes of 4 partitions node 0 leads
     move into another chip block (PartitionMover.move_lane), then one
     frame at rest; every node's mesh frames held against the numpy host
     leg on a copy of its lanes (advanced rows, LANES, HEALTH_LANES,
     mesh_totals) and every health refresh against the host reduction;
     the host quorum backend's leg equal in offsets, watermarks and
     records; fold_replies and mesh_tick_frame launched once a held
     frame, health_totals once a held refresh. Prints a `[seams]` line
     per part with setup, produce wall and per-batch p50 / p99, fetch
     MB/s, the launches by stage, the held calls, the moves, the event
     loop's longest stall and the phase's wall seconds.
The launch counters are zeroed just before each main-path phase (3, 4,
6, 8, 8b, 9, 10, 12's traffic, 13's produce, 14's part B, each part
of 15, once its cluster has started, and each part of 16's produce)
and read just after (14's part A reads the node processes' probe
calls); every kernel
must have launched there, except those in OFF_PATH
(follower_commit_step, local_append_update, build_heartbeats,
fused_snappy, fused_zstd).

Output: progress lines, the card line, one JSON line of per-kernel
numbers, and last `{"ok": true, "device": {...}}`. Without a CUDA card
it exits 2 and prints no result.

The traffic generator and the leg driver below are also used by
tests/test_torch_slice.py on the CPU (device="cpu").
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import signal
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
    "heartbeat_tick": ("redpanda_tpu_torch/csrc/quorum.cu", "redpanda_tpu/ops/quorum.py:260", quorum_ops.LAUNCHES),
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
HEALTH_KEYS = ("max_lag", "under_replicated", "leaderless")  # their health_reduce outputs


@contextlib.contextmanager
def environ(values: dict):
    """Set (a str) or unset (None) each variable; restore on exit."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def env_backend(var: str, name: str):
    return environ({var: name})


def quorum_backend(name: str):
    return env_backend("RP_QUORUM_BACKEND", name)


def codec_backend(name: str):
    return env_backend("RP_CODEC_BACKEND", name)


def assert_equal(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = np.argwhere(a != b)[:5] if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: device leg != host leg (first diffs at {bad})")


def health_np(arrays) -> dict:
    """The host health reduction (health_reduce_np) of every row of a
    ShardGroupArrays' lanes."""
    from redpanda_tpu_torch.ops.health import health_reduce_np

    return health_reduce_np(arrays.match_index, arrays.commit_index, arrays.is_voter, arrays.is_voter_old,
                            arrays.is_leader, arrays.leader_id >= 0, arrays.row_active)


def totals_np(arrays, health: dict) -> dict:
    return {"max_follower_lag": int(health["max_lag"].max(initial=0)),
            "under_replicated": int(health["under_replicated"].sum()),
            "leaderless": int(health["leaderless"].sum()), "active": int(arrays.row_active.sum())}


def run_slice(g: int, ticks: int, device: str, seed: int = SEED) -> dict:
    """The replication slice on two legs fed identical traffic: the
    device leg (RP_QUORUM_BACKEND=device on `device`) and the numpy host
    leg. Raises on the first lane that differs; returns per-tick
    timings of both legs' fold calls and the device leg's stages."""
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
            want = health_np(host)
            for lane, k in zip(HEALTH_LANES, HEALTH_KEYS):
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
    heartbeat_tick is one call of its entry (its fold kernel, then its
    sweep kernel), also timed as the launch sequence it replaced
    (fold_replies, then quorum_commit_step: `sequence_ms`); tick_frame
    and tick_frame_health one launch of the frame kernel each, entered as
    "tick_frame" (the health form is the one the main path calls)."""
    m, nf = len(replies[0]), int(fresh.sum())
    tick = tick_bytes(G, R, m, nf, uniq, uniq_fresh)
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
    entries["heartbeat_tick"]["sequence_ms"] = time_kernel(
        lambda: quorum_ops.quorum_commit_step(quorum_ops.fold_replies(work, *replies)), reset)
    one_call(torch, lambda: quorum_ops.heartbeat_tick(work, *replies), reset)
    blocks, threads, its = quorum_ops.frame_grid(m, G, R, H_ROWS)
    log(f"[kernels] tick_frame: one cooperative launch of {blocks} blocks x {threads} threads, {its} "
        f"reply(ies) a thread, at M={m} G={G} H={H_ROWS}")
    no_health = entries.pop("tick_frame@no_health")
    entries["tick_frame"]["max_abs_err"] = max(entries["tick_frame"]["max_abs_err"], no_health["max_abs_err"])
    entries["tick_frame"]["no_health"] = {k: no_health[k] for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[kernels] tick_frame without health (quorum tick_frame): equal to plain, kernel "
        f"{no_health['ms']:.4f} ms, bound {no_health['bound_ms']:.4f} ms, plain {no_health['plain_ms']:.3f} ms")
    out.update(entries)


def tick_bytes(g: int, r: int, m: int, nf: int, uniq: int, uniq_fresh: int) -> int:
    """The bytes heartbeat_tick must move as one function for m replies,
    nf of them fresh, on uniq addressed pairs (uniq_fresh with a fresh
    reply): group, slot and seq of every reply, dirty and flushed of every
    fresh one; last_seq once per addressed pair; match / flushed / both
    voter masks over [G, R] and four [G] lanes read; the fresh pairs'
    three lanes and commit / visible written."""
    return (24 * m + 16 * nf + 8 * uniq + g * r * (8 + 8 + 1 + 1) + g * (1 + 8 + 8 + 8)
            + 24 * uniq_fresh + 16 * g)


def one_call(torch, fn, reset) -> None:
    """heartbeat_tick on the card is one launch of its entry a call, and
    launches neither of the kernels it replaced."""
    names = ("heartbeat_tick", "fold_replies", "quorum_commit_step")
    reset()
    before = {k: quorum_ops.LAUNCHES[k] for k in names}
    fn()
    torch.cuda.synchronize()
    moved = {k: quorum_ops.LAUNCHES[k] - before[k] for k in names}
    if moved != {"heartbeat_tick": 1, "fold_replies": 0, "quorum_commit_step": 0}:
        raise AssertionError(f"one heartbeat_tick call launched {moved}")


def live_tick(torch, shape: tuple, mem_rate: float) -> dict:
    """heartbeat_tick at the live Raft layer's shape (G rows of R slots,
    a bucket of M replies, as phase 12's calls had them) on seeded lanes
    and replies (M / 2 + M / 4 of them real, so the bucket stays M, over
    a quarter of the rows: duplicate pairs, a tenth stale, the rest
    padding), exact against its plain chain, timed beside the launch
    sequence it replaced and its bound."""
    from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy

    g, r, m = shape
    rng = np.random.default_rng(SEED + 21)
    fields = random_state_fields(rng, g, r)
    replies_np = padded_replies(rng, g, r, m // 2 + m // 4)
    if len(replies_np[0]) != m:
        raise AssertionError(f"the live batch pads to {len(replies_np[0])} replies, not {m}")
    base = group_state_from_numpy(fields, "cuda")
    work = group_state_from_numpy(fields, "cuda")
    replies = [torch.from_numpy(a).cuda() for a in replies_np]

    def reset():
        for a, b in zip(work, base):
            a.copy_(b)

    def lanes(state):
        return {k: getattr(state, k).clone() for k in state._fields}

    reset()
    want = lanes(quorum_ops.heartbeat_tick_plain(work, *replies))
    reset()
    got = lanes(quorum_ops.heartbeat_tick(work, *replies))
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    one_call(torch, lambda: quorum_ops.heartbeat_tick(work, *replies), reset)
    rows, slots, _, _, seqs = replies_np
    cell = rows * r + slots
    fresh = seqs > fields["last_seq"].reshape(-1)[cell]
    return {
        "shape": f"G={g} R={r} M={m} (of which {m // 2 + m // 4} real, {int(fresh.sum())} fresh)",
        "max_abs_err": err,
        "ms": time_kernel(lambda: quorum_ops.heartbeat_tick(work, *replies), reset),
        "sequence_ms": time_kernel(
            lambda: quorum_ops.quorum_commit_step(quorum_ops.fold_replies(work, *replies)), reset),
        "plain_ms": time_plain(lambda: quorum_ops.heartbeat_tick_plain(work, *replies), reset),
        "bound_ms": tick_bytes(g, r, m, int(fresh.sum()), len(np.unique(cell)), len(np.unique(cell[fresh])))
        / mem_rate * 1e3,
    }


@contextlib.contextmanager
def tick_shapes(shapes: list):
    """Append (G, R, M) of every heartbeat_tick call to `shapes`: the
    rows and slots of its state and the length of its reply batch
    (ShardGroupArrays.device_tick looks the function up at each call)."""
    tick = quorum_ops.heartbeat_tick

    def recorded(state, group_idx, *rest):
        shapes.append((*state.match_index.shape, group_idx.shape[0]))
        return tick(state, group_idx, *rest)

    quorum_ops.heartbeat_tick = recorded
    try:
        yield shapes
    finally:
        quorum_ops.heartbeat_tick = tick


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
    local_append_update, build_heartbeats, heartbeat_tick, tick_frame and
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
        ("heartbeat_tick", lambda s: [quorum_ops.heartbeat_tick(s, *replies)._asdict()],
         lambda s: [quorum_ops.heartbeat_tick_plain(s, *replies)._asdict()]),
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
        f"{H_ROWS} heartbeat rows: fold_replies, local_append_update, build_heartbeats, heartbeat_tick, tick_frame, "
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
    """fold_replies, quorum_commit_step, heartbeat_tick, the tick frame
    kernel (with health) and the mesh frame against their plain versions
    at G groups for each R in EXTRA_SLOTS, exact."""
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
            ("heartbeat_tick", quorum_ops.heartbeat_tick, quorum_ops.heartbeat_tick_plain, replies),
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
        log(f"[kernels] fold_replies, quorum_commit_step, heartbeat_tick, tick_frame (health), mesh_tick_frame "
            f"at G={G} R={r}: "
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
    from redpanda_tpu_torch.compression import CompressionType

    batches = build_batches(np.random.default_rng(SEED + 6))
    want = [[(r.key, r.value) for r in b.records()] for b in batches]
    with no_zstd_punt([]), env_backend("RP_ZSTD_BACKEND", "tpu"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [b.recompressed(CompressionType.zstd, verify_crc=b.header.crc) for b in batches]
        t1 = time.perf_counter()
        got = [[(r.key, r.value) for r in o.records()] for o in outs]
        t2 = time.perf_counter()
        launches = {k: zstd_ops.LAUNCHES[k] for k in zstd_ops.LAUNCHES}
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
        want = health_np(host)
        for lane, key in zip(HEALTH_LANES, HEALTH_KEYS):
            assert_equal(getattr(mesh, lane), want[key], f"window {k}: {lane}")
        totals = {"advanced": len(adv_h), **totals_np(host, want)}
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
    # the scenario's joint reconfiguration steps the commit sweep alone
    launches["quorum_commit_step"] = quorum_ops.LAUNCHES["quorum_commit_step"]
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


# ----------------------------------------- phase 11: the armed devplane
# the armed child's depths: phase 3's tick, the mesh at phase 9's scale
# over fewer windows, part of phase 6's batches, entry() and the dry run
ARMED_MESH_WINDOWS, ARMED_MESH_BIG_WINDOWS = 2, 1
ARMED_BATCHES = 64
# the probes the armed main path must reach (the others have no caller
# there: quorum.tick_frame, build_heartbeats and fold_replies run inside
# the frame kernel or a composite, the codec registry legs and the zstd
# path are not driven by this phase)
ARMED_PATH = ("quorum.heartbeat_tick", "health.tick_frame", "health.reduce", "mesh_frame.tick_frame",
              "mesh_frame.health", "fused.crc_lz4", "quorum.commit_step", "cluster.tick",
              "cluster.election_round")


def count_probe_calls(devplane) -> dict:
    """Count the calls each devplane probe forwards, apart from its own
    sampling counter: every probe bound so far, and every probe made
    from here on, gets a counting shim under its `fn`. Returns {id:
    [name, calls, probe]}, one entry a probe (a name may have several:
    one MeshFrame or cluster factory call makes one); the entry keeps
    its probe alive, so no later probe reuses its id."""
    calls: dict = {}

    def wrap(p):
        if id(p) in calls:
            return
        rec = calls[id(p)] = [p.name, 0, p]
        inner = p.fn

        def counted(*args, **kwargs):
            rec[1] += 1
            return inner(*args, **kwargs)

        p.fn = counted

    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("redpanda_tpu_torch"):
            for v in list(vars(mod).values()):
                if isinstance(v, devplane._Probe):
                    wrap(v)
    init = devplane._Probe.__init__

    def counted_init(self, fn, name):
        init(self, fn, name)
        wrap(self)

    devplane._Probe.__init__ = counted_init
    return calls


def sampled(n: int, every: int) -> int:
    """Samples a probe takes over n calls: the first and every Nth."""
    return n if every == 1 else (1 + n // every if n else 0)


def reply_bucket(m: int) -> int:
    """The padded reply columns of a frame of m replies (shard_state)."""
    b = 8
    while b < m:
        b *= 2
    return b


def mesh_frame_bytes(g: int, r: int, buckets, health_frames: int) -> dict:
    """Host<->device bytes the mesh frames must move for g rows of r
    slots: each tick frame uploads the ten state lanes (i64 term, commit,
    term_start, last_visible; bool is_leader; i64 match, flushed,
    last_seq and bool is_voter, is_voter_old a slot), the five i64 reply
    columns at their bucket and the bool known / active lanes, and reads
    back five lanes (i64 commit, visible; match, flushed, last_seq a
    slot), the three health lanes (i64 lag, bool under, bool leaderless)
    and five i64 totals; each health frame uploads match, commit, both
    voter masks, is_leader, known and active and reads back the health
    lanes and four totals."""
    h2d = sum(g * (4 * 8 + 1) + g * r * (3 * 8 + 2) + 5 * 8 * b + 2 * g for b in buckets)
    d2h = len(buckets) * (2 * 8 * g + 3 * 8 * g * r + 10 * g + 5 * 8)
    h2d += health_frames * (8 * g * r + 8 * g + 2 * g * r + 3 * g)
    d2h += health_frames * (10 * g + 4 * 8)
    return {"h2d": h2d, "d2h": d2h}


def armed_run(device: str, g: int, ticks: int, mesh_g: int, mesh_d: int, batches: int) -> dict:
    """The main path with every probe live (RP_DEVPLANE=1 at import):
    the tick of `g` groups for `ticks` ticks, the mesh backend at
    `mesh_g` rows over `mesh_d` blocks, `batches` recompressed(lz4)
    calls, entry()'s heartbeat_tick against its plain chain and
    dryrun_multichip(mesh_d), all on `device`; then every check of the
    devplane's counts. Raises on any check; returns the numbers."""
    from redpanda_tpu_torch.compression import CompressionType
    from redpanda_tpu_torch.entry import dryrun_multichip, entry
    from redpanda_tpu_torch.models.consensus_state import GroupState
    from redpanda_tpu_torch.observability import devplane
    from redpanda_tpu_torch.observability.fleet import RegistrySnapshot

    if not devplane.enabled():
        raise AssertionError("the armed run needs RP_DEVPLANE=1 at import")
    every = devplane.SAMPLE_EVERY
    calls = count_probe_calls(devplane)
    t0 = time.perf_counter()
    s = run_slice(g, ticks, device)
    t1 = time.perf_counter()
    mesh = run_mesh_slice(mesh_g, mesh_d, device, windows=ARMED_MESH_WINDOWS,
                          big_windows=ARMED_MESH_BIG_WINDOWS)
    mesh_r = mesh["arrays"].replica_slots
    del mesh["arrays"], mesh["rows"]
    t2 = time.perf_counter()
    built = build_batches(np.random.default_rng(SEED + 6), batches)
    with codec_backend("device"):
        outs = [b.recompressed(CompressionType.lz4, verify_crc=b.header.crc) for b in built]
    for b, o in zip(built, outs):
        if lz4_frame_decode(o.body) != b.body:
            raise AssertionError("an armed recompressed frame does not decode to its body")
    fn, args = entry(device)
    plain = GroupState(*(t.clone() for t in args[0]))
    quorum_ops.fold_replies_plain(plain, *args[1:])
    quorum_ops.quorum_commit_step_plain(plain)
    out = fn(*args)
    err = max_abs_err(dict(zip(GroupState._fields, out)), dict(zip(GroupState._fields, plain)))
    if not bool((out.commit_index == 100).all()):
        raise AssertionError("entry(): every group must commit at 100")
    dryrun_multichip(mesh_d, device)
    t3 = time.perf_counter()

    st = devplane.status()
    want: dict = {}
    n_calls: dict = {}
    for name, n, _ in calls.values():
        want[name] = want.get(name, 0) + sampled(n, every)
        n_calls[name] = n_calls.get(name, 0) + n
    got = {name: d["count"] for name, d in st["kernels"].items()}
    bad = {k: (got.get(k, 0), want.get(k, 0)) for k in set(got) | set(want) if got.get(k, 0) != want.get(k, 0)}
    if bad:
        raise AssertionError(f"sampled counts != 1 + calls // {every} per probe: {bad}")
    idle = [k for k in ARMED_PATH if n_calls.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"probes the armed main path never reached: {idle}")
    if st["folds"] != st["frames_total"] or st["frames_total"] != mesh["frames"] + 1:
        raise AssertionError(f"folds {st['folds']} / frames {st['frames']}: one fold a frame, "
                             f"{mesh['frames'] + 1} frames")
    if st["tick_violations"] != 0:
        raise AssertionError(f"{st['tick_violations']} device events on the tick outside a frame")
    buckets = [8] + [reply_bucket(MESH_WINDOW)] * ARMED_MESH_WINDOWS + \
        [reply_bucket(MESH_BIG_WINDOW)] * ARMED_MESH_BIG_WINDOWS
    moved = mesh_frame_bytes(mesh_g, mesh_r, buckets, 1)
    if st["transfer_bytes"] != moved:
        raise AssertionError(f"transfer bytes {st['transfer_bytes']} != the mesh frames' {moved}")
    wire = devplane.snapshot(shard=0, node=0).encode()
    merged = devplane.merged_status([RegistrySnapshot.decode(wire)])
    if merged["kernels"] != st["kernels"] or merged["frames"] != st["frames"]:
        raise AssertionError("merged_status of the snapshot differs from status()")
    kernels = {k: {"calls": n_calls[k], "samples": d["count"], "p50_ms": d["p50_ms"], "p99_ms": d["p99_ms"]}
               for k, d in st["kernels"].items() if d["count"]}
    log(f"[armed] RP_DEVPLANE=1 RP_DEVPLANE_SAMPLE={every}: slice {t1 - t0:.1f} s, mesh {t2 - t1:.1f} s, "
        f"recompress + entry + dryrun {t3 - t2:.1f} s")
    log(f"[armed] every probe's samples == 1 + calls // {every}; folds {st['folds']} == frames "
        f"{st['frames']}; tick_violations 0; transfer bytes {st['transfer_bytes']} == the mesh frames'; "
        f"entry() heartbeat_tick equal to its plain chain (max_abs_err {err}); merged_status round trip "
        f"of a {len(wire)} B snapshot equal")
    return {
        "tick_s": s["tick_s"], "kernels": kernels, "frame_ms": st["frame_ms"],
        "transfer_bytes": st["transfer_bytes"], "frames": st["frames"], "folds": st["folds"],
        "sample_every": every, "entry_max_abs_err": err, "seconds": t3 - t0,
    }


def armed_main() -> int:
    """The armed child (`chip_smoke.py --armed`, RP_DEVPLANE=1 in its
    environment): `armed_run` on the card at the main path's sizes;
    prints its lines and last one JSON object for the parent."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --armed: no CUDA device available", file=sys.stderr)
        return 2
    from redpanda_tpu_torch.ops import _build

    # the child's start-up, not a tick's cost: the CUDA context and the
    # kernel libraries, which the parent's phase 3 finds loaded
    torch.zeros(1, device="cuda")
    for name in _build.SOURCES:
        _build.load(name)
    armed = armed_run("cuda", G, TICKS, MESH_G, MESH_D, ARMED_BATCHES)
    print(json.dumps({"armed": armed}), flush=True)
    return 0


def phase_armed(off_tick_s) -> dict:
    """Phase 11: the main path again with the devplane armed, in a child
    process (RP_DEVPLANE is read at import) on the card: phase 3's tick,
    the mesh backend at 1M rows, 64 recompressed(lz4) calls, entry()'s
    heartbeat_tick and dryrun_multichip(8). The child raises on any
    check; here its lines are relayed and the tick compared with phase
    3's off-state tick."""
    t0 = time.perf_counter()
    env = dict(os.environ, RP_DEVPLANE="1")
    run = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--armed"], env=env, capture_output=True,
        text=True, timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    lines = run.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if run.returncode != 0:
        raise AssertionError(f"the armed phase failed (rc {run.returncode}):\n{run.stdout[-4000:]}\n"
                             f"{run.stderr[-8000:]}")
    armed = json.loads(lines[-1])["armed"]
    a, o = armed["tick_s"], off_tick_s
    log(f"[armed] tick p50 {pct(a, 50) * 1e3:.3f} ms p99 {pct(a, 99) * 1e3:.3f} ms armed vs "
        f"p50 {pct(o, 50) * 1e3:.3f} ms p99 {pct(o, 99) * 1e3:.3f} ms off (phase 3); child "
        f"{time.perf_counter() - t0:.1f} s")
    log("[armed] sampled dispatch->ready p50 (calls / samples): " + ", ".join(
        f"{k} {d['p50_ms']:.3f} ms ({d['calls']}/{d['samples']})" for k, d in sorted(armed["kernels"].items())))
    fr = armed["frame_ms"]
    log("[armed] mesh frame dispatch->ready p50: " + ", ".join(
        f"{k} {d['p50_ms']:.3f} ms (n={d['count']})" for k, d in sorted(fr.items())))
    return armed


# ------------------------------------------------------- live raft layer
# bench.py:133 _live_tick_async at BENCH_LIVE_GROUPS' default (bench.py:327):
# 5,000 groups, here at RF=3 on three GroupManagers over loopback, node 0
# forced leader of all of them; each round one acks=-1 batch of 16 x 1 KiB
# records (PERF.md §4's batch, Kafka's batch.size) on a seeded tenth of the
# groups, then one heartbeat tick on node 0; 10 rounds, so the whole run
# with phase 14 in it stays under ~650 s
LIVE_GROUPS, LIVE_ROUNDS, LIVE_PER_ROUND, LIVE_NODES = 5_000, 10, 500, 3
LIVE_STEADY_TICKS = 20
# the kernels the live layer must launch between its traffic and its
# health report (a frame flush without heartbeat rows: heartbeat_tick's
# fold and sweep; the report: health_reduce); the frame kernel
# (tick_frame_health) runs only in prewarm
LIVE_PATH = ("heartbeat_tick", "health_reduce")


def port_raft():
    """The port's Raft entry points, as LiveRaft takes them."""
    from types import SimpleNamespace

    from redpanda_tpu_torch.models.record import RecordBatchBuilder, RecordBatchType
    from redpanda_tpu_torch.raft.group_manager import GroupManager
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork, LoopbackTransport

    return SimpleNamespace(GroupManager=GroupManager, LoopbackNetwork=LoopbackNetwork,
                           LoopbackTransport=LoopbackTransport, RecordBatchBuilder=RecordBatchBuilder,
                           RecordBatchType=RecordBatchType)


def shadow_arrays(arrays):
    """A copy of a ShardGroupArrays whose lanes are its own: the numpy
    host leg can step it without touching the original."""
    import copy

    shadow = copy.copy(arrays)
    for k, v in vars(arrays).items():
        if isinstance(v, np.ndarray):
            setattr(shadow, k, v.copy())
    return shadow


def hold_device_ticks(arrays, held: dict | None = None) -> dict:
    """Hold every device_tick call on `arrays` against the numpy host
    leg (host_tick) run on a copy of the lanes taken just before the
    call: the advanced rows and LANES must be equal, exact. A call that
    differs raises, and since a frame flush runs in an event-loop
    callback, where asyncio only logs what it raises, the error is also
    kept: check_held raises the first. Returns {"calls": the reply
    count of each held call, "errors": the mismatches}; a `held` given
    (one node's arrays across its restarts) collects into that."""
    if held is None:
        held = {"calls": [], "errors": []}
    device_tick = arrays.device_tick

    def checked(*args, **kwargs):
        shadow = shadow_arrays(arrays)
        got = device_tick(*args, **kwargs)
        want = shadow.host_tick(*args, **kwargs)
        n = len(held["calls"])
        held["calls"].append(len(args[0]))
        try:
            assert_equal(np.sort(got), np.sort(want), f"device_tick call {n}: advanced rows")
            for lane in LANES:
                assert_equal(getattr(arrays, lane), getattr(shadow, lane), f"device_tick call {n}: {lane}")
        except AssertionError as e:
            held["errors"].append(e)
            raise
        return got

    arrays.device_tick = checked
    return held


def check_held(held: dict) -> None:
    if held["errors"]:
        raise held["errors"][0]
    if not held["calls"]:
        raise AssertionError("no device_tick call was held")


class LiveRaft:
    """Three GroupManagers of one package (`pkg`: its GroupManager,
    LoopbackNetwork, LoopbackTransport, RecordBatchBuilder and
    RecordBatchType) over loopback, ticks driven by hand (3,600 s
    timeouts, as bench.py's live tick), `groups` raft groups of the
    three voters with node 0 forced leader of all of them."""

    def __init__(self, pkg, data_dir: str, groups: int, **gm_kw):
        self.pkg, self.data_dir, self.groups, self.gm_kw = pkg, data_dir, groups, gm_kw
        self.gms: list = []
        self.net = None

    def _sender(self, src):
        async def send(dst, method_id, payload, timeout):
            return await self.pkg.LoopbackTransport(self.net, src, dst).call(method_id, payload, timeout)

        return send

    async def start(self, hold=None) -> None:
        """Start the nodes and create every group on each; `hold(gm)`
        runs on node 0 before its start (its prewarm included)."""
        self.net = self.pkg.LoopbackNetwork()
        for nid in range(LIVE_NODES):
            gm = self.pkg.GroupManager(
                node_id=nid, data_dir=os.path.join(self.data_dir, f"node_{nid}"), send=self._sender(nid),
                election_timeout_s=3600.0, heartbeat_interval_s=3600.0, **self.gm_kw,
            )
            if nid == 0 and hold is not None:
                hold(gm)
            self.net.register(nid, gm.service)
            self.gms.append(gm)
            await gm.start()
        voters = list(range(LIVE_NODES))
        for gid in range(1, self.groups + 1):
            for gm in self.gms:
                await gm.create_group(gid, voters)

    def leader(self, gid: int):
        return self.gms[0].get(gid)

    async def lead(self, terms=0) -> float:
        """Force node 0 leader of every group, then tick until every
        leader's commit_index >= term_start. A fresh group leads at
        `terms` (one int, or one a group; 0 as bench.py:168-175), a
        restarted one (terms=None) at its recovered term. Returns the
        catch-up seconds."""
        leaders = []
        if terms is not None:
            terms = np.broadcast_to(terms, self.groups)
        for gid in range(1, self.groups + 1):
            c = self.leader(gid)
            if terms is not None:
                c.arrays.term[c.row] = int(terms[gid - 1])
            c._become_leader()
            leaders.append(c)
        hb = self.gms[0].heartbeat_manager
        t0 = time.perf_counter()
        # each follower's catch-up append is fsync-bound: 37-41 s at 5,000
        # groups on the disk of an H100 host (PERF.md §5)
        deadline = time.monotonic() + max(120.0, self.groups / 25.0)
        pending = leaders
        while True:
            while pending and pending[-1].commit_index >= pending[-1].term_start:
                pending.pop()
            if not pending:
                return time.perf_counter() - t0
            await hb.tick()
            if time.monotonic() > deadline:
                raise TimeoutError(f"followers never caught up ({len(pending)} groups behind)")
            await asyncio.sleep(0)

    async def traffic(self, rounds: int, per_round: int, seed: int) -> dict:
        """`rounds` rounds: one acks=-1 batch of RECORDS x RECORD_BYTES
        records on `per_round` seeded groups, every ack awaited, then one
        heartbeat tick on node 0. Returns the acks [(group, base,
        last)], the blake2b digest of the records each group was sent
        (offset, key, value) and the round and tick seconds."""
        import hashlib

        pkg, rng = self.pkg, np.random.default_rng(seed)
        hb = self.gms[0].heartbeat_manager
        sent = {gid: hashlib.blake2b() for gid in range(1, self.groups + 1)}
        acks, round_s, tick_s = [], [], []
        for k in range(rounds):
            picks = [int(g) + 1 for g in rng.choice(self.groups, per_round, replace=False)]
            blobs = [rng.bytes(RECORDS * RECORD_BYTES) for _ in picks]
            builders = []
            for gid, blob in zip(picks, blobs):
                b = pkg.RecordBatchBuilder(pkg.RecordBatchType.raft_data, timestamp_ms=1_700_000_000_000 + k)
                for i in range(RECORDS):
                    b.add(value=blob[i * RECORD_BYTES:(i + 1) * RECORD_BYTES], key=b"k%d" % i)
                builders.append(b)
            t0 = time.perf_counter()
            got = await asyncio.gather(*(self.leader(gid).replicate(b, acks=-1) for gid, b in zip(picks, builders)))
            t1 = time.perf_counter()
            await hb.tick()
            t2 = time.perf_counter()
            round_s.append(t2 - t0)
            tick_s.append(t2 - t1)
            for gid, blob, (base, last) in zip(picks, blobs, got):
                if last - base + 1 != RECORDS:
                    raise AssertionError(f"g{gid}: ack ({base}, {last}) does not cover {RECORDS} records")
                for i in range(RECORDS):
                    record_digest(sent[gid], base + i, b"k%d" % i, blob[i * RECORD_BYTES:(i + 1) * RECORD_BYTES])
                acks.append((gid, int(base), int(last)))
        return {"acks": acks, "sent": {g: d.hexdigest() for g, d in sent.items()},
                "round_s": round_s, "tick_s": tick_s}

    async def steady(self, ticks: int) -> list:
        """`ticks` heartbeat ticks on node 0 with no traffic; seconds each."""
        hb, out = self.gms[0].heartbeat_manager, []
        for _ in range(ticks):
            t0 = time.perf_counter()
            await hb.tick()
            out.append(time.perf_counter() - t0)
        return out

    def state(self) -> dict:
        """Per node and group: commit_index, last_visible, term; node
        0's match_index and flushed_index rows."""
        out = {}
        for nid, gm in enumerate(self.gms):
            cs = [gm.get(gid) for gid in range(1, self.groups + 1)]
            out[f"commit_index@{nid}"] = np.array([c.commit_index for c in cs], np.int64)
            out[f"last_visible@{nid}"] = np.array([c.last_visible_index for c in cs], np.int64)
            out[f"term@{nid}"] = np.array([c.term for c in cs], np.int64)
        a, rows = self.gms[0].arrays, [self.leader(gid).row for gid in range(1, self.groups + 1)]
        out["match_index@0"] = a.match_index[rows].copy()
        out["flushed_index@0"] = a.flushed_index[rows].copy()
        return out

    def records(self, nodes) -> dict:
        """The blake2b digest of the data records each group's log holds
        on each of `nodes` (offset, key, value), and each batch's
        (base, last, term, type) on node nodes[0]."""
        import hashlib

        out = {}
        for nid in nodes:
            for gid in range(1, self.groups + 1):
                log_ = self.gms[nid].get(gid).log
                d, batches = hashlib.blake2b(), []
                for batch in log_.read(0, max_bytes=1 << 62):
                    h = batch.header
                    batches.append((int(h.base_offset), int(h.last_offset), int(h.term), int(h.type)))
                    if h.type != self.pkg.RecordBatchType.raft_data:
                        continue
                    for r in batch.records():
                        record_digest(d, h.base_offset + r.offset_delta, r.key, r.value)
                out[(nid, gid)] = d.hexdigest()
                if nid == nodes[0]:
                    out[("batches", gid)] = batches
        return out

    async def stop(self) -> None:
        for gm in self.gms:
            await gm.stop()
        self.gms = []


def record_digest(d, offset: int, key: bytes, value: bytes) -> None:
    d.update(int(offset).to_bytes(8, "little", signed=True))
    d.update(len(key).to_bytes(4, "little") + key + len(value).to_bytes(4, "little") + value)


def check_records(got: dict, sent: dict, nodes, groups: int) -> None:
    """Every node in `nodes` holds exactly the records each group was sent."""
    bad = [(nid, gid) for nid in nodes for gid in range(1, groups + 1) if got[(nid, gid)] != sent[gid]]
    if bad:
        raise AssertionError(f"records read back differ from those sent at (node, group) {bad[:5]}")


async def live_scenario(pkg, data_dir: str, groups: int, rounds: int, per_round: int, seed: int,
                        steady: int = 0, hold=None, on_traffic=None, terms=0, **gm_kw) -> dict:
    """The live Raft layer end to end: start, lead, `rounds` rounds of
    traffic, `steady` idle ticks, one health_report on node 0, the end
    state and the records read back from both followers (checked
    against those sent). Node 0 leads at `terms` (LiveRaft.lead).
    `on_traffic(phase)` is called with "start" just before the traffic
    and "end" just after the health report."""
    live = LiveRaft(pkg, data_dir, groups, **gm_kw)
    t0 = time.perf_counter()
    await live.start(hold)
    setup_s = time.perf_counter() - t0
    catchup_s = await live.lead(terms)
    if on_traffic:
        on_traffic("start")
    out = await live.traffic(rounds, per_round, seed)
    out["steady_s"] = await live.steady(steady)
    out["health"] = live.gms[0].health_report()
    if on_traffic:
        on_traffic("end")
    out["state"] = live.state()
    followers = list(range(1, LIVE_NODES))
    out["records"] = live.records(followers)
    check_records(out["records"], out["sent"], followers, groups)
    out["flushes"] = live.gms[0].tick_frame.flushes
    out["setup_s"], out["catchup_s"] = setup_s, catchup_s
    await live.stop()
    return out


def health_totals(report: dict) -> dict:
    return {k: report[k] for k in ("max_follower_lag", "under_replicated", "leaderless", "active")}


def same_live(a: dict, b: dict, what: str) -> None:
    """Two runs of live_scenario ended in the same state: acks, every
    lane of `state`, the records read back and health_report."""
    if a["acks"] != b["acks"]:
        raise AssertionError(f"{what}: acks differ")
    for k in a["state"]:
        assert_equal(a["state"][k], b["state"][k], f"{what}: {k}")
    if a["records"] != b["records"]:
        raise AssertionError(f"{what}: records read back differ")
    if a["health"] != b["health"]:
        raise AssertionError(f"{what}: health_report {a['health']} != {b['health']}")


def run_live_raft(device: str, groups: int = LIVE_GROUPS, rounds: int = LIVE_ROUNDS,
                  per_round: int = LIVE_PER_ROUND, steady: int = LIVE_STEADY_TICKS, seed: int = SEED + 12) -> dict:
    """Phase 12's runs: the port's live Raft layer on `device` with the
    default quorum backend, every device_tick of node 0 held against the
    host leg and the launches counted around the traffic; then the same
    scenario under RP_QUORUM_BACKEND=host, whose end state must be
    equal. Returns the device run with its launches and held calls."""
    import shutil
    import tempfile

    pkg = port_raft()
    held: list = []
    launches: dict = {}
    shapes: list = []

    def hold(gm):
        held.append(hold_device_ticks(gm.arrays))

    def count(phase):
        if phase == "start":
            launches["warm"] = {k: KERNELS[k][2][k] for k in ("tick_frame",) + LIVE_PATH}
            reset_launches()
            del shapes[:]  # the traffic's calls only
        else:
            launches["path"] = {k: KERNELS[k][2][k] for k in LIVE_PATH + ("tick_frame",)}
            launches["shapes"] = list(shapes)

    env = {k: os.environ.pop(k) for k in ("RP_QUORUM_BACKEND",) if k in os.environ}
    tmp = tempfile.mkdtemp(prefix="rp_live_")
    try:
        reset_launches()
        with tick_shapes(shapes):
            dev = asyncio.run(live_scenario(pkg, os.path.join(tmp, "device"), groups, rounds, per_round, seed,
                                            steady, hold=hold, on_traffic=count, device=device))
        with quorum_backend("host"):
            host = asyncio.run(live_scenario(pkg, os.path.join(tmp, "host"), groups, rounds, per_round, seed,
                                             steady, device=device))
    finally:
        os.environ.update(env)
        shutil.rmtree(tmp, ignore_errors=True)
    check_held(held[0])
    same_live(dev, host, "device leg vs host leg")
    dev["tick_shapes"] = launches.pop("shapes")
    dev["launches"], dev["held"], dev["host"] = launches, held[0]["calls"], host
    return dev


def phase_live_raft() -> dict:
    """Phase 12: the port's Raft layer live on the card (run_live_raft
    at LIVE_GROUPS), its numbers logged."""
    t0 = time.perf_counter()
    r = run_live_raft("cuda")
    h = r["host"]
    idle = [k for k in LIVE_PATH if r["launches"]["path"][k] <= 0]
    if idle:
        raise AssertionError(f"the live Raft layer never launched {idle}: {r['launches']['path']}")
    if len(r["tick_shapes"]) != r["launches"]["path"]["heartbeat_tick"]:
        raise AssertionError(f"{len(r['tick_shapes'])} heartbeat_tick calls in the traffic, "
                             f"{r['launches']['path']['heartbeat_tick']} launches")
    # each shape of the traffic's calls (the GroupManager's row capacity,
    # its replica slots and the reply bucket: a round's replies, or the
    # few of the heartbeat tick after it), the most frequent first
    import torch
    from collections import Counter

    shapes = sorted(Counter(r["tick_shapes"]).items(), key=lambda kv: (-kv[1], -kv[0][2]))
    r["tick"] = [{**live_tick(torch, shape, MEM_BYTES_PER_S), "calls": n} for shape, n in shapes]
    for t in r["tick"]:
        log(f"[raft] heartbeat_tick at {t['shape']} ({t['calls']} of the traffic's calls): equal to the plain "
            f"chain, one call {t['ms']:.4f} ms (the fold + sweep sequence it replaced {t['sequence_ms']:.4f} ms), "
            f"bound {t['bound_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms")
    log(f"[raft] {LIVE_GROUPS} groups at RF={LIVE_NODES} on three GroupManagers (cuda, default backend): "
        f"setup {r['setup_s']:.3f} s, catch-up {r['catchup_s']:.3f} s; {LIVE_ROUNDS} rounds of {LIVE_PER_ROUND} "
        f"acks=-1 batches ({RECORDS} x {RECORD_BYTES} B): round p50 {pct(r['round_s'], 50) * 1e3:.3f} ms "
        f"p99 {pct(r['round_s'], 99) * 1e3:.3f} ms, the round's tick p50 {pct(r['tick_s'], 50) * 1e3:.3f} ms "
        f"p99 {pct(r['tick_s'], 99) * 1e3:.3f} ms; steady tick ({LIVE_STEADY_TICKS}) p50 "
        f"{pct(r['steady_s'], 50) * 1e3:.3f} ms p99 {pct(r['steady_s'], 99) * 1e3:.3f} ms; "
        f"tick_frame.flushes {r['flushes']}")
    log(f"[raft] host leg (RP_QUORUM_BACKEND=host): setup {h['setup_s']:.3f} s, catch-up {h['catchup_s']:.3f} s, "
        f"round p50 {pct(h['round_s'], 50) * 1e3:.3f} ms p99 {pct(h['round_s'], 99) * 1e3:.3f} ms, steady tick "
        f"p50 {pct(h['steady_s'], 50) * 1e3:.3f} ms p99 {pct(h['steady_s'], 99) * 1e3:.3f} ms, "
        f"tick_frame.flushes {h['flushes']}")
    log(f"[raft] {len(r['held'])} device_tick calls of node 0 ({sum(r['held'])} replies) each equal to the host "
        f"leg, exact; end state equal to the host leg's ({len(r['acks'])} acks, commit / visible / term on 3 "
        f"nodes, node 0's match / flushed, records on both followers, health_report {health_totals(r['health'])}); "
        f"launches at warm-up {r['launches']['warm']}, around the traffic {r['launches']['path']}; "
        f"{time.perf_counter() - t0:.1f} s")
    return r


# ------------------------------------------------------------ Kafka broker
# OMB's workloads/1-topic-100-partitions-1kb.yaml: one topic of 100
# partitions and 1 KiB messages, here at RF=3 on three brokers with
# acks=all; Kafka's default batch.size (16,384 B) makes 16 records a batch
BROKER_TOPIC, BROKER_PARTITIONS, BROKER_BATCHES, BROKER_NODES = "omb-1kb", 100, 1024, 3
# the kernels the broker's produce, fetch, replication and health seams
# launch (the frame kernel runs in each GroupManager's prewarm)
BROKER_PATH = ("fused_lz4", "crc32c_device", "heartbeat_tick", "health_reduce")
# the two legs' environments: the card's seams, then the host's
BROKER_DEVICE_ENV = {"RP_CODEC_BACKEND": "device", "RP_FETCH_VERIFY": "1",
                     "RP_QUORUM_BACKEND": None, "RP_CRC_BACKEND": None}
BROKER_HOST_ENV = {"RP_CODEC_BACKEND": None, "RP_FETCH_VERIFY": "0",
                   "RP_QUORUM_BACKEND": "host", "RP_CRC_BACKEND": "host"}
KAFKA_STORAGE_ERROR, NOT_LEADER_FOR_PARTITION = 56, 6


def port_broker():
    """The port's Kafka entry points, as KafkaCluster takes them (and
    its placement package, for the lane moves of phase 16)."""
    from types import SimpleNamespace

    from redpanda_tpu_torch import placement
    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
    from redpanda_tpu_torch.models.fundamental import kafka_ntp
    from redpanda_tpu_torch.raft.consensus import NotLeaderError
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    return SimpleNamespace(Broker=Broker, BrokerConfig=BrokerConfig, KafkaClient=KafkaClient,
                           KafkaClientError=KafkaClientError, LoopbackNetwork=LoopbackNetwork,
                           kafka_ntp=kafka_ntp, NotLeaderError=NotLeaderError, placement=placement)


def broker_batches(seed: int, topics, count: int, compression=None, json_only: bool = False) -> list:
    """`count` produce requests of one batch each, as a client would
    send them: RECORDS x RECORD_BYTES records, batch i to topics[i % T]
    and partition (i // T) % partitions, JSON-like text where i // T is
    even (every batch with `json_only`) and random bytes where it is odd
    (phase 6's corpus). Built once with the port's RecordBatchBuilder at
    fixed timestamps, so two clusters get the same wire bytes; the
    producer compresses them as `compression` (a CompressionType) when
    given. Returns [(topic, partition, wire, [(key, value)])]."""
    from redpanda_tpu_torch.models.record import RecordBatchBuilder

    rng = np.random.default_rng(seed)

    def is_json(i):
        return json_only or (i // len(topics)) % 2 == 0

    n_json = sum(1 for i in range(count) if is_json(i))
    json_vals = iter(json_values(rng, n_json * RECORDS))
    codec = {} if compression is None else {"compression": compression}
    out = []
    for i in range(count):
        name, parts = topics[i % len(topics)]
        part = (i // len(topics)) % parts
        b = RecordBatchBuilder(timestamp_ms=1_700_000_000_000 + i, **codec)
        records = []
        for r in range(RECORDS):
            value = next(json_vals) if is_json(i) else rng.bytes(RECORD_BYTES)
            records.append((b"key-%d-%d" % (i, r), value))
            b.add(value, key=records[-1][0])
        out.append((name, part, b.build().to_kafka_wire(), records))
    return out


class KafkaCluster:
    """`nodes` Brokers of one package (`pkg`: its Broker, BrokerConfig,
    KafkaClient, KafkaClientError, LoopbackNetwork, kafka_ntp and
    NotLeaderError) in one process over loopback internal RPC, each with
    its real Kafka TCP listener, and one KafkaClient over them. `cfg`
    goes to every BrokerConfig (the port's takes device=)."""

    def __init__(self, pkg, data_dir: str, nodes: int = BROKER_NODES, **cfg):
        self.pkg, self.data_dir, self.nodes, self.cfg = pkg, data_dir, nodes, cfg
        self.brokers: list = []
        self.client = None

    async def start(self) -> None:
        net = self.pkg.LoopbackNetwork()
        members = list(range(self.nodes))
        for i in members:
            cfg = self.pkg.BrokerConfig(node_id=i, data_dir=os.path.join(self.data_dir, f"node{i}"),
                                        members=members, **self.cfg)
            self.brokers.append(self.pkg.Broker(cfg, loopback=net))
        for b in self.brokers:
            self.made(b)
            # the scenario places every leader itself (`create`); the
            # controller's leader balancer would move one mid-traffic,
            # and a produce it interrupts is retried on the new leader
            b.controller.leader_balancer_enabled = False
            await b.start()
        addrs = {b.node_id: b.kafka_advertised for b in self.brokers}
        for b in self.brokers:
            b.config.peer_kafka_addresses = addrs
        await self.brokers[0].wait_controller_leader(timeout=60.0)
        self.client = self.pkg.KafkaClient([b.kafka_advertised for b in self.brokers])

    def made(self, broker) -> None:
        """Called with each Broker just before it starts (a subclass
        hooks its seams here)."""

    def replicas(self, what) -> list:
        """Each node's replica of `what`, "controller" or (topic,
        partition); None where the node has none yet."""
        if what == "controller":
            return [b.controller for b in self.brokers]
        return [b.partition_manager.get(self.pkg.kafka_ntp(*what)) for b in self.brokers]

    async def create(self, topics, rf: int = BROKER_NODES) -> None:
        """Create each (name, partitions, configs) at `rf`, then move
        every leader to a fixed node: the controller to node 0, partition
        p of the k-th topic to node (p + k) % nodes (transfer_leadership,
        as the admin API's), so two runs lead alike."""
        for name, parts, configs in topics:
            await self.client.create_topic(name, partitions=parts, replication_factor=rf, configs=configs)
        await self.place(topics)

    async def place(self, topics) -> int:
        """Move the leaders as `create` does, once every replica exists.
        Returns how many partitions had another leader."""
        moved = await self.lead("controller", 0)
        for k, (name, parts, _) in enumerate(topics):
            for p in range(parts):
                moved += await self.lead((name, p), (p + k) % self.nodes)
        await self.client.metadata([name for name, _, _ in topics])
        return moved

    async def lead(self, what, target: int, timeout: float = 60.0) -> int:
        """Make node `target` the leader of `what` (see replicas);
        returns 1 if another node led it, else 0."""
        deadline, moved = time.monotonic() + timeout, 0
        while True:
            reps = self.replicas(what)
            if all(r is not None for r in reps):
                if reps[target].is_leader:
                    return moved
                moved = 1
                leader = next((r for r in reps if r.is_leader), None)
                if leader is not None:
                    # lost leadership or a target still catching up: retry
                    with contextlib.suppress(self.pkg.NotLeaderError, TimeoutError):
                        await leader.consensus.transfer_leadership(target)
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: node {target} never became leader")
            await asyncio.sleep(0.02)

    async def produce(self, batches, acks: int = -1) -> dict:
        """Send every batch with acks=`acks`: the batches of a partition
        one after another in order, all partitions at once (a request in
        flight for each). Returns the base offset of each batch, each
        request's seconds and the wall seconds."""
        by_part: dict = {}
        for i, (name, part, _, _) in enumerate(batches):
            by_part.setdefault((name, part), []).append(i)
        bases, lat = [None] * len(batches), [0.0] * len(batches)

        async def one_partition(idx):
            for i in idx:
                name, part, wire, _ = batches[i]
                t0 = time.perf_counter()
                bases[i] = await self.client.produce_wire(name, part, wire, acks=acks)
                lat[i] = time.perf_counter() - t0

        t0 = time.perf_counter()
        await asyncio.gather(*(one_partition(idx) for idx in by_part.values()))
        return {"bases": bases, "lat_s": lat, "wall_s": time.perf_counter() - t0}

    async def fetch_all(self, topics) -> dict:
        """Read every partition of `topics` back from offset 0 to its
        high watermark through the client, all partitions at once.
        Returns {(topic, partition): [(offset, key, value)]}, the high
        watermarks, the fetch responses that carried records, the record
        bytes, each fetch call's seconds and the wall seconds. A
        KAFKA_STORAGE_ERROR raises."""
        got, hwm, counts, lat = {}, {}, {"responses": 0, "bytes": 0}, []

        async def one_partition(name, part):
            hwm[(name, part)] = end = await self.high_watermark(name, part)
            rows, offset = [], 0
            while offset < end:
                t0 = time.perf_counter()
                try:
                    recs = await self.client.fetch(name, part, offset, max_wait_ms=100)
                    lat.append(time.perf_counter() - t0)
                except self.pkg.KafkaClientError as e:
                    if e.code == KAFKA_STORAGE_ERROR:
                        raise AssertionError(f"fetch {name}/{part}@{offset}: KAFKA_STORAGE_ERROR") from e
                    raise
                if recs:
                    counts["responses"] += 1
                    counts["bytes"] += sum(len(k or b"") + len(v or b"") for _, k, v in recs)
                    rows.extend(recs)
                    offset = recs[-1][0] + 1
            got[(name, part)] = rows

        t0 = time.perf_counter()
        await asyncio.gather(*(one_partition(name, p) for name, parts, _ in topics for p in range(parts)))
        return {"records": got, "hwm": hwm, "lat_s": lat, "wall_s": time.perf_counter() - t0, **counts}

    async def high_watermark(self, name: str, part: int, timeout: float = 30.0) -> int:
        """list_offset(latest), asked again of the new leader when the
        client's cached one answers NOT_LEADER_FOR_PARTITION."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return await self.client.list_offset(name, part, -1)
            except self.pkg.KafkaClientError as e:
                if e.code != NOT_LEADER_FOR_PARTITION or time.monotonic() > deadline:
                    raise
            await asyncio.sleep(0.05)
            await self.client.metadata([name])

    async def settle(self, timeout: float = 60.0) -> dict:
        """Wait until node 0's health report shows every follower caught
        up; returns that report (the HealthSampler's build, fresh)."""
        sampler = self.brokers[0].health_sampler
        deadline = time.monotonic() + timeout
        while True:
            rep = sampler.report(fresh=True)
            if rep["max_follower_lag"] == 0 and rep["under_replicated"] == 0 and rep["leaderless"] == 0:
                return rep
            if time.monotonic() > deadline:
                raise TimeoutError(f"followers never caught up: {health_totals(rep)}")
            await asyncio.sleep(0.05)

    def stored(self, topic: str, parts: int) -> dict:
        """Each partition's stored data batches on its leader: [(codec,
        records body bytes)]."""
        out = {}
        for p in range(parts):
            leader = next(r for r in self.replicas((topic, p)) if r.is_leader)
            out[(topic, p)] = [(int(b.header.compression), bytes(b.body))
                               for b in leader.log.read(0, max_bytes=1 << 62)
                               if b.header.type.name == "raft_data"]
        return out

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.close()
            self.client = None
        for b in self.brokers:
            await b.stop()
        self.brokers = []


def check_broker_run(run: dict, batches, topics) -> None:
    """Every batch acknowledged at the next offsets of its partition,
    high watermarks at the end of what was sent, and every record read
    back equal at its offset."""
    want: dict = {}
    for i, (name, part, _, records) in enumerate(batches):
        rows = want.setdefault((name, part), [])
        base = len(rows)
        if run["bases"][i] != base:
            raise AssertionError(f"batch {i} ({name}/{part}) acked at {run['bases'][i]}, expected {base}")
        rows.extend((base + r, k, v) for r, (k, v) in enumerate(records))
    for name, parts, _ in topics:
        for p in range(parts):
            rows = want.get((name, p), [])
            if run["hwm"][(name, p)] != len(rows):
                raise AssertionError(f"{name}/{p}: high watermark {run['hwm'][(name, p)]}, sent {len(rows)}")
            if run["records"][(name, p)] != rows:
                raise AssertionError(f"{name}/{p}: records fetched back differ from those sent")


async def loop_stalls(out: list, period: float = 0.01) -> None:
    """Append how late each `period` sleep of the event loop woke: the
    brokers share the loop, so a stall over the election timeout lets
    a follower's timer fire before its leader's heartbeat lands."""
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(period)
        out.append(loop.time() - t0 - period)


async def broker_scenario(pkg, data_dir: str, topics, batches, on_phase=None, stored=(), then=(), **cfg) -> dict:
    """One cluster end to end: start, create `topics`, produce `batches`
    (acks=-1) and, once they are acknowledged, `then` (its run under
    "then"), lead as created, fetch everything back, lead as created,
    settle, node 0's health report
    (health_sampler, fresh) and group_manager.health_report(). Checked
    by check_broker_run. `on_phase(name)` is called with "produce" just
    before the traffic, "then" before `then`, "fetch" between produce
    and fetch and "end" after the health report; `stored` names (topic,
    partitions) whose stored batches are returned."""
    cluster = KafkaCluster(pkg, data_dir, **cfg)
    t0 = time.perf_counter()
    try:
        await cluster.start()
        await cluster.create(topics)
        setup_s = time.perf_counter() - t0
        if on_phase:
            on_phase("produce")
        stalls: list = []
        watch = asyncio.ensure_future(loop_stalls(stalls))
        run = await cluster.produce(batches)
        if then:
            if on_phase:
                on_phase("then")
            run["then"] = await cluster.produce(then)
        run["produce_stall_s"] = max(stalls, default=0.0)
        # leaders that moved during the produce (an election after an
        # event-loop stall) lead as created again
        run["moved"] = await cluster.place(topics)
        if on_phase:
            on_phase("fetch")
        stalls.clear()
        run.update({f"fetch_{k}": v for k, v in (await cluster.fetch_all(topics)).items()})
        run["fetch_stall_s"] = max(stalls, default=0.0)
        watch.cancel()
        run["records"], run["hwm"] = run.pop("fetch_records"), run.pop("fetch_hwm")
        # a stalled event loop (a first compile, a long fsync) can move a
        # leader during the traffic: lead as created again, then report
        await cluster.place(topics)
        run["sampler"] = await cluster.settle()
        run["health"] = cluster.brokers[0].group_manager.health_report()
        if on_phase:
            on_phase("end")
        run["stored"] = {}
        for name, parts in stored:
            run["stored"].update(cluster.stored(name, parts))
        run["setup_s"] = setup_s
    finally:
        await cluster.stop()
    check_broker_run({**run, "bases": run["bases"] + run.get("then", {}).get("bases", [])}, list(batches) + list(then),
                     topics)
    return run


def run_broker(device: str, partitions: int = BROKER_PARTITIONS, count: int = BROKER_BATCHES,
               seed: int = SEED + 13) -> dict:
    """Phase 13's two legs on the port: the card's seams
    (BROKER_DEVICE_ENV, brokers on `device`) with the launches counted
    around the produce and the fetch, then the host's
    (BROKER_HOST_ENV) on the same batches. Returns both runs."""
    import shutil
    import tempfile

    pkg = port_broker()
    topics = [(BROKER_TOPIC, partitions, {"compression.type": "lz4"})]
    batches = broker_batches(seed, [(BROKER_TOPIC, partitions)], count)
    marks: dict = {}

    def mark(phase):
        marks[phase] = {k: KERNELS[k][2][k] for k in BROKER_PATH + ("tick_frame",)}
        if phase == "produce":
            reset_launches()
            marks[phase] = {k: 0 for k in marks[phase]}

    tmp = tempfile.mkdtemp(prefix="rp_broker_")
    try:
        with environ(BROKER_DEVICE_ENV):
            dev = asyncio.run(broker_scenario(pkg, os.path.join(tmp, "device"), topics, batches,
                                              on_phase=mark, device=device))
        with environ(BROKER_HOST_ENV):
            host = asyncio.run(broker_scenario(pkg, os.path.join(tmp, "host"), topics, batches, device=device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev["launches"] = {k: marks["end"][k] for k in marks["end"]}
    dev["produce_launches"] = {k: marks["fetch"][k] - marks["produce"][k] for k in marks["end"]}
    dev["fetch_launches"] = {k: marks["end"][k] - marks["fetch"][k] for k in marks["end"]}
    dev["host"], dev["batches"] = host, len(batches)
    return dev


def phase_broker() -> dict:
    """Phase 13: the Kafka broker on the card (run_broker at OMB's
    1-topic-100-partitions-1kb size), its checks and numbers."""
    t0 = time.perf_counter()
    r = run_broker("cuda")
    h = r["host"]
    if r["produce_launches"]["fused_lz4"] != r["batches"]:
        raise AssertionError(f"fused_lz4 launched {r['produce_launches']['fused_lz4']} times for "
                             f"{r['batches']} produced batches")
    # the health report's fresh builds launch no CRC; every fetch response
    # that carried records was verified in one crc32c launch
    if r["fetch_launches"]["crc32c_device"] != r["fetch_responses"]:
        raise AssertionError(f"crc32c_device launched {r['fetch_launches']['crc32c_device']} times for "
                             f"{r['fetch_responses']} fetch responses with records")
    idle = [k for k in BROKER_PATH if r["launches"][k] <= 0]
    if idle:
        raise AssertionError(f"the broker path never launched {idle}: {r['launches']}")
    if r["records"] != h["records"] or r["hwm"] != h["hwm"] or r["bases"] != h["bases"]:
        raise AssertionError("device leg and host leg differ in offsets, watermarks or records")

    def line(x, tag):
        lat = np.asarray(x["lat_s"]) * 1e3
        flat = np.asarray(x["fetch_lat_s"]) * 1e3
        return (f"{tag}: setup {x['setup_s']:.3f} s; produce {len(lat)} batches in {x['wall_s']:.3f} s "
                f"(per batch p50 {pct(lat, 50):.3f} ms p99 {pct(lat, 99):.3f} ms); fetch "
                f"{x['fetch_bytes']} B of records in {x['fetch_responses']} responses, {x['fetch_wall_s']:.3f} s "
                f"= {x['fetch_bytes'] / x['fetch_wall_s'] / 1e6:.1f} MB/s (per fetch call, {len(flat)}: "
                f"p50 {pct(flat, 50):.3f} ms p99 {pct(flat, 99):.3f} ms)")

    log(f"[broker] {BROKER_NODES} brokers (cuda), topic {BROKER_TOPIC} {BROKER_PARTITIONS} partitions RF=3 "
        f"compression.type=lz4, {r['batches']} acks=all batches of {RECORDS} x {RECORD_BYTES} B; "
        + line(r, "device leg (RP_CODEC_BACKEND=device RP_FETCH_VERIFY=1)"))
    log("[broker] " + line(h, "host leg (RP_QUORUM_BACKEND=host RP_CRC_BACKEND=host RP_FETCH_VERIFY=0)"))
    log(f"[broker] every record fetched back equal on both legs at the same offsets and high watermarks; "
        f"launches during produce {r['produce_launches']}, during fetch + health {r['fetch_launches']}; "
        f"health {health_totals(r['health'])}; leaders moved during the produce {r['moved']} / "
        f"{h['moved']} (device / host leg), the event loop's longest stall in the produce "
        f"{r['produce_stall_s'] * 1e3:.1f} / {h['produce_stall_s'] * 1e3:.1f} ms, in the fetch "
        f"{r['fetch_stall_s'] * 1e3:.1f} / {h['fetch_stall_s'] * 1e3:.1f} ms; {time.perf_counter() - t0:.1f} s")
    return r


# -------------------------------------------------- the port as users start it
# Phase 14, part A: a node is `python -m redpanda_tpu_torch --shards 2`,
# shard 0 plus one worker process, at phase 13's OMB shape; part B: three
# Brokers whose closed segments go to a shared bucket zstd-compressed
PROC_NODES, PROC_SHARDS, PROC_RESTART_BATCHES = 3, 2, 256
# RP_DEVPLANE_SAMPLE=1: every probe call is sampled, so a probe's sample
# count is its call count in that process. RP_ALERTS=0: the default SLO
# profile's produce alerts (40 ms p99) fire on a Python broker's latency,
# and each firing makes the placement rebalancer move partitions between
# shards mid-traffic, where a produce it interrupts is retried and can be
# written twice
PROC_ENV = {"RP_DEVPLANE": "1", "RP_DEVPLANE_SAMPLE": "1", "RP_CODEC_BACKEND": "device",
            "RP_FETCH_VERIFY": "1", "RP_ALERTS": "0"}
# a process's devplane families, by kernel label: the probes' samples and
# the kernel wrappers' own launch counters (LAUNCHES)
SAMPLES, LAUNCH_COUNTS = "devplane_kernel_seconds_count", "devplane_kernel_launches"
# what the restarted worker must run while it leads: the heartbeat tick
# (probe) and its kernels (launch counter: one a call on the card, none
# on the CPU, where the plain chain runs)
WORKER_PROBES, WORKER_KERNELS = ("quorum.heartbeat_tick",), ("heartbeat_tick",)
# each seam the run's environment arms, as (probe, kernel): its samples
# in node 0's merged /v1/devplane, and on the card its kernel's launches
# in the traffic (shard 0 runs both seams: a worker's produce path stores
# the client's codec, and fetches are verified where shard 0 answers them)
SEAM_PROBES = {("RP_CODEC_BACKEND", "device"): ("fused.crc_lz4", "fused_lz4"),
               ("RP_FETCH_VERIFY", "1"): ("crc32c.device", "crc32c_device")}
# Redpanda's log_segment_size is 128 MiB; cut to 16 MiB (three segments
# of one partition in the run's time)
TIERED_TOPIC, TIERED_SEGMENT, TIERED_BYTES, TIERED_PER_REQUEST = "tiered-1kb", 16 << 20, 48 << 20, 16
TIERED_ENV = {"RP_ARCHIVE_COMPRESSION": "zstd", "RP_ZSTD_BACKEND": "tpu"}
# the host leg: the same brokers with no zstd anywhere (archived
# uncompressed; the card's machine has no host zstd encoder)
HOST_LEG_ENV = {"RP_ARCHIVE_COMPRESSION": "none", "RP_ZSTD_BACKEND": "host"}
REPO = os.path.dirname(os.path.abspath(__file__))


def free_ports(n: int, low: int = 20000, high: int = 32768) -> list:
    """`n` distinct ports in [low, high) that bind on 127.0.0.1 now.
    The range lies under Linux's default ephemeral range (32768-60999),
    so no outgoing connection can take one before a node binds it."""
    import random
    import socket

    ports: list = []
    for port in random.Random().sample(range(low, high), high - low):
        with socket.socket() as sk:
            try:
                sk.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
        if len(ports) == n:
            return ports
    raise RuntimeError(f"fewer than {n} free ports in [{low}, {high})")


def http_json(port: int, path: str, method: str = "GET", timeout: float = 10.0):
    """One admin API call on 127.0.0.1:`port`; the body as JSON, or as
    text where it is not JSON."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read().decode()
    try:
        return json.loads(body)
    except ValueError:
        return body


def by_kernel(metrics_text: str, family: str) -> dict:
    """{kernel label: value} of `family` in a Prometheus rendering of a
    registry that adopted the devplane's families."""
    out = {}
    for line in metrics_text.splitlines():
        if line.startswith("#") or f"{family}{{" not in line:
            continue
        head, _, value = line.rpartition(" ")
        key = 'kernel="'
        if key in head:
            name = head.split(key, 1)[1].split('"', 1)[0]
            out[name] = out.get(name, 0) + int(float(value))
    return out


def counts_since(now: dict, then: dict) -> dict:
    """{family: {kernel: now - then}} for two ProcessCluster.counts."""
    return {f: {k: v - then[f].get(k, 0) for k, v in now[f].items() if v != then[f].get(k, 0)}
            for f in now}


def add_counts(into: dict, more: dict) -> dict:
    for f, table in more.items():
        dst = into.setdefault(f, {})
        for k, v in table.items():
            dst[k] = dst.get(k, 0) + v
    return into


class ProcessCluster(KafkaCluster):
    """`nodes` OS processes, each started as a user starts a node:
    `python -m redpanda_tpu_torch --device D --shards S` (or `command`
    in its place, before --shards) with the seeds, its own ports and
    data dir, and `env` on top of this process's environment (None
    removes a variable); one KafkaClient over them. `cli` runs the
    port's CLI against node 0. A start where a node exits on a port
    taken since free_ports probed it is made again on fresh ports."""

    def __init__(self, data_dir: str, device: str, nodes: int = PROC_NODES, shards: int = PROC_SHARDS,
                 env=None, command=None):
        super().__init__(port_broker(), data_dir, nodes)
        self.device, self.shards, self.env = device, shards, dict(env or {})
        self.command = command or [sys.executable, "-m", "redpanda_tpu_torch", "--device", device]
        self.procs, self.logs = [], []

    async def start(self, timeout: float = 120.0, attempts: int = 3) -> None:
        for attempt in range(attempts):
            self.spawn(f".{attempt}" if attempt else "")
            try:
                await self.until(lambda: all(self.shards_view(i).get("sharded") for i in range(self.nodes)),
                                 timeout, "every node's shard runtime up")
                break
            except AssertionError as e:  # a node exited
                if attempt + 1 == attempts or "Address already in use" not in str(e):
                    raise
                await self.stop()
        self.client = self.pkg.KafkaClient([("127.0.0.1", p) for p in self.kafka])

    def spawn(self, suffix: str) -> None:
        """Start the nodes on fresh ports, each in data dir n<i><suffix>
        with its output in node<i><suffix>.log."""
        n = self.nodes
        ports = free_ports(3 * n)
        self.rpc, self.kafka, self.admin = ports[:n], ports[n:2 * n], ports[2 * n:]
        seeds = ",".join(f"127.0.0.1:{p}" for p in self.rpc)
        env = dict(os.environ)
        for k, v in self.env.items():
            if v is None:
                env.pop(k, None)
            else:
                env[k] = v
        for i in range(n):
            log = open(os.path.join(self.data_dir, f"node{i}{suffix}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [*self.command, "--shards", str(self.shards), "--node-id", str(i),
                 "--data-dir", os.path.join(self.data_dir, f"n{i}{suffix}"), "--seeds", seeds,
                 "--kafka-host", "127.0.0.1", "--kafka-port", str(self.kafka[i]),
                 "--rpc-port", str(self.rpc[i]), "--admin-port", str(self.admin[i])],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True))

    def tail(self, i: int, size: int = 3000) -> str:
        self.logs[i].flush()
        self.logs[i].seek(0)
        return self.logs[i].read()[-size:]

    def check_alive(self) -> None:
        for i, p in enumerate(self.procs):
            if p.poll() is not None:
                raise AssertionError(f"node {i} exited with {p.returncode}:\n{self.tail(i)}")

    async def until(self, cond, timeout: float, what: str):
        deadline = time.monotonic() + timeout
        while True:
            self.check_alive()
            try:
                got = cond()
                if got:
                    return got
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: not within {timeout} s")
            await asyncio.sleep(0.5)

    def shards_view(self, i: int) -> dict:
        return http_json(self.admin[i], "/v1/shards")

    def counts(self, i: int, sid: int) -> dict:
        """Node i's shard `sid`: its own registry's probe samples and
        kernel launches, {SAMPLES: {...}, LAUNCH_COUNTS: {...}}."""
        text = http_json(self.admin[i], f"/v1/shards/{sid}/metrics")
        return {f: by_kernel(text, f) for f in (SAMPLES, LAUNCH_COUNTS)}

    def led_by(self, i: int, sid: int) -> int:
        """How many raft groups shard `sid` of node i leads, from its own
        registry."""
        for line in http_json(self.admin[i], f"/v1/shards/{sid}/metrics").splitlines():
            if line.split(" ")[0].endswith("_shard_leaders"):
                return int(float(line.split(" ")[1]))
        return 0

    async def place(self, topics, timeout: float = 60.0) -> int:
        """Move the leaders as KafkaCluster.place does, partition p of the
        k-th topic to node (p + k) % nodes, through the raft
        TransferLeadership RPC (the controller's leader balancer sends the
        same) to every other node, whichever leads the partition hands it
        over; again until the metadata shows every one placed. Returns how
        many partitions had another leader at first. The even spread
        leaves the leader balancer, which moves one when two nodes' counts
        differ by 2, nothing to move mid-traffic."""
        from redpanda_tpu_torch.raft import types as rt
        from redpanda_tpu_torch.rpc.transport import TcpTransport
        from redpanda_tpu_torch.rpc.types import RpcError

        plan = {(name, p): (p + k) % self.nodes for k, (name, parts, _) in enumerate(topics) for p in range(parts)}
        groups = {key: http_json(self.admin[0], f"/v1/partitions/kafka/{key[0]}/{key[1]}")["group"]
                  for key in plan}
        conns: dict = {}

        async def transfer(conn, group, target):
            req = rt.TransferLeadershipRequest(group=group, target=target).encode()
            # "not leader here" and a target still catching up are
            # answered without success: asked again next round
            with contextlib.suppress(RpcError, ConnectionError, OSError):
                await conn.call(rt.TRANSFER_LEADERSHIP, req, 10.0)

        deadline, moved = time.monotonic() + timeout, None
        try:
            while True:
                led = {}
                for name, _, _ in topics:
                    md = await self.client.metadata([name])
                    led.update({(name, p.partition_index): p.leader_id for p in md.topics[0].partitions})
                todo = [key for key, node in plan.items() if led.get(key) != node]
                if moved is None:
                    moved = len(todo)
                if not todo:
                    return moved
                if time.monotonic() > deadline:
                    raise TimeoutError(f"leaders never placed: {todo}")
                for i in range(self.nodes):
                    if not (i in conns and conns[i].is_connected()):
                        conns[i] = TcpTransport("127.0.0.1", self.rpc[i])
                        await conns[i].connect()
                await asyncio.gather(*(transfer(conns[i], groups[key], plan[key]) for key in todo
                                       for i in range(self.nodes) if i != plan[key]))
                await asyncio.sleep(0.5)
        finally:
            for c in conns.values():
                await c.close()

    def cli(self, *args, timeout: float = 60.0) -> subprocess.CompletedProcess:
        return subprocess.run(
            [sys.executable, "-m", "redpanda_tpu_torch.cli", "--brokers", f"127.0.0.1:{self.kafka[0]}",
             "--admin", f"http://127.0.0.1:{self.admin[0]}", *args],
            cwd=REPO, capture_output=True, text=True, timeout=timeout)

    async def create(self, topics, rf: int = PROC_NODES, timeout: float = 60.0) -> None:
        """Create each (name, partitions, configs) through the port's
        CLI (retried while the controller elects), wait until every
        partition has a leader, and place the leaders (`place`)."""
        for name, parts, configs in topics:
            args = ["topic", "create", name, "-p", str(parts), "-r", str(rf)]
            for k, v in configs.items():
                args += ["-c", f"{k}={v}"]
            deadline = time.monotonic() + timeout
            while True:
                r = self.cli(*args)
                if r.returncode == 0:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"topic create {name}: {r.stdout}{r.stderr}")
                await asyncio.sleep(0.5)

        async def led():
            md = await self.client.metadata([name for name, _, _ in topics])
            return all(len(t.partitions) == parts and all(p.leader_id >= 0 for p in t.partitions)
                       for t, (_, parts, _) in zip(md.topics, topics))

        deadline = time.monotonic() + timeout
        while not await led():
            self.check_alive()
            if time.monotonic() > deadline:
                raise TimeoutError("partitions without a leader")
            await asyncio.sleep(0.2)
        await self.place(topics)

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.close()
            self.client = None
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            # the node's session holds its worker shards and fork server
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=30)
        for log in self.logs:
            log.close()
        self.procs, self.logs = [], []


async def visible(cluster, ends: dict, timeout: float = 60.0) -> int:
    """Wait until every (topic, partition)'s high watermark reaches
    `ends` (what its acks covered): a leader elected during the traffic
    reports its high watermark only once it has committed in its term.
    Returns how many partitions read short at first."""
    short = 0
    for (name, part), end in ends.items():
        deadline, first = time.monotonic() + timeout, True
        while await cluster.high_watermark(name, part) < end:
            short += first
            first = False
            if time.monotonic() > deadline:
                raise AssertionError(f"{name}/{part}: acked up to {end}, high watermark never reached it")
            await asyncio.sleep(0.1)
    return short


def acked_ends(batches, bases) -> dict:
    ends: dict = {}
    for (name, part, _, records), base in zip(batches, bases):
        ends[(name, part)] = max(ends.get((name, part), 0), base + len(records))
    return ends


async def fetched(cluster, run: dict, topics) -> dict:
    """`run` (a produce's) with every partition of `topics` fetched
    back: records and hwm as check_broker_run reads them, the rest of
    fetch_all's keys prefixed "fetch_"."""
    got = await cluster.fetch_all(topics)
    run.update({f"fetch_{k}": v for k, v in got.items()})
    run["records"], run["hwm"] = run.pop("fetch_records"), run.pop("fetch_hwm")
    return run


def remap_partitions(batches, parts: list) -> list:
    """broker_batches made for len(parts) partitions, sent to `parts`."""
    return [(name, parts[p], wire, records) for name, p, wire, records in batches]


async def process_scenario(data_dir: str, device: str, partitions: int, count: int, restart_count: int,
                           seed: int, env=None) -> dict:
    """Part A: start the nodes, create the topic with the CLI and place
    its leaders, produce `count` acks=all batches and fetch every
    partition back; SIGKILL node 0's worker shard (its pid from GET
    /v1/shards), wait for its restart, place the leaders again (the kill
    moved those of the worker's partitions to other nodes), produce
    `restart_count` more batches to the worker's partitions that node 0
    leads and fetch everything back again.

    Every process's probe samples and kernel launches (ProcessCluster
    .counts) are read just before the first produce, of the worker just
    before the kill and again once it leads, and of every process after
    the last fetch: `path` is what the traffic ran (the killed worker's
    up to the kill, the restarted one's since it leads), `worker` what
    the restarted worker ran for the last `restart_count` batches.
    Returns these, the runs, the nodes' shard views and node 0's merged
    /v1/devplane. On a failure the tails of the nodes' logs are
    printed."""
    topics = [(BROKER_TOPIC, partitions, {"compression.type": "lz4"})]
    batches = broker_batches(seed, [(BROKER_TOPIC, partitions)], count)
    cluster = ProcessCluster(data_dir, device, env={**PROC_ENV, **(env or {})})
    t0 = time.perf_counter()
    try:
        await cluster.start()
        await cluster.create(topics)
        out = {"setup_s": time.perf_counter() - t0}
        procs = [(i, sid) for i in range(cluster.nodes) for sid in range(cluster.shards)]
        zero = {p: cluster.counts(*p) for p in procs}
        run = await cluster.produce(batches)
        run["short"] = await visible(cluster, acked_ends(batches, run["bases"]))
        run = await fetched(cluster, run, topics)
        check_broker_run(run, batches, topics)
        out["run"] = run
        victim = int(cluster.shards_view(0)["liveness"]["alive"]["1"])
        killed = cluster.counts(0, 1)
        os.kill(victim, signal.SIGKILL)
        t1 = time.perf_counter()

        def restarted():
            live = cluster.shards_view(0)["liveness"]
            return (live["shard_restarts"].get("1") == 1 and live["alive"].get("1") not in (None, victim)
                    and http_json(cluster.admin[0], "/v1/shards/1")["available"])

        await cluster.until(restarted, 60.0, "node 0's worker restarted")
        out["restart_s"] = time.perf_counter() - t1
        owned = sorted(int(e["ntp"].rsplit("/", 1)[1]) for e in http_json(cluster.admin[0], "/v1/placement")["entries"]
                       if e["shard"] == 1 and e["ntp"].startswith(f"kafka/{BROKER_TOPIC}/"))
        # the kill moved the leaders of the worker's partitions to other
        # nodes; placed again, node 0's worker leads those node 0 led
        back = [p for p in owned if p % cluster.nodes == 0]
        if not back:
            raise AssertionError("node 0's worker owns no partition that node 0 leads")
        t1 = time.perf_counter()
        while True:
            # the metadata can still show node 0 before the other nodes
            # elect: placed until the worker's own count agrees
            await cluster.place(topics)
            if cluster.led_by(0, 1) >= len(back):
                break
            if time.perf_counter() - t1 > 60.0:
                raise TimeoutError(f"node 0's worker never led {back}")
            await asyncio.sleep(0.5)
        out["lead_s"] = time.perf_counter() - t1
        reborn = cluster.counts(0, 1)
        more = remap_partitions(broker_batches(seed + 1, [(BROKER_TOPIC, len(back))], restart_count), back)
        again = await cluster.produce(more)
        again["short"] = await visible(cluster, acked_ends(batches + more, run["bases"] + again["bases"]))
        again = await fetched(cluster, again, topics)
        check_broker_run({**again, "bases": run["bases"] + again["bases"]}, batches + more, topics)
        end = {p: cluster.counts(*p) for p in procs}
        out.update(again=again, owned=owned, back=back, victim=victim)
        out["worker"] = counts_since(end[(0, 1)], reborn)
        path: dict = {}
        for p in procs:
            if p != (0, 1):
                add_counts(path, counts_since(end[p], zero[p]))
        add_counts(path, counts_since(killed, zero[(0, 1)]))
        out["path"] = add_counts(path, out["worker"])
        out["views"] = [cluster.shards_view(i) for i in range(cluster.nodes)]
        out["devplane"] = http_json(cluster.admin[0], "/v1/devplane")
        out["compute_apps"] = nvidia_smi_apps()
    except BaseException:
        for i in range(len(cluster.logs)):
            print(f"--- node {i} log tail\n{cluster.tail(i)}", file=sys.stderr)
        raise
    finally:
        await cluster.stop()
    return out


def check_processes(r: dict, env: dict, device: str) -> None:
    """Part A's checks: one restart on node 0 (the kill) and none
    anywhere else; the restarted worker ran the heartbeat tick for the
    last batches (its samples, and on the card its kernels' launches);
    each seam `env` arms has samples in node 0's /v1/devplane and, on the
    card, launches in the traffic (records were checked by
    process_scenario)."""
    for i, view in enumerate(r["views"]):
        live = view["liveness"]
        want = {"1": 1} if i == 0 else {}
        if not view["sharded"] or live["shard_restarts"] != want or live["restarts"] != len(want):
            raise AssertionError(f"node {i}: restarts {live['shard_restarts']} (want {want}): {live}")
        if live["gray_failures"] or live["failed"] or "1" not in live["alive"]:
            raise AssertionError(f"node {i}: shard runtime not whole: {live}")
    wanted = [(SAMPLES, name) for name in WORKER_PROBES]
    if device == "cuda":
        wanted += [(LAUNCH_COUNTS, name) for name in WORKER_KERNELS]
    for family, name in wanted:
        if r["worker"][family].get(name, 0) <= 0:
            raise AssertionError(f"the restarted worker ran no {name} for the last batches: {r['worker']}")
    # every call of the sampled probe is one launch of the tick's entry
    calls = r["worker"][SAMPLES].get("quorum.heartbeat_tick", 0)
    if device == "cuda" and r["worker"][LAUNCH_COUNTS].get("heartbeat_tick", 0) != calls:
        raise AssertionError(f"the restarted worker's heartbeat_tick launches differ from its "
                             f"{calls} quorum.heartbeat_tick calls: {r['worker']}")
    kernels = r["devplane"].get("kernels", {})
    for (var, value), (probe, kernel) in SEAM_PROBES.items():
        if env.get(var) != value:
            continue
        if kernels.get(probe, {}).get("count", 0) <= 0:
            raise AssertionError(f"node 0's /v1/devplane has no {probe} samples: {sorted(kernels)}")
        if device == "cuda" and r["path"][LAUNCH_COUNTS].get(kernel, 0) <= 0:
            raise AssertionError(f"the traffic launched no {kernel}: {r['path']}")


def nvidia_smi_apps() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


async def tiered_scenario(pkg, data_dir: str, batches, segment_bytes: int, per_request: int, **cfg) -> dict:
    """Part B: three Brokers sharing one bucket directory, one topic of
    one partition at RF=3 with remote write / read, `segment_bytes`
    segments and as much local retention; `batches` produced acks=all,
    `per_request` batches a request; then every broker's
    archival.run_once() and housekeeping(), and the partition fetched
    back from offset 0 (below the local start: hydrated from the
    bucket). Returns the records, the bases of the requests, each stored
    segment object beside the local segment it came from, and the
    hydrations."""
    cluster = KafkaCluster(pkg, data_dir, **cfg)
    configs = {"compression.type": "none", "redpanda.remote.write": "true",
               "redpanda.remote.read": "true", "segment.bytes": str(segment_bytes),
               "retention.local.target.bytes": str(segment_bytes)}
    topics = [(TIERED_TOPIC, 1, configs)]
    t0 = time.perf_counter()
    out: dict = {}
    try:
        await cluster.start()
        await cluster.create(topics, rf=cluster.nodes)
        out["setup_s"] = time.perf_counter() - t0
        bases, lat = [], []
        t1 = time.perf_counter()
        for i in range(0, len(batches), per_request):
            wire = b"".join(w for _, _, w, _ in batches[i:i + per_request])
            t2 = time.perf_counter()
            bases.append(await cluster.client.produce_wire(TIERED_TOPIC, 0, wire, acks=-1))
            lat.append(time.perf_counter() - t2)
        out.update(bases=bases, lat_s=lat, produce_s=time.perf_counter() - t1)
        await cluster.place(topics)
        leader = next(r for r in cluster.replicas((TIERED_TOPIC, 0)) if r.is_leader)
        leader.log.flush()
        local = {}
        for seg in leader.log._segments[:-1]:
            with open(seg._path, "rb") as f:
                local[int(seg.base_offset)] = f.read()
        t1 = time.perf_counter()
        out["uploaded"] = sum([await b.archival.run_once() for b in cluster.brokers])
        out["archive_s"] = time.perf_counter() - t1
        for b in cluster.brokers:
            b.storage.log_mgr.housekeeping()
        out["local_start"] = int(leader.log.offsets().start_offset)
        man = leader.archiver.manifest
        out["objects"] = [(int(m.base_offset), await leader.archiver.store.get(man.segment_key(m)),
                           int(m.size_bytes), int(m.size_compressed)) for m in man.segments]
        out["local"] = local
        end = await cluster.high_watermark(TIERED_TOPIC, 0)
        rows, offset, t1 = [], 0, time.perf_counter()
        while offset < end:
            recs = await cluster.client.fetch(TIERED_TOPIC, 0, offset, max_bytes=8 << 20, max_wait_ms=100)
            if recs:
                rows.extend(recs)
                offset = recs[-1][0] + 1
        out.update(records=rows, hwm=end, fetch_s=time.perf_counter() - t1,
                   hydrations=sum(b.remote_reader.hydrations for b in cluster.brokers))
    finally:
        await cluster.stop()
    return out


def host_zstd_decompress(blob: bytes) -> bytes:
    """One zstd frame decoded by libzstd through ctypes (the card's
    machine has libzstd and no zstandard module)."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("zstd")
    if not name:
        raise RuntimeError("no host zstd decoder: libzstd not found")
    lib = ctypes.CDLL(name)
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    size = lib.ZSTD_getFrameContentSize(blob, len(blob))
    if size >= (1 << 63):
        raise ValueError("zstd frame without a content size")
    out = ctypes.create_string_buffer(max(1, size))
    n = lib.ZSTD_decompress(out, size, blob, len(blob))
    if lib.ZSTD_isError(n) or n != size:
        raise ValueError(f"libzstd could not decode a {len(blob)}-byte frame")
    return out.raw[:size]


def check_tiered(run: dict, batches, per_request: int) -> None:
    """Every request acknowledged at its offset, every record fetched
    back equal at its offset from 0, the log trimmed below what was
    archived, and each stored object decoding to the bytes of its local
    segment (libzstd where it is compressed)."""
    want, n = [], 0
    for i in range(0, len(batches), per_request):
        if run["bases"][i // per_request] != n:
            raise AssertionError(f"request {i // per_request} acked at {run['bases'][i // per_request]}, "
                                 f"expected {n}")
        for _, _, _, records in batches[i:i + per_request]:
            want.extend((n + r, k, v) for r, (k, v) in enumerate(records))
            n += len(records)
    if run["hwm"] != n or run["records"] != want:
        raise AssertionError(f"tiered partition: high watermark {run['hwm']} of {n}, or records differ")
    if not run["objects"] or run["uploaded"] != len(run["objects"]) or run["local_start"] <= 0:
        raise AssertionError(f"{run['uploaded']} segments uploaded, {len(run['objects'])} in the manifest, "
                             f"local start {run['local_start']}")
    for base, blob, size, size_compressed in run["objects"]:
        body = host_zstd_decompress(blob) if size_compressed else blob
        if size_compressed not in (0, len(blob)) or len(body) != size or body != run["local"].get(base):
            raise AssertionError(f"segment object at {base} does not decode to its local segment")
    if run["hydrations"] <= 0:
        raise AssertionError("the fetch from offset 0 hydrated nothing")


def tiered_batches(seed: int, total: int) -> list:
    return broker_batches(seed, [(TIERED_TOPIC, 1)], max(1, total // (RECORDS * RECORD_BYTES)))


def run_tiered(device: str, total: int = TIERED_BYTES, segment_bytes: int = TIERED_SEGMENT,
               per_request: int = TIERED_PER_REQUEST, seed: int = SEED + 14) -> dict:
    """Part B on the port: the card's zstd leg (TIERED_ENV) with the zstd
    launches counted around its run, then the host leg (HOST_LEG_ENV) on
    the same batches; both checked."""
    import shutil
    import tempfile

    pkg = port_broker()
    batches = tiered_batches(seed, total)
    tmp = tempfile.mkdtemp(prefix="rp_tiered_")
    cfg = dict(device=device, archival_interval_s=0, housekeeping_interval_s=0)
    try:
        with environ(TIERED_ENV):
            reset_launches()
            dev = asyncio.run(tiered_scenario(pkg, os.path.join(tmp, "device"), batches, segment_bytes,
                                              per_request, cloud_storage_dir=os.path.join(tmp, "bucket-d"),
                                              **cfg))
            dev["launches"] = {k: KERNELS[k][2][k] for k in ("zstd_encode", "zstd_decode")}
        with environ(HOST_LEG_ENV):
            host = asyncio.run(tiered_scenario(pkg, os.path.join(tmp, "host"), batches, segment_bytes,
                                               per_request, cloud_storage_dir=os.path.join(tmp, "bucket-h"),
                                               **cfg))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_tiered(dev, batches, per_request)
    check_tiered(host, batches, per_request)
    if dev["records"] != host["records"] or dev["bases"] != host["bases"]:
        raise AssertionError("the card's zstd leg and the host leg differ in records or offsets")
    idle = [k for k, v in dev["launches"].items() if v <= 0]
    if idle and device == "cuda":
        raise AssertionError(f"the tiered brokers never launched {idle}")
    if dev["objects"] and not all(o[3] for o in dev["objects"]):
        raise AssertionError("the card's leg stored a segment uncompressed")
    dev["host"], dev["batches"], dev["bytes"] = host, len(batches), len(batches) * RECORDS * RECORD_BYTES
    return dev


def run_processes(device: str, partitions: int = BROKER_PARTITIONS, count: int = BROKER_BATCHES,
                  restart_count: int = PROC_RESTART_BATCHES, seed: int = SEED + 15, env=None) -> dict:
    """Part A on the port: process_scenario in a fresh data dir (`env`
    over PROC_ENV), checked; `launches` are the kernel launches of its
    traffic."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="rp_procs_")
    try:
        r = asyncio.run(process_scenario(tmp, device, partitions, count, restart_count, seed, env))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_processes(r, {**PROC_ENV, **(env or {})}, device)
    r["launches"] = r["path"][LAUNCH_COUNTS]
    return r


def phase_entry_points() -> dict:
    """Phase 14: the port as users start it (part A: run_processes;
    part B: run_tiered), its checks and numbers."""
    t0 = time.perf_counter()
    a = run_processes("cuda")
    t_a = time.perf_counter() - t0
    b = run_tiered("cuda")
    smi = nvidia_smi()

    def lat(xs):
        ms = np.asarray(xs) * 1e3
        return f"p50 {pct(ms, 50):.3f} ms p99 {pct(ms, 99):.3f} ms"

    def traffic(x, tag):
        return (f"{tag}: produce {len(x['lat_s'])} acks=all batches in {x['wall_s']:.3f} s (per batch "
                f"{lat(x['lat_s'])}); fetch {x['fetch_bytes']} B of records in {x['fetch_responses']} responses, "
                f"{x['fetch_wall_s']:.3f} s = {x['fetch_bytes'] / x['fetch_wall_s'] / 1e6:.1f} MB/s (per fetch "
                f"call {lat(x['fetch_lat_s'])}); {x['short']} partitions read a high watermark short of their "
                f"acks first")

    log(f"[procs] {smi}: {PROC_NODES} nodes `python -m redpanda_tpu_torch --device cuda --shards {PROC_SHARDS}` "
        f"({' '.join(f'{k}={v}' for k, v in PROC_ENV.items())}); topic {BROKER_TOPIC} created with the CLI, "
        f"{BROKER_PARTITIONS} partitions RF=3 compression.type=lz4; setup {a['setup_s']:.3f} s; "
        + traffic(a["run"], "first"))
    log(f"[procs] SIGKILL of node 0's worker (pid {a['victim']}): serving again in {a['restart_s']:.3f} s; "
        f"leaders placed again in {a['lead_s']:.3f} s, the worker leading {len(a['back'])} of its "
        f"{len(a['owned'])} partitions; " + traffic(a["again"], f"then those {len(a['back'])}")
        + f" (the fetch re-reads all {BROKER_PARTITIONS} partitions); every record back equal at its offset")
    log(f"[procs] restarts {[v['liveness']['shard_restarts'] for v in a['views']]}; the restarted worker for "
        f"the last batches: probe samples {a['worker'][SAMPLES]}, launches {a['worker'][LAUNCH_COUNTS]}; "
        f"node 0's /v1/devplane samples "
        f"{ {k: v['count'] for k, v in a['devplane'].get('kernels', {}).items()} }; the traffic's probe calls in "
        f"all {PROC_NODES * PROC_SHARDS} processes (RP_DEVPLANE_SAMPLE=1) {a['path'][SAMPLES]}, launches "
        f"{a['path'][LAUNCH_COUNTS]}; compute apps: {a['compute_apps']}; part A {t_a:.1f} s")
    h = b["host"]
    log(f"[tiered] {smi}: 3 Brokers (cuda), {' '.join(f'{k}={v}' for k, v in TIERED_ENV.items())}, topic "
        f"{TIERED_TOPIC} 1 partition RF=3 remote write/read, segment.bytes = retention.local.target.bytes = "
        f"{TIERED_SEGMENT} B; {b['batches']} batches ({b['bytes']} B of records), {TIERED_PER_REQUEST} a "
        f"request: setup {b['setup_s']:.3f} s, produce {b['produce_s']:.3f} s (per request {lat(b['lat_s'])}, "
        f"{b['bytes'] / b['produce_s'] / 1e6:.1f} MB/s); {b['uploaded']} segments archived in "
        f"{b['archive_s']:.3f} s ({sum(len(o[1]) for o in b['objects'])} B stored for "
        f"{sum(o[2] for o in b['objects'])} B); local start {b['local_start']}; fetch from 0 in "
        f"{b['fetch_s']:.3f} s = {b['bytes'] / b['fetch_s'] / 1e6:.1f} MB/s, {b['hydrations']} hydrations; "
        f"launches {b['launches']}")
    log(f"[tiered] host leg ({' '.join(f'{k}={v}' for k, v in HOST_LEG_ENV.items())}): produce "
        f"{h['produce_s']:.3f} s, archive {h['archive_s']:.3f} s, fetch {h['fetch_s']:.3f} s, {h['hydrations']} "
        f"hydrations; records and offsets equal to the card's leg; every stored object decodes (libzstd where "
        f"compressed) to its local segment; phase 14 {time.perf_counter() - t0:.1f} s")
    launches = dict(a["launches"])
    for k, v in b["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "procs": a["launches"], "tiered": b["launches"]}


# ------------------------------------------------ the brokers under faults
# Phase 15: the port's copy of the chaos harness (tests/
# test_torch_chaos_harness.py) on the card. Part A: three Brokers under
# crashes, partitions and leadership transfers, their internal RPC under
# the network nemesis of test_nemesis.py's capstone (its rules and seed);
# part B: the tiered brokers under test_chaos.py's object-store faults
# (its rules and seed, 515)
FAULT_TOPIC, FAULT_PARTITIONS = "chaos", 2
FAULT_SEED_A, FAULT_SEED_B = 20_260_804, 515
FAULT_SECONDS_A, FAULT_SECONDS_B = 15.0, 6.0
FAULT_ACTIONS = ("drop", "duplicate", "reorder", "corrupt", "delay")
FAULT_PATH_A = ("heartbeat_tick", "fused_lz4", "crc32c_device", "health_reduce")
FAULT_PATH_B = ("crc32c_device", "zstd_encode", "zstd_decode")
# part A: every produced batch recompressed to the topic's lz4 by the
# fused kernel, every fetch response verified on the card, the default
# (device) quorum backend; part B adds the zstd archive leg
FAULT_ENV_A = {"RP_CODEC_BACKEND": "device", "RP_FETCH_VERIFY": "1", "RP_QUORUM_BACKEND": None}
FAULT_ENV_B = {**FAULT_ENV_A, **TIERED_ENV}


def chaos_harness():
    """The port's chaos harness and the history checker, imported from
    the repository's tests/ (neither imports JAX)."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import linear_check
    import test_torch_chaos_harness

    return test_torch_chaos_harness, linear_check


def nemesis_rules():
    """test_nemesis.py's capstone schedule without its one-way episode:
    drop, duplicate, reorder and corrupt on AppendEntries, duplicated
    heartbeats (both kinds), jitter on every method."""
    import redpanda_tpu_torch.raft.types as rt
    from redpanda_tpu_torch.rpc import NetRule

    return [
        NetRule(method=rt.APPEND_ENTRIES, action="drop", prob=0.05),
        NetRule(method=rt.APPEND_ENTRIES, action="duplicate", prob=0.02),
        NetRule(method=rt.HEARTBEAT, action="duplicate", prob=0.02),
        NetRule(method=rt.HEARTBEAT_SAME, action="duplicate", prob=0.02),
        NetRule(method=rt.APPEND_ENTRIES, action="reorder", prob=0.04, reorder_window=4, reorder_hold_s=0.03),
        NetRule(method=rt.APPEND_ENTRIES, action="corrupt", prob=0.01),
        NetRule(action="delay", prob=0.05, delay_s=0.001, jitter_s=0.004),
    ]


def store_rules():
    """test_chaos.py's object-store schedule: partial uploads, torn
    manifests, slow ranged reads, failed gets, throttles."""
    from redpanda_tpu_torch.cloud.nemesis import StoreRule

    return [
        StoreRule(op="put", action="partial", prob=0.15),
        StoreRule(op="put", key_glob="*manifest.bin", action="error", prob=0.1),
        StoreRule(op="get_range", action="slow", prob=0.1, delay_s=0.0, bandwidth_bps=512 * 1024),
        StoreRule(op="get", action="error", prob=0.1),
        StoreRule(op="*", action="throttle", prob=0.05, delay_s=0.02),
    ]


class FaultWatch:
    """What phase 15 reads around one run_chaos call, through subclasses
    of the harness's ChaosCluster and SeqProducer that run_chaos builds
    while `watching` holds: node 0's device_tick calls held against the
    host leg across its restarts, the launch counters zeroed once the
    cluster has started, each produce in a linearizability history with
    its latency, and just before the cluster stops (after validation),
    for a tiered run the topic fetched from offset 0 with the hydrations
    it took, else a live fetch stream into the history, every replica's
    committed records and node 0's health report."""

    def __init__(self, harness, linear_check, tiered: bool):
        self.harness, self.tiered = harness, tiered
        self.hist = linear_check.LinearHistory()
        self.held = {"calls": [], "errors": []}
        self.lat_s: list = []
        self.producer = None
        self.replicas: dict = {}
        self.reread: dict = {}
        self.health = None
        self.hydrations = 0

    @contextlib.contextmanager
    def watching(self):
        h = self.harness
        old = h.ChaosCluster, h.SeqProducer
        h.ChaosCluster, h.SeqProducer = self._cluster(old[0]), self._producer(old[1])
        try:
            yield
        finally:
            h.ChaosCluster, h.SeqProducer = old

    def _cluster(self, base):
        watch = self

        class Watched(base):
            def _make_broker(self, nid):
                b = super()._make_broker(nid)
                if nid == 0:
                    hold_device_ticks(b.group_manager.arrays, watch.held)
                return b

            async def start(self):
                await super().start()
                reset_launches()

            async def stop(self):
                if watch.producer is not None and watch.producer._stop:
                    await watch.capture(self)
                await super().stop()

        return Watched

    def _producer(self, base):
        watch = self
        h = self.harness

        class Watched(base):
            async def run(self):
                watch.producer = self
                loops = [self._produce()] + ([] if watch.tiered else [self._fetch()])
                await asyncio.gather(*loops)

            async def _produce(self):
                # SeqProducer.run, each produce also in the history
                client = h.KafkaClient(self.cluster.addresses())
                try:
                    while not self._stop:
                        seq = self._seq
                        self._seq += 1
                        pid = seq % self.partitions
                        self.attempts += 1
                        op = watch.hist.begin_produce(pid, seq)
                        t0 = time.perf_counter()
                        try:
                            off = await asyncio.wait_for(
                                client.produce(self.topic, pid, [(b"seq-%d" % seq, b"payload-%d" % seq)], acks=-1),
                                timeout=3.0,
                            )
                            watch.lat_s.append(time.perf_counter() - t0)
                            watch.hist.ack(op, off)
                            self.acked.append((pid, off, seq))
                        except (h.KafkaClientError, asyncio.TimeoutError, OSError):
                            with contextlib.suppress(Exception):
                                await client.close()
                            client = h.KafkaClient(self.cluster.addresses())
                        await asyncio.sleep(0.01)
                finally:
                    with contextlib.suppress(Exception):
                        await client.close()

            async def _fetch(self):
                # the capstone's fetch loop, over every partition
                client = h.KafkaClient(self.cluster.addresses())
                try:
                    while not self._stop:
                        for pid in range(self.partitions):
                            t0 = time.monotonic()
                            try:
                                recs = await asyncio.wait_for(
                                    client.fetch(self.topic, pid, 0, max_bytes=1 << 24, max_wait_ms=50), timeout=3.0)
                                watch.hist.record_fetch(pid, 0, t0, recs)
                            except (h.KafkaClientError, asyncio.TimeoutError, OSError):
                                with contextlib.suppress(Exception):
                                    await client.close()
                                client = h.KafkaClient(self.cluster.addresses())
                        await asyncio.sleep(0.05)
                finally:
                    with contextlib.suppress(Exception):
                        await client.close()

        return Watched

    async def capture(self, cluster) -> None:
        from redpanda_tpu_torch.models.fundamental import kafka_ntp

        if self.tiered:
            # the whole topic again after the settle sweeps' trim: the
            # read below the local start hydrates archived segments
            h0 = sum(b.remote_reader.hydrations for b in cluster.brokers.values() if b.remote_reader)
            client = self.harness.KafkaClient(cluster.addresses())
            try:
                for pid in range(self.producer.partitions):
                    got = await client.fetch(self.producer.topic, pid, 0, max_bytes=1 << 24, max_wait_ms=100)
                    self.reread[pid] = {o: (k, v) for o, k, v in got}
            finally:
                await client.close()
            self.hydrations = sum(b.remote_reader.hydrations for b in cluster.brokers.values()
                                  if b.remote_reader) - h0
            return
        # every replica's committed records, once its watermark covers
        # the partition's last ack (a follower learns it by heartbeat)
        top: dict = {}
        for pid, off, _ in self.producer.acked:
            top[pid] = max(top.get(pid, -1), off)
        deadline = time.monotonic() + 15.0
        for nid, b in cluster.brokers.items():
            for pid in range(self.producer.partitions):
                ntp = kafka_ntp(self.producer.topic, pid)
                while True:
                    p = b.partition_manager.get(ntp)
                    if (p is not None and p.high_watermark() > top.get(pid, -1)) or time.monotonic() > deadline:
                        break
                    await asyncio.sleep(0.05)
                rows = {}
                if p is not None:
                    for kbase, batch in p.read_kafka(0, max_bytes=1 << 30):
                        for r in batch.records():
                            rows[kbase + r.offset_delta] = (r.key, r.value)
                self.replicas[(nid, pid)] = rows
        self.health = cluster.brokers[0].group_manager.health_report()


def check_acked(acked, rows_of, what: str) -> None:
    """Every acked (partition, offset, seq) is that seq's record at that
    offset in rows_of[partition]."""
    for pid, off, seq in acked:
        got = rows_of(pid).get(off)
        if got != (b"seq-%d" % seq, b"payload-%d" % seq):
            raise AssertionError(f"{what}: p{pid}@{off}: acked seq {seq}, found {got!r}")


def run_faults(device: str, seconds_a: float = FAULT_SECONDS_A, seconds_b: float = FAULT_SECONDS_B) -> dict:
    """Phase 15 on `device`: part A (network nemesis, crashes,
    partitions, transfers; lz4 topic) and part B (tiered, object-store
    faults), each one run_chaos call of the port's harness, with their
    checks: I1-I3 (the harness's validate) in both; in A each replica's
    records, L1-L4 over the live fetch stream, every device_tick call of
    node 0 exact against the host leg and the nemesis trace one line a
    fault; in B the tiered checks, the archive and the trim, the store
    fault trace replayed byte-equal and the topic read again from offset
    0. Launch counts are read after each run (zeroed once its cluster
    has started)."""
    import shutil
    import tempfile
    from dataclasses import replace
    from pathlib import Path

    from redpanda_tpu_torch.cloud.nemesis import StoreFaultSchedule, replay_trace
    from redpanda_tpu_torch.rpc import NemesisSchedule

    harness, linear_check = chaos_harness()
    tmp = Path(tempfile.mkdtemp(prefix="rp_faults_"))
    out = {}
    try:
        # part A
        watch = FaultWatch(harness, linear_check, tiered=False)
        sched = NemesisSchedule(rules=nemesis_rules(), seed=FAULT_SEED_A)
        t0 = time.perf_counter()
        with environ(FAULT_ENV_A), watch.watching():
            stats = asyncio.run(harness.run_chaos(
                tmp / "a", seed=FAULT_SEED_A, duration_s=seconds_a, partitions=FAULT_PARTITIONS,
                faults=("partition", "crash", "transfer"), nemesis=sched, device=device,
                topic_configs={"compression.type": "lz4"}))
        a = {"wall_s": time.perf_counter() - t0, "stats": stats, "lat_s": watch.lat_s,
             "launches": {k: KERNELS[k][2][k] for k in FAULT_PATH_A}, "held": len(watch.held["calls"])}
        acked = watch.producer.acked
        if not acked:
            raise AssertionError(f"part A: no produce was acknowledged ({stats})")
        for nid in range(3):
            check_acked(acked, lambda pid: watch.replicas[(nid, pid)], f"part A: node {nid}'s replica")
        a["linear"] = linear_check.check(watch.hist)
        if a["linear"]["acked"] != len(acked) or a["linear"]["fetches"] <= 10:
            raise AssertionError(f"part A: history {a['linear']} for {len(acked)} acks")
        check_held(watch.held)
        if len(sched.trace) != sum(sched.injected.values()):
            raise AssertionError(f"part A: a trace of {len(sched.trace)} for {sched.injected}")
        a["health"] = watch.health
        out["a"] = a
        # part B
        watch = FaultWatch(harness, linear_check, tiered=True)
        rules = store_rules()
        store = StoreFaultSchedule(rules=[replace(r) for r in rules], seed=FAULT_SEED_B)
        t0 = time.perf_counter()
        with environ(FAULT_ENV_B), watch.watching():
            stats = asyncio.run(harness.run_chaos(
                tmp / "b", seed=FAULT_SEED_B, duration_s=seconds_b, partitions=FAULT_PARTITIONS,
                faults=("partition", "crash", "transfer"), tiered=True, store_faults=store, device=device))
        b = {"wall_s": time.perf_counter() - t0, "stats": stats, "lat_s": watch.lat_s,
             "launches": {k: KERNELS[k][2][k] for k in FAULT_PATH_B}, "hydrations": watch.hydrations}
        acked = watch.producer.acked
        if not acked or stats["tiered_archived"] < 1 or stats["tiered_trimmed"] < 1:
            raise AssertionError(f"part B: nothing acked, archived or trimmed ({stats})")
        check_acked(acked, lambda pid: watch.reread[pid], "part B: the topic from offset 0 after the trim")
        if sum(store.injected.values()) <= 0 or replay_trace(rules, FAULT_SEED_B, store.ops) != store.trace:
            raise AssertionError(f"part B: the store fault trace ({store.injected}) does not replay")
        out["b"] = b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_faults() -> dict:
    """Phase 15: the brokers under faults on the card (run_faults), the
    launches of each part, and its numbers."""
    t0 = time.perf_counter()
    r = run_faults("cuda")
    # the replies this phase exists to show: every action of the network
    # nemesis fired in part A
    fired = r["a"]["stats"]["nemesis"]
    idle = [k for k in FAULT_ACTIONS if fired.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"phase 15 part A: the nemesis never fired {idle} ({fired})")
    for part, path in (("a", FAULT_PATH_A), ("b", FAULT_PATH_B)):
        idle = [k for k in path if r[part]["launches"][k] <= 0]
        if idle:
            raise AssertionError(f"phase 15 part {part.upper()} never launched {idle}: {r[part]['launches']}")

    def line(x, faults):
        lat = np.asarray(x["lat_s"]) * 1e3
        s = x["stats"]
        return (f"{s['acked']} acked / {s['attempts']} attempts; faults {faults}; events "
                f"{sum(1 for e in s['events'] if e[0] != 'recover')} ({', '.join(sorted({e[0] for e in s['events']}))}); "
                f"produce per ack p50 {pct(lat, 50):.3f} ms p99 {pct(lat, 99):.3f} ms (host clock); "
                f"launches {x['launches']}; {x['wall_s']:.3f} s wall")

    a, b = r["a"], r["b"]
    log(f"[faults] part A: 3 brokers (cuda), topic {FAULT_TOPIC} {FAULT_PARTITIONS} partitions RF=3 "
        f"compression.type=lz4, network nemesis seed {FAULT_SEED_A}, crash / partition / transfer: "
        + line(a, a["stats"]["nemesis"]))
    log(f"[faults] part A: I1-I3 hold, every acked record on each of the 3 replicas, L1-L4 hold "
        f"({a['linear']}); {a['held']} node-0 heartbeat_tick calls exact against the host leg; health "
        f"{health_totals(a['health'])}")
    log(f"[faults] part B: 3 tiered brokers (cuda, zstd archive), store nemesis seed {FAULT_SEED_B}: "
        + line(b, b["stats"]["store_faults"]))
    log(f"[faults] part B: I1-I3 hold; archived {b['stats']['tiered_archived']}, trimmed "
        f"{b['stats']['tiered_trimmed']}; store trace of {b['stats']['store_trace_len']} replays byte-equal; "
        f"the topic from offset 0 after the trim equal to the acks ({b['hydrations']} hydrations); "
        f"phase {time.perf_counter() - t0:.1f} s")
    launches = {k: a["launches"].get(k, 0) + b["launches"].get(k, 0) for k in FAULT_PATH_A + FAULT_PATH_B}
    return {"launches": launches, "a": a, "b": b}


# ------------------------------------------ the broker's zstd and mesh seams
# Phase 16. Part A: a zstd topic at BASELINE.json config 5's codec (OMB's
# 1-topic-100-partitions, zstd, 1 KB), whose leaders recompress every
# uncompressed producer batch on the card, then an lz4 topic fed batches
# the producer compressed with zstd, as bench.py:3447 _omb_async's
# producers do (the codec-mismatch leg: the leader decodes each on the
# card and re-encodes it with the fused LZ4 kernel). Part B: phase 13's
# lz4 traffic under RP_QUORUM_BACKEND=mesh over bench.py:478's 8 chip
# blocks, with lanes moved across blocks mid-produce, beside the host
# quorum backend
SEAMS_ZSTD_TOPIC, SEAMS_MISMATCH_TOPIC = "omb-zstd", "omb-mismatch"
SEAMS_MISMATCH_BATCHES, SEAMS_MOVES, SEAMS_MESH_DEVICES = 512, 4, 8
SEAMS_ENV_A = {**BROKER_DEVICE_ENV, "RP_ZSTD_BACKEND": "tpu"}
SEAMS_ENV_B = {**BROKER_DEVICE_ENV, "RP_QUORUM_BACKEND": "mesh", "RP_MESH_FULL": "1",
               "RP_MESH_DEVICES": str(SEAMS_MESH_DEVICES)}
SEAMS_HOST_B = {**SEAMS_ENV_B, "RP_QUORUM_BACKEND": "host", "RP_MESH_FULL": None, "RP_MESH_DEVICES": None}
# the kernels each part must launch (part A's brokers run the default
# device quorum backend: heartbeat_tick and health_reduce)
SEAMS_PATH_A = ("zstd_encode", "zstd_decode", "fused_lz4", "crc32c_device", "heartbeat_tick", "health_reduce")
SEAMS_PATH_B = ("fold_replies", "mesh_tick_frame", "health_totals", "fused_lz4", "crc32c_device")


def same_outputs(fields):
    """A comparison of a kernel entry's output tuple with its plain
    version's: every field exact (max_abs_err)."""

    def same(got, want, what: str) -> None:
        try:
            max_abs_err(dict(zip(fields, got)), dict(zip(fields, want)))
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from None

    return same


class KernelHold:
    """Every call of a kernel entry (`module.name`, looked up there by
    its callers; `kernel` names it in errors) held against its plain
    version on the same inputs while the hold is entered. A call that
    differs raises where it ran and is kept, and `check` raises the first
    after the run, since a broker answers a produce whose handler raised
    with an error code. `calls` counts the held calls (on the card one
    launch each)."""

    def __init__(self, kernel: str, module, name: str, plain, same):
        self.kernel, self.module, self.name, self.plain, self.same = kernel, module, name, plain, same
        self.calls, self.errors = 0, []

    def __enter__(self):
        entry = self.entry = getattr(self.module, self.name)

        def held(*args, **kwargs):
            got = entry(*args, **kwargs)
            want = self.plain(*args, **kwargs)
            n = self.calls
            self.calls += 1
            try:
                self.same(got, want, f"{self.kernel} call {n}")
            except AssertionError as e:
                self.errors.append(e)
                raise
            return got

        setattr(self.module, self.name, held)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.entry)

    def check(self) -> None:
        if self.errors:
            raise self.errors[0]


def seam_holds(plains: dict | None = None) -> dict:
    """Part A's holds, by kernel: the zstd encode and decode entries and
    the fused CRC + LZ4 entry, each against its plain version (the fused
    entry's CRC against the host's: the plain CRC takes ~2 s a batch on
    the card, PERF.md's kernel table); `plains` replaces one by name."""
    import torch

    plains = {"zstd_encode": zstd_ops._encode_chunks_plain, "zstd_decode": decode_plain,
              "fused_lz4": lambda d, v, n: fused_plain(torch, d, v, n, host_crc=True), **(plains or {})}
    holds = [("zstd_encode", zstd_ops, "_encode_chunks", same_outputs(ENC_FIELDS)),
             ("zstd_decode", zstd_ops, "decode_staged", same_outputs(("out", "end"))),
             ("fused_lz4", fused_ops, "_fused", lambda got, want, what: fused_err(torch, got, want, what))]
    return {k: KernelHold(k, module, name, plains[k], same) for k, module, name, same in holds}


@contextlib.contextmanager
def counted_recompress(counts: dict):
    """Count RecordBatch.recompressed calls by (source codec, target
    codec): a leader's recompression of a produced batch, retries
    included, and the inner call of a codec mismatch (source none)."""
    from redpanda_tpu_torch.models.record import RecordBatch

    method = RecordBatch.recompressed

    def counted(self, ctype, verify_crc=None):
        key = (int(self.header.compression), int(ctype))
        counts[key] = counts.get(key, 0) + 1
        return method(self, ctype, verify_crc=verify_crc)

    RecordBatch.recompressed = counted
    try:
        yield
    finally:
        RecordBatch.recompressed = method


@contextlib.contextmanager
def no_zstd_punt(punts: list):
    """Fail any punt of uncompress_zstd to the host codec: every frame of
    phase 16 comes from the port's own encoder, inside the kernels'
    profile."""
    from redpanda_tpu_torch import compression

    saved = compression._zstd_uncompress_host

    def punt(data):
        punts.append(len(data))
        raise AssertionError("a zstd frame of the port's own encoder punted to the host codec")

    compression._zstd_uncompress_host = punt
    try:
        yield
    finally:
        compression._zstd_uncompress_host = saved


def kernel_counts() -> dict:
    return {k: KERNELS[k][2][k] for k in KERNELS}


def check_zstd_stored(stored: dict, a1, zstd: int) -> int:
    """Every stored batch of the zstd topic is zstd and decodes through
    libzstd to the records body its producer sent; returns how many."""
    from redpanda_tpu_torch.models.record import RecordBatch

    sent: dict = {}
    for name, part, wire, _ in a1:
        sent.setdefault((name, part), []).append(bytes(RecordBatch.from_kafka_wire(wire).body))
    n = 0
    for key, bodies in sent.items():
        rows = stored[key]
        if len(rows) != len(bodies):
            raise AssertionError(f"{key}: {len(rows)} batches stored for {len(bodies)} sent")
        for i, ((codec, blob), body) in enumerate(zip(rows, bodies)):
            if codec != zstd or host_zstd_decompress(blob) != body:
                raise AssertionError(f"{key} batch {i}: stored as codec {codec}, or libzstd does not decode "
                                     f"it to the body sent")
            n += 1
    return n


def check_seams(holds: dict, punts: list) -> None:
    """Raise the first mismatch a hold kept, or a punt."""
    for h in holds.values():
        h.check()
    if punts:
        raise AssertionError(f"{len(punts)} zstd decodes punted to the host codec")


def run_seams_zstd(device: str, partitions: int = BROKER_PARTITIONS, count: int = BROKER_BATCHES,
                   mismatch: int = SEAMS_MISMATCH_BATCHES, seed: int = SEED + 16, plains: dict | None = None) -> dict:
    """Part A on the port (SEAMS_ENV_A, brokers on `device`):
    broker_scenario with `count` uncompressed batches to a zstd topic of
    `partitions` (A1), then `mismatch` zstd batches (JSON-like records,
    built by the port's RecordBatchBuilder under RP_ZSTD_BACKEND=tpu
    before the count starts) to an lz4 topic of `partitions` (A2). Every
    zstd encode, zstd decode and fused CRC + LZ4 call is held against its
    plain version (`plains` replaces one, by kernel name) and counted by
    stage (A1, A2, fetch) beside the leaders' recompressions by codec
    pair; no zstd decode may punt to the host codec. Checked on both
    devices: every record back at its offset, every stored zstd batch
    decoding through libzstd to the body sent, every stored batch of the
    lz4 topic lz4, A1's held calls one zstd_encode a recompression to
    zstd, A2's one zstd_decode and one fused call a codec mismatch (its
    recompressions), retries included; on the card also each stage's
    launches equal to its held calls, one crc32c_device a fetch response
    with records, and every SEAMS_PATH_A kernel launched."""
    import shutil
    import tempfile

    from redpanda_tpu_torch.compression import CompressionType
    from redpanda_tpu_torch.models.record import RecordBatch

    pkg = port_broker()
    zstd, lz4 = int(CompressionType.zstd), int(CompressionType.lz4)
    topics = [(SEAMS_ZSTD_TOPIC, partitions, {"compression.type": "zstd"}),
              (SEAMS_MISMATCH_TOPIC, partitions, {"compression.type": "lz4"})]
    a1 = broker_batches(seed, [(SEAMS_ZSTD_TOPIC, partitions)], count)
    with environ(SEAMS_ENV_A):
        a2 = broker_batches(seed + 1, [(SEAMS_MISMATCH_TOPIC, partitions)], mismatch,
                            compression=CompressionType.zstd, json_only=True)
    # every producer frame carries a compressed block, so the leader's
    # decode of each is one launch
    for i, (_, _, wire, _) in enumerate(a2):
        if block_kinds(bytes(RecordBatch.from_kafka_wire(wire).body))[0]["compressed"] < 1:
            raise AssertionError(f"mismatch batch {i}: the producer's zstd frame has no compressed block")
    holds = seam_holds(plains)
    recompress: dict = {}
    punts: list = []
    marks: dict = {}

    def mark(stage):
        if stage == "produce":
            reset_launches()
        marks[stage] = {"launches": kernel_counts(), "recompress": dict(recompress),
                        "held": {k: h.calls for k, h in holds.items()}}

    tmp = tempfile.mkdtemp(prefix="rp_seams_a_")
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(environ(SEAMS_ENV_A))
            for h in holds.values():
                stack.enter_context(h)
            stack.enter_context(counted_recompress(recompress))
            stack.enter_context(no_zstd_punt(punts))
            try:
                run = asyncio.run(broker_scenario(pkg, os.path.join(tmp, "a"), topics, a1, on_phase=mark,
                                                  stored=[(name, parts) for name, parts, _ in topics], then=a2,
                                                  device=device))
            except Exception:
                # a held mismatch or a punt is the cause of what failed
                check_seams(holds, punts)
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_seams(holds, punts)
    run["stored_zstd"] = check_zstd_stored(run["stored"], a1, zstd)
    bad = [k for k, rows in run["stored"].items() if k[0] == SEAMS_MISMATCH_TOPIC and any(c != lz4 for c, _ in rows)]
    if bad:
        raise AssertionError(f"codec-mismatch partitions {bad[:5]} store a batch that is not lz4")

    def between(a, b, what):
        return {k: marks[b][what][k] - marks[a][what].get(k, 0) for k in marks[b][what]}

    stages = {name: {w: between(s, t, w) for w in ("launches", "recompress", "held")}
              for name, s, t in (("a1", "produce", "then"), ("a2", "then", "fetch"), ("fetch", "fetch", "end"))}
    recompressed = stages["a1"]["recompress"].get((0, zstd), 0)
    mismatched = stages["a2"]["recompress"].get((zstd, lz4), 0)
    want = {"a1": {"zstd_encode": recompressed, "zstd_decode": 0, "fused_lz4": 0},
            "a2": {"zstd_encode": 0, "zstd_decode": mismatched,
                   "fused_lz4": stages["a2"]["recompress"].get((0, lz4), 0)}}
    for stage, calls in want.items():
        if stages[stage]["held"] != calls:
            raise AssertionError(f"{stage}: held calls {stages[stage]['held']} for recompressions "
                                 f"{stages[stage]['recompress']}")
    if recompressed < len(a1) or mismatched < len(a2) or want["a2"]["fused_lz4"] != mismatched:
        raise AssertionError(f"recompressions {stages['a1']['recompress']} / {stages['a2']['recompress']} for "
                             f"{len(a1)} / {len(a2)} batches")
    if device == "cuda":
        for stage, st in stages.items():
            for k, n in st["held"].items():
                if st["launches"][k] != n:
                    raise AssertionError(f"{stage}: {st['launches'][k]} {k} launches for {n} held calls")
        if stages["fetch"]["launches"]["crc32c_device"] != run["fetch_responses"]:
            raise AssertionError(f"crc32c_device launched {stages['fetch']['launches']['crc32c_device']} times "
                                 f"for {run['fetch_responses']} fetch responses with records")
    run["launches"] = {k: marks["end"]["launches"][k] - marks["produce"]["launches"][k] for k in SEAMS_PATH_A}
    idle = [k for k, v in run["launches"].items() if v <= 0]
    if idle and device == "cuda":
        raise AssertionError(f"phase 16 part A never launched {idle}: {run['launches']}")
    run.update(stages=stages, batches=(len(a1), len(a2)), retries=(recompressed - len(a1), mismatched - len(a2)))
    return run


def hold_mesh(arrays) -> dict:
    """Hold every full mesh frame of `arrays` (`_mesh_full_frame`, which
    both device_tick and frame_tick reach on the mesh backend) against
    the numpy host leg (host_tick) on a copy of the lanes taken just
    before it: the advanced rows, LANES, the HEALTH_LANES against the
    host health reduction of the copy, and mesh_totals() against the
    copy's totals; and every run_health (the read path's refresh)
    against the host health reduction of the same lanes. A frame or a
    refresh that differs raises and is kept, as in hold_device_ticks.
    Returns {"frames": the reply count of each held frame, "health":
    one entry a held refresh, "errors": the mismatches}."""
    held: dict = {"frames": [], "health": [], "errors": []}
    full = arrays._mesh_full_frame
    run_health = arrays.mesh_frame.run_health

    def kept(check) -> None:
        try:
            check()
        except AssertionError as e:
            held["errors"].append(e)
            raise

    def frame(*args, **kwargs):
        shadow = shadow_arrays(arrays)
        got = full(*args, **kwargs)
        want = shadow.host_tick(*args, **kwargs)
        n = len(held["frames"])
        held["frames"].append(len(args[0]))

        def check():
            assert_equal(np.sort(got), np.sort(want), f"mesh frame {n}: advanced rows")
            for lane in LANES:
                assert_equal(getattr(arrays, lane), getattr(shadow, lane), f"mesh frame {n}: {lane}")
            h = health_np(shadow)
            for lane, key in zip(HEALTH_LANES, HEALTH_KEYS):
                assert_equal(getattr(arrays, lane), h[key], f"mesh frame {n}: {lane}")
            totals = {"advanced": len(want), **totals_np(shadow, h)}
            if arrays.mesh_totals() != totals:
                raise AssertionError(f"mesh frame {n}: totals {arrays.mesh_totals()} != host leg's {totals}")

        kept(check)
        return got

    def health(a):
        got, totals = run_health(a)
        n = len(held["health"])
        held["health"].append(1)

        def check():
            h = health_np(a)
            for key in HEALTH_KEYS:
                assert_equal(got[key], h[key], f"run_health {n}: {key}")
            if totals != totals_np(a, h):
                raise AssertionError(f"run_health {n}: totals {totals} != host leg's {totals_np(a, h)}")

        kept(check)
        return got, totals

    arrays._mesh_full_frame = frame
    arrays.mesh_frame.run_health = health
    return held


def check_kept(held: list) -> None:
    """Raise the first mismatch any node's hold_mesh kept."""
    for h in held:
        if h["errors"]:
            raise h["errors"][0]


async def move_lanes(cluster, topic: str, parts: int, n: int) -> list:
    """Move the lanes of the first `n` partitions of `topic` that node 0
    leads into another chip block of node 0's mesh (the block with the
    most free rows), one after another, with PartitionMover.move_lane on
    node 0's own placement table as tests/test_placement.py:341-400 sets
    it up; each move checked (the partition's row in the new block, the
    table bound to it). Returns one entry a move."""
    pl = cluster.pkg.placement
    b = cluster.brokers[0]
    arrays = b.group_manager.arrays
    mover = pl.PartitionMover(b.shard_table, pl.MoveHost(b.partition_manager, b.group_manager, b.storage.log_mgr),
                              budget=pl.MoveBudget(moves_per_window=100))
    led = [p for p in range(parts) if cluster.replicas((topic, p))[0].is_leader][:n]
    if len(led) < n:
        raise AssertionError(f"node 0 leads {len(led)} partitions of {topic}, {n} lanes to move")
    out = []
    for p in led:
        ntp = cluster.pkg.kafka_ntp(topic, p)
        part = b.partition_manager.get(ntp)
        src_row = part.consensus.row
        src = arrays.chip_of(src_row)
        free = np.bincount(arrays.chip_of_rows(np.asarray(arrays._free, np.int64)), minlength=arrays.chip_count())
        free[src] = -1
        dst = int(np.argmax(free))
        t0 = time.perf_counter()
        r = await mover.move_lane(ntp, dst)
        row = part.consensus.row
        if not r["moved"] or r["to_chip"] != dst or arrays.chip_of(row) != dst \
                or b.shard_table.chip_lane_for(r["group"]) != (dst, row):
            raise AssertionError(f"{topic}/{p}: lane move to chip {dst} did not land ({r}, row {row})")
        out.append({"partition": p, "group": r["group"], "from": (src, src_row), "to": (dst, row),
                    "s": time.perf_counter() - t0})
    return out


async def mesh_scenario(pkg, data_dir: str, topics, batches, moves: int, held: list | None = None, mark=None,
                        **cfg) -> dict:
    """Part B's cluster: start (each node's mesh frames and health
    refreshes held into `held` when given, hold_mesh), create `topics`
    at RF = the node count, produce the first half of `batches`, then
    the second half while `moves` lanes move on node 0 (move_lanes),
    lead as created, fetch every partition back, settle, take node 0's
    health report and run one frame at rest; each moved lane is checked
    again in its block at the end. `mark(stage)` is called with
    "produce" and "end". Returns the run with the moves, node 0's chip
    count and mesh_totals(), and every node's commit_index and
    last_visible lanes."""

    class Held(KafkaCluster):
        def made(self, broker):
            if held is not None:
                held.append(hold_mesh(broker.group_manager.arrays))

    cluster = Held(pkg, data_dir, **cfg)
    (name, parts, _), = topics
    t0 = time.perf_counter()
    try:
        await cluster.start()
        await cluster.create(topics, rf=cluster.nodes)
        out = {"setup_s": time.perf_counter() - t0}
        if mark:
            mark("produce")
        stalls: list = []
        watch = asyncio.ensure_future(loop_stalls(stalls))
        half = len(batches) // 2
        first = await cluster.produce(batches[:half])
        rest = asyncio.ensure_future(cluster.produce(batches[half:]))
        out["moves"] = await move_lanes(cluster, name, parts, moves) if moves else []
        second = await rest
        out.update(bases=first["bases"] + second["bases"], lat_s=first["lat_s"] + second["lat_s"],
                   wall_s=first["wall_s"] + second["wall_s"], produce_stall_s=max(stalls, default=0.0))
        out["moved"] = await cluster.place(topics)
        stalls.clear()
        out.update({f"fetch_{k}": v for k, v in (await cluster.fetch_all(topics)).items()})
        out["fetch_stall_s"] = max(stalls, default=0.0)
        watch.cancel()
        out["records"], out["hwm"] = out.pop("fetch_records"), out.pop("fetch_hwm")
        await cluster.place(topics)
        out["sampler"] = await cluster.settle()
        out["health"] = cluster.brokers[0].group_manager.health_report()
        # one frame at rest (no replies) on node 0, so its totals are the
        # settled view whatever the traffic's last frame advanced
        arrays = cluster.brokers[0].group_manager.arrays
        empty = np.empty(0, np.int64)
        arrays.frame_tick(empty, empty, empty, empty, empty)
        if mark:
            mark("end")
        for m in out["moves"]:
            row = cluster.brokers[0].partition_manager.get(pkg.kafka_ntp(name, m["partition"])).consensus.row
            if (arrays.chip_of(row), row) != m["to"]:
                raise AssertionError(f"{name}/{m['partition']}: lane at (chip {arrays.chip_of(row)}, row {row}) "
                                     f"at the end, moved to {m['to']}")
        out["chips"], out["mesh_totals"] = arrays.chip_count(), arrays.mesh_totals()
        out["lanes"] = [{k: getattr(b.group_manager.arrays, k).copy() for k in ("commit_index", "last_visible")}
                        for b in cluster.brokers]
    finally:
        await cluster.stop()
    check_broker_run(out, batches, topics)
    return out


def run_seams_mesh(device: str, partitions: int = BROKER_PARTITIONS, count: int = BROKER_BATCHES,
                   moves: int = SEAMS_MOVES, seed: int = SEED + 17, env: dict | None = None) -> dict:
    """Part B on the port: mesh_scenario under SEAMS_ENV_B (`env` over
    it; brokers on `device`) with every node's mesh frames and health
    refreshes held and `moves` lane moves, the launches counted from the
    produce to the health report; then the host leg (SEAMS_HOST_B, no
    move: one block) on the same batches. Checked: every record back at
    its offset on both legs, the legs equal in offsets, watermarks and
    records, every held frame and refresh exact, a held frame on every
    node and a held refresh; on the card also fold_replies and
    mesh_tick_frame launched once a held frame, health_totals once a
    held refresh, and every SEAMS_PATH_B kernel launched."""
    import shutil
    import tempfile

    pkg = port_broker()
    topics = [(BROKER_TOPIC, partitions, {"compression.type": "lz4"})]
    batches = broker_batches(seed, [(BROKER_TOPIC, partitions)], count)
    marks: dict = {}
    dev_held: list = []

    def mark(stage):
        if stage == "produce":
            reset_launches()
        marks[stage] = {"launches": kernel_counts(),
                        "frames": [len(h["frames"]) for h in dev_held], "health": [len(h["health"]) for h in dev_held]}

    tmp = tempfile.mkdtemp(prefix="rp_seams_b_")
    try:
        with environ({**SEAMS_ENV_B, **(env or {})}):
            try:
                dev = asyncio.run(mesh_scenario(pkg, os.path.join(tmp, "mesh"), topics, batches, moves, dev_held,
                                                mark, device=device))
            except Exception:
                # a held mismatch is the cause of what failed
                check_kept(dev_held)
                raise
        with environ({**SEAMS_HOST_B, **(env or {})}):
            host = asyncio.run(mesh_scenario(pkg, os.path.join(tmp, "host"), topics, batches, 0, device=device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_kept(dev_held)
    if dev["records"] != host["records"] or dev["hwm"] != host["hwm"] or dev["bases"] != host["bases"]:
        raise AssertionError("the mesh leg and the host leg differ in offsets, watermarks or records")
    if len(dev["moves"]) != moves or dev["chips"] != SEAMS_MESH_DEVICES:
        raise AssertionError(f"{len(dev['moves'])} lane moves of {moves}, over {dev['chips']} chip blocks")
    frames = [e - s for s, e in zip(marks["produce"]["frames"], marks["end"]["frames"])]
    refreshes = sum(marks["end"]["health"]) - sum(marks["produce"]["health"])
    if not all(len(h["frames"]) for h in dev_held) or not all(frames) or refreshes <= 0:
        raise AssertionError(f"held mesh frames by node {frames} (since start "
                             f"{[len(h['frames']) for h in dev_held]}), held refreshes {refreshes}")
    launches = {k: marks["end"]["launches"][k] - marks["produce"]["launches"][k] for k in KERNELS}
    if device == "cuda":
        if not launches["fold_replies"] == launches["mesh_tick_frame"] == sum(frames):
            raise AssertionError(f"fold_replies {launches['fold_replies']} / mesh_tick_frame "
                                 f"{launches['mesh_tick_frame']} launches for {sum(frames)} held frames")
        if launches["health_totals"] != refreshes:
            raise AssertionError(f"health_totals launched {launches['health_totals']} times for {refreshes} "
                                 f"held refreshes")
        idle = [k for k in SEAMS_PATH_B if launches[k] <= 0]
        if idle:
            raise AssertionError(f"phase 16 part B never launched {idle}: {launches}")
    dev.update(host=host, batches=len(batches), frames=frames, refreshes=refreshes,
               launches={k: launches[k] for k in SEAMS_PATH_B},
               held_frames=sum(len(h["frames"]) for h in dev_held))
    return dev


def phase_seams() -> dict:
    """Phase 16: the broker's zstd and mesh seams on the card (part A:
    run_seams_zstd; part B: run_seams_mesh), its checks and numbers."""
    t0 = time.perf_counter()
    a = run_seams_zstd("cuda")
    t_a = time.perf_counter() - t0
    b = run_seams_mesh("cuda")
    smi = nvidia_smi()

    def lat(xs):
        ms = np.asarray(xs) * 1e3
        return f"p50 {pct(ms, 50):.3f} ms p99 {pct(ms, 99):.3f} ms"

    def fetch(x):
        return (f"fetch {x['fetch_bytes']} B in {x['fetch_responses']} responses, {x['fetch_wall_s']:.3f} s = "
                f"{x['fetch_bytes'] / x['fetch_wall_s'] / 1e6:.1f} MB/s")

    s, (n1, n2), a2 = a["stages"], a["batches"], a["then"]
    log(f"[seams] part A {smi}: {BROKER_NODES} brokers (cuda), "
        f"{' '.join(f'{k}={v}' for k, v in SEAMS_ENV_A.items() if v)}; setup {a['setup_s']:.3f} s; A1 {n1} "
        f"uncompressed acks=all batches to {SEAMS_ZSTD_TOPIC} ({BROKER_PARTITIONS} partitions RF=3 "
        f"compression.type=zstd) in {a['wall_s']:.3f} s (per batch {lat(a['lat_s'])}), {a['retries'][0]} retried; "
        f"A2 {n2} producer-zstd batches to {SEAMS_MISMATCH_TOPIC} (compression.type=lz4) in {a2['wall_s']:.3f} s "
        f"(per batch {lat(a2['lat_s'])}), {a['retries'][1]} retried; {fetch(a)}")
    log(f"[seams] part A launches: A1 produce {s['a1']['launches']['zstd_encode']} zstd_encode (held "
        f"{s['a1']['held']['zstd_encode']}); A2 produce {s['a2']['launches']['zstd_decode']} zstd_decode, "
        f"{s['a2']['launches']['fused_lz4']} fused_lz4 (held {s['a2']['held']['zstd_decode']} / "
        f"{s['a2']['held']['fused_lz4']}); recompressions by codec pair {s['a1']['recompress']} / "
        f"{s['a2']['recompress']}; fetch "
        f"{s['fetch']['launches']['crc32c_device']} crc32c_device for {a['fetch_responses']} responses and the "
        f"consumer's {s['fetch']['launches']['zstd_decode']} zstd_decode (held {s['fetch']['held']['zstd_decode']}); "
        f"all {a['launches']}; every held call exact, no punt; {a['stored_zstd']} stored zstd batches decode "
        f"through libzstd to the bodies sent; health {health_totals(a['health'])}; leaders moved {a['moved']}; "
        f"the event loop's longest stall {a['produce_stall_s'] * 1e3:.1f} ms (produce) / "
        f"{a['fetch_stall_s'] * 1e3:.1f} ms (fetch); part A {t_a:.1f} s")
    h = b["host"]
    moves = ", ".join(f"p{m['partition']} chip {m['from'][0]} row {m['from'][1]} -> chip {m['to'][0]} row "
                      f"{m['to'][1]} ({m['s'] * 1e3:.1f} ms)" for m in b["moves"])
    log(f"[seams] part B {smi}: {' '.join(f'{k}={v}' for k, v in SEAMS_ENV_B.items() if v)}; topic "
        f"{BROKER_TOPIC} {BROKER_PARTITIONS} partitions RF=3 lz4; setup {b['setup_s']:.3f} s; produce "
        f"{b['batches']} batches in {b['wall_s']:.3f} s (per batch {lat(b['lat_s'])}); fetch "
        f"{b['fetch_bytes']} B in {b['fetch_wall_s']:.3f} s = {b['fetch_bytes'] / b['fetch_wall_s'] / 1e6:.1f} "
        f"MB/s; host leg (RP_QUORUM_BACKEND=host) produce {h['wall_s']:.3f} s (per batch {lat(h['lat_s'])}), "
        f"fetch {h['fetch_bytes'] / h['fetch_wall_s'] / 1e6:.1f} MB/s")
    log(f"[seams] part B: held mesh frames by node {b['frames']} (since start {b['held_frames']}), held "
        f"refreshes {b['refreshes']}, each exact in advanced rows, lanes, health lanes and totals; launches "
        f"{b['launches']}; lane moves on node 0 over {b['chips']} chip blocks: {moves}; mesh_totals "
        f"{b['mesh_totals']}; offsets, watermarks and records equal to the host leg; leaders moved "
        f"{b['moved']} / {h['moved']}; the event loop's longest stall {b['produce_stall_s'] * 1e3:.1f} / "
        f"{h['produce_stall_s'] * 1e3:.1f} ms (produce), {b['fetch_stall_s'] * 1e3:.1f} / "
        f"{h['fetch_stall_s'] * 1e3:.1f} ms (fetch); phase 16 {time.perf_counter() - t0:.1f} s")
    launches = {k: a["launches"].get(k, 0) + b["launches"].get(k, 0) for k in SEAMS_PATH_A + SEAMS_PATH_B}
    return {"launches": launches, "a": a, "b": b}


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
        for name in ("fold_replies", "heartbeat_tick", "build_heartbeats", "tick_frame", "health_reduce")
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
    phase_armed(s["tick_s"])
    # the broker phase runs before the Raft layer's: its brokers keep
    # election timers (1.5 s), and phase 12's fsync'd logs leave the disk
    # writing back behind it
    broker = phase_broker()
    entry = phase_entry_points()
    faults = phase_faults()
    seams = phase_seams()
    live = phase_live_raft()
    results["heartbeat_tick"]["live"] = live["tick"]
    for launches in (seg["launches"], zr["launches"], mesh["launches"], cluster["launches"],
                     live["launches"]["path"], broker["launches"], entry["launches"], faults["launches"],
                     seams["launches"]):
        for name, count in launches.items():
            path_launches[name] = path_launches.get(name, 0) + count
    missing = [k for k in KERNELS if k not in OFF_PATH and path_launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"[launches] main path (batch CRCs: crc32c_device {rb['launches']}; codec path: {rc['launches']}; "
        f"segment path: {seg['launches']}; zstd batches: {zr['launches']}; mesh: {mesh['launches']}; "
        f"cluster: {cluster['launches']}; live raft: {live['launches']['path']}; "
        f"broker: {broker['launches']}; node processes: {entry['procs']}; tiered brokers: "
        f"{entry['tiered']}; brokers under faults: {faults['launches']}; the broker's zstd and mesh seams: "
        f"{seams['launches']}; no main-path caller: "
        f"{', '.join(OFF_PATH)}): {path_launches}")

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
        if "sequence_ms" in e:  # the launch sequence the kernel replaced, on the same inputs
            kernels[-1]["sequence_ms"] = e["sequence_ms"]
        if "live" in e:  # the same kernel at each of the live Raft layer's call shapes
            kernels[-1]["live"] = e["live"]
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
    sys.exit(armed_main() if sys.argv[1:] == ["--armed"] else main())
