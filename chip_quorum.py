#!/usr/bin/env python3
"""On-card breakdown and A/B timing of the replication tick's and the
mesh frame's kernels (one H100): the reply fold, the commit sweep, the
health reductions, the tick frame kernel and the mesh frame, which runs
the fold, the sweep, each row's health and the fleet totals in one pass
over the rows.

    mkdir -p .chipcheck/old
    for f in quorum.cu quorum_rules.cuh quorum_rows.cuh health.cu chip_blocks.cuh cluster.cu; do
        git show <commit>:redpanda_tpu_torch/csrc/$f > .chipcheck/old/$f; done
    python3 chip_quorum.py breakdown .chipcheck/old [OUT_DIR]
    python3 chip_quorum.py ab .chipcheck/old [OUT_DIR]
    python3 chip_quorum.py append .chipcheck/old [OUT_DIR]
    python3 chip_quorum.py follower .chipcheck/old [OUT_DIR]
    python3 chip_quorum.py tick .chipcheck/old [OUT_DIR [G_LIVE M_LIVE]]

The old directory holds a tree whose mesh frame is a launch sequence
(a copy of the commit lane, the fold, the sweep, two zero fills and
`health_totals` with its fold over the blocks) with the same C entry
points and argument lists as this tree's for the kernels it shares
(`rp_fold_replies`, `rp_commit_step`, `rp_build_heartbeats`,
`rp_tick_frame`, `rp_health_reduce`, `rp_health_totals`, the cluster
kernels): the tree of ba9e811.

Both modes run at chip_smoke phase 9's mesh shape (G = 1,000,000, R = 8,
D = 8, an 8,192-reply bucket). The mesh frame has two designs: this
tree's (B: the fold kernel, then the mesh sweep kernel, which sweeps the
rows with their health and folds the fleet totals in its own launch) and
one cooperative launch of the fold, the sweep with health and the totals
(A: `MESH_COOP`, appended to this tree's quorum.cu). `breakdown`: the old
sequence and each of its launches alone; the tick frame kernel without
heartbeat rows cut to its phases (the sweep alone in the co-resident
grid, with health, with the fold and its barrier); A with and without
replies; B's fold kernel alone, its sweep kernel alone, both; empty
kernels at the sweep kernel's shape and, cooperative, at A's grid with
0 and 1 grid barriers.

`ab` times, in turns (old, each new side, then the same in reverse):
at the mesh shape the fold, the sweep, `health_totals` and the mesh
frame as the old sequence, as B (this tree's) and as A at 256-, 128-
and 512-thread blocks (copies of this tree's quorum.cu with
FRAME_THREADS patched, `NEW_VARIANTS`); at the tick's shape (G = 50,000, M =
131,072, H = 50,000; chip_smoke phase 2) the fold, the sweep,
`health_reduce`, `heartbeat_tick`, `tick_frame` and `tick_frame_health`;
and the ring cluster's two kernels at 1,000,000 groups over 8 blocks.
Every output of each side is held exactly against the old one, and this
tree's against the plain versions, before anything is timed.

`append` breaks down and times the local append (`local_append_update`,
the scatter-max of M appends into slot 0 of match and flushed) at
chip_smoke phase 10's cluster shape (G = 1,000,000, R = 8, M =
1,000,000 appends to random rows), on the phase's appends (about 4 in 11
raise nothing) and on appends that each exceed their slot: the old
tree's kernel (both lanes' atomics a thread); pieces of it at its grid
(`APPEND_EXTRAS`: an empty kernel, the three input loads alone, the
loads and both slots' reads, one lane's atomics, plain stores in place
of the atomics: wrong under duplicates, a floor only); the library's
two `scatter_reduce_(amax)` calls on the same cells; this tree's entry
(one append a thread for small batches, else 2 * parts passes, a lane
and a part of the rows each) and its launch at one pass and 1 to 8 row
parts, at 128 to 512 threads. Every exact side is held against the
plain version, and on a batch with rows -1, -G, -G - 1, G and G + 5,
first. Then the old kernel, this tree's entry and its launch at one
pass and 1, 2, 4, 5, 6 and 8 parts, at M from G / 64 to 2 G; old and
this tree's entry in turns, beside `follower_commit_step` and the ring
cluster's kernels, old and new. The designs that lost to the passes (several
appends a thread, slot reads that skip atomics, `red.global`, a binned
two-launch design) are described in PERF.md.
Its old directory holds the files of 5a3ba4a (as for `ab`).

`follower` breaks down and times the follower rule
(`follower_commit_step`) at chip_smoke phase 10's cluster shape (G =
1,000,000, R = 8, leader_commit = commit + U{-2..5}): the old tree's
kernel (one thread a row) and pieces of it at its grid (`FOLLOW_EXTRAS`,
appended to the old quorum.cu: an empty kernel, the three [G] lanes
read and commit and visible written, slot 0's column of flushed alone);
this tree's entry (`FOLLOW_ROWS` rows a thread, vectors, the column only
where leader_commit > commit) and copies of it (`FOLLOW_VARIANTS`: 2 and 8
rows a thread, the column loaded on every row, every vector written
back, the column read through the read-only path), the pieces and kernels also under each L2 fetch granularity hint
(32, 64, 128 bytes; then the default again). Every side is first held
exactly against the plain version on
those inputs, on rows with no update (leader_commit = i64 min), on G - 3
rows (the scalar tail) and on a view one row in (unaligned [G] lanes).
Then all in turns (each side, then the same in reverse), and the ring
cluster's kernels and `local_append_update` old against new. Its old
directory holds the files of 288c153 (as for `ab`).

`tick` times `heartbeat_tick` at chip_smoke phase 2's tick shape (G =
50,000, R = 8, M = 131,072) and at the live Raft layer's call shape
(phase 12: G_LIVE rows, a bucket of M_LIVE replies; by default 8,192 and
1,024), on chip_smoke's inputs for each: the old tree's launch sequence
(its cooperative fold, then its sweep); this tree's pair with its sweep
kernel launched by programmatic dependent launch (`pdl`), back to back
(`plain`: the `back_to_back` copy), and each captured in a CUDA graph
and replayed (`graph_pdl`, `graph`); copies of this tree's pair with one
change each (`TICK_VARIANTS`, launched by PDL); this tree's two kernels alone and
empty kernels at their grids, alone and as a pair by PDL and back to
back (`TICK_EXTRAS`, appended to its quorum.cu).
Every side is first held exactly against the plain chain; then all in
turns (each side, then the same in reverse). Its old directory holds
the files of c5806f4 (as for `ab`).

Every library is built under .chipcheck/quorum (git-ignored) with
`-Xptxas -v` (registers and spills printed and kept); results are
printed and written to OUT_DIR/quorum_<mode>.json (default .chipcheck/).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as cs
from redpanda_tpu_torch.ops import _build
from redpanda_tpu_torch.ops import health as health_ops
from redpanda_tpu_torch.ops import quorum as quorum_ops

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chipcheck", "quorum")
OUT = os.path.join(REPO, ".chipcheck")
MESH_BUCKET = 8192

# Appended to this tree's quorum.cu for the breakdown: an empty kernel,
# launched plainly or cooperatively with `syncs` grid barriers.
EXTRAS = r"""
__global__ void rp_empty_kernel(int) {}
__global__ void rp_empty_sync_kernel(int syncs) {
    for (int i = 0; i < syncs; ++i) cooperative_groups::this_grid().sync();
}

extern "C" {

int rp_empty_shape(i64 blocks, i64 threads, i64 coop, i64 syncs, void* stream) {
    int n = (int)syncs;
    void* args[1] = {&n};
    if (!coop) {
        rp_empty_kernel<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(0);
        return (int)cudaGetLastError();
    }
    return (int)cudaLaunchCooperativeKernel((const void*)rp_empty_sync_kernel, dim3((unsigned)blocks),
                                            dim3((unsigned)threads), args, 0, (cudaStream_t)stream);
}

}  // extern "C"
"""

# Appended to this tree's quorum.cu: the mesh frame's other design (A),
# one cooperative launch of the tick frame kernel's fold phase and sweep
# loop with each row's health and the fleet totals (grid_totals), and no
# heartbeat rows; the tree keeps the fold kernel and the mesh sweep
# kernel (B), which won.
MESH_COOP = r"""
template <int N, bool kAligned>
__global__ void __launch_bounds__(FRAME_THREADS)
mesh_coop_kernel(FrameLanes s, FrameReplies rp, FrameHealth hh, FrameTotals tt, i64 m, i64 g_n,
                 int r_n, int its) {
    extern __shared__ unsigned fresh_words[];
    const i64 warps = (i64)gridDim.x * (FRAME_THREADS / 32);
    const i64 first = ((i64)(threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 + (threadIdx.x & 31);
    const i64 stride = warps * 32;
    RowFlags f0 = {};
    bool known0 = false, active0 = false;
    if (first < g_n) {
        f0 = load_flags<N, kAligned>(s.term_start, s.is_leader, s.commit, s.last_visible,
                                     s.voter, s.voter_old, first, r_n);
        known0 = hh.leader_known[first] != 0;
        active0 = hh.active[first] != 0;
    }
    if (m > 0) {
#define RP_FOLD(RUNS)                                                                  \
    fold_phase<FRAME_THREADS, RUNS>(s.match, s.flushed, s.last_seq, rp.group_idx, rp.slot, \
                                    rp.dirty, rp.flushed, rp.seq, m, g_n, r_n, its,       \
                                    fresh_words)
        if (its == 1) RP_FOLD(1);
        else if (its == 2) RP_FOLD(2);
        else RP_FOLD(0);
#undef RP_FOLD
    }
    i64 t[T_N] = {0, 0, 0, 0, 0};
    for (i64 g = first; g < g_n; g += stride) {
        RowFlags f = f0;
        bool known = known0, active = active0;
        if (g != first) {
            f = load_flags<N, kAligned>(s.term_start, s.is_leader, s.commit, s.last_visible,
                                        s.voter, s.voter_old, g, r_n);
            known = hh.leader_known[g] != 0;
            active = hh.active[g] != 0;
        }
        i64 c;
        const HealthRow x = frame_row<N, kAligned>(s, hh, f, known, active, true, g, r_n, &c);
        count_row(t, x, c > f.commit, active);
    }
    grid_totals<T_N>(t, 1u << T_MAX_LAG, tt.acc, tt.ticket, tt.out);
}

static const void* mesh_coop_instance(i64 r_n, bool aligned) {
    if (r_n <= 8)
        return aligned ? (const void*)mesh_coop_kernel<8, true> : (const void*)mesh_coop_kernel<8, false>;
    if (r_n <= 16)
        return aligned ? (const void*)mesh_coop_kernel<16, true> : (const void*)mesh_coop_kernel<16, false>;
    return aligned ? (const void*)mesh_coop_kernel<32, true> : (const void*)mesh_coop_kernel<32, false>;
}

extern "C" {

int rp_mesh_coop_grid(i64 m, i64 g_n, i64 r_n, i64 aligned, i64* out) {
    CoopGrid grid;
    const cudaError_t e = frame_grid(m, g_n, mesh_coop_instance(r_n, aligned != 0), &grid);
    if (e == cudaSuccess) {
        out[0] = grid.blocks;
        out[1] = grid.threads;
        out[2] = grid.its;
    }
    return (int)e;
}

int rp_mesh_coop(const i64* term, const u8* is_leader, i64* commit, const i64* term_start,
                 i64* last_visible, i64* match, i64* flushed, i64* last_seq, const u8* voter,
                 const u8* voter_old, const i64* group_idx, const i64* slot, const i64* dirty,
                 const i64* flushed_in, const i64* seq, const u8* leader_known, const u8* active,
                 i64* max_lag, u8* under, u8* leaderless, i64* scratch, i64* totals, i64 m,
                 i64 g_n, i64 r_n, void* stream) {
    if (g_n <= 0) return 0;
    const void* kernel = mesh_coop_instance(r_n, aligned_rows(r_n, match, flushed, voter, voter_old));
    CoopGrid grid;
    cudaError_t e = frame_grid(m, g_n, kernel, &grid);
    if (e != cudaSuccess) return (int)e;
    FrameLanes s = {term, is_leader, commit, term_start, last_visible,
                    match, flushed, last_seq, voter, voter_old};
    FrameReplies rp = {group_idx, slot, dirty, flushed_in, seq};
    FrameHealth hh = {leader_known, active, max_lag, under, leaderless};
    FrameTotals tt = {scratch, (unsigned long long*)(scratch + TOTALS_SCRATCH - 1), totals};
    int rn = (int)r_n, its = grid.its;
    void* args[] = {&s, &rp, &hh, &tt, &m, &g_n, &rn, &its};
    e = cudaLaunchCooperativeKernel(kernel, dim3(grid.blocks), dim3(grid.threads), args,
                                    grid.smem, (cudaStream_t)stream);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

}  // extern "C"
"""

# this tree's quorum.cu with design A appended ("new"), and copies with
# another frame block size (design A at 128 and 512 threads)
# Appended to this tree's quorum.cu for `append`: pieces of the old local
# append at its grid (one append a thread), and this tree's launch at any
# count of row parts and block size.
APPEND_EXTRAS = r"""
// KIND: 0 nothing; 1 the three input loads (a store no input can reach
// keeps them); 2 match's atomics alone; 4 plain stores of both lanes;
// 6 the loads and both slots' reads, no write
template <int KIND>
__global__ void la_part_kernel(i64* __restrict__ match, i64* __restrict__ flushed, const i64* __restrict__ gi,
                               const i64* __restrict__ dv, const i64* __restrict__ fv, i64 m, i64 g_n, i64 r_n) {
    if (KIND == 0) return;
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const i64 k = scatter_cell(gi[i], 0, g_n, r_n);
    const i64 d = dv[i], f = fv[i];
    if (KIND == 1) {
        if (k == -7 && d == f) match[0] = d;
        return;
    }
    if (k < 0) return;
    if (KIND == 2) atomicMax(match + k, d);
    if (KIND == 4) {
        match[k] = d;
        flushed[k] = f;
    }
    if (KIND == 6) {
        const i64 a = __ldcg(match + k), b = __ldcg(flushed + k);
        if (a == -7 && b == d) match[0] = f;
    }
}

extern "C" int rp_la_piece(i64* match, i64* flushed, const i64* gi, const i64* dv, const i64* fv, i64 m,
                           i64 g_n, i64 r_n, i64 kind, void* stream) {
    if (m <= 0) return 0;
    const unsigned blocks = (unsigned)((m + THREADS - 1) / THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
#define LA_PART(K) la_part_kernel<K><<<blocks, THREADS, 0, st>>>(match, flushed, gi, dv, fv, m, g_n, r_n)
    switch (kind) {
        case 0: LA_PART(0); break;
        case 1: LA_PART(1); break;
        case 2: LA_PART(2); break;
        case 4: LA_PART(4); break;
        case 6: LA_PART(6); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// this tree's launch at another count of row parts (0: one append a
// thread) and block size
extern "C" int rp_la_parts(i64* match, i64* flushed, const i64* gi, const i64* dv, const i64* fv, i64 m, i64 g_n,
                           i64 r_n, i64 parts, i64 threads, void* stream) {
    if (m <= 0) return 0;
    return (int)launch_local_append(match, flushed, gi, dv, fv, m, g_n, r_n, parts, (unsigned)threads,
                                    (cudaStream_t)stream);
}
"""
# rp_la_piece's pieces of the old kernel
APPEND_PIECES = {0: "empty kernel at the old grid", 1: "the three input loads alone",
                6: "the loads and both slots' reads (__ldcg), no write", 2: "match's atomics alone",
                4: "plain stores in place of the atomics (wrong under duplicates)"}
# this tree's launch at these row parts (2 * parts passes; 0: one append a
# thread) and block sizes, and the batch sizes, as fractions of G, of the
# sweep by M
APPEND_ROW_PARTS = (0, 1, 2, 3, 4, 5, 6, 8)
APPEND_PART_THREADS = (128, 256, 512)
APPEND_SWEEP = (1 / 64, 1 / 16, 1 / 8, 1 / 4, 1 / 2, 1, 2)

NEW_VARIANTS = {
    "new": [],
    "coop_t128": [("#define FRAME_THREADS 256", "#define FRAME_THREADS 128")],
    "coop_t512": [("#define FRAME_THREADS 256", "#define FRAME_THREADS 512")],
}


FOLLOW_EXTRAS = r"""
// KIND: 0 nothing; 1 the three [G] lanes read, commit and visible written
// (commit = max(commit, leader_commit): the rule's stores without its
// column); 2 slot 0's column of flushed read on every row (a store no
// value reaches keeps the loads)
template <int KIND>
__global__ void fc_piece_kernel(i64* __restrict__ commit, i64* __restrict__ vis, const i64* __restrict__ flushed,
                                const i64* __restrict__ lc, i64 g_n, i64 r_n) {
    if (KIND == 0) return;
    const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= g_n) return;
    if (KIND == 1) {
        const i64 c = commit[g], l = lc[g], v = vis[g];
        commit[g] = c > l ? c : l;
        vis[g] = v > c ? v : c;
    }
    if (KIND == 2) {
        const i64 f = flushed[g * r_n];
        if (f == -0x7FFFFFFFFFFFFFF7LL) commit[g] = f;
    }
}

extern "C" int rp_fc_piece(i64* commit, i64* vis, const i64* flushed, const i64* lc, i64 g_n, i64 r_n, i64 kind,
                           void* stream) {
    if (g_n <= 0) return 0;
    const unsigned blocks = (unsigned)((g_n + THREADS - 1) / THREADS);
    const cudaStream_t st = (cudaStream_t)stream;
#define FC_PIECE(K) fc_piece_kernel<K><<<blocks, THREADS, 0, st>>>(commit, vis, flushed, lc, g_n, r_n)
    switch (kind) {
        case 0: FC_PIECE(0); break;
        case 1: FC_PIECE(1); break;
        case 2: FC_PIECE(2); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// the device's L2 fetch granularity hint (cudaLimitMaxL2FetchGranularity):
// `before` gets the current value, which becomes `bytes` unless it is < 0
extern "C" int rp_l2_fetch(i64 bytes, i64* before) {
    size_t v = 0;
    cudaError_t e = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
    if (e != cudaSuccess) return (int)e;
    *before = (i64)v;
    return bytes < 0 ? 0 : (int)cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
}
"""
FOLLOW_PIECES = {0: "old grid: empty kernel", 1: "old grid: the [G] lanes alone (read 3, write 2)",
                 2: "old grid: slot 0's column alone (every row)"}
# copies of this tree's quorum.cu with the follower kernel changed
FOLLOW_VARIANTS = {
    "rows 2": [("#define FOLLOW_ROWS 4", "#define FOLLOW_ROWS 2")],
    "rows 8": [("#define FOLLOW_ROWS 4", "#define FOLLOW_ROWS 8")],
    "column on every row": [("fl[k] = lc[k] > c[k] ? __ldcs(flushed + (g0 + k) * r_n) : 0;",
                             "fl[k] = g0 + k < g_n ? __ldcs(flushed + (g0 + k) * r_n) : 0;")],
    "every vector written": [("            if (moved) __stcs(", "            __stcs("),
                             ("            if (raised) __stcs(", "            __stcs(")],
    "column by __ldg": [("fl[k] = lc[k] > c[k] ? __ldcs(flushed + (g0 + k) * r_n) : 0;",
                         "fl[k] = lc[k] > c[k] ? __ldg(flushed + (g0 + k) * r_n) : 0;")],
}


# Appended to this tree's quorum.cu for `tick`: the heartbeat tick's
# fold kernel alone (part 0) or its sweep kernel with the last_seq raise
# alone (part 1, an ordinary launch), with rp_heartbeat_tick's arguments
TICK_EXTRAS = r"""
extern "C" int rp_tick_part(const i64* term, const u8* is_leader, i64* commit,
                            const i64* term_start, i64* last_visible, i64* match, i64* flushed,
                            i64* last_seq, const u8* voter, const u8* voter_old,
                            const i64* group_idx, const i64* slot, const i64* dirty,
                            const i64* flushed_in, const i64* seq, i64 m, i64 g_n, i64 r_n,
                            i64 part, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (part == 0) {
        tick_fold_kernel<<<(unsigned)((m + THREADS - 1) / THREADS), THREADS, 0, s>>>(
            match, flushed, last_seq, group_idx, slot, dirty, flushed_in, seq, m, g_n, r_n, 0);
        return (int)cudaGetLastError();
    }
    const i64 per_block = (i64)COMMIT_THREADS * TICK_RAISE;
    i64 blocks = (g_n + COMMIT_THREADS - 1) / COMMIT_THREADS;
    if ((m + per_block - 1) / per_block > blocks) blocks = (m + per_block - 1) / per_block;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(COMMIT_THREADS);
    cfg.stream = s;
    const cudaError_t e = launch_tick_sweep(&cfg, term_start, is_leader, commit, last_visible,
                                            match, flushed, voter, voter_old, last_seq,
                                            group_idx, slot, seq, m, g_n, r_n);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

// the launch floor of the pair: an empty K1 that lets its dependents
// launch, then an empty K2 that waits for it, by PDL (pdl) or back to back
__global__ void rp_empty_trigger_kernel(int) { launch_dependents(); }
__global__ void rp_empty_wait_kernel(int) { wait_prerequisites(); }

extern "C" int rp_empty_pair(i64 b1, i64 t1, i64 b2, i64 t2, i64 pdl, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    rp_empty_trigger_kernel<<<(unsigned)b1, (unsigned)t1, 0, s>>>(0);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)b2);
    cfg.blockDim = dim3((unsigned)t2);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, rp_empty_wait_kernel, 0);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}
"""
# the tick's kernels alone (rp_tick_part's parts)
TICK_PARTS = {"fold kernel alone": 0, "sweep kernel alone (with the raise)": 1}
# copies of this tree's quorum.cu with the pair changed, each timed as a
# side of `tick` (PDL): the fold kernel reading match and flushed beside
# last_seq and raising only what exceeds them; letting its dependents
# launch at its start, or after its loads, whatever its grid; at
# 128-thread blocks; the sweep kernel raising last_seq before it sweeps
# its row
_K1_ATOMICS = """    const bool fresh = k >= 0 && sq > last_seq[k];
    if (!early) launch_dependents();
    if (fresh) {
        atomicMax(&match[k], d);
        atomicMax(&flushed[k], fl);
    }"""
_K2_TAIL = """    i64 cur[TICK_RAISE];
#pragma unroll
    for (int s = 0; s < TICK_RAISE; ++s) cur[s] = k[s] >= 0 ? last_seq[k[s]] : sq[s];
    if (t < g_n) {
        i64 row[N];
        sweep_row<N, kAligned>(f, commit, last_visible, match, flushed, t, r_n, row);
    }
#pragma unroll
    for (int s = 0; s < TICK_RAISE; ++s)
        if (sq[s] > cur[s]) atomicMax(&last_seq[k[s]], sq[s]);"""
_K2_BODY = """    const i64 t = (i64)blockIdx.x * COMMIT_THREADS + threadIdx.x;
    const i64 stride = (i64)gridDim.x * COMMIT_THREADS;
    // the prologue: only what K1 never writes
    RowFlags f = {};
    if (t < g_n)
        f = load_flags<N, kAligned>(term_start, is_leader, commit, last_visible, voter,
                                    voter_old, t, r_n);
    i64 k[TICK_RAISE], sq[TICK_RAISE];"""
_K2_GRID = """    i64 blocks = (g_n + COMMIT_THREADS - 1) / COMMIT_THREADS;
    if ((m + per_block - 1) / per_block > blocks) blocks = (m + per_block - 1) / per_block;"""
TICK_VARIANTS = {
    # the pair launched back to back (no PDL attribute on the sweep kernel)
    "back_to_back": [("    cfg.numAttrs = m > 0 ? 1 : 0;", "    cfg.numAttrs = 0;")],
    # the sweep kernel's rows and its raise in separate blocks: the first
    # ceil(G / 128) blocks sweep, the rest raise TICK_RAISE replies a thread
    "k2_raise_blocks": [
        (_K2_BODY, """    const i64 row_blocks = (g_n + COMMIT_THREADS - 1) / COMMIT_THREADS;
    if ((i64)blockIdx.x < row_blocks) {
        const i64 g = (i64)blockIdx.x * COMMIT_THREADS + threadIdx.x;
        RowFlags f0 = {};
        if (g < g_n)
            f0 = load_flags<N, kAligned>(term_start, is_leader, commit, last_visible, voter,
                                         voter_old, g, r_n);
        wait_prerequisites();
        if (g < g_n) {
            i64 row[N];
            sweep_row<N, kAligned>(f0, commit, last_visible, match, flushed, g, r_n, row);
        }
        return;
    }
    const i64 t = ((i64)blockIdx.x - row_blocks) * COMMIT_THREADS + threadIdx.x;
    const i64 stride = ((i64)gridDim.x - row_blocks) * COMMIT_THREADS;
    i64 k[TICK_RAISE], sq[TICK_RAISE];"""),
        (_K2_TAIL, """    i64 cur[TICK_RAISE];
#pragma unroll
    for (int s = 0; s < TICK_RAISE; ++s) cur[s] = k[s] >= 0 ? last_seq[k[s]] : sq[s];
#pragma unroll
    for (int s = 0; s < TICK_RAISE; ++s)
        if (sq[s] > cur[s]) atomicMax(&last_seq[k[s]], sq[s]);"""),
        (_K2_GRID, """    const i64 blocks = (g_n + COMMIT_THREADS - 1) / COMMIT_THREADS + (m + per_block - 1) / per_block;"""),
    ],
    # 64-thread blocks for the sweep kernel (and the sweeps it shares the
    # constant with, unused here)
    "k2_t64": [("#define COMMIT_THREADS 128", "#define COMMIT_THREADS 64")],
    # two replies a thread of the sweep kernel
    "k2_raise2": [("#define TICK_RAISE 4", "#define TICK_RAISE 2")],
    "k1_reads_first": [(_K1_ATOMICS, """    i64 ls = 0, cm = 0, cf = 0;
    if (k >= 0) {
        ls = last_seq[k];
        cm = match[k];
        cf = flushed[k];
    }
    const bool fresh = k >= 0 && sq > ls;
    if (!early) launch_dependents();
    if (fresh) {
        if (d > cm) atomicMax(&match[k], d);
        if (fl > cf) atomicMax(&flushed[k], fl);
    }""")],
    "k1_trigger_first": [("        const int early = blocks <= sms;", "        const int early = 1;")],
    "k1_trigger_late": [("        const int early = blocks <= sms;", "        const int early = 0;")],
    "k1_t128": [
        ("__global__ void __launch_bounds__(THREADS)\ntick_fold_kernel(",
         "__global__ void __launch_bounds__(128)\ntick_fold_kernel("),
        ("    const i64 i = (i64)blockIdx.x * THREADS + threadIdx.x;\n    i64 k = -1, sq = 0, d = 0, fl = 0;",
         "    const i64 i = (i64)blockIdx.x * 128 + threadIdx.x;\n    i64 k = -1, sq = 0, d = 0, fl = 0;"),
        ("        const i64 blocks = (m + THREADS - 1) / THREADS;", "        const i64 blocks = (m + 127) / 128;"),
        ("        tick_fold_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(",
         "        tick_fold_kernel<<<(unsigned)blocks, 128, 0, s>>>("),
    ],
    "k2_raise_first": [(_K2_TAIL, """    i64 cur[TICK_RAISE];
#pragma unroll
    for (int s = 0; s < TICK_RAISE; ++s) cur[s] = k[s] >= 0 ? last_seq[k[s]] : sq[s];
#pragma unroll
    for (int s = 0; s < TICK_RAISE; ++s)
        if (sq[s] > cur[s]) atomicMax(&last_seq[k[s]], sq[s]);
    if (t < g_n) {
        i64 row[N];
        sweep_row<N, kAligned>(f, commit, last_visible, match, flushed, t, r_n, row);
    }""")],
}


def bind_coop(lib):
    """Bind design A's entry points on a library built with MESH_COOP."""
    _build.bind(lib, "rp_mesh_coop", 22, 3)
    lib.rp_mesh_coop_grid.argtypes = [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    lib.rp_mesh_coop_grid.restype = ctypes.c_int
    return lib


def coop_grid(m: int, g: int, r: int) -> tuple:
    """Design A's cooperative grid on the bound library: (blocks, threads, runs)."""
    lib = quorum_ops._lib()
    out = (ctypes.c_int64 * 3)()
    _build.check(lib, lib.rp_mesh_coop_grid(m, g, r, int(r % 8 == 0), ctypes.addressof(out)), "coop grid")
    return tuple(int(x) for x in out)


def mesh_coop(state, replies, known, active):
    """Design A through the bound library, as launch_mesh_frame returns."""
    import torch

    g, r = state.match_index.shape
    dev = state.match_index.device
    health = quorum_ops._health_lanes(g, dev)
    totals = torch.empty(quorum_ops.N_TOTALS, dtype=torch.int64, device=dev)
    stream = _build.stream_of(state.match_index)
    lib = quorum_ops._lib()
    rc = lib.rp_mesh_coop(*(getattr(state, k).data_ptr() for k in quorum_ops.LANE_ORDER),
                          *(t.data_ptr() for t in replies), known.data_ptr(), active.data_ptr(),
                          *(health[k].data_ptr() for k in quorum_ops.HEALTH_KEYS),
                          quorum_ops._totals_scratch(dev, stream).data_ptr(), totals.data_ptr(),
                          replies[0].shape[0], g, r, stream)
    _build.check(lib, rc, "mesh frame, design A")
    return state, health, totals


def nvcc(name: str, src: str, include: str) -> tuple:
    path = os.path.join(WORK, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = os.path.join(WORK, f"lib{name}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, "-Xptxas", "-v", "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {name}:\n{r.stderr[-3000:]}")
    info = [ln.strip() for ln in r.stderr.splitlines()
            if "registers" in ln or "Compiling entry" in ln or "bytes stack" in ln]
    return name, so, info


def build(sources: dict, ptxas: dict) -> dict:
    """{name: (source, include dir)} -> {name: CDLL}, one nvcc each, in
    parallel; each library's -Xptxas -v lines go into `ptxas`."""
    os.makedirs(WORK, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda kv: nvcc(kv[0], *kv[1]), sources.items()))
    libs = {}
    for name, so, info in built:
        for ln in info:
            print(f"[ptxas] {name}: {ln}", flush=True)
        ptxas[name] = info
        libs[name] = ctypes.CDLL(so)
        libs[name].rp_error_string.restype = ctypes.c_char_p
        libs[name].rp_error_string.argtypes = [ctypes.c_int]
    return libs


def patched(src: str, patches: list, name: str) -> str:
    for a, b in patches:
        if src.count(a) != 1:
            raise AssertionError(f"variant {name}: patch does not apply once: {a[:60]!r}")
        src = src.replace(a, b)
    return src


def old_libs(old_dir: str, extra: dict, ptxas: dict) -> dict:
    """The old tree's quorum, health and cluster libraries plus `extra`
    sources (this tree's quorum.cu and its variants, bound with this
    tree's argument lists), built together; the old ones bound with this
    tree's argument lists for their shared entry points."""
    from redpanda_tpu_torch.parallel import cluster_step as cluster_ops

    sources = {f"old_{n}": (open(os.path.join(old_dir, f"{n}.cu")).read(), old_dir)
               for n in ("quorum", "health", "cluster")}
    libs = build({**sources, **extra}, ptxas)
    old = libs["old_quorum"]
    for fn, ptrs, sizes in (("rp_fold_replies", 8, 3), ("rp_commit_step", 8, 2),
                            ("rp_build_heartbeats", 9, 3), ("rp_tick_frame", 25, 4)):
        _build.bind(old, fn, ptrs, sizes)
    old.rp_fold_grid.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    health_ops.bind(libs["old_health"])
    for lib in (libs["old_cluster"], cluster_ops._lib()):
        _build.bind(lib, "rp_cluster_tick", 18, 3)
        _build.bind(lib, "rp_election_round", 9, 4)
    for name in extra:
        bind_coop(quorum_ops.bind(libs[name]))
    _build.build_all(("quorum", "health", "cluster"))
    quorum_ops._lib()
    health_ops._lib()
    return libs


def time_us(fn, reset=None, reps: int = 30) -> float:
    return cs.time_kernel(fn, reset, reps=reps) * 1e3


def mesh_fields(g: int, r: int, seed: int) -> dict:
    """Lanes drawn as chip_smoke.mesh_lanes draws the mesh bench's shard
    (SELF always a current voter, a quarter of the rows in joint
    consensus, every row a leader), with last_seq below the window's."""
    rng = np.random.default_rng(seed)
    match = rng.integers(-1, 400, (g, r)).astype(np.int64)
    voter = rng.random((g, r)) < 0.6
    voter[:, 0] = True
    old = np.zeros((g, r), bool)
    joint = rng.random(g) < 0.25
    old[joint] = rng.random((int(joint.sum()), r)) < 0.5
    commit = rng.integers(-1, 200, g).astype(np.int64)
    return {
        "term": np.ones(g, np.int64),
        "is_leader": np.ones(g, bool),
        "commit_index": commit,
        "term_start": rng.integers(0, 300, g).astype(np.int64),
        "last_visible": commit.copy(),
        "match_index": match,
        "flushed_index": np.maximum(match - rng.integers(0, 40, (g, r)), -1),
        "is_voter": voter,
        "is_voter_old": old,
        "last_seq": rng.integers(0, 13, (g, r)).astype(np.int64),
    }


class Shape:
    """A state (base and work copies), a padded reply batch, heartbeat
    rows and the two health flags on the card."""

    def __init__(self, torch, label, fields, replies, rng):
        from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy

        self.label = label
        self.base = group_state_from_numpy(fields, "cuda")
        self.work = group_state_from_numpy(fields, "cuda")
        self.replies = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in replies]
        self.none = [t[:0] for t in self.replies]
        self.m = len(replies[0])
        self.g, self.r = fields["match_index"].shape
        self.hb = torch.from_numpy(rng.permutation(self.g)[: min(cs.H_ROWS, self.g)].astype(np.int64)).cuda()
        self.known = torch.from_numpy(rng.random(self.g) < 0.5).cuda()
        self.active = torch.from_numpy(rng.random(self.g) < 0.95).cuda()
        self.stream = _build.stream_of(self.replies[0])

    def reset(self):
        for a, b in zip(self.work, self.base):
            a.copy_(b)

    def health(self):
        w = self.work
        return health_ops.health_reduce(w.match_index, w.commit_index, w.is_voter, w.is_voter_old,
                                        w.is_leader, self.known, self.active)

    def health_plain(self):
        w = self.work
        return health_ops.health_reduce_plain(w.match_index, w.commit_index, w.is_voter, w.is_voter_old,
                                              w.is_leader, self.known, self.active)

    def frame(self, replies, hb, health=True):
        """The frame kernel through launch_frame: `replies` or none (m = 0),
        `hb` or none (h = 0), health or not."""
        return lambda: quorum_ops.launch_frame(self.work, replies, hb,
                                               *((self.known, self.active) if health else ()))

    def mesh(self, replies, coop=False):
        """The mesh frame: this tree's (the fold kernel and the mesh sweep
        kernel, launch_mesh_frame) or design A (one cooperative launch)."""
        return lambda: (mesh_coop if coop else quorum_ops.launch_mesh_frame)(
            self.work, replies, self.known, self.active)

    def mesh_plain(self, replies):
        return lambda: cs.mesh_frame_plain(self.work, replies, self.known, self.active)

    def mesh_old(self):
        """The old tree's mesh frame: the copy of the commit lane, the fold,
        the sweep and health_totals (its two zero fills and fold_blocks)."""
        w = self.work

        def run():
            before = w.commit_index.clone()
            quorum_ops.quorum_commit_step(quorum_ops.fold_replies(w, *self.replies))
            return health_ops.health_totals(w.match_index, w.commit_index, w.is_voter, w.is_voter_old,
                                            w.is_leader, self.known, self.active, cs.MESH_D, before=before)
        return run


def shapes(torch) -> dict:
    rng = np.random.default_rng(cs.SEED)
    fields = cs.random_state_fields(rng, cs.G, cs.R)
    out = {"tick": Shape(torch, "tick", fields, cs.padded_replies(rng, cs.G, cs.R, cs.M_REPLIES), rng)}
    fields = mesh_fields(cs.MESH_G, cs.R, cs.SEED + 9)
    window = cs.mesh_window(np.random.default_rng(cs.SEED + 13), np.arange(cs.MESH_G), MESH_BUCKET, 13, cs.R)
    out["mesh"] = Shape(torch, "mesh", fields, cs.padded_window(window), rng)
    return out


def tensors(x) -> list:
    """Every tensor in a wrapper's result, in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x.clone()]
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in tensors(y)]
    return []


def same(a: list, b: list, what: str) -> None:
    import torch

    if len(a) != len(b) or any(x.shape != y.shape or not torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what} differs")


def mesh_outputs(x) -> list:
    """A mesh frame's health lanes and totals, whichever side returned
    them (the state is compared from the work lanes)."""
    if isinstance(x, list):  # mesh_frame_plain: [state, health, {"totals"}]
        return tensors(x[1]) + tensors(x[2]["totals"])
    if len(x) == 3:  # launch_mesh_frame: (state, health, totals)
        return tensors(x[1]) + tensors(x[2])
    return tensors(x[0]) + tensors(x[1])  # health_totals: (health, totals)


class Sides:
    """Runs a function with the wrappers bound to one side's libraries."""

    def __init__(self, quorum: dict, health: dict, cluster: dict):
        from redpanda_tpu_torch.parallel import cluster_step as cluster_ops

        self.cluster_ops = cluster_ops
        self.quorum, self.health, self.cluster = quorum, health, cluster
        self.home = (quorum_ops._LIB, health_ops._LIB, cluster_ops._LIB)

    def run(self, side, fn):
        quorum_ops._LIB = self.quorum[side]
        health_ops._LIB = self.health[side]
        self.cluster_ops._LIB = self.cluster[side]
        try:
            return fn()
        finally:
            quorum_ops._LIB, health_ops._LIB, self.cluster_ops._LIB = self.home


def tick_items(shp) -> dict:
    """name -> (the call, or {side: call}, and the plain chain), at the
    tick's shape."""
    w, rep, hb = shp.work, shp.replies, shp.hb

    def plain_frame(health):
        def run():
            quorum_ops.quorum_commit_step_plain(quorum_ops.fold_replies_plain(w, *rep))
            beats = quorum_ops.build_heartbeats_plain(w, hb)
            return (beats, shp.health_plain()) if health else beats
        return run

    def frame(health):
        def run():
            _, beats, lanes = shp.frame(rep, hb, health)()
            return (beats, lanes) if health else beats
        return run

    return {
        "fold_replies": (lambda: quorum_ops.fold_replies(w, *rep), lambda: quorum_ops.fold_replies_plain(w, *rep)),
        "quorum_commit_step": (lambda: quorum_ops.quorum_commit_step(w),
                               lambda: quorum_ops.quorum_commit_step_plain(w)),
        "health_reduce": (shp.health, shp.health_plain),
        # the old tree has no rp_heartbeat_tick: its tick is the fold, then the sweep
        "heartbeat_tick": ({"old": lambda: quorum_ops.quorum_commit_step(quorum_ops.fold_replies(w, *rep)),
                            "new": lambda: quorum_ops.heartbeat_tick(w, *rep)},
                           lambda: quorum_ops.heartbeat_tick_plain(w, *rep)),
        "tick_frame": (frame(False), plain_frame(False)),
        "tick_frame_health": (frame(True), plain_frame(True)),
    }


def mesh_items(shp) -> dict:
    """name -> ({side: call}, the plain chain), at the mesh shape. The
    mesh frame's sides: the old sequence, this tree's (the fold kernel,
    then the sweep kernel) and design A at each block size."""
    w, rep = shp.work, shp.replies
    hargs = (w.match_index, w.commit_index, w.is_voter, w.is_voter_old, w.is_leader, shp.known, shp.active,
             cs.MESH_D)
    before = shp.base.commit_index

    def shared(fn):
        return {"old": fn, "new": fn}

    return {
        "fold_replies": (shared(lambda: quorum_ops.fold_replies(w, *rep)),
                         lambda: quorum_ops.fold_replies_plain(w, *rep)),
        "quorum_commit_step": (shared(lambda: quorum_ops.quorum_commit_step(w)),
                               lambda: quorum_ops.quorum_commit_step_plain(w)),
        "health_totals": (shared(lambda: health_ops.health_totals(*hargs, before=before)),
                          lambda: health_ops.health_totals_plain(*hargs, before=before)),
        "mesh_tick_frame": ({"old": shp.mesh_old(), "new": shp.mesh(rep),
                             **{COOP_SIDES[n]: shp.mesh(rep, coop=True) for n in NEW_VARIANTS}},
                            shp.mesh_plain(rep)),
    }


# design A's side of each library
COOP_SIDES = {"new": "coop", "coop_t128": "coop_t128", "coop_t512": "coop_t512"}


def held(sides, shp, name, fns: dict, plain=None, outputs=tensors) -> None:
    """Every side's outputs and lanes equal to the old side's, and the
    new side's to the plain chain's."""
    outs = {}
    first = next(iter(fns))
    for side, fn in fns.items():
        shp.reset()
        outs[side] = outputs(sides.run(side, fn)) + tensors(shp.work)
        same(outs[side], outs[first], f"{shp.label} {name}: {side} vs {first}")
    if plain is not None:
        shp.reset()
        new = "new" if "new" in outs else first
        same(outs[new], outputs(plain()) + tensors(shp.work), f"{shp.label} {name}: {new} vs plain")


def in_turns(sides, shp, fns: dict, t: dict, prefix: str = "") -> None:
    order = list(fns)
    for side in order + order[::-1]:
        t.setdefault(f"{prefix}{side}", []).append(time_us(lambda: sides.run(side, fns[side]), shp.reset))


def empties(lib, shp, frame: tuple) -> dict:
    """Empty kernels at the sweep kernel's shape and, cooperative, at the
    frame's grid with 0 and 1 grid barriers."""
    _build.bind(lib, "rp_empty_shape", 0, 4)
    blocks, threads, _ = frame
    sweep_blocks = -(-shp.g // (128 * 4))
    shapes_ = [
        (f"128 x {sweep_blocks} (a plain launch at the mesh sweep kernel's shape)", sweep_blocks, 128, 0, 0),
        (f"cooperative {threads} x {blocks} (the frame's grid), no barrier", blocks, threads, 1, 0),
        (f"cooperative {threads} x {blocks}, one grid barrier", blocks, threads, 1, 1),
    ]
    out = {}
    for label, b, th, coop, syncs in shapes_:
        out[label] = time_us(lambda: _build.check(lib, lib.rp_empty_shape(b, th, coop, syncs, shp.stream), "empty"))
    return out


def breakdown(torch, old_dir: str) -> dict:
    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    ptxas = {}
    libs = old_libs(old_dir, {"new": (new_src + EXTRAS + MESH_COOP, _build.CSRC_DIR)}, ptxas)
    sides = Sides({"old": libs["old_quorum"], "new": libs["new"]},
                  {"old": libs["old_health"], "new": health_ops._lib()},
                  {"old": libs["old_cluster"], "new": libs["old_cluster"]})
    res = {"card": cs.nvidia_smi(), "clocks": clocks(), "ptxas": ptxas}
    shp = shapes(torch)["mesh"]
    w, rep, none, no_hb = shp.work, shp.replies, shp.none, shp.hb[:0]
    frame = sides.run("new", lambda: coop_grid(shp.m, shp.g, shp.r))
    items = mesh_items(shp)
    for name, (fns, plain) in items.items():
        held(sides, shp, name, {"old": fns["old"], "new": fns["new"]}, plain,
             mesh_outputs if name in ("health_totals", "mesh_tick_frame") else tensors)

    def chain(fold, health=True):
        def run():
            if fold:
                quorum_ops.fold_replies_plain(w, *rep)
            quorum_ops.quorum_commit_step_plain(w)
            return [shp.health_plain()] if health else []
        return run

    def cut(replies, health=True):
        def run():
            _, _, lanes = shp.frame(replies, no_hb, health)()
            return [lanes] if health else []
        return run

    def totals_cut(replies, coop):
        def run():
            _, lanes, totals = shp.mesh(replies, coop)()
            return [lanes, totals]
        return run

    def totals_chain(fold):
        def run():
            before = w.commit_index.clone()
            if fold:
                quorum_ops.fold_replies_plain(w, *rep)
            quorum_ops.quorum_commit_step_plain(w)
            return list(health_ops.health_totals_plain(w.match_index, w.commit_index, w.is_voter, w.is_voter_old,
                                                       w.is_leader, shp.known, shp.active, 1, before=before))
        return run

    cuts = {
        "tick frame kernel (H = 0): sweep alone (m = 0, no health)": (cut(none, False), chain(False, False)),
        "tick frame kernel (H = 0): sweep + health (m = 0)": (cut(none), chain(False)),
        "tick frame kernel (H = 0): fold, barrier, sweep + health": (cut(rep), chain(True)),
        "A: sweep + health + totals (m = 0)": (totals_cut(none, True), totals_chain(False)),
        "A: whole (fold, barrier, sweep + health + totals)": (totals_cut(rep, True), totals_chain(True)),
        "B: the fold kernel alone": (lambda: quorum_ops.fold_replies(w, *rep),
                                    lambda: quorum_ops.fold_replies_plain(w, *rep)),
        "B: the mesh sweep kernel alone (health + totals, m = 0)": (totals_cut(none, False), totals_chain(False)),
        "B: whole (the fold kernel, then the mesh sweep kernel)": (totals_cut(rep, False), totals_chain(True)),
    }
    for name, (fn, plain) in cuts.items():
        shp.reset()
        got = tensors(sides.run("new", fn)) + tensors(w)
        shp.reset()
        same(got, tensors(plain()) + tensors(w), f"{name} vs plain")
    old_parts = {
        "old: the copy of the commit lane": lambda: w.commit_index.clone(),
        "old: two [D, 5] / [5] zero fills": lambda: (torch.zeros((cs.MESH_D, 5), dtype=torch.int64, device="cuda"),
                                                    torch.zeros(5, dtype=torch.int64, device="cuda")),
        **{f"old: {name}": items[name][0]["old"] for name in items},
    }
    fns = {name: (lambda fn=fn: sides.run("old", fn)) for name, fn in old_parts.items()}
    fns.update({name: (lambda fn=fn: sides.run("new", fn)) for name, (fn, _) in cuts.items()})
    t = {}
    for turn in range(2):
        for name in (list(fns) if turn == 0 else list(fns)[::-1]):
            t.setdefault(name, []).append(time_us(fns[name], shp.reset))
    res["mesh"] = {"G": shp.g, "R": shp.r, "D": cs.MESH_D, "M": shp.m, "frame grid": frame,
                   "us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t,
                   "empty us": empties(libs["new"], shp, frame)}
    print("mesh", json.dumps(res["mesh"]), flush=True)
    return res


def ab(torch, old_dir: str) -> dict:
    from redpanda_tpu_torch.parallel import cluster_step as cluster_ops

    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    ptxas = {}
    libs = old_libs(old_dir, {name: (patched(new_src + MESH_COOP, p, name), _build.CSRC_DIR)
                              for name, p in NEW_VARIANTS.items()}, ptxas)
    quorum_libs = {"new": libs["new"], **{COOP_SIDES[n]: libs[n] for n in NEW_VARIANTS}}
    sides = Sides({"old": libs["old_quorum"], **quorum_libs},
                  {"old": libs["old_health"], **{n: health_ops._lib() for n in quorum_libs}},
                  {"old": libs["old_cluster"], **{n: cluster_ops._lib() for n in quorum_libs}})
    res = {"card": cs.nvidia_smi(), "clocks": clocks(), "ptxas": ptxas}
    for label, shp in shapes(torch).items():
        r = {"G": shp.g, "R": shp.r, "M": shp.m, "H": len(shp.hb) if label == "tick" else 0,
             "fold grid (blocks, threads, runs)": quorum_ops.fold_grid(shp.m)}
        if label == "tick":
            r["frame grid (blocks, threads, runs)"] = quorum_ops.frame_grid(shp.m, shp.g, shp.r, len(shp.hb))
            items = {name: (fn if isinstance(fn, dict) else {"old": fn, "new": fn}, plain)
                     for name, (fn, plain) in tick_items(shp).items()}
        else:
            r["D"] = cs.MESH_D
            r["design A grid (blocks, threads, runs)"] = {
                n: sides.run(n, lambda: coop_grid(shp.m, shp.g, shp.r)) for n in COOP_SIDES.values()}
            items = mesh_items(shp)
        t = {}
        for name, (fns, plain) in items.items():
            held(sides, shp, name, fns, plain,
                 mesh_outputs if name in ("health_totals", "mesh_tick_frame") else tensors)
            in_turns(sides, shp, fns, t, f"{name} ")
        r["us"] = {k: float(np.mean(v)) for k, v in t.items()}
        r["us turns"] = t
        res[label] = r
        print(label, json.dumps(r), flush=True)
    res["cluster"] = cluster_ab(torch, sides)
    return res


def cluster_ab(torch, sides) -> dict:
    """The ring cluster's kernels at 1M groups over 8 blocks, old and new
    in turns, exact against each other and the plain versions."""
    cluster_ops = sides.cluster_ops
    rng = np.random.default_rng(cs.SEED + 22)
    fields = cs.cluster_fields(rng, cs.CLUSTER_G)
    base, work = cs.cluster_state(fields, "cuda"), cs.cluster_state(fields, "cuda")
    g = cs.CLUSTER_G

    def reset():
        for a, b in zip(work.leader, base.leader):
            a.copy_(b)
        for k in cs.MIRROR_LANES:
            getattr(work, k).copy_(getattr(base, k))

    new_dirty = torch.where(torch.from_numpy(rng.random(g) < 0.3).cuda(), -1,
                            base.leader.match_index[:, 0] + torch.from_numpy(rng.integers(0, 4, g)).cuda())
    mask = torch.from_numpy(rng.random(g) < 0.01).cuda()

    def lanes():
        return tensors(work.leader) + [getattr(work, k).clone() for k in cs.MIRROR_LANES]

    items = {
        "cluster_tick": (lambda: cluster_ops.cluster_tick(work, new_dirty, cs.MESH_D),
                         lambda: cluster_ops.cluster_tick_plain(work, new_dirty, cs.MESH_D)),
        "election_round": (lambda: cluster_ops.election_round(work, mask, 1, cs.MESH_D),
                           lambda: cluster_ops.election_round_plain(work, mask, 1, cs.MESH_D)),
    }
    r = {"G": g, "D": cs.MESH_D}
    for name, (fn, plain) in items.items():
        outs = {}
        for side in ("old", "new"):
            reset()
            outs[side] = tensors(sides.run(side, fn)[1:]) + lanes()
        reset()
        want = tensors(plain()[1:]) + lanes()
        same(outs["new"], outs["old"], f"cluster {name}: new vs old")
        same(outs["new"], want, f"cluster {name}: new vs plain")
    t = {}
    for name, (fn, _) in items.items():
        for side in ("old", "new", "new", "old"):
            t.setdefault(f"{name} {side}", []).append(time_us(lambda: sides.run(side, fn), reset))
    r["us"] = {k: float(np.mean(v)) for k, v in t.items()}
    r["us turns"] = t
    print("cluster", json.dumps(r), flush=True)
    return r


def append_batch(torch, rng, base, m: int) -> tuple:
    """m appends as chip_smoke phase 10 draws them: rows at random, dirty
    from -3 to +7 around the row's slot 0, flushed up to 2 below."""
    g = base.match_index.shape[0]
    rows = torch.from_numpy(rng.integers(0, g, m)).cuda()
    app = base.match_index[:, 0][rows] + torch.from_numpy(rng.integers(-3, 8, m)).cuda()
    return rows, app, app - torch.from_numpy(rng.integers(0, 3, m)).cuda()


def append_inputs(torch) -> dict:
    """The leader lanes of the cluster state at G = 1M (R = 8) and the
    append batches: chip_smoke phase 10's (M = G), one whose appends each
    exceed their slot's value, a short batch that mixes rows -1, -G,
    -G - 1, G and G + 5 with duplicates, and phase 10's draw at the sweep's
    sizes."""
    from redpanda_tpu_torch.models.consensus_state import GroupState

    rng = np.random.default_rng(cs.SEED + 12)
    g = cs.CLUSTER_G
    base = cs.cluster_state(cs.cluster_fields(rng, g), "cuda").leader
    lead = GroupState(*(t.clone() for t in base))
    phase10 = append_batch(torch, rng, base, g)
    rows = phase10[0]
    raise_all = (base.match_index[:, 0][rows] + torch.from_numpy(rng.integers(1, 9, g)).cuda(),
                 base.flushed_index[:, 0][rows] + torch.from_numpy(rng.integers(1, 9, g)).cuda())
    odd = np.array([-1, -g, -g - 1, g, g + 5, 7, 7, -1, 3], np.int64)
    mixed = torch.from_numpy(np.concatenate([odd, rng.integers(0, g, 5000)])).cuda()
    mixed_d = torch.from_numpy(rng.integers(-5, 60, mixed.numel())).cuda()
    return {
        "g": g, "r": base.match_index.shape[1], "base": base, "lead": lead,
        "distinct": int(torch.unique(rows).numel()),
        "batches": {"phase 10": phase10, "each raises": (rows, *raise_all), "mixed rows": (mixed, mixed_d, mixed_d - 1)},
        "sweep": {x: append_batch(torch, rng, base, int(g * x)) for x in APPEND_SWEEP},
    }


def append(torch, old_dir: str) -> dict:
    """The local append's breakdown and this tree's launch by row parts,
    each exact side held first, then old and this tree's entry in turns
    (module doc)."""
    from redpanda_tpu_torch.parallel import cluster_step as cluster_ops

    ptxas = {}
    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    libs = build({"old_quorum": (open(os.path.join(old_dir, "quorum.cu")).read(), old_dir),
                  "old_cluster": (open(os.path.join(old_dir, "cluster.cu")).read(), old_dir),
                  "new": (new_src + APPEND_EXTRAS, _build.CSRC_DIR)}, ptxas)
    _build.bind(libs["old_quorum"], "rp_local_append", 5, 3)
    _build.bind(libs["old_quorum"], "rp_follower_commit", 4, 2)
    quorum_ops.bind(libs["new"])
    _build.bind(libs["new"], "rp_la_piece", 5, 4)
    _build.bind(libs["new"], "rp_la_parts", 5, 5)
    _build.build_all(("quorum", "health", "cluster"))
    for lib in (libs["old_cluster"], cluster_ops._lib()):
        _build.bind(lib, "rp_cluster_tick", 18, 3)
        _build.bind(lib, "rp_election_round", 9, 4)
    sides = Sides({"old": libs["old_quorum"], "new": quorum_ops._lib()},
                  {"old": health_ops._lib(), "new": health_ops._lib()},
                  {"old": libs["old_cluster"], "new": cluster_ops._lib()})
    inp = append_inputs(torch)
    g, r, base, lead = inp["g"], inp["r"], inp["base"], inp["lead"]
    var = libs["new"]
    stream = _build.stream_of(base.match_index)

    def reset():
        for a, b in zip(lead, base):
            a.copy_(b)

    def lanes():
        return [lead.match_index.clone(), lead.flushed_index.clone()]

    def piece(kind, batch):
        rows, d, f = batch

        def run():
            rc = var.rp_la_piece(lead.match_index.data_ptr(), lead.flushed_index.data_ptr(), rows.data_ptr(),
                                 d.data_ptr(), f.data_ptr(), rows.numel(), g, r, kind, stream)
            _build.check(var, rc, f"local append piece {kind}")
        return run

    def parts(n, threads, batch):
        rows, d, f = batch

        def run():
            rc = var.rp_la_parts(lead.match_index.data_ptr(), lead.flushed_index.data_ptr(), rows.data_ptr(),
                                 d.data_ptr(), f.data_ptr(), rows.numel(), g, r, n, threads, stream)
            _build.check(var, rc, f"local append at {n} row parts")
        return run

    def entry(side, batch):
        """This tree's wrapper, or the old tree's entry with its own
        argument list (no scratch)."""
        if side == "new":
            return lambda: quorum_ops.local_append_update(lead, *batch)
        rows, d, f = batch
        old = libs["old_quorum"]
        return lambda: _build.check(old, old.rp_local_append(
            lead.match_index.data_ptr(), lead.flushed_index.data_ptr(), rows.data_ptr(), d.data_ptr(),
            f.data_ptr(), rows.numel(), g, r, stream), "old local append")

    def library(batch):  # rows drawn in range: the cells need no wrap
        rows, d, f = batch
        cells = rows * r + quorum_ops.SELF_SLOT
        return lambda: (lead.match_index.view(-1).scatter_reduce_(0, cells, d, "amax"),
                        lead.flushed_index.view(-1).scatter_reduce_(0, cells, f, "amax"))

    def held(label, batch, checks):
        reset()
        quorum_ops.local_append_update_plain(lead, *batch)
        want = lanes()
        for name, fn in checks.items():
            reset()
            fn()
            torch.cuda.synchronize()
            same(lanes(), want, f"local append {name} on {label} vs plain")

    res = {"card": cs.nvidia_smi(), "clocks": clocks(), "ptxas": ptxas, "G": g, "R": r, "M": g,
           "distinct rows": inp["distinct"]}
    sides_of = {}
    for label, batch in inp["batches"].items():
        checks = {"old": entry("old", batch), "new": entry("new", batch)}
        for n in APPEND_ROW_PARTS:
            for th in APPEND_PART_THREADS:
                checks[f"row parts {n} t={th}"] = parts(n, th, batch)
        if label != "mixed rows":
            checks["library"] = library(batch)
        held(label, batch, checks)
        sides_of[label] = checks
    print("append: every exact side equal to the plain version on each batch", flush=True)
    for label in ("phase 10", "each raises"):
        batch = inp["batches"][label]
        fns = {f"old part: {name}": piece(kind, batch) for kind, name in APPEND_PIECES.items()}
        fns.update(sides_of[label])
        t = {}
        for name in list(fns) + list(fns)[::-1]:
            t.setdefault(name, []).append(time_us(fns[name], reset))
        res[label] = {"us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t}
        print(f"append {label}", json.dumps(res[label]["us"]), flush=True)
    # the old kernel and this tree's by batch size
    sweep = {}
    for x, batch in inp["sweep"].items():
        fns = {"old": entry("old", batch), "new": entry("new", batch),
               **{f"row parts {n}": parts(n, 256, batch) for n in (0, 1, 2, 4, 5, 6, 8)}}
        held(f"sweep M={batch[0].numel()}", batch, fns)
        t = {}
        for name in list(fns) + list(fns)[::-1]:
            t.setdefault(name, []).append(time_us(fns[name], reset))
        sweep[str(batch[0].numel())] = {k: float(np.mean(v)) for k, v in t.items()}
    res["sweep"] = sweep
    print("append sweep", json.dumps(sweep), flush=True)
    # old and new in turns, with the follower rule beside them
    batch = inp["batches"]["phase 10"]
    lc = base.commit_index + torch.from_numpy(np.random.default_rng(cs.SEED + 14).integers(-2, 6, g)).cuda()
    items = {"follower_commit_step": lambda: quorum_ops.follower_commit_step(lead, lc)}
    reset()
    quorum_ops.follower_commit_step_plain(lead, lc)
    want = tensors(lead)
    for side in ("old", "new"):
        reset()
        sides.run(side, items["follower_commit_step"])
        same(tensors(lead), want, f"follower_commit_step {side} vs plain")
    t = {}
    for side in ("old", "new", "new", "old"):
        t.setdefault(f"local_append_update {side}", []).append(time_us(entry(side, batch), reset))
    for name, fn in items.items():
        for side in ("old", "new", "new", "old"):
            t.setdefault(f"{name} {side}", []).append(time_us(lambda: sides.run(side, fn), reset))
    res["ab"] = {"us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t}
    print("append ab", json.dumps(res["ab"]), flush=True)
    res["cluster"] = cluster_ab(torch, sides)
    return res


def follower(torch, old_dir: str) -> dict:
    """The follower rule's breakdown, this tree's kernel and its variants,
    each exact side held first, then all in turns; the cluster kernels and
    the local append old against new (module doc)."""
    from redpanda_tpu_torch.models.consensus_state import GroupState
    from redpanda_tpu_torch.parallel import cluster_step as cluster_ops

    ptxas = {}
    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    sources = {"old_quorum": (open(os.path.join(old_dir, "quorum.cu")).read() + FOLLOW_EXTRAS, old_dir),
               "old_cluster": (open(os.path.join(old_dir, "cluster.cu")).read(), old_dir)}
    sources.update({name: (patched(new_src, p, name), _build.CSRC_DIR) for name, p in FOLLOW_VARIANTS.items()})
    libs = build(sources, ptxas)
    for name in FOLLOW_VARIANTS:
        quorum_ops.bind(libs[name])
    # the old tree's entries this mode calls, with that tree's argument lists
    _build.bind(libs["old_quorum"], "rp_follower_commit", 4, 2)
    _build.bind(libs["old_quorum"], "rp_local_append", 5, 4)
    _build.bind(libs["old_quorum"], "rp_fc_piece", 4, 3)
    _build.build_all(("quorum", "health", "cluster"))
    for lib in (libs["old_cluster"], cluster_ops._lib()):
        _build.bind(lib, "rp_cluster_tick", 18, 3)
        _build.bind(lib, "rp_election_round", 9, 4)
    this = quorum_ops._lib()
    quorum_sides = {"old": libs["old_quorum"], "new": this, **{k: libs[k] for k in FOLLOW_VARIANTS}}
    sides = Sides(quorum_sides, {k: health_ops._lib() for k in quorum_sides},
                  {k: (libs["old_cluster"] if k == "old" else cluster_ops._lib()) for k in quorum_sides})
    rng = np.random.default_rng(cs.SEED + 12)
    g = cs.CLUSTER_G
    base = cs.cluster_state(cs.cluster_fields(rng, g), "cuda").leader
    lead = GroupState(*(t.clone() for t in base))
    r = base.match_index.shape[1]
    lc = base.commit_index + torch.from_numpy(rng.integers(-2, 6, g)).cuda()
    none = torch.where(torch.from_numpy(rng.random(g) < 0.2).cuda(), torch.iinfo(torch.int64).min, lc)
    stream = _build.stream_of(base.match_index)

    def reset():
        for a, b in zip(lead, base):
            a.copy_(b)

    def call(side, rows=slice(None), lanes=lc):
        part = GroupState(*(t[rows] for t in lead))
        return lambda: sides.run(side, lambda: quorum_ops.follower_commit_step(part, lanes[rows]))

    def held(label, rows, lanes):
        reset()
        part = GroupState(*(t[rows] for t in lead))
        quorum_ops.follower_commit_step_plain(part, lanes[rows])
        want = tensors(lead)
        for side in quorum_sides:
            reset()
            call(side, rows, lanes)()
            torch.cuda.synchronize()
            same(tensors(lead), want, f"follower_commit_step {side} on {label} vs plain")

    for label, rows, lanes in (("phase 10", slice(None), lc), ("no update on a fifth", slice(None), none),
                               ("G - 3 rows", slice(0, g - 3), lc), ("a view one row in", slice(1, g), lc)):
        held(label, rows, lanes)
    msg = ("follower_commit_step: every side equal to the plain version on phase 10's leader commits, with a "
           "fifth of the rows without an update, on G - 3 rows and on a view one row in, tolerance exact")
    print(msg, flush=True)
    moved = int((lc > base.commit_index).sum())
    res = {"card": cs.nvidia_smi(), "clocks": clocks(), "ptxas": ptxas, "G": g, "R": r, "held": msg,
           "rows with leader_commit > commit": moved}

    def piece(kind):
        old = libs["old_quorum"]
        return lambda: _build.check(old, old.rp_fc_piece(
            lead.commit_index.data_ptr(), lead.last_visible.data_ptr(), lead.flushed_index.data_ptr(),
            lc.data_ptr(), g, r, kind, stream), f"follower piece {kind}")

    fns = {name: piece(kind) for kind, name in FOLLOW_PIECES.items()}
    fns.update({f"follower_commit_step {side}": call(side) for side in quorum_sides})
    t = {}
    for name in list(fns) + list(fns)[::-1]:
        t.setdefault(name, []).append(time_us(fns[name], reset))
    res["us"] = {k: float(np.mean(v)) for k, v in t.items()}
    res["us turns"] = t
    print("follower", json.dumps(res["us"]), flush=True)
    # the same pieces and kernels under each L2 fetch granularity hint (how
    # many bytes a sector miss brings from device memory), then the default
    fetch = libs["old_quorum"].rp_l2_fetch
    fetch.argtypes, fetch.restype = [ctypes.c_int64, ctypes.c_void_p], ctypes.c_int
    default = ctypes.c_int64()
    _build.check(libs["old_quorum"], fetch(-1, ctypes.addressof(default)), "L2 fetch granularity")
    by_fetch = {}
    for bytes_ in (32, 64, 128):
        _build.check(libs["old_quorum"], fetch(bytes_, ctypes.addressof(ctypes.c_int64())), "L2 fetch")
        by_fetch[bytes_] = {name: time_us(fns[name], reset) for name in
                            (FOLLOW_PIECES[1], FOLLOW_PIECES[2], "follower_commit_step old",
                             "follower_commit_step new", "follower_commit_step column on every row")}
    _build.check(libs["old_quorum"], fetch(default.value, ctypes.addressof(ctypes.c_int64())), "L2 fetch")
    res["by L2 fetch granularity"] = {"default": default.value, **by_fetch}
    print("L2 fetch granularity", json.dumps(res["by L2 fetch granularity"]), flush=True)
    # the neighbours that share no code with the rule, old against new
    batch = append_batch(torch, np.random.default_rng(cs.SEED + 13), base, g)
    t = {}
    for side in ("old", "new", "new", "old"):
        t.setdefault(f"local_append_update {side}", []).append(time_us(
            lambda: sides.run(side, lambda: quorum_ops.local_append_update(lead, *batch)), reset))
    res["local append"] = {"us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t}
    print("local append", json.dumps(res["local append"]), flush=True)
    res["cluster"] = cluster_ab(torch, sides)
    return res


def tick_shapes(torch, g_live: int, m_live: int) -> dict:
    """chip_smoke's inputs for heartbeat_tick: phase 2's at the tick
    shape, live_tick's at the live shape."""
    rng = np.random.default_rng(cs.SEED)
    fields = cs.random_state_fields(rng, cs.G, cs.R)
    out = {"tick": Shape(torch, "tick", fields, cs.padded_replies(rng, cs.G, cs.R, cs.M_REPLIES), rng)}
    rng = np.random.default_rng(cs.SEED + 21)
    fields = cs.random_state_fields(rng, g_live, cs.R)
    out["live"] = Shape(torch, "live", fields, cs.padded_replies(rng, g_live, cs.R, m_live // 2 + m_live // 4),
                        rng)
    return out


def tick(torch, old_dir: str, g_live: int = 8192, m_live: int = 1024) -> dict:
    """heartbeat_tick old against new by launch mechanism (module doc)."""
    ptxas = {}
    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    libs = build({"old_quorum": (open(os.path.join(old_dir, "quorum.cu")).read(), old_dir),
                  "new_parts": (new_src + TICK_EXTRAS + EXTRAS, _build.CSRC_DIR),
                  **{name: (patched(new_src, p, name), _build.CSRC_DIR) for name, p in TICK_VARIANTS.items()}},
                 ptxas)
    old = libs["old_quorum"]
    _build.bind(old, "rp_fold_replies", 8, 3)
    _build.bind(old, "rp_commit_step", 8, 2)
    parts = quorum_ops.bind(libs["new_parts"])
    _build.bind(parts, "rp_tick_part", 15, 4)
    _build.bind(parts, "rp_empty_pair", 0, 5)
    _build.bind(parts, "rp_empty_shape", 0, 4)
    for name in TICK_VARIANTS:
        quorum_ops.bind(libs[name])
    _build.build_all(("quorum",))
    this = quorum_ops._lib()
    res = {"card": cs.nvidia_smi(), "clocks": clocks(), "ptxas": ptxas}
    for label, shp in tick_shapes(torch, g_live, m_live).items():
        w, rep_ = shp.work, shp.replies
        stream = shp.stream

        def old_pair():
            quorum_ops._LIB = old
            try:
                quorum_ops.quorum_commit_step(quorum_ops.fold_replies(w, *rep_))
            finally:
                quorum_ops._LIB = this

        def pair():
            quorum_ops.heartbeat_tick(w, *rep_)

        def graph_of(fn):
            g = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                shp.reset()
                fn()
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(g):
                fn()
            torch.cuda.synchronize()
            return g.replay

        def part(k):
            return lambda: _build.check(parts, parts.rp_tick_part(
                *(getattr(w, n).data_ptr() for n in quorum_ops.LANE_ORDER), *(t.data_ptr() for t in rep_),
                shp.m, shp.g, shp.r, k, stream), "tick part")

        def variant(name):
            def run():
                quorum_ops._LIB = libs[name]
                try:
                    pair()
                finally:
                    quorum_ops._LIB = this
            return run

        fns = {"old": old_pair, "pdl": pair, "plain": variant("back_to_back"),
               "graph": graph_of(variant("back_to_back")), "graph_pdl": graph_of(pair),
               **{name: variant(name) for name in TICK_VARIANTS if name != "back_to_back"}}
        shp.reset()
        quorum_ops.heartbeat_tick_plain(w, *rep_)
        want = tensors(w)
        for side, fn in fns.items():
            shp.reset()
            fn()
            torch.cuda.synchronize()
            same(tensors(w), want, f"{label} heartbeat_tick {side} vs plain")
        r = {"G": shp.g, "R": shp.r, "M": shp.m}
        b1 = -(-shp.m // 256)
        b2 = max(-(-shp.g // 128), -(-shp.m // 512))
        floors = {
            f"empty kernel at the fold kernel's grid ({b1} x 256)": lambda: parts.rp_empty_shape(b1, 256, 0, 0, stream),
            f"empty kernel at the sweep kernel's grid ({b2} x 128)": lambda: parts.rp_empty_shape(b2, 128, 0, 0, stream),
            "empty pair at the two grids, PDL": lambda: parts.rp_empty_pair(b1, 256, b2, 128, 1, stream),
            "empty pair at the two grids, back to back": lambda: parts.rp_empty_pair(b1, 256, b2, 128, 0, stream),
        }
        t = {}
        order = list(fns)
        for _ in range(2):
            for side in order + order[::-1]:
                t.setdefault(side, []).append(time_us(fns[side], shp.reset))
            for name, k in TICK_PARTS.items():
                t.setdefault(name, []).append(time_us(part(k), shp.reset))
            for name, fn in floors.items():
                t.setdefault(name, []).append(time_us(lambda: _build.check(parts, fn(), name)))
            quorum_ops._LIB = old
            try:
                t.setdefault("old fold alone", []).append(
                    time_us(lambda: quorum_ops.fold_replies(w, *rep_), shp.reset))
                t.setdefault("old sweep alone", []).append(
                    time_us(lambda: quorum_ops.quorum_commit_step(w), shp.reset))
            finally:
                quorum_ops._LIB = this
        r["us"] = {k: float(np.mean(v)) for k, v in t.items()}
        r["us turns"] = t
        res[label] = r
        print(label, json.dumps(r), flush=True)
    return res


def clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_quorum: no CUDA device available", file=sys.stderr)
        return 2
    mode, old_dir = sys.argv[1], sys.argv[2]
    out = sys.argv[3] if len(sys.argv) > 3 else OUT
    print(cs.nvidia_smi(), flush=True)
    if mode == "tick":
        res = tick(torch, old_dir, *(int(x) for x in sys.argv[4:6]))
    else:
        res = {"breakdown": breakdown, "ab": ab, "append": append, "follower": follower}[mode](torch, old_dir)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"quorum_{mode}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"ok": True, "mode": mode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
