#!/usr/bin/env python3
"""On-card breakdown and A/B timing of the replication tick's reply fold
and commit sweep (one H100).

    mkdir -p .chipcheck/old
    for f in quorum.cu quorum_rules.cuh cluster.cu chip_blocks.cuh; do
        git show <commit>:redpanda_tpu_torch/csrc/$f > .chipcheck/old/$f; done
    python3 chip_quorum.py breakdown .chipcheck/old [OUT_DIR]
    python3 chip_quorum.py ab .chipcheck/old [OUT_DIR]

`breakdown` takes a csrc directory whose fold is the two-launch pair
(`rp_fold_replies` with a `fresh` scratch: a guard launch, then an
atomicMax launch) and whose commit sweep sorts rows (`rp_commit_step`),
appends variant kernels to its quorum.cu (the guard and the apply alone;
the sweep cut to its loads, to its loads as 16-byte vectors, to its
loads and the row rule without stores; the sweep with clock64() marks a
warp after its loads and after the rule; empty kernels at each launch
shape, plain and cooperative, with and without a grid barrier) and times
each with CUDA events at two shapes: the tick (G = 50,000, R = 8,
M = 131,072 replies, chip_smoke phase 2) and the mesh frame's
(1,000,000 rows, R = 8, an 8,192-reply bucket, chip_smoke phase 9).

`ab` times that directory's kernels beside this tree's and beside copies
of this tree's quorum.cu with one design choice patched back
(`NEW_VARIANTS`: the fold's block size, when it raises match / flushed,
its one-reply-a-thread path; the sweep's block size and load hint), in
turns (old, each new side, then the same in reverse): the fold, the
sweep, the tick's three launch sequences and the mesh frame's at their
shapes, and the ring cluster's two kernels (cluster.cu shares the
sweep's row rule) at 1,000,000 groups over 8 blocks. Every output of
each side is held exactly against the old one, and this tree's against
the plain versions, before anything is timed.

Variants are built under .chipcheck/quorum (git-ignored); results are
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
MAGIC = "0x5a5a5a5a5a5a5a5aLL"

# Appended to the old quorum.cu: each stage of the pair alone, the sweep
# cut after its loads (scalar as the kernel loads them, or as 16-byte
# vectors and one 8-byte word a voter mask) and after its rule, the
# sweep with marks, and empty kernels at a launch shape.
EXTRAS = r"""
#include <cooperative_groups.h>

__device__ long long g_marks[3 << 15];

__device__ __forceinline__ long long clock_after(long long dep) {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "l"(dep) : "memory");
    return t;
}

__device__ __forceinline__ unsigned nz_bytes(unsigned long long w) {
    w |= w >> 4; w |= w >> 2; w |= w >> 1;
    return (unsigned)(((w & 0x0101010101010101ull) * 0x0102040810204080ull) >> 56);
}

// VARIANT 0: loads only; 1: loads + rule, no stores; 2: loads as vectors
// (R = 8 rows only); 3: the whole kernel with marks
template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
commit_variant_kernel(const i64* __restrict__ term_start,
                      const u8* __restrict__ is_leader, i64* __restrict__ commit,
                      i64* __restrict__ last_visible,
                      const i64* __restrict__ match,
                      const i64* __restrict__ flushed,
                      const u8* __restrict__ voter, const u8* __restrict__ voter_old,
                      i64 g_n, int r_n) {
    constexpr int N = 8;
    const long long t0 = clock64();
    const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= g_n) return;
    const i64 base = g * r_n;
    i64 m[N], c[N];
    unsigned vm = 0u, om = 0u;
    if (VARIANT == 2) {
        const longlong2* pm = reinterpret_cast<const longlong2*>(match + base);
        const longlong2* pf = reinterpret_cast<const longlong2*>(flushed + base);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            const longlong2 a = pm[i], b = pf[i];
            m[2 * i] = a.x; m[2 * i + 1] = a.y;
            c[2 * i] = b.x < a.x ? b.x : a.x;
            c[2 * i + 1] = b.y < a.y ? b.y : a.y;
        }
        vm = nz_bytes(*reinterpret_cast<const unsigned long long*>(voter + base));
        om = nz_bytes(*reinterpret_cast<const unsigned long long*>(voter_old + base));
    } else {
#pragma unroll
        for (int r = 0; r < N; ++r) {
            if (r < r_n) {
                const i64 mv = match[base + r], fv = flushed[base + r];
                m[r] = mv;
                c[r] = fv < mv ? fv : mv;
                vm |= (unsigned)(voter[base + r] != 0) << r;
                om |= (unsigned)(voter_old[base + r] != 0) << r;
            } else {
                m[r] = RP_I64_MIN;
                c[r] = RP_I64_MIN;
            }
        }
    }
    if (VARIANT == 0 || VARIANT == 2) {
        i64 acc = (i64)vm ^ ((i64)om << 32);
#pragma unroll
        for (int r = 0; r < N; ++r) acc ^= m[r] + c[r];
        if (acc == MAGIC) commit[g] = acc;
        return;
    }
    i64 dep = (i64)vm ^ ((i64)om << 32);
#pragma unroll
    for (int r = 0; r < N; ++r) dep ^= m[r] ^ c[r];
    const long long t1 = clock_after(dep);
    const i64 lv = last_visible[g];
    i64 nv = lv;
    const i64 x = commit_row(m, c, vm, om, flushed[base], is_leader[g] != 0,
                             term_start[g], commit[g], &nv);
    if (VARIANT == 1) {
        if (x == MAGIC && nv == MAGIC) commit[g] = x;
        return;
    }
    const long long t2 = clock_after(x ^ nv);
    commit[g] = x;
    if (nv != lv) last_visible[g] = nv;
    const long long t3 = clock64();
    const i64 w = g >> 5;
    if ((threadIdx.x & 31) == 0 && w < (1 << 15)) {
        g_marks[3 * w] = t1 - t0;
        g_marks[3 * w + 1] = t2 - t1;
        g_marks[3 * w + 2] = t3 - t2;
    }
}

__global__ void rp_empty_kernel(int) {}
__global__ void rp_empty_sync_kernel(int) { cooperative_groups::this_grid().sync(); }

extern "C" {

int rp_fold_guard_only(const i64* last_seq, const i64* group_idx, const i64* slot,
                       const i64* seq, u8* fresh, i64 m, i64 g_n, i64 r_n, void* stream) {
    fold_guard_kernel<<<blocks_for(m), THREADS, 0, (cudaStream_t)stream>>>(
        last_seq, group_idx, slot, seq, fresh, m, g_n, r_n);
    return (int)cudaGetLastError();
}

int rp_fold_apply_only(i64* match, i64* flushed, i64* last_seq, const i64* group_idx,
                       const i64* slot, const i64* dirty, const i64* flushed_in,
                       const i64* seq, const u8* fresh, i64 m, i64 r_n, void* stream) {
    fold_apply_kernel<<<blocks_for(m), THREADS, 0, (cudaStream_t)stream>>>(
        match, flushed, last_seq, group_idx, slot, dirty, flushed_in, seq, fresh, m, r_n);
    return (int)cudaGetLastError();
}

int rp_commit_variant(const i64* term_start, const u8* is_leader, i64* commit,
                      i64* last_visible, const i64* match, const i64* flushed,
                      const u8* voter, const u8* voter_old, i64 g_n, i64 r_n,
                      i64 variant, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define RP_V(V) commit_variant_kernel<V><<<blocks_for(g_n), THREADS, 0, s>>>( \
        term_start, is_leader, commit, last_visible, match, flushed, voter, voter_old, g_n, (int)r_n)
    if (variant == 0) RP_V(0);
    else if (variant == 1) RP_V(1);
    else if (variant == 2) RP_V(2);
    else RP_V(3);
#undef RP_V
    return (int)cudaGetLastError();
}

int rp_marks(void* host, i64 n) {
    return (int)cudaMemcpyFromSymbol(host, g_marks, n * 8);
}

int rp_empty_shape(i64 blocks, i64 threads, i64 coop, i64 sync, void* stream) {
    int dummy = 0;
    void* args[1] = {&dummy};
    if (!coop) {
        rp_empty_kernel<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(0);
        return (int)cudaGetLastError();
    }
    return (int)cudaLaunchCooperativeKernel(
        sync ? (const void*)rp_empty_sync_kernel : (const void*)rp_empty_kernel,
        dim3((unsigned)blocks), dim3((unsigned)threads), args, 0, (cudaStream_t)stream);
}

int rp_coop_blocks_per_sm(i64 threads, i64* out) {
    int n = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rp_empty_sync_kernel, (int)threads, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    out[0] = n;
    out[1] = sms;
    return (int)e;
}

}  // extern "C"
""".replace("MAGIC", MAGIC)


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


def build(sources: dict) -> dict:
    """{name: (source, include dir)} -> {name: CDLL}, one nvcc each, in parallel."""
    os.makedirs(WORK, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda kv: nvcc(kv[0], *kv[1]), sources.items()))
    libs = {}
    for name, so, info in built:
        for ln in info:
            print(f"[ptxas] {name}: {ln}", flush=True)
        libs[name] = ctypes.CDLL(so)
        libs[name].rp_error_string.restype = ctypes.c_char_p
        libs[name].rp_error_string.argtypes = [ctypes.c_int]
    return libs


def bind_old(lib) -> None:
    _build.bind(lib, "rp_fold_replies", 9, 3)
    _build.bind(lib, "rp_commit_step", 8, 2)
    _build.bind(lib, "rp_build_heartbeats", 9, 3)


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
    """A state (base and work copies) and a padded reply batch on the card."""

    def __init__(self, torch, label, fields, replies):
        from redpanda_tpu_torch.models.consensus_state import group_state_from_numpy

        self.label = label
        self.base = group_state_from_numpy(fields, "cuda")
        self.work = group_state_from_numpy(fields, "cuda")
        self.replies = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in replies]
        self.m = len(replies[0])
        self.g, self.r = fields["match_index"].shape
        self.fresh = torch.zeros(self.m, dtype=torch.uint8, device="cuda")
        self.stream = _build.stream_of(self.replies[0])

    def reset(self):
        for a, b in zip(self.work, self.base):
            a.copy_(b)

    def lanes(self):
        return {k: getattr(self.work, k).clone() for k in self.work._fields}

    def fold_old(self, lib):
        w, rep = self.work, self.replies
        return lambda: _build.check(lib, lib.rp_fold_replies(
            w.match_index.data_ptr(), w.flushed_index.data_ptr(), w.last_seq.data_ptr(),
            *(t.data_ptr() for t in rep), self.fresh.data_ptr(), self.m, self.g, self.r, self.stream), "fold")

    def guard_only(self, lib):
        w, (gi, sl, _, _, sq) = self.work, self.replies
        return lambda: _build.check(lib, lib.rp_fold_guard_only(
            w.last_seq.data_ptr(), gi.data_ptr(), sl.data_ptr(), sq.data_ptr(), self.fresh.data_ptr(),
            self.m, self.g, self.r, self.stream), "guard")

    def apply_only(self, lib):
        w, rep = self.work, self.replies
        return lambda: _build.check(lib, lib.rp_fold_apply_only(
            w.match_index.data_ptr(), w.flushed_index.data_ptr(), w.last_seq.data_ptr(),
            *(t.data_ptr() for t in rep), self.fresh.data_ptr(), self.m, self.r, self.stream), "apply")

    def _commit_ptrs(self):
        w = self.work
        return (w.term_start.data_ptr(), w.is_leader.data_ptr(), w.commit_index.data_ptr(),
                w.last_visible.data_ptr(), w.match_index.data_ptr(), w.flushed_index.data_ptr(),
                w.is_voter.data_ptr(), w.is_voter_old.data_ptr())

    def commit_old(self, lib):
        return lambda: _build.check(lib, lib.rp_commit_step(*self._commit_ptrs(), self.g, self.r, self.stream),
                                    "commit")

    def commit_variant(self, lib, v):
        return lambda: _build.check(lib, lib.rp_commit_variant(*self._commit_ptrs(), self.g, self.r, v,
                                                               self.stream), f"commit variant {v}")


def shapes(torch) -> dict:
    rng = np.random.default_rng(cs.SEED)
    fields = cs.random_state_fields(rng, cs.G, cs.R)
    out = {"tick": Shape(torch, "tick", fields, cs.padded_replies(rng, cs.G, cs.R, cs.M_REPLIES))}
    fields = mesh_fields(cs.MESH_G, cs.R, cs.SEED + 9)
    window = cs.mesh_window(np.random.default_rng(cs.SEED + 13), np.arange(cs.MESH_G), MESH_BUCKET, 13, cs.R)
    out["mesh"] = Shape(torch, "mesh", fields, cs.padded_window(window))
    return out


def empties(lib, shp) -> dict:
    """Empty kernels at the old launch shapes and at cooperative grids."""
    _build.bind(lib, "rp_empty_shape", 0, 4)
    lib.rp_coop_blocks_per_sm.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    occ = np.zeros(2, np.int64)
    _build.check(lib, lib.rp_coop_blocks_per_sm(256, occ.ctypes.data), "occupancy")
    per_sm, sms = int(occ[0]), int(occ[1])
    fold_blocks = -(-shp.m // 256)
    shapes_ = [
        (f"256 x {-(-shp.g // 256)} (the sweep's shape)", -(-shp.g // 256), 256, 0, 0),
        (f"256 x {fold_blocks} (each fold launch's shape)", fold_blocks, 256, 0, 0),
        (f"cooperative 256 x {fold_blocks}, no barrier", fold_blocks, 256, 1, 0),
        (f"cooperative 256 x {fold_blocks}, one grid barrier", fold_blocks, 256, 1, 1),
        (f"cooperative 256 x {per_sm * sms} (full co-residency), one grid barrier", per_sm * sms, 256, 1, 1),
        (f"cooperative 1024 x {sms}, one grid barrier", sms, 1024, 1, 1),
    ]
    out = {"co-resident blocks of 256 a SM": per_sm, "SMs": sms}
    for label, blocks, threads, coop, sync in shapes_:
        if blocks > per_sm * sms and coop:
            continue
        out[label] = time_us(lambda: _build.check(lib, lib.rp_empty_shape(blocks, threads, coop, sync, shp.stream),
                                                  "empty"))
    return out


def marks(torch, lib, shp) -> dict:
    """One marked sweep: cycles a warp (lane 0) from the start to its
    loads' arrival, through the rule, and to the stores' issue."""
    lib.rp_marks.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    shp.reset()
    shp.commit_variant(lib, 3)()
    torch.cuda.synchronize()
    warps = min(-(-shp.g // 32), 1 << 15)
    d = np.zeros(3 * warps, np.int64)
    _build.check(lib, lib.rp_marks(d.ctypes.data, d.size), "marks")
    d = d.reshape(warps, 3)
    names = ("start to loads arrived", "row rule", "stores issued")
    return {k: {"mean": float(d[:, i].mean()), "p50": float(np.median(d[:, i])), "max": int(d[:, i].max())}
            for i, k in enumerate(names)}


def breakdown(torch, old_dir: str) -> dict:
    src = open(os.path.join(old_dir, "quorum.cu")).read()
    lib = build({"base": (src + EXTRAS, old_dir)})["base"]
    bind_old(lib)
    _build.bind(lib, "rp_fold_guard_only", 5, 3)
    _build.bind(lib, "rp_fold_apply_only", 9, 2)
    _build.bind(lib, "rp_commit_variant", 8, 3)
    res = {"card": cs.nvidia_smi(), "clocks": clocks()}
    for label, shp in shapes(torch).items():
        # the variants against the kernel: the marked sweep writes what
        # the kernel writes; the fold's stages alone write what the pair does
        shp.reset()
        shp.commit_old(lib)()
        want = shp.lanes()
        shp.reset()
        shp.commit_variant(lib, 3)()
        torch.cuda.synchronize()
        if any(not torch.equal(want[k], v) for k, v in shp.lanes().items()):
            raise AssertionError(f"{label}: the marked sweep differs from the kernel")
        shp.reset()
        shp.fold_old(lib)()
        want = shp.lanes()
        shp.reset()
        shp.guard_only(lib)()
        shp.apply_only(lib)()
        torch.cuda.synchronize()
        if any(not torch.equal(want[k], v) for k, v in shp.lanes().items()):
            raise AssertionError(f"{label}: guard + apply differ from the pair")
        fns = {
            "fold: the pair (one call)": shp.fold_old(lib),
            "fold: guard launch alone": shp.guard_only(lib),
            "fold: apply launch alone": shp.apply_only(lib),
            "sweep: loads only (scalar, as the kernel)": shp.commit_variant(lib, 0),
            "sweep: loads only (16-byte vectors, 8-byte mask words)": shp.commit_variant(lib, 2),
            "sweep: loads + rule, no stores": shp.commit_variant(lib, 1),
            "sweep: whole kernel": shp.commit_old(lib),
        }
        t = {}
        for turn in range(2):
            for name in (list(fns) if turn == 0 else list(fns)[::-1]):
                # guard_only leaves fresh from the last full pair: apply reads it
                t.setdefault(name, []).append(time_us(fns[name], shp.reset))
        r = {"G": shp.g, "R": shp.r, "M": shp.m, "us": {k: float(np.mean(v)) for k, v in t.items()},
             "us turns": t, "empty us": empties(lib, shp), "marks (cycles a warp)": marks(torch, lib, shp)}
        res[label] = r
        print(label, json.dumps(r), flush=True)
    return res


class OldQuorum:
    """The old quorum library behind this tree's `rp_fold_replies`
    argument list: the old fold takes a `fresh` scratch, allocated per
    call as its wrapper did."""

    def __init__(self, lib):
        bind_old(lib)
        self.lib = lib

    def rp_fold_replies(self, match, flushed, last_seq, gi, sl, dirty, fl, seq, m, g, r, stream):
        import torch

        fresh = torch.empty(m, dtype=torch.uint8, device="cuda")
        return self.lib.rp_fold_replies(match, flushed, last_seq, gi, sl, dirty, fl, seq, fresh.data_ptr(),
                                        m, g, r, stream)

    def __getattr__(self, name):
        return getattr(self.lib, name)


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


# this tree's quorum.cu ("new") beside copies with another design choice
# patched in, each bound with the same argument lists
FOLD_EARLY = """        // match and flushed never feed a guard: raise them before the barrier
        if (fresh) {
            atomicMax(&match[k], d);
            atomicMax(&flushed[k], fl);
        }
        // no last_seq cell moves before every guard of the batch has read it
        cooperative_groups::this_grid().sync();
        if (fresh) atomicMax(&last_seq[k], sq);
"""
FOLD_LATE = """        cooperative_groups::this_grid().sync();
        if (fresh) {
            atomicMax(&match[k], d);
            atomicMax(&flushed[k], fl);
            atomicMax(&last_seq[k], sq);
        }
"""
NEW_VARIANTS = {
    "new": [],
    # the fold at 1,024-thread blocks whatever the batch size
    "fold_1024": [("    const int threads = m <= (i64)FOLD_FEW_THREADS * sms ? FOLD_FEW_THREADS : FOLD_THREADS;",
                   "    const int threads = FOLD_THREADS;")],
    # match / flushed raised after the barrier with last_seq
    "fold_late": [(FOLD_EARLY, FOLD_LATE)],
    # every batch through the runs path (ballot words, replies read again)
    "fold_runs": [("static const void* fold_instance(int threads, bool one_run) {\n",
                   "static const void* fold_instance(int threads, bool one_run) {\n    one_run = false;\n")],
    "sweep_t64": [("#define COMMIT_THREADS 128", "#define COMMIT_THREADS 64")],
    "sweep_t256": [("#define COMMIT_THREADS 128", "#define COMMIT_THREADS 256")],
    # the row lanes and the mask words read without the streaming hint
    "sweep_ld": [("            if (2 * i < r_n) x = __ldcs(p + i);", "            if (2 * i < r_n) x = p[i];"),
                 ("            if (8 * i < r_n) mask |= nonzero_bytes(__ldcs(p + i)) << (8 * i);",
                  "            if (8 * i < r_n) mask |= nonzero_bytes(p[i]) << (8 * i);")],
}


def ab(torch, old_dir: str) -> dict:
    from redpanda_tpu_torch.parallel import cluster_step as cluster_ops
    from redpanda_tpu_torch.parallel import mesh_frame

    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    sources = {
        "old_quorum": (open(os.path.join(old_dir, "quorum.cu")).read(), old_dir),
        "old_cluster": (open(os.path.join(old_dir, "cluster.cu")).read(), old_dir),
    }
    for name, patches in NEW_VARIANTS.items():
        src = new_src
        for a, b in patches:
            if src.count(a) != 1:
                raise AssertionError(f"variant {name}: patch does not apply once: {a[:60]!r}")
            src = src.replace(a, b)
        sources[name] = (src, _build.CSRC_DIR)
    libs = build(sources)
    _build.build_all(("quorum", "health", "cluster"))
    for lib in (libs["old_cluster"], cluster_ops._lib()):
        _build.bind(lib, "rp_cluster_tick", 18, 3)
        _build.bind(lib, "rp_election_round", 9, 4)
    for name in NEW_VARIANTS:
        libs[name].rp_fold_grid.argtypes = [ctypes.c_int64, ctypes.c_void_p]
        _build.bind(libs[name], "rp_fold_replies", 8, 3)
        _build.bind(libs[name], "rp_commit_step", 8, 2)
        _build.bind(libs[name], "rp_build_heartbeats", 9, 3)
    quorum = {"old": OldQuorum(libs["old_quorum"]), **{name: libs[name] for name in NEW_VARIANTS}}
    cluster = {side: cluster_ops._lib() for side in quorum}
    cluster["old"] = libs["old_cluster"]
    quorum_ops._lib()
    health_ops._lib()
    sides = list(quorum)

    def run(side, fn):
        quorum_ops._LIB, cluster_ops._LIB = quorum[side], cluster[side]
        try:
            return fn()
        finally:
            quorum_ops._LIB, cluster_ops._LIB = quorum["new"], cluster["new"]

    res = {"card": cs.nvidia_smi(), "clocks": clocks()}
    rng = np.random.default_rng(cs.SEED + 21)
    for label, shp in shapes(torch).items():
        w, rep = shp.work, shp.replies
        known = torch.from_numpy(rng.random(shp.g) < 0.5).cuda()
        active = torch.from_numpy(rng.random(shp.g) < 0.95).cuda()
        items = {
            "fold_replies": (lambda: quorum_ops.fold_replies(w, *rep),
                             lambda: quorum_ops.fold_replies_plain(w, *rep)),
            "quorum_commit_step": (lambda: quorum_ops.quorum_commit_step(w),
                                   lambda: quorum_ops.quorum_commit_step_plain(w)),
        }
        if label == "tick":
            hb = torch.from_numpy(rng.permutation(shp.g)[: cs.H_ROWS].astype(np.int64)).cuda()
            items["heartbeat_tick"] = (lambda: quorum_ops.heartbeat_tick(w, *rep), None)
            items["tick_frame"] = (lambda: quorum_ops.tick_frame(w, *rep, hb), None)
            items["tick_frame_health"] = (lambda: health_ops.tick_frame_health(w, *rep, hb, known, active), None)
        else:
            items["mesh_tick_frame"] = (lambda: mesh_frame.mesh_tick_frame(w, *rep, known, active, cs.MESH_D), None)
        r = {"G": shp.g, "R": shp.r, "M": shp.m, "fold grid (blocks, runs a block)": quorum_ops.fold_grid(shp.m)}
        # exact first: every side against the old one, the kernels against the plain versions
        for name, (fn, plain) in items.items():
            outs = {}
            for side in sides:
                shp.reset()
                outs[side] = tensors(run(side, fn)) + tensors(w)
                torch.cuda.synchronize()
                same(outs[side], outs["old"], f"{label} {name}: {side} vs old")
            if plain is not None:
                shp.reset()
                same(outs["new"], tensors(plain()) + tensors(w), f"{label} {name}: new vs plain")
        t = {}
        for name, (fn, _) in items.items():
            for side in sides + sides[::-1]:
                t.setdefault(f"{name} {side}", []).append(time_us(lambda: run(side, fn), shp.reset))
        r["us"] = {k: float(np.mean(v)) for k, v in t.items()}
        r["us turns"] = t
        res[label] = r
        print(label, json.dumps(r), flush=True)
    # the ring cluster at 1M groups over 8 blocks: commit_row is shared
    fields = cs.cluster_fields(np.random.default_rng(cs.SEED + 22), cs.CLUSTER_G)
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
            outs[side] = tensors(run(side, fn)[1:]) + lanes()
        reset()
        want = tensors(plain()[1:]) + lanes()
        same(outs["new"], outs["old"], f"cluster {name}: new vs old")
        same(outs["new"], want, f"cluster {name}: new vs plain")
    t = {}
    for name, (fn, _) in items.items():
        for side in ("old", "new", "new", "old"):
            t.setdefault(f"{name} {side}", []).append(time_us(lambda: run(side, fn), reset))
    r["us"] = {k: float(np.mean(v)) for k, v in t.items()}
    r["us turns"] = t
    res["cluster"] = r
    print("cluster", json.dumps(r), flush=True)
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
    res = {"breakdown": breakdown, "ab": ab}[mode](torch, old_dir)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"quorum_{mode}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"ok": True, "mode": mode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
