#!/usr/bin/env python3
"""On-card breakdown and A/B timing of the replication tick's kernels
(one H100): the reply fold, the commit sweep, the heartbeat gather, the
health reduction and the tick frame kernel that runs them in one launch.

    mkdir -p .chipcheck/old
    for f in quorum.cu quorum_rules.cuh health.cu chip_blocks.cuh cluster.cu; do
        git show <commit>:redpanda_tpu_torch/csrc/$f > .chipcheck/old/$f; done
    python3 chip_quorum.py breakdown .chipcheck/old [OUT_DIR]
    python3 chip_quorum.py ab .chipcheck/old [OUT_DIR]

The old directory holds a tree whose tick frame is a launch sequence
(fold, sweep, gather, and the health reduction for tick_frame_health)
with the same C entry points and argument lists as this tree's
(`rp_fold_replies`, `rp_commit_step`, `rp_build_heartbeats`,
`rp_health_reduce`, `rp_health_totals`, the cluster kernels).

`breakdown`, at the tick's shape (G = 50,000, R = 8, M = 131,072
replies, H = 50,000 heartbeat rows; chip_smoke phase 2): the old tree's
kernels alone and its three sequences; this tree's frame kernel cut to
its phases (the sweep alone, with health, with the gather behind the
second barrier, with the fold but no gather, whole with and without
health), the two-launch variant (the fold kernel, then the frame kernel
with no replies), the standalone health_reduce and build_heartbeats; and
empty kernels at the sweep's shape and, launched cooperatively, at the
frame's grid with 0, 1 and 2 grid barriers.

`ab` times the old tree's kernels beside this tree's and beside copies
of this tree's quorum.cu with one frame design choice patched
(`NEW_VARIANTS`: the block size, a register cap, the later phases'
first loads moved back into their phases),
and the two-launch variant, in turns (old, each new side, then the same
in reverse): the fold, the sweep, the gather, the health reduction and
the tick's three sequences at the tick's shape, the fold, the sweep and
the mesh frame's sequence at its shape (1,000,000 rows, an 8,192-reply
bucket, chip_smoke phase 9), and the ring cluster's two kernels at
1,000,000 groups over 8 blocks. Every output of each side is held
exactly against the old one, and this tree's against the plain
versions, before anything is timed.

Variants are built under .chipcheck/quorum (git-ignored) with `-Xptxas
-v` (registers and spills printed); results are printed and written to
OUT_DIR/quorum_<mode>.json (default .chipcheck/).
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

# this tree's quorum.cu ("new") beside copies with another frame block size
NEW_VARIANTS = {
    "new": [],
    "frame_t128": [("#define FRAME_THREADS 256", "#define FRAME_THREADS 128")],
    "frame_t512": [("#define FRAME_THREADS 256", "#define FRAME_THREADS 512")],
    "frame_t1024": [("#define FRAME_THREADS 256", "#define FRAME_THREADS 1024")],
    # the sweep's flags and the gather's index and term loaded in their phases, not at the start
    "frame_late_loads": [("        if (g != first) {", "        if (true) {"),
                         ("const i64 g = i == first ? g0 : gather_row(hb.idx[i], g_n);",
                          "const i64 g = gather_row(hb.idx[i], g_n);"),
                         ("hb.term[i] = i == first ? term0 : s.term[g];", "hb.term[i] = s.term[g];")],
    # 256-thread blocks capped at 64 registers: four blocks an SM, one reply a thread
    "frame_min4": [("__launch_bounds__(FRAME_THREADS)\ntick_frame_kernel",
                    "__launch_bounds__(FRAME_THREADS, 4)\ntick_frame_kernel")],
}


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


def patched(src: str, patches: list, name: str) -> str:
    for a, b in patches:
        if src.count(a) != 1:
            raise AssertionError(f"variant {name}: patch does not apply once: {a[:60]!r}")
        src = src.replace(a, b)
    return src


def old_libs(old_dir: str, extra: dict) -> dict:
    """The old tree's quorum, health and cluster libraries plus `extra`
    sources, built together, the old ones bound with this tree's
    argument lists for their shared entry points."""
    from redpanda_tpu_torch.parallel import cluster_step as cluster_ops

    sources = {f"old_{n}": (open(os.path.join(old_dir, f"{n}.cu")).read(), old_dir)
               for n in ("quorum", "health", "cluster")}
    libs = build({**sources, **extra})
    _build.bind(libs["old_quorum"], "rp_fold_replies", 8, 3)
    _build.bind(libs["old_quorum"], "rp_commit_step", 8, 2)
    _build.bind(libs["old_quorum"], "rp_build_heartbeats", 9, 3)
    libs["old_quorum"].rp_fold_grid.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    health_ops.bind(libs["old_health"])
    for lib in (libs["old_cluster"], cluster_ops._lib()):
        _build.bind(lib, "rp_cluster_tick", 18, 3)
        _build.bind(lib, "rp_election_round", 9, 4)
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
    """name -> (this tree's call, the old tree's call or None for the
    same, the plain chain or None). The old tree's frames are its launch
    sequences."""
    w, rep, hb = shp.work, shp.replies, shp.hb

    def old_frame(health):
        def run():
            quorum_ops.fold_replies(w, *rep)
            quorum_ops.quorum_commit_step(w)
            beats = quorum_ops.build_heartbeats(w, hb)
            return (beats, shp.health()) if health else beats
        return run

    def plain_frame(health):
        def run():
            quorum_ops.quorum_commit_step_plain(quorum_ops.fold_replies_plain(w, *rep))
            beats = quorum_ops.build_heartbeats_plain(w, hb)
            return (beats, shp.health_plain()) if health else beats
        return run

    def new_frame(health):
        def run():
            _, beats, lanes = shp.frame(rep, hb, health)()
            return (beats, lanes) if health else beats
        return run

    return {
        "fold_replies": (lambda: quorum_ops.fold_replies(w, *rep), None,
                         lambda: quorum_ops.fold_replies_plain(w, *rep)),
        "quorum_commit_step": (lambda: quorum_ops.quorum_commit_step(w), None,
                               lambda: quorum_ops.quorum_commit_step_plain(w)),
        "build_heartbeats": (lambda: quorum_ops.build_heartbeats(w, hb), None,
                             lambda: quorum_ops.build_heartbeats_plain(w, hb)),
        "health_reduce": (shp.health, None, shp.health_plain),
        "heartbeat_tick": (lambda: quorum_ops.heartbeat_tick(w, *rep), None, None),
        "tick_frame": (new_frame(False), old_frame(False), plain_frame(False)),
        "tick_frame_health": (new_frame(True), old_frame(True), plain_frame(True)),
    }


def two_launch(shp):
    """The two-launch variant of tick_frame_health: the fold kernel, then
    the frame kernel with no replies (sweep, health, barrier, gather)."""
    def run():
        quorum_ops.fold_replies(shp.work, *shp.replies)
        _, beats, lanes = shp.frame(shp.none, shp.hb)()
        return beats, lanes
    return run


def held(sides, shp, name, fns: dict, plain=None) -> None:
    """Every side's outputs and lanes equal to the old side's, and the
    new side's to the plain chain's."""
    outs = {}
    for side, fn in fns.items():
        shp.reset()
        outs[side] = tensors(sides.run(side, fn)) + tensors(shp.work)
        same(outs[side], outs["old"], f"{shp.label} {name}: {side} vs old")
    if plain is not None:
        shp.reset()
        same(outs["new"], tensors(plain()) + tensors(shp.work), f"{shp.label} {name}: new vs plain")


def in_turns(sides, shp, fns: dict, t: dict, prefix: str = "") -> None:
    order = list(fns)
    for side in order + order[::-1]:
        t.setdefault(f"{prefix}{side}", []).append(time_us(lambda: sides.run(side, fns[side]), shp.reset))


def empties(lib, shp, frame: tuple) -> dict:
    """Empty kernels at the sweep's shape and, cooperative, at the
    frame's grid with 0, 1 and 2 grid barriers."""
    _build.bind(lib, "rp_empty_shape", 0, 4)
    blocks, threads, _ = frame
    shapes_ = [
        (f"256 x {-(-shp.g // 256)} (a plain launch at the old sweep's rows)", -(-shp.g // 256), 256, 0, 0),
        (f"cooperative {threads} x {blocks} (the frame's grid), no barrier", blocks, threads, 1, 0),
        (f"cooperative {threads} x {blocks}, one grid barrier", blocks, threads, 1, 1),
        (f"cooperative {threads} x {blocks}, two grid barriers", blocks, threads, 1, 2),
    ]
    out = {}
    for label, b, th, coop, syncs in shapes_:
        out[label] = time_us(lambda: _build.check(lib, lib.rp_empty_shape(b, th, coop, syncs, shp.stream), "empty"))
    return out


def breakdown(torch, old_dir: str) -> dict:
    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    libs = old_libs(old_dir, {"new": (new_src + EXTRAS, _build.CSRC_DIR)})
    quorum_ops.bind(libs["new"])
    sides = Sides({"old": libs["old_quorum"], "new": libs["new"]},
                  {"old": libs["old_health"], "new": health_ops._lib()},
                  {"old": libs["old_cluster"], "new": libs["old_cluster"]})
    res = {"card": cs.nvidia_smi(), "clocks": clocks()}
    shp = shapes(torch)["tick"]
    items = tick_items(shp)
    frame = sides.run("new", lambda: quorum_ops.frame_grid(shp.m, shp.g, shp.r, len(shp.hb)))
    for name, (new, old, plain) in items.items():
        held(sides, shp, name, {"old": old or new, "new": new}, plain)
    # the frame's phases and the two-launch variant, each against its plain chain
    none_hb = shp.hb[:0]
    w = shp.work

    def cut(replies, hb, health=True):
        def run():
            _, beats, lanes = shp.frame(replies, hb, health)()
            return [x for x in (beats if len(hb) else None, lanes) if x is not None]
        return run

    def chain(fold, hb, health=True):
        def run():
            if fold:
                quorum_ops.fold_replies_plain(w, *shp.replies)
            quorum_ops.quorum_commit_step_plain(w)
            beats = quorum_ops.build_heartbeats_plain(w, hb) if len(hb) else None
            return [x for x in (beats, shp.health_plain() if health else None) if x is not None]
        return run

    cuts = {
        "frame: sweep alone (m = 0, H = 0)": (cut(shp.none, none_hb, False), chain(False, none_hb, False)),
        "frame: sweep + health (m = 0, H = 0)": (cut(shp.none, none_hb), chain(False, none_hb)),
        "frame: sweep + health, barrier, gather (m = 0)": (cut(shp.none, shp.hb), chain(False, shp.hb)),
        "frame: fold, barrier, sweep + health (H = 0)": (cut(shp.replies, none_hb), chain(True, none_hb)),
        "frame: whole, no health (tick_frame)": (cut(shp.replies, shp.hb, False), chain(True, shp.hb, False)),
        "frame: whole, health (tick_frame_health)": (cut(shp.replies, shp.hb), chain(True, shp.hb)),
        "two launches: fold, then the frame with m = 0": (two_launch(shp), chain(True, shp.hb)),
    }
    for name, (fn, plain) in cuts.items():
        shp.reset()
        got = tensors(sides.run("new", fn)) + tensors(w)
        shp.reset()
        same(got, tensors(plain()) + tensors(w), f"{name} vs plain")
    fns = {f"old: {name}": (lambda fn=(old or new): sides.run("old", fn))
           for name, (new, old, _) in items.items()}
    fns.update({f"new: {name}": (lambda fn=new: sides.run("new", fn))
                for name, (new, _, _) in items.items() if name in ("health_reduce", "build_heartbeats")})
    fns.update({name: (lambda fn=fn: sides.run("new", fn)) for name, (fn, _) in cuts.items()})
    t = {}
    for turn in range(2):
        for name in (list(fns) if turn == 0 else list(fns)[::-1]):
            t.setdefault(name, []).append(time_us(fns[name], shp.reset))
    res["tick"] = {"G": shp.g, "R": shp.r, "M": shp.m, "H": len(shp.hb), "frame grid": frame,
                   "us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t,
                   "empty us": empties(libs["new"], shp, frame)}
    print("tick", json.dumps(res["tick"]), flush=True)
    return res


def ab(torch, old_dir: str) -> dict:
    from redpanda_tpu_torch.parallel import cluster_step as cluster_ops
    from redpanda_tpu_torch.parallel import mesh_frame

    new_src = open(os.path.join(_build.CSRC_DIR, "quorum.cu")).read()
    libs = old_libs(old_dir, {name: (patched(new_src, p, name), _build.CSRC_DIR)
                              for name, p in NEW_VARIANTS.items()})
    for name in NEW_VARIANTS:
        quorum_ops.bind(libs[name])
    news = list(NEW_VARIANTS)
    new_sides = news + ["two_launch"]  # two_launch: this tree's kernels, fold and frame apart
    sides = Sides({"old": libs["old_quorum"], "two_launch": libs["new"], **{n: libs[n] for n in news}},
                  {"old": libs["old_health"], **{n: health_ops._lib() for n in new_sides}},
                  {"old": libs["old_cluster"], **{n: cluster_ops._lib() for n in new_sides}})
    res = {"card": cs.nvidia_smi(), "clocks": clocks()}
    for label, shp in shapes(torch).items():
        w, rep = shp.work, shp.replies
        r = {"G": shp.g, "R": shp.r, "M": shp.m, "H": len(shp.hb),
             "fold grid (blocks, threads, runs)": quorum_ops.fold_grid(shp.m),
             "frame grid (blocks, threads, runs)": {
                 n: sides.run(n, lambda: quorum_ops.frame_grid(shp.m, shp.g, shp.r, len(shp.hb))) for n in news}}
        if label == "tick":
            items = tick_items(shp)
        else:
            def mesh(w=w, rep=rep, shp=shp):
                return mesh_frame.mesh_tick_frame(w, *rep, shp.known, shp.active, cs.MESH_D)

            items = {k: v for k, v in tick_items(shp).items() if k in ("fold_replies", "quorum_commit_step")}
            items["mesh_tick_frame"] = (mesh, None, None)
        t = {}
        for name, (new, old, plain) in items.items():
            # the block-size variants change only the frame kernel
            frame = name in ("tick_frame", "tick_frame_health")
            fns = {"old": old or new, **{n: new for n in (news if frame else ["new"])}}
            if name == "tick_frame_health":
                fns["two_launch"] = two_launch(shp)
            held(sides, shp, name, fns, plain)
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
