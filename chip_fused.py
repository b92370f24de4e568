#!/usr/bin/env python3
"""On-card breakdown and A/B timing of the fused CRC + LZ4 and CRC +
snappy programs (one H100): the three-launch sequences of an older tree
(CRC, cell parse, LZ4 or snappy emission) against this tree's one
cluster launch (`rp_fused_lz4`, `rp_fused_snappy`: csrc/fused.cu), and
the older tree's own `rp_fused_lz4` beside this tree's.

    mkdir -p .chipcheck/old
    for f in codec.cu crc32c.cu fused.cu lz77.cuh crc_ops.cuh; do
        git show <commit>:redpanda_tpu_torch/csrc/$f > .chipcheck/old/$f; done
    python3 chip_fused.py breakdown .chipcheck/old [OUT_DIR]
    python3 chip_fused.py ab .chipcheck/old [OUT_DIR]

The old directory holds a tree whose `_fused_snappy` is the launch
sequence, with the C entry points `rp_crc32c`, `rp_cell_parse`,
`rp_lz4_emit`, `rp_snappy_emit` and `rp_fused_lz4` taking this tree's
argument lists: the tree of 5a3ba4a (for the LZ4 sequence alone, without
its fused.cu, the tree of be95b06).

Both modes first hold the new kernels exactly (CRC, out_len, the block's
bytes on [0, out_len)) against the old sequences at every cluster size
`plan` can choose on the skew edges (one repeated byte, all 4-grams
distinct, random bytes, a zero row, each cut to v in {0, 1, 3, 4, 5} and
full, at n = 512 and 65,536).

`breakdown` (chip_smoke phase 6's one row: one 16 x 1 KiB batch, n =
32,768): the old sequences and each of their launches alone; the old parse
cut to its phases (returns after the staging, each sort pass, the
candidate scatter, the verification, the scans: a copy of its codec.cu
with a run-time cut); the new kernel cut the same way at each cluster
size (after the staging, sort pass 0 with the CRC, pass 1, the candidate
scatter, the verification (plus one cluster barrier so no CTA leaves
while a peer reads it), exchange 1, exchange 2, heads and literals),
with each codec, and its `%globaltimer` marks; empty kernels: one plain
block, and the cluster launch at each size with each codec's shared
memory.

`ab`: old and new in turns (for each codec the old sequence and the new
kernel at each valid cluster size, for LZ4 also the old tree's kernel,
then the same in reverse) at B in {1, 4, 16, 64, 256} record batches
(half JSON-like, half random, n = 32,768), at chip_smoke phase 5's fused
shape (256 rows of 32 KiB bodies), and the standalone kernels the
sequences keep (`crc32c_device`, `cell_parse`, `lz4_emit`,
`snappy_emit`) at the one row, old against this tree's.

Every library is built under .chipcheck/fused (git-ignored) with
`-Xptxas -v` (registers and spills printed and kept); results are
printed and written to OUT_DIR/fused_<mode>.json (default .chipcheck/).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as cs
from redpanda_tpu_torch.ops import _build
from redpanda_tpu_torch.ops import cellparse as parse_ops
from redpanda_tpu_torch.ops import crc32c as crc_ops
from redpanda_tpu_torch.ops import fused
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chipcheck", "fused")
OUT = os.path.join(REPO, ".chipcheck")
BATCHES = (1, 4, 16, 64, 256)

CUT_VAR = "__device__ int rp_cut;  // a run-time phase cut (0: the whole kernel)\n"
SET_CUT = """
extern "C" int rp_set_cut(int c) { return (int)cudaMemcpyToSymbol(rp_cut, &c, sizeof(int)); }
"""
# (anchor, its replacement: "@" stands for the anchor) in the old tree's cell_parse_kernel
OLD_PARSE_CUTS = [
    ("__global__ void __launch_bounds__(PARSE_THREADS, 1)\ncell_parse_kernel", CUT_VAR + "@"),
    ("    const int tid = threadIdx.x;\n    const i64 row = blockIdx.x;\n", "@    const int cut = rp_cut;\n"),
    ("    for (int i = tid; i < n + CELL; i += PARSE_THREADS) d[i] = src[i];\n    __syncthreads();\n",
     "@    if (cut == 1) return;\n"),
    ("    radix_pass<true>(d, nullptr, ka, ent, 16, r0, r1, scan_sh);\n", "@    if (cut == 2) return;\n"),
    ("    radix_pass<false>(d, ka, kb, ent, 24, r0, r1, scan_sh);\n", "@    if (cut == 3) return;\n"),
    ("        cand_w[key & 0xFFFFu] = (uint16_t)c;\n    }\n    __syncthreads();\n", "@    if (cut == 4) return;\n"),
    ("    // -- absorption, run ends, literal attribution (block scans)\n", "    if (cut == 5) return;\n@"),
    ("    const i64 ob = row * nc;\n", "@    if (cut == 6) return;\n"),
]
OLD_PHASES = ("staging", "sort pass 0", "sort pass 1", "candidate scatter", "verification", "scans", "writes")
# the same in this tree's fused_kernel: every cut returns where no peer
# will touch the CTA's shared memory again (after a cluster barrier)
NEW_CUTS = [
    ("template <class Codec, int C>\n__global__ void __launch_bounds__(FUSED_THREADS, 1) fused_kernel", CUT_VAR + "@"),
    ("    cluster_arrive();  // peers may write this CTA's memory once every CTA has started\n",
     "@    const int cut = rp_cut;\n"),
    ("    // -- partition:", "    if (cut == 1) { cluster_wait(); return; }\n@"),
    ("                exchange_wait(bar0 + 8 * BAR_KEYS0);\n",
     "@                if (cut == 2) return;  // every CTA has its keys; none sends more\n"),
    ("    // -- candidates: each rank's", "    if (cut == 3) return;\n@"),
    ("    // -- verification: a thread a position", "    if (cut == 4) return;\n@"),
    ("    // -- absorption inside the CTA", "    if (cut == 5) { cluster_sync(); return; }\n@"),
    ("    // -- exchange 1 read:", "    if (cut == 6) return;\n@"),
    ("    // -- exchange 2 read:", "    if (cut == 7) return;\n@"),
    ("    // -- the deferred parts, each by the whole CTA", "    if (cut == 8) return;\n@"),
]
# %globaltimer marks (ns, the same clock on every SM) thread 0 of each CTA
# takes in a copy of this tree's fused_kernel: (anchor, replacement)
MARK_VAR = """__device__ unsigned long long rp_marks[4096 * 64];
__device__ __forceinline__ unsigned long long rp_now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define MARK(i) if (threadIdx.x == 0) rp_marks[(size_t)blockIdx.x * 64 + (i)] = rp_now()
"""
GET_MARKS = """
extern "C" int rp_get_marks(unsigned long long* host, int count) {
    return (int)cudaMemcpyFromSymbol(host, rp_marks, sizeof(unsigned long long) * count);
}
"""
MARKS = [
    ("template <class Codec, int C>\n__global__ void __launch_bounds__(FUSED_THREADS, 1) fused_kernel", MARK_VAR + "@"),
    ("    cluster_arrive();  // peers may write this CTA's memory once every CTA has started\n",
     "@    MARK(0);\n"),
    ("    // -- partition:", "    MARK(1);\n@"),
    ("            __syncthreads();\n            if (pass == 0) cluster_wait();  // every CTA has started\n",
     "            __syncthreads();\n            MARK(2 + 8 * pass);\n            if (pass == 0) cluster_wait();\n"
     "            MARK(3 + 8 * pass);\n"),
    ("            if (pass == 0) {\n                crc_lanes();\n", "            MARK(4 + 8 * pass);\n@"),
    ("                crc_join();\n            }\n            exchange_wait(cnt_bar);\n",
     "                crc_join();\n            }\n            MARK(5 + 8 * pass);\n            exchange_wait(cnt_bar);\n"
     "            MARK(6 + 8 * pass);\n"),
    ("            __syncthreads();\n            // the stable scatter, 32 keys a step, each to its rank's owner\n",
     "            __syncthreads();\n            MARK(7 + 8 * pass);\n"),
    ("            if (pass == 0) {\n                exchange_wait(bar0 + 8 * BAR_KEYS0);\n            } else {\n"
     "                cluster_sync();\n            }\n",
     "            MARK(8 + 8 * pass);\n@            MARK(9 + 8 * pass);\n"),
    ("        cluster.map_shared_rank(cand, owner)[pos - owner * cpc * CELL] = (uint16_t)c;\n    }\n    cluster_sync();\n",
     "        cluster.map_shared_rank(cand, owner)[pos - owner * cpc * CELL] = (uint16_t)c;\n    }\n    MARK(18);\n"
     "    cluster_sync();\n    MARK(19);\n"),
    ("    __syncthreads();\n\n    // -- absorption inside the CTA", "    __syncthreads();\n    MARK(20);\n\n    // -- absorption inside the CTA"),
    ("    exchange_wait(bar0 + 8 * BAR_SUMM1);\n", "    MARK(21);\n@    MARK(22);\n"),
    ("    exchange_wait(bar0 + 8 * BAR_SUMM2);\n", "    MARK(23);\n@"),
    ("    // -- exchange 2 read:", "    MARK(24);\n@"),
    ("    const int nseq = s2[k].heads;\n", "@    MARK(25);\n"),
    ("    __syncthreads();\n\n    // -- the deferred parts", "    __syncthreads();\n    MARK(26);\n\n    // -- the deferred parts"),
]
MARK_NAMES = {0: "start", 1: "staged", 2: "pass 0 counted", 3: "pass 0 start barrier", 4: "pass 0 counts pushed",
              5: "CRC lanes folded", 6: "pass 0 counts in", 7: "pass 0 offsets", 8: "pass 0 scattered",
              9: "pass 0 keys in", 10: "pass 1 counted", 12: "pass 1 counts pushed", 14: "pass 1 counts in",
              13: "CRC joined", 15: "pass 1 offsets", 16: "pass 1 scattered", 17: "pass 1 barrier", 18: "candidates stored",
              19: "candidate barrier", 20: "verified", 21: "exchange 1 pushed", 22: "exchange 1 in",
              23: "exchange 2 pushed", 24: "exchange 2 in", 25: "sequences placed", 26: "heads and literals"}
# on the marked copy: the whole body twice in one launch, the second time
# with code and tables warm (its marks 32 up; the mbarriers armed again
# and waited on with the second phase's parity)
TWICE = [
    ("    cg::cluster_group cluster = cg::this_cluster();\n", "@    for (int rep_ = 0; rep_ < 2; ++rep_) {\n"),
    ("        for (int b = 0; b < N_BARS; ++b) bar_init(bar0 + 8 * b);\n",
     "        if (rep_ == 0)\n            for (int b = 0; b < N_BARS; ++b) bar_init(bar0 + 8 * b);\n"),
    ("__device__ __forceinline__ void bar_wait(uint32_t bar) {", "__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {"),
    ('        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\\n"',
     '        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\\n"'),
    ('        "}\\n" ::"r"(bar) : "memory");', '        "}\\n" ::"r"(bar), "r"(parity) : "memory");'),
    ("__device__ __forceinline__ void exchange_wait(uint32_t bar) {\n    bar_wait(bar);",
     "__device__ __forceinline__ void exchange_wait(uint32_t bar, int parity) {\n    bar_wait(bar, parity);"),
    ("            exchange_wait(cnt_bar);\n", "            exchange_wait(cnt_bar, rep_);\n"),
    ("                exchange_wait(bar0 + 8 * BAR_KEYS0);\n", "                exchange_wait(bar0 + 8 * BAR_KEYS0, rep_);\n"),
    ("    exchange_wait(bar0 + 8 * BAR_SUMM1);\n", "    exchange_wait(bar0 + 8 * BAR_SUMM1, rep_);\n"),
    ("    exchange_wait(bar0 + 8 * BAR_SUMM2);\n", "    exchange_wait(bar0 + 8 * BAR_SUMM2, rep_);\n"),
    ("    }\n}\n\n// no work: a launch of it at the fused kernel's grid", "    }\n    __syncthreads();\n    }\n}\n\n"
     "// no work: a launch of it at the fused kernel's grid"),
    ("#define MARK(i) if (threadIdx.x == 0) rp_marks[(size_t)blockIdx.x * 64 + (i)] = rp_now()",
     "#define MARK(i) if (threadIdx.x == 0) rp_marks[(size_t)blockIdx.x * 64 + (i) + 32 * rep_] = rp_now()"),
]
TWICE_NAMES = {**{i: f"first: {name}" for i, name in MARK_NAMES.items()},
               **{32 + i: f"second: {name}" for i, name in MARK_NAMES.items()}}
# on the marked copy: the CRC fold left out
NO_CRC = [("                crc_lanes();\n", ""), ("                crc_join();\n", "")]
NEW_PHASES = ("staging", "sort pass 0 + CRC", "sort pass 1", "candidate scatter", "verification (+1 barrier)",
              "exchange 1", "exchange 2", "heads and literals", "deferred parts and flush")


def patched(src: str, patches: list, name: str, tail: str) -> str:
    """`src` with each (anchor, replacement) applied ("@" stands for the
    anchor, which must occur once) and `tail` appended."""
    for anchor, repl in patches:
        if src.count(anchor) != 1:
            raise AssertionError(f"{name}: anchor does not occur once: {anchor[:60]!r}")
        src = src.replace(anchor, repl.replace("@", anchor))
    return src + tail


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
            if "registers" in ln or "Compiling entry" in ln or "bytes stack" in ln or "spill" in ln]
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


def libraries(old_dir: str, ptxas: dict) -> dict:
    """The old tree's CRC, codec and fused libraries (the codec also with
    its parse's cuts), this tree's fused kernel with its cuts, all bound
    with this tree's argument lists; and this tree's own libraries."""
    codec_old = open(os.path.join(old_dir, "codec.cu")).read()
    new_src = open(os.path.join(_build.CSRC_DIR, "fused.cu")).read()
    libs = build({
        "old_fused": (open(os.path.join(old_dir, "fused.cu")).read(), old_dir),
        "old_crc32c": (open(os.path.join(old_dir, "crc32c.cu")).read(), old_dir),
        "old_codec": (codec_old, old_dir),
        "old_codec_cut": (patched(codec_old, OLD_PARSE_CUTS, "old", SET_CUT), old_dir),
        "new_cut": (patched(new_src, NEW_CUTS, "new", SET_CUT), _build.CSRC_DIR),
        "new_marks": (patched(new_src, MARKS, "marks", GET_MARKS), _build.CSRC_DIR),
        "new_nocrc": (patched(patched(new_src, MARKS, "marks", ""), NO_CRC, "no CRC", GET_MARKS), _build.CSRC_DIR),
        "new_twice": (patched(patched(new_src, MARKS, "marks", ""), TWICE, "twice", GET_MARKS), _build.CSRC_DIR),
    }, ptxas)
    _build.bind(libs["old_crc32c"], "rp_crc32c", 4, 4)
    _build.bind(libs["old_fused"], "rp_fused_lz4", 6, 8)
    for fn, ptrs, sizes in (("rp_cell_parse", 10, 4), ("rp_lz4_emit", 11, 5), ("rp_snappy_emit", 11, 5)):
        for name in ("old_codec", "old_codec_cut"):
            _build.bind(libs[name], fn, ptrs, sizes)
    fused.bind(libs["new_cut"])
    for name in ("new_marks", "new_nocrc", "new_twice"):
        fused.bind(libs[name]).rp_get_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for lib in (libs["old_codec_cut"], libs["new_cut"]):
        lib.rp_set_cut.argtypes = [ctypes.c_int]
        lib.rp_set_cut.restype = ctypes.c_int
    _build.build_all(("crc32c", "codec", "fused"))
    libs["this_crc32c"], libs["this_codec"], libs["this_fused"] = crc_ops._lib(), parse_ops._lib(), fused._lib()
    return libs


@contextlib.contextmanager
def using(crc=None, codec=None, fused_lib=None):
    """Run the wrappers on other libraries for the duration."""
    saved = crc_ops._LIB, parse_ops._LIB, fused._LIB
    crc_ops._LIB = crc or saved[0]
    parse_ops._LIB = codec or saved[1]
    fused._LIB = fused_lib or saved[2]
    try:
        yield
    finally:
        crc_ops._LIB, parse_ops._LIB, fused._LIB = saved


def set_cut(lib, cut: int) -> None:
    _build.check(lib, lib.rp_set_cut(cut), "set cut")


def time_us(fn, reps: int = 30) -> float:
    return cs.time_kernel(fn, reps=reps) * 1e3


def stage(torch, prefixes, bodies):
    mat, blen, n = fused.stage_fused(prefixes, bodies)
    return torch.from_numpy(mat).cuda(), torch.from_numpy(blen).cuda(), n


def batch_rows(torch, b: int):
    """b record batches (16 x 1 KiB records, even ones JSON-like, odd ones
    random), staged as `crc_lz4_fused` stages them."""
    batches = cs.build_batches(np.random.default_rng(cs.SEED + 6), count=b)
    return stage(torch, [x.header.crc_prefix() for x in batches], [bytes(x.body) for x in batches])


def outputs(torch, res) -> list:
    crc, out, out_len = res
    torch.cuda.synchronize()
    cols = torch.arange(out.shape[1], device=out.device)[None, :] < out_len[:, None].long()
    return [crc.clone(), out_len.clone(), torch.where(cols, out, 0)]


SEQUENCE = {"lz4": fused._fused_sequence, "snappy": fused._fused_snappy_sequence}
CODECS = tuple(SEQUENCE)


def held(torch, libs, data, valid, n, sizes, what: str, codec: str = "lz4") -> None:
    """Each cluster size's outputs equal to the old sequence's (for LZ4
    also the old tree's kernel's at each size)."""
    with using(libs["old_crc32c"], libs["old_codec"]):
        want = outputs(torch, SEQUENCE[codec](data, valid, n))
    runs = [(f"C={c}", new_cluster(libs["this_fused"], c, codec)) for c in sizes]
    if codec == "lz4":
        runs += [(f"old kernel C={c}", new_cluster(libs["old_fused"], c, codec)) for c in sizes]
    for side, run in runs:
        got = outputs(torch, run(data, valid, n))
        for g, w, name in zip(got, want, ("crc", "out_len", "block")):
            if not torch.equal(g, w):
                raise AssertionError(f"{what}, {codec} {side}: {name} differs from the old sequence")


def sizes_for(n: int, codec: str = "lz4") -> list:
    """The cluster sizes `plan` can choose for bucket n on this card."""
    return fused.sizes(n, fused.resident("cuda", n, codec))


def held_edges(torch, libs) -> str:
    for n in (512, 65536):
        full = {"one_byte": b"a" * n, "distinct": cs.distinct_grams_row(n),
                "random": np.random.default_rng(cs.SEED + 31).integers(0, 256, n, dtype=np.uint8).tobytes(),
                "zeros": bytes(n)}
        for kind, raw in full.items():
            bodies = [raw[:v] for v in (0, 1, 3, 4, 5)] + [raw]
            rng = np.random.default_rng(cs.SEED + 32)
            prefixes = [rng.integers(0, 256, fused.PREFIX, dtype=np.uint8).tobytes() for _ in bodies]
            data, valid, nn = stage(torch, prefixes, bodies)
            for codec in CODECS:
                held(torch, libs, data, valid, nn, sizes_for(nn, codec), f"{kind}@{n}", codec)
    msg = ("skew edges (one byte, distinct, random, zeros; v in {0,1,3,4,5,n}; n = 512, 65536): LZ4 and snappy "
           "exact at every C")
    print(msg, flush=True)
    return msg


def old_sequence(libs, codec: str = "lz4"):
    def run(data, valid, n):
        with using(libs["old_crc32c"], libs["old_codec"]):
            return SEQUENCE[codec](data, valid, n)
    return run


def new_cluster(lib, c, codec: str = "lz4"):
    def run(data, valid, n):
        with using(fused_lib=lib):
            return fused.launch_fused(data, valid, n, c, codec)
    return run


def breakdown(torch, old_dir: str) -> dict:
    ptxas = {}
    libs = libraries(old_dir, ptxas)
    res = {"card": cs.nvidia_smi(), "clocks": clocks(), "ptxas": ptxas, "edges": held_edges(torch, libs)}
    data, valid, n = batch_rows(torch, 1)
    res["row"] = f"B=1 n={n} bytes={int(valid.sum())}"
    us = {}
    with using(libs["old_crc32c"], libs["old_codec"]):
        us["old sequence"] = time_us(lambda: fused._fused_sequence(data, valid, n))
        us["old snappy sequence"] = time_us(lambda: fused._fused_snappy_sequence(data, valid, n))
        us["old crc32c_rows"] = time_us(lambda: crc_ops.crc32c_rows(data, valid, fused.PREFIX))
        parse = parse_ops.launch_parse(data, valid, n, fused.PREFIX)
        us["old cell_parse"] = time_us(lambda: parse_ops.launch_parse(data, valid, n, fused.PREFIX))
        us["old lz4_emit"] = time_us(lambda: lz4_ops.lz4_emit(data, valid, parse, n, fused.PREFIX))
        us["old snappy_emit"] = time_us(lambda: snappy_ops.snappy_emit(data, valid, parse, n, fused.PREFIX))
    old = libs["old_codec_cut"]
    with using(libs["old_crc32c"], old):
        for cut, phase in list(enumerate(OLD_PHASES[:-1], start=1)) + [(0, "writes")]:
            set_cut(old, cut)
            us[f"old cell_parse (cut build) to the end of {phase}"] = time_us(
                lambda: parse_ops.launch_parse(data, valid, n, fused.PREFIX))
        set_cut(old, 0)
    new = libs["new_cut"]
    for codec in CODECS:
        held(torch, {**libs, "this_fused": new}, data, valid, n, sizes_for(n, codec), "row (cut build, cut 0)",
             codec)
        tag = "" if codec == "lz4" else " snappy"
        for c in sizes_for(n, codec):
            with using(fused_lib=new):
                for cut, phase in list(enumerate(NEW_PHASES[:-1], start=1)) + [(0, "the whole kernel")]:
                    set_cut(new, cut)
                    label = phase if cut == 0 else f"to the end of {phase}"
                    us[f"new{tag} C={c} {label}"] = time_us(lambda: fused.launch_fused(data, valid, n, c, codec))
                set_cut(new, 0)
                us[f"empty cluster launch{tag} C={c}"] = time_us(lambda: fused.launch_empty(data, n, c, codec))
            with using(fused_lib=libs["this_fused"]):
                us[f"new{tag} C={c} (this tree's build)"] = time_us(
                    lambda: fused.launch_fused(data, valid, n, c, codec))
                smem, clusters = fused.shape_info(n, c, codec)
                res[f"{codec} C={c} shared memory, resident clusters"] = [smem, clusters]
    for codec in CODECS:
        tag = "" if codec == "lz4" else f" ({codec})"
        res[f"marks{tag}"] = marks(torch, libs["new_marks"], data, valid, n, MARK_NAMES, codec=codec)
    res["marks, no CRC"] = marks(torch, libs["new_nocrc"], data, valid, n, MARK_NAMES)
    res["marks, the body twice"] = marks(torch, libs["new_twice"], data, valid, n, TWICE_NAMES)
    lib = libs["this_codec"]
    _build.bind(lib, "rp_empty", 0, 0)
    stream = _build.stream_of(data)
    us["empty plain block (1 x 1024)"] = time_us(lambda: _build.check(lib, lib.rp_empty(stream), "empty"))
    res["us"] = us
    print("breakdown", json.dumps(res["us"], indent=1), flush=True)
    return res


def marks(torch, lib, data, valid, n: int, names: dict, reps: int = 20, codec: str = "lz4") -> dict:
    """Per cluster size, each mark's time from the cluster's first start
    (µs, medians over reps): the earliest and the latest CTA."""
    out = {}
    for c in sizes_for(n, codec):
        runs = []
        with using(fused_lib=lib):
            for _ in range(reps + 3):
                torch.cuda._sleep(1_000_000)
                fused.launch_fused(data, valid, n, c, codec)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * (c * 64))()
                _build.check(lib, lib.rp_get_marks(ctypes.addressof(buf), c * 64), "marks")
                runs.append(np.array(buf, np.int64).reshape(c, 64))
        runs = np.stack(runs[3:])  # [reps, C, 32]
        rel = (runs - runs[:, :, :1].min(axis=1, keepdims=True)) / 1e3
        out[f"C={c}"] = {f"{i} {name}": [float(np.median(rel[:, :, i].min(axis=1))),
                                          float(np.median(rel[:, :, i].max(axis=1)))]
                         for i, name in names.items()}
        if 20 in names:  # each CTA's verification (candidate barrier to verified)
            out[f"C={c}"]["verification by CTA"] = [float(x) for x in np.median(rel[:, :, 20] - rel[:, :, 19], axis=0)]
    print("marks", json.dumps(out, indent=1), flush=True)
    return out


def standalone(torch, libs) -> dict:
    """The kernels the sequence keeps, at the one row: old and this tree's
    builds in turns, exact against each other."""
    data, valid, n = batch_rows(torch, 1)
    off = fused.PREFIX
    sides = {"old": (libs["old_crc32c"], libs["old_codec"]), "new": (libs["this_crc32c"], libs["this_codec"])}
    items = {
        "crc32c_device": lambda: crc_ops.crc32c_rows(data, valid, off),
        "cell_parse": lambda: parse_ops.launch_parse(data, valid, n, off),
        "lz4_emit": lambda p: lz4_ops.lz4_emit(data, valid, p, n, off),
        "snappy_emit": lambda p: snappy_ops.snappy_emit(data, valid, p, n, off),
    }
    outs, t = {}, {}
    for side, (crc_lib, codec_lib) in sides.items():
        with using(crc_lib, codec_lib):
            parse = parse_ops.launch_parse(data, valid, n, off)
            outs[side] = [crc_ops.crc32c_rows(data, valid, off), *parse,
                          *lz4_ops.lz4_emit(data, valid, parse, n, off),
                          *snappy_ops.snappy_emit(data, valid, parse, n, off)]
            torch.cuda.synchronize()
    lens = (outs["old"][9], outs["old"][11])
    for i, (a, b) in enumerate(zip(outs["old"], outs["new"])):
        if i in (8, 10):  # the blocks: bytes on [0, out_len)
            ln = lens[0] if i == 8 else lens[1]
            cols = torch.arange(a.shape[1], device=a.device)[None, :] < ln[:, None].long()
            a, b = torch.where(cols, a, 0), torch.where(cols, b, 0)
        if not torch.equal(a, b):
            raise AssertionError(f"standalone output {i}: this tree's build differs from the old one")
    for side in ("old", "new", "new", "old"):
        crc_lib, codec_lib = sides[side]
        with using(crc_lib, codec_lib):
            parse = parse_ops.launch_parse(data, valid, n, off)
            for name, fn in items.items():
                call = (lambda fn=fn: fn(parse)) if name.endswith("emit") else fn
                t.setdefault(f"{name} {side}", []).append(time_us(call))
    return {"us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t}


def ab(torch, old_dir: str) -> dict:
    ptxas = {}
    libs = libraries(old_dir, ptxas)
    res = {"card": cs.nvidia_smi(), "clocks": clocks(), "ptxas": ptxas, "edges": held_edges(torch, libs),
           "resident": {codec: fused.resident(torch.device("cuda"), 32768, codec) for codec in CODECS}}
    shapes = {f"B={b}": batch_rows(torch, b) for b in BATCHES}
    data, valid, n, _ = cs.codec_shapes(torch)["fused"]
    shapes["fused 256 x 32 KiB"] = (data, valid, n)
    sides_of = {}
    for codec in CODECS:
        tag = "" if codec == "lz4" else f"{codec} "
        sides_of[f"{tag}old"] = old_sequence(libs, codec)
        for c in fused.CLUSTERS:
            sides_of[f"{tag}C={c}"] = new_cluster(libs["this_fused"], c, codec)
            if codec == "lz4":
                sides_of[f"old kernel C={c}"] = new_cluster(libs["old_fused"], c, codec)
    for label, (data, valid, n) in shapes.items():
        b = data.shape[0]
        t = {}
        for codec in CODECS:
            sizes = sizes_for(n, codec)
            held(torch, libs, data, valid, n, sizes, label, codec)
            tag = "" if codec == "lz4" else f"{codec} "
            order = [f"{tag}old"] + [f"{tag}C={c}" for c in sizes]
            if codec == "lz4":
                order += [f"old kernel C={c}" for c in sizes]
            for side in order + order[::-1]:
                t.setdefault(side, []).append(time_us(lambda: sides_of[side](data, valid, n), reps=20))
        r = {"B": b, "n": n, "bytes": int(valid.sum()),
             "plan": {codec: fused.plan_for(data, n, codec) for codec in CODECS},
             "us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t}
        res[label] = r
        print(label, json.dumps(r), flush=True)
    res["standalone"] = standalone(torch, libs)
    print("standalone", json.dumps(res["standalone"]), flush=True)
    return res


def clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_fused: no CUDA device available", file=sys.stderr)
        return 2
    mode, old_dir = sys.argv[1], sys.argv[2]
    out = sys.argv[3] if len(sys.argv) > 3 else OUT
    print(cs.nvidia_smi(), flush=True)
    res = {"breakdown": breakdown, "ab": ab}[mode](torch, old_dir)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"fused_{mode}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"ok": True, "mode": mode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
