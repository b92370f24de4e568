#!/usr/bin/env python3
"""On-card breakdown and A/B timing of the zstd huff0 encode (one H100).

    git show <commit>:redpanda_tpu_torch/csrc/zstd.cu > .chipcheck/zstd_old.cu
    python3 chip_zstd_encode.py breakdown .chipcheck/zstd_old.cu [OUT_DIR]
    python3 chip_zstd_encode.py ab .chipcheck/zstd_old.cu [OUT_DIR]
    python3 chip_zstd_encode.py newvar - [OUT_DIR]

`breakdown` takes a zstd.cu whose encode is the two-kernel pair
`rp_zstd_lengths` + `rp_zstd_emit` (one 256-thread block a row, then one
512-thread block a stream), builds variant copies of it beside the tree
(the histogram alone, two other histogram schemes, the emission cut
after each phase, the pair with `clock64()` marks a block between its
phases and the Kraft loops' step counts, and empty kernels at each
launch shape), and times each with CUDA events at three shapes: one
call's row (one 16 x 1 KiB record batch staged as a zstd row, n =
32,768, column offset 40), 16 chunks of a tiered segment, and one 64 KiB
row whose Kraft seed overshoots by 100 slots. It also runs the marked
pair over all 2,048 chunks of a 128 MiB segment and 1,024 batch rows,
for the step counts and the phase cycles per row.

`ab` times that pair beside this tree's `rp_zstd_encode` in turns (old,
new, new, old) at the one-call row, the segment's 2,048 x 64 KiB and
the fused 256 x 32 KiB shape, each output held exactly against the
other. `breakdown` and `ab` target the two-kernel pair of a8c2a9e's zstd.cu.

    mkdir -p .chipcheck/old
    for f in zstd.cu crc32c.cu crc_ops.cuh; do
        git show <commit>:redpanda_tpu_torch/csrc/$f > .chipcheck/old/$f; done
    python3 chip_zstd_encode.py fused .chipcheck/old [OUT_DIR]

`fused` takes a tree whose `_fused_zstd` is the two-launch sequence
(`rp_crc32c`, then `rp_zstd_encode`, with this tree's argument lists:
288c153's) and this tree's one-launch `rp_fused_zstd` (the encode kernel
with its CRC stage). Every output of the new kernel (CRC, nbits, codes,
all stream bytes, bits) is first held exactly against the old sequence's
and the plain chain's at one call's row (one 16 x 1 KiB record batch,
n = 32,768), at 4, 16, 64 and 256 batches, at the fused 256 x 32 KiB
shape and on edge rows (v = 0, 1, 3, 4, 5, 8, n - 1, n of random bytes
and of one repeated byte at n = 512 and 65,536, alone and 40 to a
launch). Then, in turns (old, new, new, old), at each shape: the old
sequence and each of its launches alone (the breakdown), the new kernel,
and the standalone encode (`kCrc` false) old against new, also at the
segment's 2,048 x 64 KiB; beside them the empty encode launch. Both
instantiations' `-Xptxas -v` lines are kept.

Variants are built under .chipcheck/ (git-ignored); results are printed
and written to OUT_DIR/zstd_encode_<mode>.json (default .chipcheck/).
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
from redpanda_tpu_torch.ops import fused
from redpanda_tpu_torch.ops import zstd as zstd_ops

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chipcheck", "encode")
OUT = os.path.join(REPO, ".chipcheck")

EMPTIES = r"""
#include <cooperative_groups.h>
__global__ void rp_empty_kernel() {}
__global__ void __cluster_dims__(4, 1, 1) rp_empty_cluster_kernel() {
    cooperative_groups::this_cluster().sync();
    cooperative_groups::this_cluster().sync();
}
extern "C" int rp_empty_shape(long long blocks, long long threads, long long cluster, void* stream) {
    if (cluster) rp_empty_cluster_kernel<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>();
    else rp_empty_kernel<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""

DBG = r"""
__device__ long long g_dbg[1 << 18];
__device__ long long g_dbg2[1 << 17];
extern "C" int rp_dbg(void* host, long long which, long long n) {
    return (int)(which ? cudaMemcpyFromSymbol(host, g_dbg2, n * 8) : cudaMemcpyFromSymbol(host, g_dbg, n * 8));
}
"""


def sub(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise AssertionError(f"patch does not apply once: {old[:60]!r}")
    return s.replace(old, new)


HIST_END = ("    for (int i = head + 16 * nvec + tid; i < v; i += LEN_THREADS) atomicAdd(&h[src[i]], 1);\n"
            "    __syncthreads();\n")


def hist_return(s: str, subs: int = 1) -> str:
    """The lengths kernel cut after its histogram (nbits <- the counts)."""
    return sub(s, HIST_END, HIST_END + (
        "    { int cnt = 0;\n"
        f"      for (int w = 0; w < LEN_WARPS * {subs}; ++w) cnt += (&hist[0][0])[w * 256 + tid];\n"
        "      nbits_out[row * 256 + tid] = (uint8_t)cnt; codes_out[row * 256 + tid] = cnt; return; }\n"))


def hist_match(s: str) -> str:
    """Warp-aggregated adds: one atomicAdd of the popcount per distinct byte."""
    old = ("    for (int i = tid; i < nvec; i += LEN_THREADS) {\n"
           "        const uint4 x = vsrc[i];\n"
           "        const uint32_t w4[4] = {x.x, x.y, x.z, x.w};\n"
           "#pragma unroll\n"
           "        for (int k = 0; k < 4; ++k)\n"
           "#pragma unroll\n"
           "            for (int b = 0; b < 4; ++b) atomicAdd(&h[(w4[k] >> (8 * b)) & 255], 1);\n"
           "    }\n")
    new = ("    for (int b0 = warp * 32; b0 < nvec; b0 += LEN_THREADS) {\n"
           "        const int i = b0 + lane;\n"
           "        const uint4 x = i < nvec ? vsrc[i] : make_uint4(0, 0, 0, 0);\n"
           "        const uint32_t w4[4] = {x.x, x.y, x.z, x.w};\n"
           "#pragma unroll\n"
           "        for (int k = 0; k < 4; ++k)\n"
           "#pragma unroll\n"
           "            for (int b = 0; b < 4; ++b) {\n"
           "                const uint32_t key = i < nvec ? (w4[k] >> (8 * b)) & 255 : 256u + lane;\n"
           "                const unsigned m = __match_any_sync(FULL, key);\n"
           "                if (key < 256 && __ffs(m) - 1 == lane) atomicAdd(&h[key], __popc(m));\n"
           "            }\n"
           "    }\n")
    return hist_return(sub(s, old, new))


def hist_sub4(s: str) -> str:
    """Four sub-histograms a warp (lane & 3): at most 8 lanes on one bin."""
    s = sub(s, "    __shared__ int hist[LEN_WARPS][256];", "    __shared__ int hist[LEN_WARPS * 4][256];")
    s = sub(s, "    for (int i = tid; i < LEN_WARPS * 256; i += LEN_THREADS) (&hist[0][0])[i] = 0;",
            "    for (int i = tid; i < LEN_WARPS * 4 * 256; i += LEN_THREADS) (&hist[0][0])[i] = 0;")
    s = sub(s, "    int* h = hist[warp];", "    int* h = hist[warp * 4 + (lane & 3)];")
    return hist_return(s, 4)


def marked(s: str) -> str:
    """clock64() marks a block (thread 0, after each barrier) between the
    phases of both kernels, and the Kraft loops' step counts."""
    s = sub(s, "typedef long long i64;", "typedef long long i64;\n" + DBG)
    s = sub(s, "    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n    const i64 row = blockIdx.x;\n",
            "    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n    const i64 row = blockIdx.x;\n"
            "    long long c0 = clock64(), cz = 0, ch = 0, cs = 0, ck = 0; int n_down = 0, n_up = 0;\n")
    s = sub(s, "    __syncthreads();\n\n    // -- histogram of [0, v)\n",
            "    __syncthreads();\n    cz = clock64();\n\n    // -- histogram of [0, v)\n")
    s = sub(s, HIST_END, HIST_END + "    ch = clock64();\n")
    s = sub(s, "        u_s[tid] = c > 0 ? u : 0;\n    }\n    __syncthreads();\n",
            "        u_s[tid] = c > 0 ? u : 0;\n    }\n    __syncthreads();\n    cs = clock64();\n")
    s = sub(s, "            if (best == FULL) break;\n", "            if (best == FULL) break;\n            ++n_down;\n")
    s = sub(s, "            if (best < 0) break;\n", "            if (best < 0) break;\n            ++n_up;\n")
    s = sub(s, "        for (int k = 0; k < 8; ++k) u_s[8 * lane + k] = uu[k];\n    }\n    __syncthreads();\n",
            "        for (int k = 0; k < 8; ++k) u_s[8 * lane + k] = uu[k];\n    }\n    __syncthreads();\n"
            "    ck = clock64();\n")
    s = sub(s, "    codes_out[row * 256 + tid] = code;\n}\n",
            "    codes_out[row * 256 + tid] = code;\n    __syncthreads();\n"
            "    if (tid == 0) { long long* d = g_dbg + 8 * row; d[0] = cz - c0; d[1] = ch - cz; d[2] = cs - ch;\n"
            "        d[3] = ck - cs; d[4] = clock64() - ck; d[5] = n_down; d[6] = n_up; d[7] = v; }\n}\n")
    # the emission
    s = sub(s, "    const int tid = threadIdx.x;\n    const i64 row = blockIdx.x >> 2;\n",
            "    const int tid = threadIdx.x;\n    const i64 row = blockIdx.x >> 2;\n"
            "    long long e0 = clock64(), e1 = 0, e2 = 0, e3 = 0, e4 = 0;\n")
    s = sub(s, "        sym_s[i] = src[p < n ? p : n - 1];\n    }\n    __syncthreads();\n",
            "        sym_s[i] = src[p < n ? p : n - 1];\n    }\n    __syncthreads();\n    e1 = clock64();\n")
    s = sub(s, "    int c = block_scan_excl_sum(local, scan_sh, &total_s);\n    __syncthreads();\n",
            "    int c = block_scan_excl_sum(local, scan_sh, &total_s);\n    __syncthreads();\n    e2 = clock64();\n")
    s = sub(s, "            if (off + nb > 32) atomicOr(&img[w + 1], code >> (32 - off));\n        }\n    }\n    __syncthreads();\n",
            "            if (off + nb > 32) atomicOr(&img[w + 1], code >> (32 - off));\n        }\n    }\n    __syncthreads();\n"
            "    e3 = clock64();\n")
    s = sub(s, "    if (tid == 0) img[tb >> 5] |= 1u << (tb & 31);  // end marker\n    __syncthreads();\n",
            "    if (tid == 0) img[tb >> 5] |= 1u << (tb & 31);  // end marker\n    __syncthreads();\n    e4 = clock64();\n")
    s = sub(s, "    if (tid == 0) bits_out[row * 4 + st] = tb;\n}\n",
            "    if (tid == 0) bits_out[row * 4 + st] = tb;\n    __syncthreads();\n"
            "    if (tid == 0) { long long* d = g_dbg2 + 8 * (i64)blockIdx.x; d[0] = e1 - e0; d[1] = e2 - e1;\n"
            "        d[2] = e3 - e2; d[3] = e4 - e3; d[4] = clock64() - e4; d[5] = slen; d[6] = tb; }\n}\n")
    return s


EMIT_STAGED = "        sym_s[i] = src[p < n ? p : n - 1];\n    }\n    __syncthreads();\n"
EMIT_SCANNED = "    int c = block_scan_excl_sum(local, scan_sh, &total_s);\n    __syncthreads();\n"
EMIT_PLACED = ("            if (off + nb > 32) atomicOr(&img[w + 1], code >> (32 - off));\n        }\n    }\n"
               "    __syncthreads();\n")


def emit_cut(at: str, keep: str):
    def f(s: str) -> str:
        return sub(s, at, at + f"    if (tid == 0) bits_out[row * 4 + st] = (int)({keep});\n    return;\n")
    return f


VARIANTS = {
    "base": lambda s: s,
    "marked": marked,
    "hist_only": hist_return,
    "hist_match": hist_match,
    "hist_sub4": hist_sub4,
    "emit_stage": emit_cut(EMIT_STAGED, "sym_s[0] + nb_t[0] + img[0]"),
    "emit_scan": emit_cut(EMIT_SCANNED, "c + total_s"),
    "emit_place": emit_cut(EMIT_PLACED, "img[0] + img[words - 1]"),
}


def nvcc(name: str, src, flags=()) -> tuple:
    if isinstance(src, tuple):
        src, flags = src
    path = os.path.join(WORK, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = os.path.join(WORK, f"lib{name}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {name}:\n{r.stderr[-3000:]}")
    info = [ln.strip() for ln in r.stderr.splitlines() if "registers" in ln or "Compiling entry" in ln
            or "bytes stack" in ln or "spill" in ln]
    return name, so, info


def build(sources: dict, ptxas: dict = None) -> dict:
    os.makedirs(WORK, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda kv: nvcc(*kv), sources.items()))
    libs = {}
    for name, so, info in built:
        lib = ctypes.CDLL(so)
        lib.rp_error_string.restype = ctypes.c_char_p
        lib.rp_error_string.argtypes = [ctypes.c_int]
        for ln in info:
            print(f"[ptxas] {name}: {ln}", flush=True)
        if ptxas is not None:
            ptxas[name] = info
        libs[name] = lib
    return libs


def bind_pair(lib) -> None:
    _build.bind(lib, "rp_zstd_lengths", 4, 4)
    _build.bind(lib, "rp_zstd_emit", 6, 4)


def time_us(fn, reps: int = 30) -> float:
    return cs.time_kernel(fn, reps=reps) * 1e3


class Shape:
    """A staged encode input and the pair's output buffers."""

    def __init__(self, torch, label, data, valid, n, offset):
        self.label, self.data, self.valid, self.n, self.offset = label, data, valid, n, offset
        b = data.shape[0]
        sb = zstd_ops.stream_byte_bound(n)
        self.nbits = torch.zeros((b, 256), dtype=torch.uint8, device="cuda")
        self.codes = torch.zeros((b, 256), dtype=torch.int32, device="cuda")
        self.streams = torch.zeros((b, 4, sb), dtype=torch.uint8, device="cuda")
        self.bits = torch.zeros((b, 4), dtype=torch.int32, device="cuda")
        self.stream = _build.stream_of(data)

    @property
    def b(self):
        return self.data.shape[0]

    def lengths(self, lib):
        return lambda: _build.check(lib, lib.rp_zstd_lengths(
            self.data.data_ptr(), self.valid.data_ptr(), self.nbits.data_ptr(), self.codes.data_ptr(),
            self.b, self.data.shape[1], self.offset, self.n, self.stream), "lengths")

    def emit(self, lib):
        return lambda: _build.check(lib, lib.rp_zstd_emit(
            self.data.data_ptr(), self.valid.data_ptr(), self.nbits.data_ptr(), self.codes.data_ptr(),
            self.streams.data_ptr(), self.bits.data_ptr(), self.b, self.data.shape[1], self.offset, self.n,
            self.stream), "emit")

    def pair(self, lib):
        f, g = self.lengths(lib), self.emit(lib)

        def run():
            f()
            g()
        return run


def shapes(torch, segment: bytes) -> dict:
    b = cs.build_batches(np.random.default_rng(cs.SEED + 6), count=1)[0]
    zmat, zlen, zn = fused.stage_fused([b.header.crc_prefix()], [bytes(b.body)], fused._zstd_width)
    out = {"row": Shape(torch, "row", torch.from_numpy(zmat).cuda(), torch.from_numpy(zlen).cuda(), zn, fused.PREFIX)}
    chunks = [segment[o : o + cs.ZSTD_BLOCK] for o in range(0, len(segment), cs.ZSTD_BLOCK)]
    step = len(chunks) // 16
    for label, rows in (("seg16", chunks[::step][:16]), ("seg2048", chunks)):
        data, valid = cs.stage_rows(torch, rows, cs.ZSTD_BLOCK)
        out[label] = Shape(torch, label, data, valid, cs.ZSTD_BLOCK, 0)
    data, valid = cs.stage_rows(torch, [cs.kraft_down_row(np.random.default_rng(0), 65536)], 65536)
    out["kraft"] = Shape(torch, "kraft", data, valid, 65536, 0)
    batches = cs.build_batches(np.random.default_rng(cs.SEED + 6))
    zmat, zlen, zn = fused.stage_fused([x.header.crc_prefix() for x in batches], [bytes(x.body) for x in batches],
                                       fused._zstd_width)
    out["batch1024"] = Shape(torch, "batch1024", torch.from_numpy(zmat).cuda(), torch.from_numpy(zlen).cuda(), zn,
                             fused.PREFIX)
    return out


def empties(libs, shp) -> dict:
    lib = libs["base"]
    _build.bind(lib, "rp_empty_shape", 0, 3)
    out = {}
    for label, blocks, threads, cl in (("256 x B", shp.b, 256, 0), ("512 x 4B", 4 * shp.b, 512, 0),
                                       ("cluster 4, 256 x 4B, 2 cluster syncs", 4 * shp.b, 256, 1),
                                       ("cluster 4, 512 x 4B, 2 cluster syncs", 4 * shp.b, 512, 1)):
        out[label] = time_us(lambda: _build.check(lib, lib.rp_empty_shape(blocks, threads, cl, shp.stream), "empty"))
    return out


def marks(torch, libs, shp) -> dict:
    """One marked launch of the pair: phase cycles (mean and max over
    rows or streams) and the Kraft loops' step counts per row."""
    lib = libs["marked"]
    _build.bind(lib, "rp_dbg", 1, 2)
    shp.pair(lib)()
    torch.cuda.synchronize()
    b = shp.b
    d1 = np.zeros(8 * b, np.int64)
    d2 = np.zeros(8 * 4 * b, np.int64)
    _build.check(lib, lib.rp_dbg(d1.ctypes.data, 0, d1.size, None), "dbg")
    _build.check(lib, lib.rp_dbg(d2.ctypes.data, 1, d2.size, None), "dbg")
    d1, d2 = d1.reshape(b, 8), d2.reshape(4 * b, 8)
    names1 = ("zero", "histogram", "seed", "kraft", "codes")
    names2 = ("stage (symbols, tables, zero image)", "walk 1 + block scan", "walk 2: placement", "marker",
              "copy out")

    def stat(col):
        return {"mean": float(col.mean()), "max": int(col.max())}

    down, up = d1[:, 5], d1[:, 6]
    return {
        "lengths cycles": {k: stat(d1[:, i]) for i, k in enumerate(names1)},
        "emit cycles": {k: stat(d2[:, i]) for i, k in enumerate(names2)},
        "down steps": {"mean": float(down.mean()), "max": int(down.max()), "rows>0": int((down > 0).sum()),
                       "rows": b},
        "up steps": {"mean": float(up.mean()), "max": int(up.max()), "rows>0": int((up > 0).sum()), "rows": b},
        "per row": [[int(x) for x in r] for r in d1[:16, [5, 6, 7]]],
    }


def breakdown(torch, old_src: str) -> dict:
    src = open(old_src).read()
    libs = build({k: f(src) + EMPTIES for k, f in VARIANTS.items()})
    for lib in libs.values():
        bind_pair(lib)
    segment = cs.build_segment(np.random.default_rng(cs.SEED + 9))
    shp = shapes(torch, segment)
    del segment
    res = {"card": cs.nvidia_smi(), "clocks": subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    base = libs["base"]
    for label in ("row", "seg16", "kraft", "seg2048", "batch1024"):
        s = shp[label]
        ref_nbits = ref_streams = None
        s.pair(base)()
        torch.cuda.synchronize()
        ref_nbits, ref_codes = s.nbits.clone(), s.codes.clone()
        ref_streams, ref_bits = s.streams.clone(), s.bits.clone()
        m = marks(torch, libs, s)
        if not (torch.equal(s.nbits, ref_nbits) and torch.equal(s.streams, ref_streams) and torch.equal(s.bits, ref_bits)):
            raise AssertionError(f"marked pair differs from base at {label}")
        r = {"rows": s.b, "n": s.n, "bytes": int(s.valid.sum()), "marks": m}
        if label != "batch1024":
            t = {}
            for turn in range(2):
                order = list(VARIANTS) if turn == 0 else list(VARIANTS)[::-1]
                for name in order:
                    if name == "marked":
                        continue
                    lib = libs[name]
                    if name.startswith("hist") or name == "base":
                        t.setdefault(f"lengths:{name}", []).append(time_us(s.lengths(lib)))
                    if not name.startswith("hist"):
                        s.lengths(base)()
                        t.setdefault(f"emit:{name}", []).append(time_us(s.emit(lib)))
            # hist variants must count what base counts
            for name in ("hist_only", "hist_match", "hist_sub4"):
                s.lengths(libs[name])()
                got = s.codes.clone()
                s.lengths(libs["hist_only"])()
                if not torch.equal(got, s.codes):
                    raise AssertionError(f"{name} counts differ at {label}")
            r["us"] = {k: float(np.mean(v)) for k, v in t.items()}
            r["empty us"] = empties(libs, s)
        res[label] = r
        print(label, json.dumps(r), flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_zstd_encode: no CUDA device available", file=sys.stderr)
        return 2
    mode, old_src = sys.argv[1], sys.argv[2]
    out = sys.argv[3] if len(sys.argv) > 3 else OUT
    print(cs.nvidia_smi(), flush=True)
    res = {"breakdown": breakdown, "ab": ab, "newvar": newvar, "fused": fused_ab}[mode](torch, old_src)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"zstd_encode_{mode}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"ok": True, "mode": mode}))
    return 0


NEW_SRC = os.path.join(REPO, "redpanda_tpu_torch", "csrc", "zstd.cu")


def new_marked(s: str) -> str:
    """This tree's encode kernel with thread 0's clock64() taken after
    every barrier, the deltas from its start written per CTA."""
    a = s.index("encode_row(const uint8_t*")
    b = s.index("// the encode's launch shape")
    body, tail = s[a:b], s[b:]
    body = body.replace("__syncthreads();", "__syncthreads(); MK();")
    body = body.replace("    cluster_wait();\n", "    cluster_wait(); MK();\n")
    body = sub(body, "    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
               "    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
               "    long long mk_t[24]; int mk_n = 0; mk_t[mk_n++] = clock64();\n")
    body = sub(body, "    if (tid == 0) bits_out[row * ENC_CLUSTER + q] = tb;\n",
               "    if (tid == 0) bits_out[row * ENC_CLUSTER + q] = tb;\n    __syncthreads(); MK();\n"
               "    if (tid == 0) { long long* d = g_dbg + 32 * (i64)blockIdx.x; d[0] = mk_n;\n"
               "        for (int i = 1; i < mk_n; ++i) d[i] = mk_t[i] - mk_t[i - 1]; }\n")
    s = s[:a]
    head = s.replace("typedef long long i64;", "typedef long long i64;\n" + DBG +
                         "#define MK() do { if (mk_n < 24) mk_t[mk_n++] = clock64(); } while (0)\n")
    return head + body + tail


# the encode's launch shape by row count (512 threads a CTA up to
# ENC_FEW_ROWS rows, else 256) against one shape for all, patched in
THREADS_AT = "static int encode_threads(i64 b_n) { return b_n <= ENC_FEW_ROWS ? 512 : 256; }"
NEW_CONFIGS = {
    "auto": [],
    "all_256": [(THREADS_AT, THREADS_AT.replace("b_n <= ENC_FEW_ROWS ? 512 : 256", "256"))],
    "all_512": [(THREADS_AT, THREADS_AT.replace("b_n <= ENC_FEW_ROWS ? 512 : 256", "512"))],
}


def bind_encode(lib) -> None:
    _build.bind(lib, "rp_zstd_encode", 6, 4)
    _build.bind(lib, "rp_zstd_encode_empty", 0, 2)


def encode_fn(lib, shp):
    return lambda: _build.check(lib, lib.rp_zstd_encode(
        shp.data.data_ptr(), shp.valid.data_ptr(), shp.nbits.data_ptr(), shp.codes.data_ptr(),
        shp.streams.data_ptr(), shp.bits.data_ptr(), shp.b, shp.data.shape[1], shp.offset, shp.n,
        shp.stream), "encode")


def newvar(torch, _old_src: str) -> dict:
    """This tree's encode at each of NEW_CONFIGS, marked, timed in turns at
    the one-call row, 16 segment chunks and the segment, each output held
    against the plain version."""
    srcs = {}
    for name, patches in NEW_CONFIGS.items():
        x = open(NEW_SRC).read()
        for old, rep in patches:
            x = sub(x, old, rep)
        srcs[name] = new_marked(x)
    libs = build(srcs)
    for lib in libs.values():
        bind_encode(lib)
        _build.bind(lib, "rp_dbg", 1, 2)
    segment = cs.build_segment(np.random.default_rng(cs.SEED + 9))
    shp = shapes(torch, segment)
    del segment
    res = {"card": cs.nvidia_smi()}
    for label in ("row", "seg16", "seg2048"):
        s = shp[label]
        r = {}
        want = None
        for turn in range(2):
            for name in (list(libs) if turn == 0 else list(libs)[::-1]):
                lib = libs[name]
                encode_fn(lib, s)()
                got = [x.clone() for x in (s.nbits, s.codes, s.streams, s.bits)]
                if want is None:
                    pn, pc = zstd_ops._lengths_plain(s.data, s.valid, s.n, s.offset)
                    want = [pn, pc, *zstd_ops._emit_plain(s.data, s.valid, pn, pc, s.n, s.offset)]
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{name} differs from the plain version at {label}")
                t = time_us(encode_fn(lib, s))
                d = np.zeros(32 * 4 * s.b, np.int64)
                _build.check(lib, lib.rp_dbg(d.ctypes.data, 0, d.size, None), "dbg")
                d = d.reshape(4 * s.b, 32)
                k = int(d[:, 0].max())
                e = r.setdefault(name, {"us": [], "marks": [float(x) for x in d[:, 1:k].mean(0)]})
                e["us"].append(t)
        res[label] = r
        print(label, json.dumps(r), flush=True)
    return res


def ab(torch, old_src: str) -> dict:
    from redpanda_tpu_torch.ops import crc32c as crc_ops

    libs = build({"old": open(old_src).read(), "new": open(NEW_SRC).read(),
                  "new_marked": new_marked(open(NEW_SRC).read())})
    bind_pair(libs["old"])
    bind_encode(libs["new"])
    bind_encode(libs["new_marked"])
    _build.bind(libs["new_marked"], "rp_dbg", 1, 2)
    segment = cs.build_segment(np.random.default_rng(cs.SEED + 9))
    shp = shapes(torch, segment)
    del segment
    rng = np.random.default_rng(cs.SEED + 8)
    prefixes = [rng.integers(0, 256, fused.PREFIX, dtype=np.uint8).tobytes() for _ in range(cs.FUSED_ROWS)]
    mat, body_len, fn_ = fused.stage_fused(prefixes, cs.fused_bodies(cs.FUSED_ROWS), fused._zstd_width)
    shp["fused"] = Shape(torch, "fused", torch.from_numpy(mat).cuda(), torch.from_numpy(body_len).cuda(), fn_,
                         fused.PREFIX)
    res = {"card": cs.nvidia_smi(), "clocks": subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    old, new, marked_lib = libs["old"], libs["new"], libs["new_marked"]
    for label in ("row", "seg16", "kraft", "fused", "seg2048", "batch1024"):
        s = shp[label]
        s.pair(old)()
        torch.cuda.synchronize()
        want = [t.clone() for t in (s.nbits, s.codes, s.streams, s.bits)]
        for lib in (new, marked_lib):
            for t in (s.nbits, s.codes, s.streams, s.bits):
                t.fill_(0x5A if t.dtype == torch.uint8 else -7)
            encode_fn(lib, s)()
            torch.cuda.synchronize()
            for name, g, w in zip(("nbits", "codes", "streams", "bits"), (s.nbits, s.codes, s.streams, s.bits), want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{label}: new {name} differs from the old pair")
        d = np.zeros(32 * 4 * s.b, np.int64)
        _build.check(marked_lib, marked_lib.rp_dbg(d.ctypes.data, 0, d.size, None), "dbg")
        d = d.reshape(4 * s.b, 32)
        k = int(d[:, 0].max())
        r = {"rows": s.b, "n": s.n, "bytes": int(s.valid.sum()),
             "marks (mean cycles a CTA between barriers)": [float(x) for x in d[:, 1:k].mean(0)],
             "marks max": [int(x) for x in d[:, 1:k].max(0)]}
        if label != "batch1024":
            t = {}
            crc_lens = s.valid + fused.PREFIX
            seq = {"old": s.pair(old), "new": encode_fn(new, s)}
            for turn in ("old", "new", "new", "old"):
                t.setdefault(turn, []).append(time_us(seq[turn]))
                if label == "fused":
                    def fused_seq(f=seq[turn]):
                        crc_ops.crc32c_rows(s.data, s.valid, fused.PREFIX)
                        f()
                    t.setdefault(f"fused {turn}", []).append(time_us(fused_seq))
            t["old lengths"] = [time_us(s.lengths(old))]
            t["old emit"] = [time_us(s.emit(old))]
            t["empty at the encode's shape"] = [time_us(lambda: _build.check(
                new, new.rp_zstd_encode_empty(s.b, s.n, s.stream), "empty"))]
            r["us"] = {k2: float(np.mean(v)) for k2, v in t.items()}
            r["us turns"] = t
        res[label] = r
        print(label, json.dumps(r), flush=True)
    return res


@contextlib.contextmanager
def using(crc=None, zstd=None):
    """Run the wrappers on other libraries for the duration."""
    from redpanda_tpu_torch.ops import crc32c as crc_ops

    saved = crc_ops._LIB, zstd_ops._LIB
    crc_ops._LIB, zstd_ops._LIB = crc or saved[0], zstd or saved[1]
    try:
        yield
    finally:
        crc_ops._LIB, zstd_ops._LIB = saved


def fused_shapes(torch) -> dict:
    """label -> (data, valid, n) staged as crc_zstd_fused stages them: B
    record batches (16 x 1 KiB records, half JSON-like, half random) and
    chip_smoke phase 7's 256 rows of 32 KiB bodies."""
    out = {}
    for b in (1, 4, 16, 64, 256):
        batches = cs.build_batches(np.random.default_rng(cs.SEED + 6), count=b)
        mat, blen, n = fused.stage_fused([x.header.crc_prefix() for x in batches], [bytes(x.body) for x in batches],
                                         fused._zstd_width)
        out["row" if b == 1 else f"B={b}"] = (torch.from_numpy(mat).cuda(), torch.from_numpy(blen).cuda(), n)
    rng = np.random.default_rng(cs.SEED + 8)
    prefixes = [rng.integers(0, 256, fused.PREFIX, dtype=np.uint8).tobytes() for _ in range(cs.FUSED_ROWS)]
    mat, blen, n = fused.stage_fused(prefixes, cs.fused_bodies(cs.FUSED_ROWS), fused._zstd_width)
    out["fused 256 x 32 KiB"] = (torch.from_numpy(mat).cuda(), torch.from_numpy(blen).cuda(), n)
    return out


def fused_edge_shapes(torch) -> dict:
    """chip_smoke's fused zstd edge rows (`fused_zstd_edge_rows` at n = 512
    and 65,536), each row alone and the 16 tiled to FUSED_EDGE_ROWS in one
    launch."""
    out = {}
    for n in (512, 65536):
        mat, blen = cs.fused_zstd_edge_rows(n)
        data, valid = torch.from_numpy(mat).cuda(), torch.from_numpy(blen).cuda()
        groups = [[i] for i in range(len(blen))] + [[i % len(blen) for i in range(cs.FUSED_EDGE_ROWS)]]
        for g, rows in enumerate(groups):
            idx = torch.tensor(rows, device=data.device)
            out[f"edge n={n} #{g}"] = (data[idx], valid[idx], n)
    return out


def fused_ab(torch, old_dir: str) -> dict:
    """288c153's two-launch `_fused_zstd` against this tree's
    `rp_fused_zstd`, and the standalone encode old against new (module
    doc); clock64() marks a CTA of the fused and the standalone kernel
    between their barriers."""
    from redpanda_tpu_torch.ops import crc32c as crc_ops

    ptxas = {}
    old_inc, new_inc = ("-I", old_dir), ("-I", _build.CSRC_DIR)
    src = open(NEW_SRC).read()
    libs = build({"old_zstd": (open(os.path.join(old_dir, "zstd.cu")).read(), old_inc),
                  "old_crc32c": (open(os.path.join(old_dir, "crc32c.cu")).read(), old_inc),
                  "new_zstd": (src, new_inc), "new_marked": (new_marked(src), new_inc)}, ptxas)
    bind_encode(libs["old_zstd"])
    _build.bind(libs["old_crc32c"], "rp_crc32c", 4, 4)
    for name in ("new_zstd", "new_marked"):
        bind_encode(libs[name])
        _build.bind(libs[name], "rp_fused_zstd", 8, 4)
        libs[name].rp_fused_zstd_units.argtypes = [ctypes.c_int64] * 3
    _build.bind(libs["new_marked"], "rp_dbg", 1, 2)
    old = dict(crc=libs["old_crc32c"], zstd=libs["old_zstd"])
    new = dict(zstd=libs["new_zstd"])
    res = {"card": cs.nvidia_smi(), "clocks": subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "ptxas": ptxas}

    def outputs(fn):
        got = [t.clone() for t in fn()]
        torch.cuda.synchronize()
        return got

    def old_seq(data, valid, n):
        with using(**old):
            crc = crc_ops.crc32c_rows(data, valid, fused.PREFIX)
            nbits, codes, streams, bits = zstd_ops.launch_encode(data, valid, n, fused.PREFIX)
        return crc, nbits, codes, streams, bits

    def new_fused(data, valid, n):
        with using(**new):
            return fused.launch_fused_zstd(data, valid, n)

    def held(label, data, valid, n):
        want = outputs(lambda: old_seq(data, valid, n))
        got = outputs(lambda: new_fused(data, valid, n))
        for name, g, w in zip(("crc", "nbits", "codes", "streams", "bits"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: rp_fused_zstd {name} differs from the old sequence")
        with using(**new):
            cs.fused_zstd_err(torch, data, valid, n, label)  # against the plain chain and the host CRC

    shapes = fused_shapes(torch)
    for label, (data, valid, n) in {**shapes, **fused_edge_shapes(torch)}.items():
        held(label, data, valid, n)
    msg = (f"rp_fused_zstd equal to the old sequence and to the plain chain (host CRC) at {list(shapes)} and "
           "on the edge rows, tolerance exact")
    print(msg, flush=True)
    res["held"] = msg
    for label, (data, valid, n) in shapes.items():
        b = data.shape[0]
        fns = {"old sequence": (old, lambda: old_seq(data, valid, n)),
               "new rp_fused_zstd": (new, lambda: new_fused(data, valid, n)),
               "old crc32c_rows alone": (old, lambda: crc_ops.crc32c_rows(data, valid, fused.PREFIX)),
               "old rp_zstd_encode alone": (old, lambda: zstd_ops.launch_encode(data, valid, n, fused.PREFIX)),
               "new rp_zstd_encode alone": (new, lambda: zstd_ops.launch_encode(data, valid, n, fused.PREFIX))}
        t = {}
        order = list(fns)
        for name in order + order[::-1]:
            libset, fn = fns[name]
            with using(**libset):
                t.setdefault(name, []).append(time_us(fn))
        with using(**new):
            empty = time_us(lambda: _build.check(libs["new_zstd"], libs["new_zstd"].rp_zstd_encode_empty(
                b, n, _build.stream_of(data)), "empty"))
        r = {"B": b, "n": n, "bytes": int(valid.sum()),
             "K": libs["new_zstd"].rp_fused_zstd_units(b, fused.PREFIX, n),
             "us": {k: float(np.mean(v)) for k, v in t.items()}, "us turns": t,
             "empty encode launch us": empty}
        res[label] = r
        print(label, json.dumps(r), flush=True)
    res["marks"] = fused_marks(torch, libs["new_marked"], {k: shapes[k] for k in ("row", "fused 256 x 32 KiB")})
    # the standalone encode on the segment path's shape, old against new
    segment = cs.build_segment(np.random.default_rng(cs.SEED + 9))
    chunks = [segment[o : o + cs.ZSTD_BLOCK] for o in range(0, len(segment), cs.ZSTD_BLOCK)]
    del segment
    data, valid = cs.stage_rows(torch, chunks, cs.ZSTD_BLOCK)
    outs = {}
    for side, libset in (("old", old), ("new", new)):
        with using(**libset):
            outs[side] = outputs(lambda: zstd_ops.launch_encode(data, valid, cs.ZSTD_BLOCK, 0))
    if not all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"])):
        raise AssertionError("segment: the new standalone encode differs from the old one")
    t = {}
    for side in ("old", "new", "new", "old"):
        with using(**(old if side == "old" else new)):
            t.setdefault(f"rp_zstd_encode {side}", []).append(
                time_us(lambda: zstd_ops.launch_encode(data, valid, cs.ZSTD_BLOCK, 0), reps=20))
    res["seg2048"] = {"B": data.shape[0], "n": cs.ZSTD_BLOCK, "us": {k: float(np.mean(v)) for k, v in t.items()},
                      "us turns": t}
    print("seg2048", json.dumps(res["seg2048"]), flush=True)
    return res


def fused_marks(torch, lib, shapes: dict) -> dict:
    """One launch of the marked copy (new_marked: thread 0's clock64()
    after each barrier, the deltas per CTA) of rp_fused_zstd and of the
    standalone encode at each shape: mean and max cycles a CTA between
    barriers, by CTA rank (CTA 0 also folds the prefix)."""
    out = {}
    with using(zstd=lib):
        for label, (data, valid, n) in shapes.items():
            b = data.shape[0]
            for kind, fn in (("fused", lambda: fused.launch_fused_zstd(data, valid, n)),
                             ("encode", lambda: zstd_ops.launch_encode(data, valid, n, fused.PREFIX))):
                fn()
                torch.cuda.synchronize()
                d = np.zeros(32 * 4 * b, np.int64)
                _build.check(lib, lib.rp_dbg(d.ctypes.data, 0, d.size, None), "dbg")
                d = d.reshape(b, 4, 32)
                k = int(d[:, :, 0].max())
                out[f"{label} {kind}"] = {
                    "mean cycles": [float(x) for x in d[:, :, 1:k].mean((0, 1))],
                    "max cycles": [int(x) for x in d[:, :, 1:k].max((0, 1))],
                    "CTA 0 mean cycles": [float(x) for x in d[:, 0, 1:k].mean(0)],
                }
    print("marks", json.dumps(out), flush=True)
    return out

if __name__ == "__main__":
    sys.exit(main())
