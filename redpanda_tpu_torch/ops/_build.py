"""Kernel loader: nvcc-built shared libraries bound with ctypes.

Each `csrc/<name>.cu` compiles into `_build/lib<name>.so` the first
time a wrapper needs it, and again whenever the source or one of the
shared headers (`csrc/*.cuh`) is newer than the library. The libraries
have a plain C interface: every pointer and the CUDA stream go over as
`c_void_p`, every size as `c_int64`, and
each entry point returns `cudaGetLastError()` right after its launches
(0 = ok) so a refused launch raises in the wrapper instead of passing
silently. Builds go to a temporary name and are renamed into place,
so concurrent builders never load a half-written library. Every build
is reported to utils/compileguard (`report_build`, with its seconds),
the port's counterpart of an XLA compile event.

Nothing here runs at import time: the CPU tests import every module on
machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

from ..utils import compileguard

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("quorum", "health", "crc32c", "codec", "fused", "zstd", "cluster")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, launch or run."""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str) -> tuple[str, str]:
    return (
        os.path.join(CSRC_DIR, f"{name}.cu"),
        os.path.join(BUILD_DIR, f"lib{name}.so"),
    )


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in [src, *headers]) > os.path.getmtime(lib)


def _start(name: str) -> tuple[subprocess.Popen, str]:
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise KernelError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, _paths(name)[1])


def build_all(names=SOURCES) -> dict[str, float]:
    """Build every stale library, one nvcc per source, all started
    together. Returns each build's seconds from its start to its end."""
    secs, errors = {}, []

    def finish(name, proc, tmp, t0):
        try:
            _finish(name, proc, tmp)
        except KernelError as e:
            errors.append(str(e))
        secs[name] = time.perf_counter() - t0

    with _lock:
        waiters = [
            threading.Thread(target=finish, args=(n, *_start(n), time.perf_counter()))
            for n in names
            if _stale(n)
        ]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
    if errors:
        raise KernelError("\n".join(errors))
    for name, s in secs.items():
        compileguard.report_build(name, s)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                t0 = time.perf_counter()
                _finish(name, *_start(name))
                compileguard.report_build(name, time.perf_counter() - t0)
            lib = ctypes.CDLL(_paths(name)[1])
            lib.rp_error_string.restype = ctypes.c_char_p
            lib.rp_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
    return lib


def bind(lib: ctypes.CDLL, fn: str, n_ptrs: int, n_sizes: int):
    """Declare `fn(ptr * n_ptrs, int64 * n_sizes, stream) -> int`."""
    f = getattr(lib, fn)
    f.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * n_sizes + [ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.rp_error_string(rc).decode()
        raise KernelError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The raw current CUDA stream for tensor `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

