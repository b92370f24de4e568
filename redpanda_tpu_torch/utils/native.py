"""Loader + typed wrappers for the host-native C++ hot-path library.

The reference keeps its data-plane primitives (CRC32c, compression,
segment appender, append_entries framing) in C++ (src/v/hashing/,
src/v/compression/, src/v/raft/); we do the same: `native/` holds a
small C++ library built with the system toolchain, loaded here via
ctypes. Pure-Python fallbacks keep the framework importable if the
toolchain is unavailable.

This module is the ONLY place raw `rp_*` symbols may be touched
(enforced by rplint RPL007): every native entry point is exposed as a
typed wrapper below whose callers must tolerate a `None`/"unavailable"
result, so each one keeps a Python fallback twin and `RP_NATIVE=0`
degrades the whole library transparently.

Escape hatches (checked per call, so tests can flip them at runtime):
  RP_NATIVE=0          disable the native library entirely
  RP_NATIVE_APPEND=0   disable only the AppendEntries follower fast path
  RP_NATIVE_PRODUCE=0  disable only the Kafka produce frontend fast path
  RP_NATIVE_FRAME=0    disable only the request-framing scanner
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libredpanda_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False

# -- append_frame layout (keep in sync with native/append_frame.cc) --
AF_STATE_N = 10
AF_DESC_HDR = 8
AF_DESC_W = 8
AF_MAX_BATCHES = 64
AF_REPLY_SIZE = 51

# -- produce_frame layout (keep in sync with native/produce_frame.cc) --
PF_OUT_N = 13

# -- frame_scan layout (keep in sync with native/produce_frame.cc) --
FS_ROW_N = 5       # [payload_off, payload_len, api_key, api_version, corr]
FS_MAX_FRAMES = 64  # descriptor rows per call; caller re-scans when full


def _sources_newer_than_lib() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for name in os.listdir(_NATIVE_DIR):
        if name.endswith((".cc", ".h")):
            if os.path.getmtime(os.path.join(_NATIVE_DIR, name)) > lib_mtime:
                return True
    return False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None on failure
    or when RP_NATIVE=0 (the env var is consulted on every call, so a
    test flipping it mid-run takes effect immediately)."""
    global _lib, _build_failed
    if os.environ.get("RP_NATIVE") == "0":
        return None
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if _sources_newer_than_lib() and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.rp_crc32c.restype = ctypes.c_uint32
        lib.rp_crc32c.argtypes = [
            ctypes.c_uint32,
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.rp_crc32c_sw.restype = ctypes.c_uint32
        lib.rp_crc32c_sw.argtypes = lib.rp_crc32c.argtypes
        lib.rp_crc32c_combine.restype = ctypes.c_uint32
        lib.rp_crc32c_combine.argtypes = [
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint64,
        ]
        lib.rp_crc32c_batch.restype = None
        lib.rp_crc32c_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_size_t,
        ]
        lib.rp_parse_records.restype = ctypes.c_int64
        lib.rp_parse_records.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rp_encode_records.restype = ctypes.c_int64
        lib.rp_encode_records.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),  # ts_deltas
            ctypes.c_char_p,                 # keys
            ctypes.POINTER(ctypes.c_int64),  # key_lens
            ctypes.c_char_p,                 # vals
            ctypes.POINTER(ctypes.c_int64),  # val_lens
            ctypes.POINTER(ctypes.c_char),   # out (writable)
            ctypes.c_uint64,
        ]
        lib.rp_append_frame.restype = ctypes.c_int64
        lib.rp_append_frame.argtypes = [
            ctypes.c_char_p,                 # payload
            ctypes.c_uint64,                 # len
            ctypes.POINTER(ctypes.c_int64),  # state
            ctypes.POINTER(ctypes.c_int64),  # desc
            ctypes.c_uint64,                 # desc rows
            ctypes.POINTER(ctypes.c_char),   # reply (writable)
            ctypes.c_uint64,                 # reply cap
        ]
        lib.rp_produce_frame.restype = ctypes.c_int64
        lib.rp_produce_frame.argtypes = [
            ctypes.c_char_p,                 # frame
            ctypes.c_uint64,                 # len
            ctypes.POINTER(ctypes.c_int64),  # out
            ctypes.c_uint64,                 # out slots
        ]
        lib.rp_frame_scan.restype = ctypes.c_int64
        lib.rp_frame_scan.argtypes = [
            ctypes.POINTER(ctypes.c_char),   # read buffer (bytearray view)
            ctypes.c_uint64,                 # len
            ctypes.c_int64,                  # max_frame
            ctypes.POINTER(ctypes.c_int64),  # out descriptor rows
            ctypes.c_uint64,                 # out rows
            ctypes.POINTER(ctypes.c_int64),  # consumed
        ]
        _lib = lib
        return _lib


# ------------------------------------------------------ crc wrappers
def crc32c(data, crc: int = 0) -> int | None:
    """Native CRC-32C extend, or None when the library is unavailable
    (caller falls back to its pure-Python twin)."""
    lib = load()
    if lib is None:
        return None
    return lib.rp_crc32c(crc, data, len(data))


def crc32c_sw(data, crc: int = 0) -> int | None:
    """Software (slice-by-8) engine — the HW path's cross-check twin."""
    lib = load()
    if lib is None:
        return None
    return lib.rp_crc32c_sw(crc, data, len(data))


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int | None:
    lib = load()
    if lib is None:
        return None
    return lib.rp_crc32c_combine(crc1, crc2, len2)


def crc32c_batch(bufs_ptr, stride: int, lens_ptr, out_ptr, n: int) -> bool:
    """Batched CRC over `n` strided rows; the caller supplies ctypes
    pointers (numpy .ctypes views). False when unavailable."""
    lib = load()
    if lib is None:
        return False
    lib.rp_crc32c_batch(bufs_ptr, stride, lens_ptr, out_ptr, n)
    return True


# --------------------------------------------------- record wrappers
def parse_records(data, length: int, count: int, desc) -> int | None:
    """Record-walker descriptor scan; returns the native rc (0 ok,
    nonzero malformed) or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    return lib.rp_parse_records(data, length, count, desc)


def encode_records(
    n: int, ts_deltas, keys, key_lens, vals, val_lens, out, cap: int
) -> int | None:
    """Record-batch body encoder; returns bytes written (<=0 on bound
    miss) or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    return lib.rp_encode_records(
        n, ts_deltas, keys, key_lens, vals, val_lens, out, cap
    )


# --------------------------------------- append_frame (raft follower)
def append_frame_ready() -> bool:
    """Feature probe for the follower AppendEntries fast path."""
    if os.environ.get("RP_NATIVE_APPEND") == "0":
        return False
    return load() is not None


def append_frame_buffers():
    """(state, desc, reply) scratch buffers for append_frame(); the
    caller owns them (one set per consensus group, reused per call)."""
    return (
        (ctypes.c_int64 * AF_STATE_N)(),
        (ctypes.c_int64 * (AF_DESC_HDR + AF_DESC_W * AF_MAX_BATCHES))(),
        ctypes.create_string_buffer(AF_REPLY_SIZE),
    )


def append_frame(payload: bytes, state, desc, reply) -> int:
    """One-call follower append framing (native/append_frame.cc).
    Returns 0 on the happy path (desc/reply filled), a positive punt
    code, or -1 when the library is unavailable."""
    lib = load()
    if lib is None:
        return -1
    return lib.rp_append_frame(
        payload, len(payload), state, desc, AF_MAX_BATCHES, reply,
        AF_REPLY_SIZE,
    )


# ------------------------------------- produce_frame (kafka frontend)
def produce_frame_ready() -> bool:
    """Feature probe for the Kafka produce frontend fast path."""
    if os.environ.get("RP_NATIVE_PRODUCE") == "0":
        return False
    return load() is not None


_pf_out = (ctypes.c_int64 * PF_OUT_N)()  # event-loop-thread scratch


def produce_frame(frame: bytes) -> tuple | None:
    """Decode + CRC-verify one produce request frame
    (native/produce_frame.cc). Returns the 13-slot descriptor tuple
    (api_version, correlation_id, flexible, client_id_off,
    client_id_len, acks, timeout_ms, topic_off, topic_len, index,
    records_off, records_len, n_batches) on the fast shape, None on
    punt or when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    out = _pf_out
    rc = lib.rp_produce_frame(frame, len(frame), out, PF_OUT_N)
    if rc != 0:
        return None
    return tuple(out)


# --------------------------------------- frame_scan (request framing)
def frame_scan_ready() -> bool:
    """Feature probe for the request-framing scanner."""
    if os.environ.get("RP_NATIVE_FRAME") == "0":
        return False
    return load() is not None


_fs_out = (ctypes.c_int64 * (FS_ROW_N * FS_MAX_FRAMES))()  # loop scratch
_fs_consumed = (ctypes.c_int64 * 1)()


def frame_scan(
    buf: bytearray, max_frame: int
) -> tuple[int, "ctypes.Array", int] | None:
    """One-call request framing over a connection read buffer
    (native/produce_frame.cc rp_frame_scan). Returns (n, rows,
    consumed) where rows is the flat descriptor scratch (FS_ROW_N
    slots per frame: payload_off, payload_len, api_key, api_version,
    correlation_id), n is the frame count (or -1 on an oversize/
    garbage size prefix — the caller closes the connection), and
    consumed is the byte offset of the first incomplete frame.
    None when the library is unavailable (caller runs its pure-Python
    twin). Zero-copy: the bytearray is viewed in place, never copied."""
    lib = load()
    if lib is None:
        return None
    view = (ctypes.c_char * len(buf)).from_buffer(buf) if buf else None
    try:
        n = lib.rp_frame_scan(
            view, len(buf), max_frame, _fs_out, FS_MAX_FRAMES, _fs_consumed
        )
    finally:
        # clear the binding INSIDE this frame: the profiler's sampler
        # thread can materialize this frame via sys._current_frames()
        # while the C call runs (the GIL is released), and an escaped
        # frame takes ownership of its locals at return — which would
        # pin the buffer export past the call and make the caller's
        # compaction (a bytearray resize) raise BufferError
        del view
    return int(n), _fs_out, int(_fs_consumed[0])
