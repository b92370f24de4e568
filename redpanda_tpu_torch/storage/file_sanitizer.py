"""File-operation sanitizer: op-history wrapper for storage files.

Reference: src/v/utils/file_sanitizer.h — debug builds wrap every
storage file handle in a proxy that records an operation history and
asserts ordering invariants, dumping the recent history with the
violation so storage bugs surface at the misuse site instead of as
downstream corruption. Enforced here: no write/flush/tell/fileno
after close, no double close, and fsync-intent (fileno) on a file
with unflushed Python-buffered writes — fsyncing the fd before
flush() would mark data durable that is still sitting in userspace.

Enabled by `RP_FILE_SANITIZER=1` in the environment (the analog of the
reference's debug-build gate); zero overhead when off — Segment calls
`wrap()` which returns the raw file untouched.

The op history doubles as the §5.2 race-detection analog for the
asyncio runtime: within-loop interleaving bugs (e.g. a truncate
racing an in-flight executor fsync) show up as impossible op
sequences in the history.
"""

from __future__ import annotations

import collections
import os
import threading

HISTORY = 64


def enabled() -> bool:
    return os.environ.get("RP_FILE_SANITIZER", "") not in ("", "0", "false")


class FileSanitizerError(AssertionError):
    pass


class SanitizedFile:
    """Proxy over a writable file object recording (op, detail) history
    and enforcing lifecycle invariants."""

    def __init__(self, raw, path: str):
        self._raw = raw
        self._path = path
        self._closed = False
        self._dirty = False  # Python-buffered writes not yet flush()ed
        self._history: collections.deque = collections.deque(maxlen=HISTORY)
        self._lock = threading.Lock()  # fsync runs in executor threads
        self._record("open", f"fd={raw.fileno()}")

    # -- history -----------------------------------------------------
    def _record(self, op: str, detail: str = "") -> None:
        with self._lock:
            self._history.append((op, detail))

    def _violation(self, msg: str) -> None:
        with self._lock:
            ops = "\n  ".join(f"{op} {d}".rstrip() for op, d in self._history)
        raise FileSanitizerError(
            f"file sanitizer: {msg} on {self._path}\nrecent ops:\n  {ops}"
        )

    def _check_open(self, op: str) -> None:
        if self._closed:
            self._violation(f"{op} after close")

    # -- proxied surface (what Segment uses) -------------------------
    def write(self, data) -> int:
        self._check_open("write")
        n = self._raw.write(data)
        self._dirty = True
        self._record("write", f"{len(data)}B")
        return n

    def flush(self) -> None:
        self._check_open("flush")
        self._raw.flush()
        self._dirty = False
        self._record("flush")

    def fileno(self) -> int:
        self._check_open("fileno")
        # callers only take fileno to fsync: fsyncing with unflushed
        # Python-buffered writes would advance stable_offset past data
        # that never reached the kernel — the exact "durable but lost"
        # bug class the reference's sanitizer exists to catch
        if self._dirty:
            self._violation("fsync (fileno) with unflushed buffered writes")
        self._record("fileno(fsync)")
        return self._raw.fileno()

    def tell(self) -> int:
        self._check_open("tell")
        return self._raw.tell()

    def close(self) -> None:
        if self._closed:
            self._violation("double close")
        self._closed = True
        self._record("close")
        self._raw.close()

    def history(self) -> list[tuple[str, str]]:
        with self._lock:
            return list(self._history)

    @property
    def closed(self) -> bool:
        return self._closed


def wrap(raw, path: str):
    """Compose the active debug layers: iofaults (innermost, so the
    sanitizer's op history sees injected outcomes) then the sanitizer.
    Identity when neither is active."""
    from . import iofaults

    f = iofaults.wrap(raw, path)
    return SanitizedFile(f, path) if enabled() else f
