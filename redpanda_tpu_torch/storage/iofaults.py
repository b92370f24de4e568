"""Fault-injecting I/O layer for consistency testing.

Reference: src/consistency-testing/iofaults/iofaults.py:20 — the
reference runs a FUSE passthrough filesystem that injects per-op
delays/errors under a live workload. No FUSE here; instead two seams
cover the same fault surface in-process:

  * file proxies — `file_sanitizer.wrap` routes every storage append
    handle through `FaultyFile` while a schedule is installed, so
    write-level rules (delay / EIO / short write) hit individual ops;
  * a patched `os.fsync` — fd is resolved to its path via
    /proc/self/fd, rules can delay, fail, or LIE (return success
    without syncing), and every HONEST fsync records the file's
    synced size.

The recorded synced sizes power `simulate_power_cut(data_dir)`: every
file under the directory is truncated to its last honestly-fsynced
size (unsynced tail = lost page cache). Crash + power-cut + restart is
the strongest durability probe this side of real hardware: anything
the broker acked must survive, so a stable-offset that advances past
a real fsync — or an fsync lie anywhere in the stack — surfaces as
acked-data loss in the chaos validator instead of shipping.

Directory-entry durability IS simulated when a watch root is given to
`install`: the patched fsync classifies directory fds as op="dirsync"
and records, on every HONEST dir fsync, the set of entry names that
reached the platter. `simulate_power_cut` then unlinks files created
under the watch root whose name was never captured by a dir fsync —
the create+fsync-the-file-only bug (storage/dirsync.py is the
production-side fix). Files already present at install time predate
the fault window and keep their entries.

Rules match (path glob, op) and fire with probability `prob` and/or on
every `nth` matching op, up to `count` times; the schedule's RNG is
seeded so every chaos run replays byte-identically.
"""

from __future__ import annotations

import fnmatch
import os
import random
import stat
import time
from dataclasses import dataclass, field
from typing import Optional

_real_fsync = os.fsync
_real_replace = os.replace


@dataclass
class Rule:
    path_glob: str
    op: str  # "write" | "fsync" | "flush" | "dirsync"
    action: str  # "delay" | "error" | "lie_fsync" | "short_write"
    prob: float = 1.0
    nth: int = 1  # fire on every nth matching op
    count: int = 1 << 30  # max firings
    delay_s: float = 0.0
    fired: int = 0
    seen: int = 0

    def matches(self, path: str, op: str, rng: random.Random) -> bool:
        if op != self.op or self.fired >= self.count:
            return False
        if not fnmatch.fnmatch(path, self.path_glob):
            return False
        self.seen += 1
        if self.seen % self.nth != 0:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


@dataclass
class FaultSchedule:
    rules: list[Rule]
    seed: int = 0
    rng: random.Random = field(init=False)
    injected: dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)

    def act(self, path: str, op: str) -> Optional[Rule]:
        for r in self.rules:
            if r.matches(path, op, self.rng):
                self.injected[r.action] = self.injected.get(r.action, 0) + 1
                return r
        return None


_schedule: Optional[FaultSchedule] = None
# path -> last honestly-fsynced size (tracked while installed)
_synced: dict[str, int] = {}
# dir path -> entry names captured by an honest dir fsync
_dir_synced: dict[str, set[str]] = {}
# files already on disk under the watch root at install time: their
# dir entries predate the fault window and are treated as durable
_baseline: set[str] = set()
_watch_root: Optional[str] = None


def active() -> bool:
    return _schedule is not None


def install(schedule: FaultSchedule, watch_dir: Optional[str] = None) -> None:
    """Install the schedule and patch os.fsync. Idempotent-ish: the
    last installed schedule wins; synced-size tracking resets. With
    `watch_dir`, directory-entry durability is simulated for files
    created under it (see module docstring)."""
    global _schedule, _watch_root
    _schedule = schedule
    _synced.clear()
    _dir_synced.clear()
    _baseline.clear()
    _watch_root = os.path.abspath(watch_dir) if watch_dir else None
    if _watch_root is not None:
        for root, _dirs, files in os.walk(_watch_root):
            for name in files:
                _baseline.add(os.path.join(root, name))
    os.fsync = _faulty_fsync
    os.replace = _tracking_replace


def clear() -> None:
    global _schedule, _watch_root
    _schedule = None
    _watch_root = None
    os.fsync = _real_fsync
    os.replace = _real_replace


def synced_size(path: str) -> int:
    return _synced.get(path, 0)


def _fd_path(fd: int) -> str:
    try:
        return os.readlink(f"/proc/self/fd/{fd}")
    except OSError:
        return ""


def _tracking_replace(src, dst, **kw) -> None:
    """os.replace, but the honestly-synced-size record follows the
    rename — tmp-write + fsync + rename is the standard atomic-update
    idiom, and keying `_synced` by path alone would otherwise truncate
    the renamed file to zero at the next power cut."""
    _real_replace(src, dst, **kw)
    src_s, dst_s = os.fspath(src), os.fspath(dst)
    if src_s in _synced:
        _synced[dst_s] = _synced.pop(src_s)
    if src_s in _baseline:
        _baseline.discard(src_s)


def _faulty_fsync(fd: int) -> None:
    sched = _schedule
    if sched is None:
        _real_fsync(fd)
        return
    path = _fd_path(fd)
    try:
        is_dir = stat.S_ISDIR(os.fstat(fd).st_mode)
    except OSError:
        is_dir = False
    rule = sched.act(path, "dirsync" if is_dir else "fsync")
    if rule is not None:
        if rule.action == "delay":
            time.sleep(rule.delay_s)
        elif rule.action == "error":
            raise OSError(5, "iofaults: injected fsync EIO", path)
        elif rule.action == "lie_fsync":
            # claim success, sync nothing, record nothing: the page
            # cache (file tail / dir entries) stays volatile until the
            # next power cut
            return
    _real_fsync(fd)
    if is_dir:
        try:
            _dir_synced.setdefault(path, set()).update(os.listdir(path))
        except OSError:
            pass
        return
    try:
        _synced[path] = os.fstat(fd).st_size
    except OSError:
        pass


class FaultyFile:
    """Write-side file proxy applying write/flush rules. Composes
    under the sanitizer proxy (faults first, history outside)."""

    def __init__(self, raw, path: str):
        self._raw = raw
        self._path = path

    def write(self, data) -> int:
        sched = _schedule
        if sched is not None:
            rule = sched.act(self._path, "write")
            if rule is not None:
                if rule.action == "delay":
                    time.sleep(rule.delay_s)
                elif rule.action == "error":
                    raise OSError(5, "iofaults: injected write EIO", self._path)
                elif rule.action == "short_write" and len(data) > 1:
                    return self._raw.write(data[: len(data) // 2])
        return self._raw.write(data)

    def flush(self) -> None:
        sched = _schedule
        if sched is not None:
            rule = sched.act(self._path, "flush")
            if rule is not None and rule.action == "error":
                raise OSError(5, "iofaults: injected flush EIO", self._path)
        self._raw.flush()

    def __getattr__(self, name):
        return getattr(self._raw, name)


def wrap(raw, path: str):
    return FaultyFile(raw, path) if active() else raw


def _entry_lost(path: str) -> bool:
    """True when `path`'s directory entry never reached the platter:
    created under the watch root during the fault window, and no
    honest dir fsync of its parent captured the name."""
    if _watch_root is None:
        return False
    if not path.startswith(_watch_root + os.sep) and path != _watch_root:
        return False
    if path in _baseline:
        return False
    synced = _dir_synced.get(os.path.dirname(path))
    return synced is None or os.path.basename(path) not in synced


def simulate_power_cut(data_dir: str) -> list[tuple[str, int, int]]:
    """Truncate every file under data_dir to its last honestly-fsynced
    size (0 if never synced); when a watch root is installed, files
    whose directory entry was never honestly dir-fsynced are unlinked
    outright. Returns [(path, old_size, new_size)] for files that lost
    bytes, new_size == -1 for vanished entries. Call AFTER stopping
    the broker."""
    lost = []
    for root, _dirs, files in os.walk(data_dir):
        for name in files:
            path = os.path.join(root, name)
            try:
                cur = os.path.getsize(path)
            except OSError:
                continue
            if _entry_lost(path):
                os.remove(path)
                lost.append((path, cur, -1))
                continue
            keep = min(_synced.get(path, 0), cur)
            if keep < cur:
                with open(path, "r+b") as f:
                    f.truncate(keep)
                lost.append((path, cur, keep))
    return lost
