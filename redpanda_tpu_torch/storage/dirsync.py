"""Parent-directory fsync — the other half of file durability.

An fsync on a file persists its *bytes*; the *entry* naming it lives
in the parent directory and needs its own fsync, or the file itself
can vanish on power loss (the classic create+fsync-the-file-only
crash bug; reference: segment_appender/snapshot writers all fsync the
parent after create/rename). Storage call sites invoke `fsync_dir`
after creating or renaming any file whose existence was acked.

The fsync is routed through `os.fsync` resolved at call time, so the
iofaults patch observes it as op="dirsync" — schedules can delay,
fail, or lie about directory durability, and the honest path records
which entries reached the platter for `simulate_power_cut`.
"""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """fsync directory `path` (the PARENT of a created/renamed file)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
