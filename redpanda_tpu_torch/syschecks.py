"""Startup environment checks + crash-loop detection.

Reference: src/v/syschecks (memory, clocksource, AIO limits, pidfile)
and the crash-loop tracker at redpanda/application.cc:357. Checks are
advisory (warnings) except an unwritable/un-fsyncable data dir, which
is fatal — a broker that cannot fsync cannot honor acks=all.

Crash-loop tracking: a marker file records startup; a clean stop
removes it. N consecutive unclean starts logs an escalating error
(the reference refuses to start past the limit; here the operator
signal is the log + the returned count, so embedded/test brokers are
never blocked).
"""

from __future__ import annotations

import logging
import os
import resource
import shutil
import time

logger = logging.getLogger("syschecks")

_CRASH_MARKER = ".startup_marker"
_CRASH_COUNT = ".crash_count"


def run_startup_checks(data_dir: str) -> list[str]:
    """Returns warning strings (already logged). Raises RuntimeError
    only for a data dir that cannot take durable writes."""
    warnings: list[str] = []
    try:
        os.makedirs(data_dir, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot create data dir {data_dir}: {e}") from e

    # fatal: durable-write probe (the acks=all contract)
    probe = os.path.join(data_dir, ".fsync_probe")
    try:
        with open(probe, "wb") as f:
            f.write(b"probe")
            f.flush()
            os.fsync(f.fileno())
        os.remove(probe)
    except OSError as e:
        raise RuntimeError(
            f"data dir {data_dir} failed the durable-write probe: {e}"
        ) from e

    def warn(msg: str) -> None:
        warnings.append(msg)
        logger.warning("%s", msg)

    # disk headroom
    try:
        usage = shutil.disk_usage(data_dir)
        if usage.free < 1 << 30:
            warn(
                f"low disk space on {data_dir}: "
                f"{usage.free // (1 << 20)} MiB free"
            )
    except OSError:
        pass

    # fd limit (every segment + index + socket costs one)
    try:
        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < 4096:
            warn(f"RLIMIT_NOFILE soft limit {soft} < 4096")
    except (OSError, ValueError):
        pass

    # clocksource: a non-vdso source makes every latency probe a syscall
    try:
        with open(
            "/sys/devices/system/clocksource/clocksource0/current_clocksource"
        ) as f:
            src = f.read().strip()
        if src not in ("tsc", "kvm-clock", "arch_sys_counter"):
            warn(f"slow clocksource {src!r} (want tsc/kvm-clock)")
    except OSError:
        pass

    # available memory
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    kb = int(line.split()[1])
                    if kb < 256 * 1024:
                        warn(f"low available memory: {kb // 1024} MiB")
                    break
    except (OSError, ValueError):
        pass

    return warnings


def note_startup(data_dir: str, limit: int = 5) -> int:
    """Record a startup; returns the number of consecutive UNCLEAN
    starts so far (0 on a clean previous shutdown)."""
    marker = os.path.join(data_dir, _CRASH_MARKER)
    countf = os.path.join(data_dir, _CRASH_COUNT)
    crashes = 0
    if os.path.exists(marker):
        try:
            with open(countf) as f:
                crashes = int(f.read().strip() or 0)
        except (OSError, ValueError):
            crashes = 0
        crashes += 1
        if crashes >= limit:
            logger.error(
                "crash loop: %d consecutive unclean shutdowns "
                "(application.cc check_for_crash_loop analog) — "
                "investigate before data loss compounds",
                crashes,
            )
        else:
            logger.warning("previous shutdown was unclean (%d so far)", crashes)
    with open(countf, "w") as f:
        f.write(str(crashes))
    with open(marker, "w") as f:
        f.write(str(int(time.time())))
    return crashes


def note_clean_stop(data_dir: str) -> None:
    for name in (_CRASH_MARKER, _CRASH_COUNT):
        try:
            os.remove(os.path.join(data_dir, name))
        except OSError:
            pass


class PidLock:
    """Exclusive data-dir ownership via flock on pid.lock: a second
    broker pointed at the same directory fails fast instead of both
    appending to the same segments. The lock lives as long as the fd
    (kernel releases it on ANY process death, so a SIGKILLed broker
    never leaves the dir wedged); release() also removes the file on a
    clean shutdown."""

    def __init__(self, data_dir: str):
        import fcntl

        self.path = os.path.join(data_dir, "pid.lock")
        self._f = open(self.path, "a+")
        try:
            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._f.seek(0)
            holder = self._f.read().strip() or "unknown"
            self._f.close()
            raise RuntimeError(
                f"data dir already in use by pid {holder} ({self.path})"
            ) from None
        self._f.truncate(0)
        self._f.write(str(os.getpid()))
        self._f.flush()

    def release(self) -> None:
        try:
            self._f.close()
            os.remove(self.path)
        except OSError:
            pass


def acquire_pidlock(data_dir: str) -> PidLock:
    return PidLock(data_dir)
