"""Flight-data plane, part 3: live continuous profiler.

Promotes the offline samplers (`bench_profiles/sampler.py`,
`loop_attrib.py`) into an always-on wall-stack profiler the broker can
answer from at any moment — "why is it slow *right now*" without
restarting under a profiler:

  * a daemon sampler thread walks `sys._current_frames()` at a bounded
    rate (default 50 Hz) and folds every thread's stack root->leaf into
    flamegraph collapsed form. Thread sampling sees *wall* stacks —
    including a loop blocked in a syscall mid-callback, which the
    suspended-task sampler at /v1/debug/cpu_profiler is blind to;
  * the event-loop thread's sample is prefixed with the asyncio task
    currently running on that loop (the `loop_attrib.py` attribution,
    read from `asyncio.tasks._current_tasks` without patching
    `Handle._run`), so stacks group by owning fiber;
  * samples land in per-second buckets kept for a rolling window
    (default 120 s): `GET /v1/debug/profile?seconds=N` answers from
    data already collected, and the alert auto-capture hook snapshots
    the window *at fire time* — the stacks that caused the burn are
    already in the ring;
  * signal mode (`RP_PROFILE_MODE=signal`, ITIMER_REAL) exists for
    single-threaded precision runs but is not the default: SIGALRM
    collides with pytest-timeout and anything else owning the alarm.

Process-wide singleton with refcounted acquire/release (in-process
multi-broker tests share one sampler) and `os.register_at_fork`
hygiene like trace.py: a forked shard worker clears inherited buckets
and re-arms its own thread. Stand-down: `RP_PROFILE=0`.
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading
import time
from collections import Counter as _TallyCounter
from collections import deque
from typing import Optional

from ..utils.serde import (
    Envelope,
    boolean,
    envelope,
    f64,
    i32,
    string,
    u64,
    vector,
)

ENABLED = os.environ.get("RP_PROFILE", "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


DEFAULT_HZ = _env_float("RP_PROFILE_HZ", 50.0)
DEFAULT_WINDOW_S = int(_env_float("RP_PROFILE_WINDOW_S", 120))
DEFAULT_MODE = os.environ.get("RP_PROFILE_MODE", "thread")
_MAX_DEPTH = 48


def _fold(frame, max_depth: int = _MAX_DEPTH) -> str:
    """Root->leaf collapsed stack: `file.func;file.func;...`. Depth
    truncation drops *root* frames — the leaf side is what names the
    hot code."""
    parts: list[str] = []
    while frame is not None:
        code = frame.f_code
        fname = code.co_filename
        stem = fname.rsplit("/", 1)[-1]
        if stem.endswith(".py"):
            stem = stem[:-3]
        parts.append(f"{stem}.{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    if len(parts) > max_depth:
        parts = parts[-max_depth:]
    return ";".join(parts)


class ContinuousProfiler:
    def __init__(
        self,
        interval_s: Optional[float] = None,
        window_s: Optional[int] = None,
        mode: Optional[str] = None,
    ):
        hz = DEFAULT_HZ
        self.interval_s = (
            1.0 / max(1.0, hz) if interval_s is None else float(interval_s)
        )
        self.window_s = max(
            2, DEFAULT_WINDOW_S if window_s is None else int(window_s)
        )
        self.mode = DEFAULT_MODE if mode is None else mode
        # (epoch_second, stack -> count); readers/writer share a lock —
        # sampling holds it only for the tally bump
        self._buckets: deque[tuple[int, _TallyCounter]] = deque(
            maxlen=self.window_s
        )
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._refs = 0
        self._prev_sig = None
        self.samples_total = 0
        # thread ident -> running asyncio loop, recorded at acquire()
        # so the sampler thread can attribute the loop thread's stack
        # to the task currently running on it
        self._loop_threads: dict[int, object] = {}
        os.register_at_fork(after_in_child=self._after_fork_child)

    # -- lifecycle ----------------------------------------------------
    def acquire(self) -> None:
        """Refcounted start; safe to call once per broker in a process
        that hosts several."""
        self.note_loop()
        self._refs += 1
        if self._refs == 1:
            self._start()

    def release(self) -> None:
        self._refs = max(0, self._refs - 1)
        if self._refs == 0:
            self._stop_sampling()

    def note_loop(self) -> None:
        """Remember which thread runs the caller's event loop (no-op
        outside async context)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._loop_threads[threading.get_ident()] = loop

    def running(self) -> bool:
        if self.mode == "signal":
            return self._prev_sig is not None
        return self._thread is not None and self._thread.is_alive()

    def _start(self) -> None:
        if self.mode == "signal":
            self._start_signal()
            return
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._thread_loop, name="rp-profiler", daemon=True
        )
        self._thread.start()

    def _stop_sampling(self) -> None:
        if self.mode == "signal":
            self._stop_signal()
            return
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=1.0)

    def _after_fork_child(self) -> None:
        # inherited buckets describe the parent; the sampler thread did
        # not survive the fork. Start fresh and re-arm if we were live.
        self._buckets = deque(maxlen=self.window_s)
        self._lock = threading.Lock()
        self._thread = None
        self._prev_sig = None
        self._loop_threads.clear()
        self._stop = threading.Event()
        self.samples_total = 0
        if self._refs > 0:
            self._refs = 0  # the child broker re-acquires on its own

    # -- thread mode --------------------------------------------------
    def _thread_loop(self) -> None:
        interval = self.interval_s
        while not self._stop.wait(interval):
            try:
                self._take_sample()
            except Exception:
                # a torn frame walk must never kill the sampler
                pass

    def _take_sample(self) -> None:
        me = threading.get_ident()
        now_s = int(time.monotonic())
        frames = sys._current_frames()
        current_tasks = getattr(asyncio.tasks, "_current_tasks", {})
        stacks: list[str] = []
        for tid, frame in frames.items():
            if tid == me:
                continue
            stack = _fold(frame)
            if not stack:
                continue
            loop = self._loop_threads.get(tid)
            if loop is not None:
                task = current_tasks.get(loop)
                if task is not None:
                    try:
                        qual = task.get_coro().__qualname__
                    except Exception:
                        qual = task.get_name()
                    stack = f"task:{qual};{stack}"
            stacks.append(stack)
        if not stacks:
            return
        with self._lock:
            if self._buckets and self._buckets[-1][0] == now_s:
                tally = self._buckets[-1][1]
            else:
                tally = _TallyCounter()
                self._buckets.append((now_s, tally))
            for stack in stacks:
                tally[stack] += 1
            self.samples_total += len(stacks)

    # -- signal mode --------------------------------------------------
    def _start_signal(self) -> None:
        import signal

        if threading.current_thread() is not threading.main_thread():
            # itimer signals deliver to the main thread only; fall back
            self.mode = "thread"
            self._start()
            return
        self._prev_sig = signal.signal(signal.SIGALRM, self._on_signal)
        signal.setitimer(signal.ITIMER_REAL, self.interval_s, self.interval_s)

    def _stop_signal(self) -> None:
        import signal

        if self._prev_sig is None:
            return
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, self._prev_sig)
        self._prev_sig = None

    def _on_signal(self, signum, frame) -> None:
        stack = _fold(frame)
        if not stack:
            return
        loop = self._loop_threads.get(threading.get_ident())
        if loop is not None:
            task = getattr(asyncio.tasks, "_current_tasks", {}).get(loop)
            if task is not None:
                try:
                    stack = f"task:{task.get_coro().__qualname__};{stack}"
                except Exception:
                    pass
        now_s = int(time.monotonic())
        with self._lock:
            if self._buckets and self._buckets[-1][0] == now_s:
                self._buckets[-1][1][stack] += 1
            else:
                self._buckets.append((now_s, _TallyCounter([stack])))
            self.samples_total += 1

    # -- queries ------------------------------------------------------
    def collapsed(self, seconds: float) -> dict[str, int]:
        """Merged stack tallies over the last `seconds` of buckets."""
        cutoff = int(time.monotonic()) - max(1, int(seconds))
        out: _TallyCounter = _TallyCounter()
        with self._lock:
            for epoch, tally in self._buckets:
                if epoch >= cutoff:
                    out.update(tally)
        return dict(out)

    def render_collapsed(self, seconds: float, prefix: str = "") -> str:
        """flamegraph.pl input: `stack count` lines."""
        rows = sorted(self.collapsed(seconds).items())
        return "\n".join(f"{prefix}{stack} {n}" for stack, n in rows)

    def snapshot(self, seconds: float, limit: int = 30) -> dict:
        """Top collapsed stacks as JSON — the alert auto-capture
        payload. Reads the ring; never blocks, never waits."""
        tallies = self.collapsed(seconds)
        total = sum(tallies.values())
        top = sorted(tallies.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
        return {
            "seconds": float(seconds),
            "samples": total,
            "interval_s": self.interval_s,
            "mode": self.mode,
            "stacks": [
                {
                    "stack": stack,
                    "count": n,
                    "pct": round(100.0 * n / total, 2) if total else 0.0,
                }
                for stack, n in top
            ],
        }


_PROFILER: Optional[ContinuousProfiler] = None


def get_profiler() -> ContinuousProfiler:
    """The per-process singleton (env-configured)."""
    global _PROFILER
    if _PROFILER is None:
        _PROFILER = ContinuousProfiler()
    return _PROFILER


# ------------------------------------------------------------- wire
class ProfileQuery(Envelope):
    SERDE_FIELDS = [
        ("seconds", f64),
        ("limit", i32),
    ]


class ProfileRow(Envelope):
    SERDE_FIELDS = [
        ("stack", string),
        ("count", u64),
    ]


class ProfileReply(Envelope):
    SERDE_FIELDS = [
        ("shard", i32),
        ("enabled", boolean),
        ("seconds", f64),
        ("samples", u64),
        ("rows", vector(envelope(ProfileRow))),
    ]


def profile_reply(
    profiler: Optional[ContinuousProfiler], shard: int, query: ProfileQuery
) -> ProfileReply:
    """Worker-side handler for the obs "profile" method."""
    if profiler is None or not profiler.running():
        return ProfileReply(
            shard=shard, enabled=False, seconds=query.seconds,
            samples=0, rows=[],
        )
    limit = query.limit if query.limit > 0 else 200
    tallies = profiler.collapsed(query.seconds)
    top = sorted(tallies.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
    return ProfileReply(
        shard=shard,
        enabled=True,
        seconds=query.seconds,
        samples=sum(tallies.values()),
        rows=[ProfileRow(stack=s, count=n) for s, n in top],
    )
