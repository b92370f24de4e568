"""rpsan — runtime async race sanitizer (`RP_SAN=1`).

The dynamic twin of rplint's RPL015/RPL016: where the linter proves
the *shape* of an await-atomicity race from source, rpsan catches one
*happening* under a real interleaving (chaos soak, smoke runs) and
names both tasks and both sites.

Model — single event loop, so the only way shared state tears is a
coroutine carrying a stale read across a suspension point:

* every instrumented attribute gets a per-instance **version counter**
  that bumps on each rebind;
* every read records (version, site) under the *current task*;
* a write checks the writing task's recorded read: if the version has
  advanced since — some other task wrote in between — the writer is
  about to clobber state it has not seen, and a report fires. A task
  that re-reads after its awaits (the check-then-act discipline the
  linter pushes you toward) refreshes its record and stays clean.

Instrumentation is opt-in per class via `instrument(cls, attrs)`,
called at module scope under the class definition. With `RP_SAN`
unset the call returns the class untouched — no descriptor, no
wrapper, no per-access branch — so the sanitizer's off-state overhead
is zero **by construction**, not by measurement.

Reports are deterministic for a deterministic interleaving: they
carry class/attr names, task names, and `file:line` sites — no ids,
no addresses, no clocks — so a seeded reproduction is byte-stable.
"""

from __future__ import annotations

import asyncio
import os
import sys
import weakref
from collections import deque
from dataclasses import dataclass

ENABLED = os.environ.get("RP_SAN", "") == "1"

#: torn-write reports, in detection order (bounded: a racing loop
#: should not OOM the process before the harness looks)
_MAX_REPORTS = 1000
REPORTS: list["Report"] = []

#: recent attribute accesses (debugging aid for a report's backstory)
ACCESS_LOG: deque = deque(maxlen=512)

_MISSING = object()
_STATE = "_rpsan_state"  # per-instance {attr: (version, write_site)}


@dataclass(frozen=True)
class Report:
    cls: str
    attr: str
    task: str  # task that carried the stale read into its write
    read_site: str  # file:line of that task's stale read
    read_version: int
    writer_task: str  # task that advanced the version in between
    write_site: str  # file:line of the intervening write
    version: int  # current version the stale writer is clobbering
    clobber_site: str  # file:line of the offending (torn) write

    def render(self) -> str:
        return (
            f"rpsan: torn write of {self.cls}.{self.attr}: task "
            f"{self.task!r} read v{self.read_version} at {self.read_site}, "
            f"task {self.writer_task!r} advanced it to v{self.version} at "
            f"{self.write_site}, stale overwrite at {self.clobber_site} "
            "without re-reading"
        )


def enabled() -> bool:
    return ENABLED


def reports() -> list[Report]:
    return list(REPORTS)


def reset() -> None:
    REPORTS.clear()
    ACCESS_LOG.clear()


def _current_task():
    try:
        return asyncio.current_task()
    except RuntimeError:
        return None


def _task_name(task) -> str:
    return task.get_name() if task is not None else "<no-task>"


def _site(depth: int) -> str:
    """`file:line` of the access, skipping this module's own frames."""
    try:
        f = sys._getframe(depth)
    except ValueError:  # pragma: no cover - interpreter edge
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _caller_name(depth: int) -> str:
    try:
        return sys._getframe(depth).f_code.co_name
    except ValueError:  # pragma: no cover - interpreter edge
        return "<unknown>"


class _TaskReads:
    """Per-task read records:
    task -> {(id(obj), attr): (ver, site, flaggable)}.

    `flaggable` distinguishes a genuine read (Load) from the implicit
    "freshest view" record a task gets after its own write. Only
    genuine reads arm a torn-write report: a task that writes an
    attribute *blindly* (constant invalidation like `self._plan =
    None`, with no read since its last write) is not carrying stale
    state, even if another task wrote in between — last-writer-wins is
    the semantics the code asked for. A task that read, suspended, and
    writes a value derived from that read is the race.

    Weakly keyed so finished tasks drop their records; the value dict
    keys use id(obj) only as a map key while the instance is alive in
    the instrumented code path, never dereferenced."""

    def __init__(self) -> None:
        self._by_task: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )

    def record(
        self, task, obj, attr: str, version: int, site: str, flaggable: bool
    ) -> None:
        reads = self._by_task.get(task)
        if reads is None:
            reads = {}
            self._by_task[task] = reads
        reads[(id(obj), attr)] = (version, site, flaggable)

    def get(self, task, obj, attr: str):
        reads = self._by_task.get(task)
        if reads is None:
            return None
        return reads.get((id(obj), attr))


_TASK_READS = _TaskReads()


class _SanAttr:
    """Data descriptor standing in for one instrumented attribute.

    The value lives in the instance `__dict__` under a mangled slot
    (data descriptors shadow instance entries, so the plain name stays
    free); versions live in the instance's `_rpsan_state` map."""

    __slots__ = ("cls_name", "name", "slot", "default", "reset_ok")

    def __init__(
        self, cls_name: str, name: str, default, reset_ok=()
    ) -> None:
        self.cls_name = cls_name
        self.name = name
        self.slot = f"_rpsan${name}"
        self.default = default
        # function names whose writes are acknowledged blind resets
        # (see instrument(reset_writers=...)): versions still advance,
        # the access log still records, but no report fires
        self.reset_ok = frozenset(reset_ok)

    def _state(self, obj) -> dict:
        state = obj.__dict__.get(_STATE)
        if state is None:
            state = obj.__dict__[_STATE] = {}
        return state

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        val = obj.__dict__.get(self.slot, _MISSING)
        if val is _MISSING:
            if self.default is _MISSING:
                raise AttributeError(
                    f"{self.cls_name} object has no attribute {self.name!r}"
                )
            val = self.default
        version, _w = self._state(obj).get(self.name, (0, ""))
        task = _current_task()
        site = _site(2)  # 0=_site, 1=this descriptor method, 2=caller
        ACCESS_LOG.append(
            ("r", self.cls_name, self.name, version, _task_name(task), site)
        )
        if task is not None:
            _TASK_READS.record(task, obj, self.name, version, site, True)
        return val

    def __set__(self, obj, value) -> None:
        state = self._state(obj)
        version, last_write_site = state.get(self.name, (0, ""))
        task = _current_task()
        site = _site(2)  # 0=_site, 1=this descriptor method, 2=caller
        if task is not None:
            rec = _TASK_READS.get(task, obj, self.name)
            if (
                rec is not None
                and rec[2]
                and rec[0] != version
                and _caller_name(2) not in self.reset_ok
            ):
                report = Report(
                    cls=self.cls_name,
                    attr=self.name,
                    task=_task_name(task),
                    read_site=rec[1],
                    read_version=rec[0],
                    writer_task=state.get("_w_" + self.name, "<unknown>"),
                    write_site=last_write_site,
                    version=version,
                    clobber_site=site,
                )
                if len(REPORTS) < _MAX_REPORTS:
                    REPORTS.append(report)
                    print(report.render(), file=sys.stderr)
        new_version = version + 1
        state[self.name] = (new_version, site)
        state["_w_" + self.name] = _task_name(task)
        if task is not None:
            # the writer has the freshest view now, but that view came
            # from writing, not reading: a later blind overwrite by
            # this task is last-writer-wins, not a torn read
            _TASK_READS.record(
                task, obj, self.name, new_version, site, False
            )
        ACCESS_LOG.append(
            ("w", self.cls_name, self.name, new_version, _task_name(task), site)
        )
        obj.__dict__[self.slot] = value

    def __delete__(self, obj) -> None:
        obj.__dict__.pop(self.slot, None)


#: (class qualname, attrs) actually instrumented this process
INSTRUMENTED: list[tuple[str, tuple[str, ...]]] = []


def instrument(cls, attrs, reset_writers=None) -> type:
    """Install version-tracking descriptors for `attrs` on `cls`.

    A no-op returning `cls` unchanged unless `RP_SAN=1`. Only rebind
    races are caught (matching RPL015/016 scope); in-place container
    mutation is governed by the SoA/touch discipline instead. Class
    attributes used as class-level state (e.g. EWMA accumulators
    assigned via `Cls.attr = ...`) must NOT be listed: a class-level
    assignment would replace the descriptor itself.

    `reset_writers` maps attr -> function names whose writes are
    declared blind resets: the value written does not derive from any
    earlier read of the attr, and its real guard is a monotonicity
    check that runs loop-atomically with the write (e.g. raft
    `_step_down` resetting `_voted_for` only under `term >
    self.term`). The runtime analog of an inline `# rplint: disable`
    — declared at the instrumentation site with a justification, never
    silently."""
    if not ENABLED:
        return cls
    reset_writers = reset_writers or {}
    for name in attrs:
        default = getattr(cls, name, _MISSING)
        if isinstance(default, _SanAttr):  # double-instrument guard
            continue
        setattr(
            cls,
            name,
            _SanAttr(
                cls.__name__, name, default, reset_writers.get(name, ())
            ),
        )
    INSTRUMENTED.append((cls.__name__, tuple(attrs)))
    return cls
