"""Tuner framework core (reference: src/go/rpk/pkg/tuners/checker.go:38
Checker, checked_tunable.go CheckedTunable, check.go:25 Check loop).

A `Tuner` owns one tunable: it reports the current value, the desired
value, whether they match, and — on tune() — the concrete mutations
(file writes / commands) needed to converge. Mutations go through the
`SysFs` facade; `dry_run=True` (the default) collects them without
applying. `FakeSysFs` backs the offline tests the same way the
reference backs its tuner tests with afero in-memory filesystems."""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class Severity(Enum):
    # reference: tuners/checker.go:12 (Fatal = boot-blocking)
    FATAL = "fatal"
    WARNING = "warning"


@dataclass
class CheckResult:
    tuner: str
    desc: str
    ok: bool
    current: str
    required: str
    severity: Severity = Severity.WARNING
    error: Optional[str] = None
    supported: bool = True  # False: tunable absent on this host


@dataclass
class TuneAction:
    """One concrete mutation: a file write or a command invocation."""

    kind: str  # "write" | "cmd"
    target: str  # file path or command line
    value: str = ""

    def describe(self) -> str:
        if self.kind == "write":
            return f"write {self.value!r} > {self.target}"
        return f"run: {self.target}"


@dataclass
class TuneResult:
    tuner: str
    changed: bool
    actions: list[TuneAction] = field(default_factory=list)
    applied: bool = False
    error: Optional[str] = None


class SysFs:
    """Thin /proc-/sys facade so tuners are testable offline and
    apply-mode failures (EACCES without root) degrade to errors, not
    crashes."""

    def read(self, path: str) -> Optional[str]:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return None

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def glob(self, pattern: str) -> list[str]:
        return sorted(_glob.glob(pattern))

    def listdir(self, path: str) -> list[str]:
        try:
            return sorted(os.listdir(path))
        except OSError:
            return []

    def write(self, path: str, value: str) -> None:
        with open(path, "w") as f:
            f.write(value)

    def cpu_count(self) -> int:
        return os.cpu_count() or 1


class FakeSysFs(SysFs):
    """Dict-backed SysFs for tests (afero-in-memory analog)."""

    def __init__(self, files: Optional[dict[str, str]] = None):
        self.files: dict[str, str] = dict(files or {})
        self.writes: list[tuple[str, str]] = []
        self.ncpu = 2

    def read(self, path: str) -> Optional[str]:
        v = self.files.get(path)
        return v.strip() if v is not None else None

    def exists(self, path: str) -> bool:
        return path in self.files or any(
            p.startswith(path.rstrip("/") + "/") for p in self.files
        )

    def glob(self, pattern: str) -> list[str]:
        import fnmatch

        return sorted(
            p for p in self.files if fnmatch.fnmatch(p, pattern)
        )

    def listdir(self, path: str) -> list[str]:
        prefix = path.rstrip("/") + "/"
        names = {
            p[len(prefix) :].split("/", 1)[0]
            for p in self.files
            if p.startswith(prefix)
        }
        return sorted(names)

    def write(self, path: str, value: str) -> None:
        self.writes.append((path, value))
        self.files[path] = value

    def cpu_count(self) -> int:
        return self.ncpu


class Tuner:
    """Base tunable: subclasses implement current()/required()/plan()."""

    name = "tuner"
    desc = ""
    severity = Severity.WARNING

    def __init__(self, fs: Optional[SysFs] = None):
        self.fs = fs or SysFs()

    # -- introspection -------------------------------------------------
    def supported(self) -> bool:
        return True

    def current(self) -> str:
        raise NotImplementedError

    def required(self) -> str:
        raise NotImplementedError

    def ok(self) -> bool:
        return self.current() == self.required()

    def plan(self) -> list[TuneAction]:
        """Mutations that would converge current → required."""
        raise NotImplementedError

    # -- drivers -------------------------------------------------------
    def check(self) -> CheckResult:
        if not self.supported():
            return CheckResult(
                tuner=self.name,
                desc=self.desc,
                ok=True,
                current="n/a",
                required="n/a",
                severity=self.severity,
                supported=False,
            )
        try:
            return CheckResult(
                tuner=self.name,
                desc=self.desc,
                ok=self.ok(),
                current=self.current(),
                required=self.required(),
                severity=self.severity,
            )
        except Exception as e:  # checks never crash the CLI
            return CheckResult(
                tuner=self.name,
                desc=self.desc,
                ok=False,
                current="?",
                required="?",
                severity=self.severity,
                error=f"{type(e).__name__}: {e}",
            )

    def tune(self, dry_run: bool = True) -> TuneResult:
        if not self.supported():
            return TuneResult(tuner=self.name, changed=False)
        try:
            if self.ok():
                return TuneResult(tuner=self.name, changed=False)
            actions = self.plan()
        except Exception as e:
            return TuneResult(
                tuner=self.name,
                changed=False,
                error=f"{type(e).__name__}: {e}",
            )
        res = TuneResult(tuner=self.name, changed=bool(actions), actions=actions)
        if dry_run:
            return res
        for a in actions:
            try:
                if a.kind == "write":
                    self.fs.write(a.target, a.value)
                else:
                    res.error = f"cmd actions need a shell: {a.target}"
                    return res
            except OSError as e:
                res.error = f"{a.describe()}: {e}"
                return res
        res.applied = True
        return res


def all_tuners(fs: Optional[SysFs] = None) -> list[Tuner]:
    from . import tunables

    fs = fs or SysFs()
    return [cls(fs) for cls in tunables.TUNERS]


def check_all(fs: Optional[SysFs] = None) -> list[CheckResult]:
    """reference check.go:25 Check — run every checker, sorted."""
    return sorted(
        (t.check() for t in all_tuners(fs)), key=lambda r: r.tuner
    )


def tune_all(
    fs: Optional[SysFs] = None, dry_run: bool = True
) -> list[TuneResult]:
    return [t.tune(dry_run=dry_run) for t in all_tuners(fs)]
