"""rpk tuner framework: detection, check, dry-run and apply of OS-level
performance tuning (reference: src/go/rpk/pkg/tuners/check.go:25,
checker.go:38 Checker interface, tuners/cpu/tuner.go, tuners/irq/,
tuners/fstrim.go, tuners/iotune.go).

Design: every tunable is a `Tuner` exposing current-vs-desired through
an injectable `SysFs` (a thin /proc + /sys + shell facade), so checks
run unprivileged and tests run against a fake filesystem. `tune()`
defaults to dry-run: it returns the exact mutations it WOULD make —
the reference applies by default; a TPU-host operator typically lacks
root, so detection/reporting is the primary mode here.
"""

from .framework import (
    CheckResult,
    Severity,
    SysFs,
    FakeSysFs,
    Tuner,
    TuneAction,
    TuneResult,
    all_tuners,
    check_all,
    tune_all,
)

__all__ = [
    "CheckResult",
    "Severity",
    "SysFs",
    "FakeSysFs",
    "Tuner",
    "TuneAction",
    "TuneResult",
    "all_tuners",
    "check_all",
    "tune_all",
]
