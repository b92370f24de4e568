"""compileguard — runtime build-discipline guard (`RP_COMPILEGUARD=1`).

The JAX package's guard catches a steady-state recompile: a shape,
dtype or static value the warmup never saw reaching a jit'd kernel
while the serving loop is live, an XLA compile that blocks the event
loop for hundreds of milliseconds. The port's kernels are CUDA
libraries that nvcc builds once per source (`ops/_build.py`, at first
use or `build_all`); a launch at a new shape builds nothing. So the
port's counterpart of a compile is a library build, and the stall
class is the same: a build that lands after `steady()` stops the
process for the seconds nvcc takes.

Model, as in the reference — every kernel wrapper on the live path is
registered through `instrument(fn, name)` at its binding site. A
process starts in the **warmup** phase (builds are expected: prewarm,
the first call of each kernel). The harness calls `steady()` once its
measured window begins; declared growth sites (capacity doubling,
explicit prewarm) wrap themselves in `with warmup(reason):`.

`ops/_build.py` reports every build it runs through `report_build`,
with its seconds. The build is attributed to the innermost
instrumented kernel on the attribution stack (the wrapper whose first
call needed the library) or, outside any kernel, to the source it
built (`csrc/<name>.cu`), and handed to every `subscribe_compiles`
subscriber with the current phase — the devplane turns these into its
compile metrics and the recompile-storm alert. `compile_counts()` is
builds per kernel name.

`instrument` registers the kernel name and returns the callable
UNTOUCHED — no wrapper, no per-call branch — so the guard costs nothing
on the tick path **by construction**. The reference's armed guard
(`RP_COMPILEGUARD=1`, a wrapper reporting jit-cache growth) has no
counterpart: a steady-phase build reaches the subscribers with its
phase, and the devplane's `device_recompile_storm` rule fires on it.
"""

from __future__ import annotations

from contextlib import contextmanager

ENABLED = False

#: names registered through instrument(), so compile_counts() lists
#: every kernel of the live path
_KERNELS: dict[str, object] = {}

#: innermost instrumented kernel currently executing (attribution
#: stack for build reports)
_CURRENT: list[str] = []

#: name -> library builds attributed while that kernel was the
#: innermost instrumented frame (or to the source built outside one)
_BUILDS: dict[str, int] = {}

#: build-event subscribers: cb(kernel, seconds, phase) on every build
_SUBSCRIBERS: list = []

_PHASE = "warmup"  # "warmup" until steady(); warmup() re-enters
_WARMUP_DEPTH = 0


def enabled() -> bool:
    return ENABLED


def reset() -> None:
    """Clear the build counts and return to the warmup phase (test
    harness hook; production processes call steady() once)."""
    global _PHASE
    _BUILDS.clear()
    _PHASE = "warmup"


def steady() -> None:
    """Declare warmup over: from here, any build outside a
    `with warmup(...)` block is a finding."""
    global _PHASE
    _PHASE = "steady"


def in_steady() -> bool:
    return _PHASE == "steady" and _WARMUP_DEPTH == 0


def phase() -> str:
    """The current build-accounting phase label: "steady" once steady()
    was called and no warmup() region is open, else "warmup"."""
    return "steady" if in_steady() else "warmup"


@contextmanager
def warmup(reason: str):
    """Declare a bounded region where builds are expected — capacity
    doubling, explicit prewarm, backend switch. `reason` documents the
    why at the site; re-enterable."""
    global _WARMUP_DEPTH
    if not reason:
        raise AssertionError("warmup() requires a justification string")
    _WARMUP_DEPTH += 1
    try:
        yield
    finally:
        _WARMUP_DEPTH -= 1


def compile_counts() -> dict[str, int]:
    """name -> library builds attributed to it, for every registered
    kernel (0 when its libraries were already built) and every source
    built outside a kernel. Works with the guard off."""
    out = {name: 0 for name in _KERNELS}
    out.update(_BUILDS)
    return dict(sorted(out.items()))


def subscribe_compiles(cb) -> None:
    """Register `cb(kernel, seconds, phase)` for every library build.
    The attribution stack is fed by the subscriber's own wrappers
    (devplane probes) via push_kernel / pop_kernel."""
    _SUBSCRIBERS.append(cb)


def push_kernel(name: str) -> None:
    """Enter kernel `name` on the attribution stack. Wrappers around a
    kernel — devplane probes — push/pop around dispatch so builds
    attribute to the innermost kernel."""
    _CURRENT.append(name)


def pop_kernel() -> None:
    _CURRENT.pop()


def report_build(source: str, secs: float) -> None:
    """One library build of `csrc/<source>.cu` took `secs` (called by
    ops._build after nvcc returns): count it against the innermost
    kernel on the stack, else the source, and tell the subscribers."""
    k = _CURRENT[-1] if _CURRENT else f"csrc/{source}.cu"
    _BUILDS[k] = _BUILDS.get(k, 0) + 1
    ph = phase()
    for cb in _SUBSCRIBERS:
        try:
            cb(k, secs, ph)
        except Exception:  # a broken subscriber must not poison the build
            pass


def instrument(fn, name: str):
    """Register kernel wrapper `fn` under `name` and return the
    callable to bind: `fn` itself (structural absence: `instrument(f,
    n) is f`). Factories that rebind per mesh re-register under the
    same name."""
    _KERNELS[name] = fn
    return fn
