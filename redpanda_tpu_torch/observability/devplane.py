"""devplane, off-state only.

The JAX package's `RP_DEVPLANE=1` telemetry (kernel latency
histograms, transfer accounting, compile events, the one-fold-per-frame
counter) is not ported yet (ROADMAP queue 1 step 3). The port keeps
the off-state contract: `instrument(f, name) is f`, no wrapper and no
per-call branch, and the frame hooks the mesh backend calls
(`tick_scope`, `frame_scope`, `count_fold`, `count_transfer`) do
nothing. Kernel launches on the port are counted by each ops module's
`LAUNCHES` instead.
"""

from __future__ import annotations

from contextlib import nullcontext

ENABLED = False


def enabled() -> bool:
    return ENABLED


def instrument(fn, name: str):
    """Return the callable to bind for kernel `name`: `fn` itself."""
    return fn


def tick_scope():
    """Scope of one replication tick (off: no accounting)."""
    return nullcontext()


def frame_scope(kind: str):
    """Scope of one device frame of `kind` (off: no accounting)."""
    return nullcontext()


def count_fold(n: int = 1) -> None:
    """Count cross-chip folds (off: nothing)."""


def count_transfer(nbytes: int, direction: str) -> None:
    """Count host<->device bytes (off: nothing)."""
