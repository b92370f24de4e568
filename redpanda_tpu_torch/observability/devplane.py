"""devplane, off-state only.

The JAX package's `RP_DEVPLANE=1` telemetry (kernel latency
histograms, transfer accounting, compile events) is not ported yet.
The port keeps the off-state contract: `instrument(f, name) is f`, no
wrapper and no per-call branch. Kernel launches on the port are
counted by each ops module's `LAUNCHES` instead.
"""

from __future__ import annotations

ENABLED = False


def enabled() -> bool:
    return ENABLED


def instrument(fn, name: str):
    """Return the callable to bind for kernel `name`: `fn` itself."""
    return fn
