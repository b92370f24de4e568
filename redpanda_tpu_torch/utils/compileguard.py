"""compileguard, off-state only.

The JAX package's guard (`RP_COMPILEGUARD=1`) reports kernels that
re-trace under steady traffic. CUDA kernels built with nvcc compile
once per process and never re-trace on a new shape, so the port keeps
only the off-state contract its callers rely on: `instrument(f, name)`
returns `f` unchanged and `warmup(reason)` marks a region where builds
are expected.
"""

from __future__ import annotations

from contextlib import contextmanager

ENABLED = False


def enabled() -> bool:
    return ENABLED


def instrument(fn, name: str):
    """Return the callable to bind for kernel `name`: `fn` itself."""
    return fn


@contextmanager
def warmup(reason: str):
    """Declare a region where kernel builds are expected (capacity
    doubling, explicit prewarm). `reason` documents the site."""
    if not reason:
        raise ValueError("warmup() requires a justification string")
    yield
