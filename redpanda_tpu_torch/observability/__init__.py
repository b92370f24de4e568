"""Observability layer: flight-recorder tracing, the flight-data plane
and the device-plane telemetry.

Copies of redpanda_tpu/observability's host modules — `trace`
(ring-buffered span trees with a slow-request freezer), `load_ledger`,
`health`, `fleet` (the serde snapshot protocol), `flightdata`
(metrics-history ring with exact windowed reducers) and `alerts`
(multi-window burn-rate SLO evaluation over that ring) — with the
histogram side in `redpanda_tpu_torch.metrics`. `devplane` is the port
of the device-plane telemetry: dispatch→ready probes on every CUDA
kernel wrapper of the live path, the mesh frame's fold and transfer
counters, and nvcc build events (`RP_DEVPLANE=1`).
"""

from .trace import (  # noqa: F401
    FlightRecorder,
    Span,
    current_span,
    propagation_ctx,
    reset_remote_parent,
    set_remote_parent,
    span,
    tag_current,
)
