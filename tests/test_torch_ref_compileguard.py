"""tests/test_compileguard.py run on the port: 2 of its 8 cases, with
imports pointed at redpanda_tpu_torch. The port's
`utils/compileguard.py` has no armed guard (ROADMAP queue 3,
"Deliberate divergences": compile events): it counts nvcc library
builds, not XLA compiles, and has no `Report`, `reports()` or
`backend_compiles()`. Left out:
`test_off_compile_counts_still_works`,
`test_on_shape_wobble_reported_byte_stable`,
`test_on_warmup_exemption_and_reset` and
`test_on_mesh_eight_forced_devices` (they build `jax.jit` programs and
read XLA's compile counts or 8 forced host devices), and
`test_phase_semantics` and `test_report_render_is_byte_stable` (they
read `reports()` and `Report`). An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu", as in
every mirror.

compileguard: the runtime twin of rplint's RPL020/021.

Off-state tests run in-process (tier-1 never sets RP_COMPILEGUARD, so
the default import IS the off state and the structural-absence claim —
`instrument(f, n) is f` — is checked directly, not simulated).
"""

import pytest

from redpanda_tpu_torch.ops import default_device
from redpanda_tpu_torch.utils import compileguard

_off = pytest.mark.skipif(
    compileguard.enabled(), reason="suite assumes the default off state"
)


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# -- off state (the tier-1 default) ------------------------------------


@_off
def test_off_instrument_is_structural_passthrough():
    def fn(x):
        return x

    assert not compileguard.enabled()
    # no wrapper, no per-call branch: the bound callable IS the kernel
    assert compileguard.instrument(fn, "t.passthrough") is fn


def test_warmup_requires_justification():
    with pytest.raises(AssertionError):
        with compileguard.warmup(""):
            pass
