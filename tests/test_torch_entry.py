"""redpanda_tpu_torch/entry.py against the root __graft_entry__.py.

* `entry()` returns the port's heartbeat_tick and example arguments at
  G = 1024, R = 8, RF = 3: on the CPU its inputs equal the JAX entry's,
  and its output equals the JAX program's on them, lane for lane.
* `dryrun_multichip(n, device="cpu")` runs the reference scenario's
  every assertion over n chip blocks (commit, failover election,
  joint-reconfiguration gate, snapshot install).
"""

import numpy as np
import pytest

import __graft_entry__ as ref_entry
from redpanda_tpu_torch import entry as port_entry
from redpanda_tpu_torch.models.consensus_state import FIELD_DTYPES


def test_entry_matches_the_jax_entry():
    import jax

    jfn, jargs = ref_entry.entry()
    fn, args = port_entry.entry(device="cpu")
    jstate, *jcols = jargs
    state, *cols = args
    for name in FIELD_DTYPES:
        np.testing.assert_array_equal(getattr(state, name).numpy(), np.asarray(getattr(jstate, name)), name)
    for got, want in zip(cols, jcols):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(jfn)(*jargs)
    out = fn(*args)
    for name in FIELD_DTYPES:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(want, name)), name)
    assert (out.commit_index.numpy() == 100).all()


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_on_cpu(n):
    line = port_entry.dryrun_multichip(n, device="cpu")
    assert line.startswith(f"dryrun_multichip OK: {n} chip blocks, {8 * n} raft groups")
