"""Declared-cap shape discipline for device-kernel wrappers.

Every jit'd kernel compiles once per distinct (shapes x dtypes x
static values) signature, so a wrapper that allocates its batch with
a data-dependent leading dim (`len(chunks)` rows) compiles once per
batch size — the silent-recompile failure class RPL020 flags. The
width dims already follow the padded-bucket recipe (`n = 256; while
n < longest: n *= 2`); this module is the same contract for ROW
counts, shared so every codec wrapper buckets identically and the
steady-state compile count stays zero (utils/compileguard.py).

Padded rows are inert by construction: the vmap'd kernels treat each
row independently, a zero row with valid=0 produces garbage that the
caller slices off, and the cost is bounded at 2x the useful rows —
the classic fixed-shape TPU trade (pay bounded padding compute, never
pay an XLA recompile on the serving path).

rplint's device-plane interpreter (tools/rplint/devplane.py) knows
`row_bucket` by name: a dim routed through it is classified bounded
(`p2`), the positive form of the `# rplint: bucketed=<why>`
annotation.
"""

from __future__ import annotations


def row_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor): the leading-dim bucket
    for batched kernel calls. `floor` must itself be a power of two."""
    assert floor > 0 and floor & (floor - 1) == 0, "floor must be pow2"
    b = floor
    while b < n:
        b *= 2
    return b
