"""The device mesh as chip blocks on one card, and group-state placement.

The JAX package builds a `jax.sharding.Mesh` over D devices and places
every `[G, ...]` tensor with `NamedSharding(P("shard"))`: device d holds
an equal contiguous block of raft groups (a chip block). The port keeps
that placement on one CUDA card: a `Mesh` is D chip blocks of
contiguous rows of tensors on one torch device, the kernels launch one
grid row per block (`gridDim.y = D`), a `ppermute` between devices is an
index roll over the block axis and a `psum` a sum of per-block partials.
Because the blocks share the card, D may exceed
`torch.cuda.device_count()`: `make_mesh(8)` on a one-card machine is
the 8-device mesh of the reference. Splitting the blocks over several
cards with `torch.distributed` is not done here.

Rows are padded to a multiple of D with zero rows, which are neutral for
every kernel that reads them (not a leader, no voters, not active), as
the reference pads its capacity for an arbitrary device count.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.consensus_state import check_device

SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D chip blocks of contiguous rows on one torch device."""

    n_devices: int
    device: torch.device
    axis: str = SHARD_AXIS


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of `n_devices` chip blocks (default: every visible CUDA
    card, the counterpart of `len(jax.devices())`) on `device`. Raises
    without CUDA when `device` is a CUDA device."""
    dev = check_device(device)
    n = n_devices if n_devices is not None else torch.cuda.device_count()
    if n < 1:
        raise ValueError(f"a mesh needs at least one chip block, got {n}")
    return Mesh(int(n), dev)


class GroupSharding(NamedTuple):
    """The block layout of `[G, ...]` tensors over a mesh: chip block d
    holds rows [d * block, (d + 1) * block) of the padded row axis."""

    n_devices: int

    def rows_per_block(self, rows: int) -> int:
        """ceil(rows / D), as ShardGroupArrays.chip_block."""
        return -(-rows // self.n_devices)

    def padded_rows(self, rows: int) -> int:
        return self.rows_per_block(rows) * self.n_devices


def group_sharding(mesh: Mesh) -> GroupSharding:
    """Groups split into D equal contiguous blocks along axis 0; any
    per-replica axis stays whole within its row."""
    return GroupSharding(mesh.n_devices)


def place_rows(a, mesh: Mesh) -> torch.Tensor:
    """One `[G, ...]` lane (numpy array or tensor, any memory order) as
    a row-major tensor on the mesh's device, its row axis padded with
    zero rows to a multiple of D. Always a copy."""
    sharding = group_sharding(mesh)
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    g = t.shape[0]
    pad = sharding.padded_rows(g) - g
    out = torch.zeros((g + pad,) + tuple(t.shape[1:]), dtype=t.dtype, device=mesh.device)
    out[:g] = t
    return out


def shard_group_state(state, mesh: Mesh):
    """Place every `[G, ...]` tensor of a GroupState or ClusterState
    with the group axis split into the mesh's chip blocks (padded with
    neutral zero rows), the device-level analog of the reference's
    shard_table (cluster/shard_table.h:26). Returns a new state."""
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(
            state,
            **{
                f.name: shard_group_state(getattr(state, f.name), mesh)
                for f in dataclasses.fields(state)
            },
        )
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(shard_group_state(t, mesh) for t in state))
    return place_rows(state, mesh)
