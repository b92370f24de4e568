"""Device-mesh parallelism (SURVEY.md §2.11, §5.8), on chip blocks.

The reference scales by sharding partitions over cores and nodes and
exchanging per-group offset/term scalars over its TCP RPC. The JAX
package maps that onto a device mesh (groups sharded over devices,
replication as ppermute rings); the port keeps the same layout as D
chip blocks of contiguous rows on one CUDA card (see mesh.py), so the
mesh backend and the ring cluster step run on one H100.
"""

from .cluster_step import (
    ClusterState,
    cluster_tick,
    cluster_tick_sharded,
    election_round,
    election_round_sharded,
    make_cluster_state,
)
from .mesh import Mesh, group_sharding, make_mesh, place_rows, shard_group_state

__all__ = [
    "ClusterState",
    "Mesh",
    "group_sharding",
    "make_mesh",
    "place_rows",
    "shard_group_state",
    "make_cluster_state",
    "cluster_tick",
    "cluster_tick_sharded",
    "election_round",
    "election_round_sharded",
]
