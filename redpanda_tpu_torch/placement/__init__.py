"""placement: the unified raft-group → (process shard, device lane
slot) layer with live partition moves and alert-driven rebalance.

The ONLY package allowed to compute shard placement (rplint RPL017);
everyone else asks the PlacementTable. See table.py for the policy,
host.py/mover.py for the freeze→ship→adopt→retire live-move protocol,
and rebalancer.py for the alert-closed loop.
"""

from .mover import (
    MoveBudget,
    MoveBudgetExhausted,
    MoveError,
    MoveStats,
    PartitionMover,
)
from .host import MoveFault, MoveHost
from .rebalancer import Rebalancer, SKEW_FAMILY
from .table import PlacementTable, compute_shard

__all__ = [
    "MoveBudget",
    "MoveBudgetExhausted",
    "MoveError",
    "MoveFault",
    "MoveHost",
    "MoveStats",
    "PartitionMover",
    "PlacementTable",
    "Rebalancer",
    "SKEW_FAMILY",
    "compute_shard",
]
