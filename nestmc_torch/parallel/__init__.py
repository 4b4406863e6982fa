"""Parallelism: the (chains, groups) mesh on torch.distributed.

Port of :mod:`nestmc.parallel`. The reference has XLA insert its
collectives from ``jit`` + ``NamedSharding``; here one process runs each
rank (multihost.initialize), the engine cuts the inputs to the rank's
part (sharding.py), and the one hot-loop collective, the sum over groups
of a population conditional, is written out (collectives.groups_sum).
"""

from nestmc_torch.parallel.sharding import (
    data_shardings,
    make_mesh,
    shard_inputs,
    state_shardings,
)

__all__ = [
    "data_shardings",
    "make_mesh",
    "shard_inputs",
    "state_shardings",
]
