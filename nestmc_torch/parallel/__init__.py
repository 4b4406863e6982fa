"""Parallelism: the (chains, groups) mesh on torch.distributed.

Port of :mod:`nestmc.parallel`. The reference has XLA insert its
collectives from ``jit`` + ``NamedSharding``; here one process runs each
rank (multihost.initialize), the engine builds the rank's part of the
carry (sharding.shard_state) and finalizes its streamed R-hat where its
units live, and the hot-loop collectives are written out: the sum
over groups of a population conditional (collectives.groups_sum) and, for
a vmap_chains user model, the gather of the unit axis its hooks run on
(collectives.groups_gather). A rank keeps its part of every tensor with
a chain or unit axis from sample()'s entry to the Posterior
(Posterior.final_state, accept_rates); :func:`gather_state` and
:func:`gather_rates` give the global layout to a caller who asks, and a
checkpoint's carry is gathered to the primary alone
(collectives.gather_to_primary).
"""

from nestmc_torch.parallel.sharding import (
    data_shardings,
    gather_rates,
    gather_state,
    make_mesh,
    shard_inputs,
    shard_state,
    state_shardings,
)

__all__ = [
    "data_shardings",
    "gather_rates",
    "gather_state",
    "make_mesh",
    "shard_inputs",
    "shard_state",
    "state_shardings",
]
