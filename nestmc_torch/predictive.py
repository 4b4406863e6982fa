"""Posterior-predictive simulation: model checking for nested data.

Port of :mod:`nestmc.predictive`. Replicated datasets y_rep ~ p(y |
theta^(s)) at posterior draws theta^(s) (Gelman et al., BDA3 ch. 6), from
the model's ``sample_data`` hook (the simulator of the calibration tiers),
and the posterior-predictive p-value of a test statistic.
"""

from __future__ import annotations

import torch

from nestmc_torch.data import data_device
from nestmc_torch.rng import SweepRNG


class _RecordingState(dict):
    """State dict that records which blocks the simulator reads."""

    def __init__(self, base):
        super().__init__(base)
        self.accessed: set = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)


def _partial(model, name, draws) -> bool:
    """True when a model block's draws hold fewer units than the block."""
    try:
        shape = tuple(model.block(name).shape)
    except KeyError:
        return False
    return tuple(draws.shape[2:]) != shape


def _not_full(model, names, needed, err=None):
    detail = f": {err}" if err is not None else ""
    return ValueError(
        f"posterior_predictive: model {model.name!r} reads blocks "
        f"{sorted(needed)}; each must be fully collected (RunConfig.collect "
        f"None or the full unit count) — partial collection of {names} "
        f"breaks the simulator shapes{detail}"
    )


def posterior_predictive(model, post, data, rng=None, num: int = 64):
    """Simulate ``num`` replicated response arrays from posterior draws.

    Draws (chain, draw) indices uniformly from ``rng.generator`` (an
    explicit torch.Generator; ``rng`` a :class:`SweepRNG`, by default
    SweepRNG(0) on the data's device), rebuilds single-chain states from
    the retained draws and calls ``model.sample_data`` once a replicate
    (the simulators read chain 0).

    Blocks that ``sample_data`` reads must be fully collected; blocks it
    does not read may be partially collected or absent. The blocks read
    are those the first replicate's call looks up.

    Returns the stacked replicated responses, (num, G, n) for padded data
    (masked entries zero), (num, N) for ragged data.
    """
    if model.sample_data is None:
        raise ValueError(f"model {model.name!r} has no sample_data hook")
    if not post.draws:
        raise ValueError("no retained draws to predict from")
    if rng is None:
        rng = SweepRNG(0, data_device(data))
    draws = post.draws
    C, D = next(iter(draws.values())).shape[:2]
    gen = rng.generator
    cs = torch.randint(0, C, (num,), generator=gen, device=gen.device)
    ds = torch.randint(0, D, (num,), generator=gen, device=gen.device)
    cs, ds = cs.tolist(), ds.tolist()

    def state(names, i):
        return {k: draws[k][cs[i], ds[i]][None] for k in names}

    probe = _RecordingState(state(draws, 0))
    try:
        first = model.sample_data(rng, probe, data).y
    except (TypeError, ValueError, RuntimeError, IndexError) as e:
        partial = [k for k in probe.accessed if _partial(model, k, draws[k])]
        if partial:
            raise _not_full(model, partial, probe.accessed, e) from e
        raise
    needed = probe.accessed or set(draws)
    partial = [k for k in needed if _partial(model, k, draws[k])]
    if partial:
        raise _not_full(model, partial, needed)
    reps = [first] + [model.sample_data(rng, state(needed, i), data).y
                      for i in range(1, num)]
    return torch.stack(reps)


def predictive_pvalue(y_rep, data, stat=None):
    """Posterior-predictive p-value of a test statistic.

    stat: fn(y, mask_or_None) -> scalar or tensor; default the masked
    mean. Returns P(stat(y_rep) >= stat(y_obs)) over the replicates:
    values near 0 or 1 flag misfit in that statistic.
    """
    mask = getattr(data, "mask", None)
    if stat is None:
        if mask is not None:
            def stat(y, m):
                return torch.sum(y * m) / torch.sum(m)
        else:
            def stat(y, m):
                return torch.mean(y)

    obs = stat(data.y, mask)
    reps = torch.stack([torch.as_tensor(stat(y, mask)) for y in y_rep])
    return torch.mean((reps >= obs).float(), dim=0)
